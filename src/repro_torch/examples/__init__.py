"""Twins of the JAX package's example scripts (``examples/*.py``), each run
as ``python -m repro_torch.examples.<name>``: the same arguments, plus
``--device`` (the CUDA card unless ``cpu``), and the same printed lines."""
