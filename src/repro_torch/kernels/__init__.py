"""Hand-written Hopper kernels (CUDA C++ for sm_90a under ``csrc/``), their
wrappers (:mod:`.ops`), plain PyTorch versions (:mod:`.ref`) and the build
(:mod:`.build`). Importing this package builds nothing: the extension is
compiled at the first launch on a CUDA tensor."""
