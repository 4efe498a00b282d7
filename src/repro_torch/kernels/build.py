"""Build the CUDA extension from the repository's sources, at first use.

Every source under ``csrc/`` goes into one ``torch.utils.cpp_extension.load``
call (ninja compiles them in parallel) for ``sm_90a``, into ``build/torch_ext``
at the root of the checkout (listed in ``.gitignore``). Only
``bindings.cpp`` includes PyTorch's headers. ``--use_fast_math`` is left
out on purpose: it flushes subnormals and approximates division, which
would break the bit-exact BFP quantizer.
"""

from __future__ import annotations

import functools
import pathlib

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("bindings.cpp", "bfp_quantize.cu", "mirage_gemm.cu",
           "mirage_gemm_stack.cu",
           "flash_attention.cu", "rns_matmul.cu", "rrns_decode.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "torch_ext"
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17")


@functools.cache
def extension():
    """The compiled extension module (built on the first call)."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)  # load() does not make it
    return load(
        name="repro_torch_kernels",
        sources=[str(CSRC / s) for s in SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cflags=["-O3", "-std=c++17"],
        extra_cuda_cflags=list(CUDA_FLAGS),
    )
