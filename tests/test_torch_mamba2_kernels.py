"""PyTorch port, slice 6e: kernel 1 at mamba2-2.7b's GEMM shapes, on the
card (``cuda``-marked; skips without a card). No JAX import, so it runs on
a machine without JAX: ``python -m pytest -q -m cuda
tests/test_torch_mamba2_kernels.py``.

Decode (M = 4) in_proj (N = 10,576, N % 64 = 16: a ragged last column
tile), out_proj and the untied head, and a prefill in_proj (M = 128),
against the plain version within the f32-order bound (1e-5 |xq| @ |wq|:
every folded product is exact in f32, only the order of the sum
differs); two launches bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.precision import get_policy


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 2560, 10576), (4, 5120, 2560),
                                   (4, 2560, 50280), (128, 2560, 10576)])
def test_cuda_gemm_kernel_at_mamba2_shapes(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    from repro_torch.kernels import ops, ref
    m, k, n = shape
    rng = np.random.default_rng(m + n)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, n)) / np.sqrt(k)).astype(
        np.float32))
    policy = get_policy("mirage")
    got = ops.mirage_matmul_fused(x.cuda(), w.cuda(), policy)
    again = ops.mirage_matmul_fused(x.cuda(), w.cuda(), policy)
    assert torch.equal(got, again)
    want = ref.mirage_gemm_ref(x, w)
    xq = ref.bfp_fake_quant_ref(x, 4, 16)
    wq = ref.bfp_fake_quant_ref(w.T, 4, 16).T
    tol = 1e-5 * (xq.abs().double() @ wq.abs().double()) + 1e-30
    assert bool(((got.cpu() - want).abs().double() <= tol).all())
