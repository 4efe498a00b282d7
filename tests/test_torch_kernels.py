"""PyTorch port: the kernels' plain versions vs the JAX Pallas kernels
(interpret mode), the wrappers' routing, the GEMM backends, and the port's
isolation from JAX.

Kernel-vs-plain checks on the card need CUDA; they carry the ``cuda`` marker
and skip here (``python3 chip_smoke.py`` runs the same checks at the
serving shapes).
"""

import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.core import gemm as jgemm
from repro.core.precision import get_policy as jpolicy
from repro.kernels.bfp_quantize import bfp_fake_quant_pallas
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.mirage_gemm import mirage_gemm_pallas
from repro.models.attention import chunked_attention as jchunked
from repro_torch import resolve_device
from repro_torch.core import backends, gemm
from repro_torch.core.precision import get_policy
from repro_torch.kernels import ops, ref
from repro_torch.models import attention


def _rand(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _gemm_tol(x, w, b_m=4, g=16):
    """|got - ref| <= 1e-5 (|xq| @ |wq|) + 1e-30: every folded product is
    exact in f32, so only the order of the f32 sum may differ."""
    xq = ref.bfp_fake_quant_ref(torch.tensor(x), b_m, g)
    wq = ref.bfp_fake_quant_ref(torch.tensor(w).T, b_m, g).T
    return (1e-5 * (xq.abs().double() @ wq.abs().double()) + 1e-30).numpy()


# --------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 37, 9), (3, 128, 17), (2, 16, 4),
                                   (7, 64, 13)])
def test_gemm_plain_matches_pallas(shape):
    m, k, n = shape
    x, w = _rand((m, k), 3), _rand((k, n), 4)
    want = np.asarray(mirage_gemm_pallas(jnp.asarray(x), jnp.asarray(w),
                                         block_m=8, block_n=8, block_k=32,
                                         interpret=True))
    got = ref.mirage_gemm_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert np.all(np.abs(got.numpy() - want) <= _gemm_tol(x, w))


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("shape", [(64, 200), (7, 33)])
def test_bfp_plain_matches_pallas_bitwise(shape, rounding):
    rng = np.random.default_rng(9)
    x = (rng.choice([-1.0, 1.0], shape) *
         10.0 ** rng.uniform(-8, 8, shape)).astype(np.float32)
    want = np.asarray(bfp_fake_quant_pallas(jnp.asarray(x),
                                            rounding=rounding,
                                            interpret=True))
    got = ref.bfp_fake_quant_ref(torch.from_numpy(x), rounding=rounding)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("shape,window", [
    ((1, 32, 4, 16, 4), None),    # MHA
    ((2, 24, 8, 16, 2), None),    # GQA 4:1
    ((1, 17, 6, 8, 3), None),     # ragged length, GQA 2:1
    ((1, 20, 4, 8, 2), 8),        # sliding window
])
def test_flash_plain_matches_pallas(shape, window):
    B, L, H, D, Kv = shape
    q = _rand((B, L, H, D), 1, 0.5)
    k = _rand((B, L, Kv, D), 2, 0.5)
    v = _rand((B, L, Kv, D), 3, 0.5)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, block_q=8,
                             block_k=8, interpret=True))
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), True, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [
    (1, 32, 4, 16, 4),            # MHA (the enc-dec encoder's layout)
    (2, 24, 8, 16, 2),            # GQA 4:1
    (1, 17, 6, 8, 3),             # ragged length, GQA 2:1
])
def test_flash_plain_matches_pallas_noncausal(shape):
    """Bidirectional attention (the enc-dec encoder's): every query reads
    every key."""
    B, L, H, D, Kv = shape
    q = _rand((B, L, H, D), 11, 0.5)
    k = _rand((B, L, Kv, D), 12, 0.5)
    v = _rand((B, L, Kv, D), 13, 0.5)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=False, block_q=8, block_k=8,
                             interpret=True))
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(causal):
    B, L, H, D, Kv = 2, 40, 4, 16, 2
    q, k, v = _rand((B, L, H, D), 4), _rand((B, L, Kv, D), 5), \
        _rand((B, L, Kv, D), 6)
    pos = np.arange(L)
    want = np.asarray(jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(pos), jnp.asarray(pos),
                               causal=causal, q_chunk=16, kv_chunk=16))
    got = attention.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pos), torch.from_numpy(pos), causal=causal,
        q_chunk=16, kv_chunk=16)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# the fused GEMM's design: BFP values exact in bf16, the split of K
# --------------------------------------------------------------------------

def _clamp_rows(g, seed):
    """Groups whose scale clamps at 2^-126 (subnormal and tiny maxima),
    groups at the top of the exponent field (maxima near 3.4e38, where
    b_m = 1 reaches the 2^127 clamp), zero groups, and groups spread over
    1e-30..1e30 with both signs."""
    rng = np.random.default_rng(seed)
    K = 8 * g
    sign = rng.choice([-1.0, 1.0], size=(6, K))
    rows = np.stack([
        rng.uniform(1e38, 3.4e38, K),                       # top exponents
        rng.uniform(1e-45, 1.17e-38, K),                    # subnormal max
        rng.uniform(1e-38, 1e-37, K),                       # tiny normals
        10.0 ** rng.uniform(-30, 30, K),
        10.0 ** rng.uniform(-3, 3, K),
        np.zeros(K)]) * sign
    return torch.from_numpy(rows.astype(np.float32))


@pytest.mark.parametrize("g", [8, 16, 32])
@pytest.mark.parametrize("b_m", range(1, 9))
def test_bfp_values_exact_in_bf16(b_m, g):
    """The tensor-core route's premise: a BFP(b_m <= 8) value is an integer
    of at most 8 bits times a power of two in [2^-126, 2^127], so bf16
    holds it exactly, at both clamps of the scale."""
    x = _clamp_rows(g, seed=b_m * 100 + g)
    q = ref.bfp_fake_quant_ref(x, b_m, g)
    assert torch.isfinite(q).all()
    back = q.to(torch.bfloat16).to(torch.float32)
    assert torch.equal(back.view(torch.int32), q.view(torch.int32))
    # the subnormal-max groups sit on the 2^-126 grid (the lower clamp)
    steps = q[1].double() / 2.0 ** -126
    assert torch.equal(steps, steps.round()) and (steps != 0).any()
    if b_m == 1:
        assert (q[0].abs() == 2.0 ** 127).any()            # the upper clamp


def test_bfp_reciprocal_scale_from_bits():
    """bfp.cuh builds 1 / 2^s from the exponent field (2^-127 as the
    subnormal bit 22) instead of dividing; it equals 1.0f / scale for every
    s the clamp allows."""
    for s in range(-126, 128):
        scale = np.array([(s + 127) << 23], np.int32).view(np.float32)
        bits = (127 - s) << 23 if s < 127 else 1 << 22
        inv = np.array([bits], np.int32).view(np.float32)
        assert (np.float32(1.0) / scale).view(np.int32)[0] == \
            inv.view(np.int32)[0]


@pytest.mark.parametrize("K,N", [(896, 896), (896, 128), (896, 4864),
                                 (4864, 896), (896, 151936)])
def test_gemm_plan_fills_the_card_at_decode(K, N):
    """At the decode tick the wrapper splits K until every serving GEMM
    launches at least one block per SM of an H100, in whole 64-row steps
    that cover K once, within the shared memory of the quantized x."""
    for M in (1, 2, 4, 8, 16):
        p = ops.gemm_plan(M, N, K, b_m=4)
        assert not p.mma and p.threads in (32, 64, 128)
        n_tiles = -(-N // (p.threads // 4))
        assert p.blocks == min(n_tiles, ops.GEMM_DECODE_BLOCKS_PER_SM *
                               ops.H100_SMS // p.splits) * p.splits
        assert p.blocks >= ops.H100_SMS
        assert p.k_split % ops.GEMM_BK == 0
        assert (p.splits - 1) * p.k_split < K <= p.splits * p.k_split
        rows = 4 if M <= 4 else 8 if M <= 8 else 16
        assert rows * p.k_split <= ops.GEMM_DECODE_X_VALUES


def test_gemm_plan_routes():
    """Tensor cores for prefill (M > 16) while b_m <= 8; beyond that the
    CUDA-core route at any M, in 16-row tiles; K splits cover K once."""
    for M, b_m, mma in ((17, 4, True), (512, 8, True), (512, 9, False),
                        (16, 4, False), (4, 23, False)):
        p = ops.gemm_plan(M, 4864, 896, b_m)
        assert p.mma == mma
        assert (p.splits - 1) * p.k_split < 896 <= p.splits * p.k_split
    p = ops.gemm_plan(512, 896, 4864, b_m=12)
    assert p.blocks % (32 * p.splits) == 0
    assert 16 * p.k_split <= ops.GEMM_DECODE_X_VALUES
    assert ops.gemm_plan(4, 151936, 896, 4).splits == 1


# --------------------------------------------------------------------------
# the flash kernel's design: 3xTF32 products under the same online softmax
# --------------------------------------------------------------------------

def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the f32 bit pattern: keep 10 stored mantissa
    bits, rounding to nearest with ties away from zero (add half of the
    dropped 13 bits to the magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b as csrc/flash_attention.cu computes it: each product of two
    TF32 values is exact in f32 and the sums are f32; terms=3 adds
    lo*hi + hi*lo before hi*hi (3xTF32), terms=1 is plain TF32."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    if terms == 1:
        return a_hi @ b_hi
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _flash_tf32(q, k, v, causal, window, terms=3, block_k=32):
    """The kernel's arithmetic in PyTorch: 32-key tiles, S and P V through
    _mm_tf32, the online softmax in f32 (m, l, rescale) and the reference's
    masks, NEG_INF and denominator clamp. Every tile is processed: the
    kernel's skipped tiles are exact no-ops."""
    B, L, H, D = q.shape
    S, Kv = k.shape[1], k.shape[2]
    rep = H // Kv
    qh = q.permute(0, 2, 1, 3)                                # (B, H, L, D)
    kh = k.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)  # (B, H, S, D)
    vh = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    qp = torch.arange(L)[:, None]
    m = torch.full((B, H, L, 1), attention.NEG_INF)
    l = torch.zeros((B, H, L, 1))
    acc = torch.zeros((B, H, L, D))
    for j0 in range(0, S, block_k):
        kp = torch.arange(j0, min(j0 + block_k, S))[None, :]
        s = _mm_tf32(qh, kh[:, :, j0:j0 + block_k].transpose(-1, -2),
                     terms) * (1.0 / np.sqrt(D))
        ok = torch.ones_like(qp >= kp)
        if causal:
            ok &= qp >= kp
        if window is not None:
            ok &= qp - kp < window
        s = torch.where(ok, s, torch.full_like(s, attention.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm_tf32(p, vh[:, :, j0:j0 + block_k], terms)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).permute(0, 2, 1, 3)


def test_tf32_rna_rounds_ties_away_from_zero():
    """10 stored mantissa bits; a dropped half (bit 12 alone) rounds the
    magnitude up for both signs; the split is exact to 2^-22 relative."""
    one = 1.0 + 2.0 ** -10
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                    one + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23],
                   np.float32)
    got = _tf32_rna(torch.from_numpy(tie)).numpy()
    np.testing.assert_array_equal(got, np.array(
        [one, -one, 1.0 + 2.0 ** -9, 1.0], np.float32))
    x = torch.from_numpy(_rand((4096,), 5))
    hi, lo = _split(x)
    assert torch.equal(_tf32_rna(hi), hi) and torch.equal(_tf32_rna(lo), lo)
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()


@pytest.mark.parametrize("shape,window", [
    ((1, 32, 4, 16, 4), None),    # MHA
    ((2, 24, 8, 16, 2), None),    # GQA 4:1
    ((1, 17, 6, 8, 3), None),     # ragged length, GQA 2:1
    ((1, 20, 4, 8, 2), 8),        # sliding window
    ((1, 128, 14, 64, 2), None),  # qwen2's prefill attention at L = 128
    ((1, 77, 14, 64, 2), 40),     # a window that cuts inside a 32-key tile
    ((2, 1, 14, 64, 14), None),   # L = 1, no GQA
])
def test_flash_3xtf32_design_within_gate(shape, window):
    """The kernel's 3xTF32 products, run through its online softmax, stay
    within the chip gate (rtol = atol = 2e-5) of the plain version."""
    B, L, H, D, Kv = shape
    q = torch.from_numpy(_rand((B, L, H, D), 21, 0.5))
    k = torch.from_numpy(_rand((B, L, Kv, D), 22, 0.5))
    v = torch.from_numpy(_rand((B, L, Kv, D), 23, 0.5))
    want = ref.flash_attention_ref(q, k, v, True, window)
    got = _flash_tf32(q, k, v, True, window)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_flash_plain_tf32_misses_the_gate():
    """Why the kernel splits: one TF32 product per term (10 mantissa bits)
    lands outside rtol = atol = 2e-5 at qwen2's prefill shape."""
    q = torch.from_numpy(_rand((1, 128, 14, 64), 21, 0.5))
    k = torch.from_numpy(_rand((1, 128, 2, 64), 22, 0.5))
    v = torch.from_numpy(_rand((1, 128, 2, 64), 23, 0.5))
    want = ref.flash_attention_ref(q, k, v, True, None)
    got = _flash_tf32(q, k, v, True, None, terms=1)
    assert not torch.allclose(got, want, rtol=2e-5, atol=2e-5)


# --------------------------------------------------------------------------
# the BFP quantizer's routes
# --------------------------------------------------------------------------

def test_bfp_quant_plan_vector_exactly_where_its_conditions_hold():
    """float4 lanes need K % 4 == 0 and 16-byte alignment; a group's lanes
    (g/4, padded to a power of two) must fit one warp: g % 4 == 0, g <= 128."""
    for K in (4, 6, 64, 896, 898, 900, 4864):
        for g in range(1, 300):
            for aligned in (True, False):
                want = (g % 4 == 0 and g <= 128 and K % 4 == 0 and aligned)
                assert (ops.bfp_quant_plan(K, g, aligned) == "vector") == want
    assert ops.bfp_quant_plan(4864, 16) == "vector"
    assert ops.bfp_quant_plan(4864, 256) == "scalar"


# --------------------------------------------------------------------------
# wrappers: CPU tensors take the plain versions and launch nothing
# --------------------------------------------------------------------------

def test_wrappers_on_cpu_take_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    policy = get_policy("mirage")
    x, w = torch.from_numpy(_rand((6, 48), 7)), torch.from_numpy(
        _rand((48, 10), 8))
    assert torch.equal(ops.bfp_fake_quant(x, policy),
                       ref.bfp_fake_quant_ref(x))
    assert torch.equal(ops.mirage_matmul_fused(x, w, policy),
                       ref.mirage_gemm_ref(x, w))
    q = torch.from_numpy(_rand((1, 9, 4, 64), 9))
    kv = torch.from_numpy(_rand((1, 9, 2, 64), 10))
    assert torch.equal(ops.flash_attention(q, kv, kv),
                       ref.flash_attention_ref(q, kv, kv))
    moduli = (31, 32, 33, 37, 41)
    rng = np.random.default_rng(11)
    xr = torch.from_numpy(np.stack([rng.integers(0, m, (2, 3, 16))
                                    for m in moduli]).astype(np.int32))
    wr = torch.from_numpy(np.stack([rng.integers(0, m, (2, 16, 5))
                                    for m in moduli]).astype(np.int32))
    res = ops.rns_group_matmul(xr, wr, moduli)
    assert torch.equal(res, ref.rns_matmul_ref(xr, wr, moduli))
    nz = torch.from_numpy(_rand((5, 2, 3, 5), 12))
    assert torch.equal(ops.rns_group_matmul_channel(xr, wr, moduli, nz, 4),
                       ref.rns_matmul_channel_ref(xr, wr, moduli, nz, 4))
    from repro_torch.analog import rrns
    tables = rrns.get_tables(moduli, 3, 16367)
    for got, want in zip(ops.rrns_decode(res, tables),
                         ref.rrns_decode_ref(res, tables)):
        assert torch.equal(got, want)
    assert ops.LAUNCHES == {"bfp_quantize": 0, "mirage_gemm": 0,
                            "gemm_stream_prep": 0, "flash_attention": 0, "rns_matmul": 0,
                            "rns_matmul_channel": 0, "rrns_decode": 0}


def test_wrappers_refuse_other_devices():
    """No fallback: an operand that is neither all-CPU nor all-CUDA raises."""
    policy = get_policy("mirage")
    meta = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.bfp_fake_quant(meta, policy)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        ops.mirage_matmul_fused(torch.zeros(4, 16), meta.T, policy)


def test_resolve_device_never_falls_back_to_cpu():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device()


def test_port_imports_no_jax():
    """The port imports torch and never jax or the JAX package."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop, repro_torch.kernels.ops\n"
        "import repro_torch.kernels.build, repro_torch.runtime.server\n"
        "import repro_torch.launch.serve, repro_torch.models\n"
        "import repro_torch.analog, repro_torch.analog.device\n"
        "import repro_torch.core.rns, repro_torch.core.noise\n"
        "import repro_torch.core.stationary, repro_torch.obs.health\n"
        "import repro_torch.core.backends.mirage_rns\n"
        "import repro_torch.core.backends.mirage_rrns\n"
        "import repro_torch.optim, repro_torch.data.pipeline\n"
        "import repro_torch.obs.trace, repro_torch.runtime.trainer\n"
        "import repro_torch.launch.train, repro_torch.configs.base\n"
        "import repro_torch.checkpoint, repro_torch.runtime.elastic\n"
        "import repro_torch.analog.sweep, repro_torch.examples.quickstart\n"
        "import repro_torch.examples.mirage_vs_fp32\n"
        "import repro_torch.examples.train_lm, repro_torch.examples.serve_lm\n"
        "import repro_torch.core.backends.mirage_faithful\n"
        "import repro_torch.core.backends.reference\n"
        "import repro_torch.models.moe, repro_torch.configs\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'jaxlib')) or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    import os
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env["PYTHONPATH"] = src
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


# --------------------------------------------------------------------------
# GEMM backends
# --------------------------------------------------------------------------

def test_mirage_fast_backend_matches_jax():
    x, w = _rand((5, 37), 11), _rand((37, 9), 12)
    want = np.asarray(jgemm.mirage_matmul_nograd(jnp.asarray(x),
                                                 jnp.asarray(w),
                                                 jpolicy("mirage")))
    got = gemm.mirage_matmul_nograd(torch.from_numpy(x), torch.from_numpy(w),
                                    get_policy("mirage")).numpy()
    assert np.all(np.abs(got - want) <= _gemm_tol(x, w))


def test_mirage_fast_folded_operands_bitwise():
    from repro.core.backends import mirage_fast as jmf
    from repro_torch.core.backends import mirage_fast as tmf
    x = _rand((4, 50), 13)
    np.testing.assert_array_equal(
        tmf._fold_x(torch.from_numpy(x), get_policy("mirage")).numpy()
        .view(np.int32),
        np.asarray(jmf._fold_x(jnp.asarray(x), jpolicy("mirage")))
        .view(np.int32))


def test_weight_stationary_branch_matches_jax():
    from repro.core import bfp as jbfp
    x, w = _rand((3, 40), 14), _rand((40, 6), 15)
    wq = np.asarray(jbfp.bfp_fake_quant(jnp.asarray(w).T, 4, 16).T)
    want = np.asarray(jgemm.mirage_matmul_nograd(
        jnp.asarray(x), jnp.asarray(wq),
        jpolicy("mirage", assume_quantized_weights=True)))
    got = gemm.mirage_matmul_nograd(
        torch.from_numpy(x), torch.from_numpy(wq.copy()),
        get_policy("mirage", assume_quantized_weights=True)).numpy()
    assert np.all(np.abs(got - want) <= _gemm_tol(x, wq))


@pytest.mark.parametrize("mode", ["fp32", "bf16", "int8"])
def test_baselines_match_jax(mode):
    x, w = _rand((6, 96), 16, 0.5), _rand((96, 10), 17, 0.5)
    want = np.asarray(jgemm.mirage_matmul_nograd(jnp.asarray(x),
                                                 jnp.asarray(w),
                                                 jpolicy(mode)))
    got = gemm.mirage_matmul_nograd(torch.from_numpy(x), torch.from_numpy(w),
                                    get_policy(mode)).numpy()
    tol = {"fp32": 1e-5, "bf16": 1e-5, "int8": 1e-4}[mode]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if mode == "fp32":
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("mode", ["mirage_faithful", "mirage_faithful_ref",
                                  "mirage_rns_ref"])
def test_unported_modes_validate_but_do_not_resolve(mode):
    """The last three modes of the JAX package are ported: each validates
    and resolves to a backend with the JAX backend's capability flags."""
    from repro.core import backends as jbackends
    policy = get_policy(mode)
    got, want = backends.resolve(policy), jbackends.resolve(jpolicy(mode))
    for flag in ("quantized", "supports_weight_stationary",
                 "weight_stationary_aligned_only", "supports_noise",
                 "supports_stationary_residues", "reference"):
        assert getattr(got, flag) == getattr(want, flag), flag
    assert set(backends.available_backends()) == \
        set(jbackends.available_backends())
    assert backends.resolve(get_policy("mirage")).supports_weight_stationary


# --------------------------------------------------------------------------
# on the card: each kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_bfp_kernel_bitexact(cuda):
    """Both routes, bit for bit: the vector route at every power-of-two g
    up to 128 (dense rows, a partial last group, idle lanes at g = 12), the
    scalar route at g = 256, K % 4 != 0 and a misaligned view."""
    rng = np.random.default_rng(1)
    flat = torch.from_numpy((rng.normal(size=33 * 900 + 1) *
                             1e3).astype(np.float32)).to(cuda)
    cases = [(flat[:33 * 200].view(33, 200), 16, "vector")]
    cases += [(flat[:33 * 896].view(33, 896), g, "vector")
              for g in (4, 8, 32, 64, 128)]
    cases += [(flat[:33 * 900].view(33, 900), 16, "vector"),
              (flat[:33 * 900].view(33, 900), 12, "vector"),
              (flat[:33 * 896].view(33, 896), 256, "scalar"),
              (flat[:33 * 898].view(33, 898), 16, "scalar"),
              (flat[1:1 + 33 * 896].view(33, 896), 16, "scalar")]
    for x, g, route in cases:
        aligned = x.data_ptr() % 16 == 0
        assert ops.bfp_quant_plan(x.shape[1], g, aligned) == route
        for rounding in ("nearest", "truncate"):
            policy = get_policy("mirage", rounding=rounding, g=g, k=8)
            got = ops.bfp_fake_quant(x, policy)
            want = ref.bfp_fake_quant_ref(x, 4, g, rounding)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 896, 896), (37, 200, 70),
                                   (4, 4864, 896), (512, 896, 4864)])
def test_cuda_gemm_kernel_vs_plain(cuda, shape):
    m, k, n = shape
    x, w = _rand((m, k), 1), _rand((k, n), 2)
    got = ops.mirage_matmul_fused(torch.from_numpy(x).to(cuda),
                                  torch.from_numpy(w).to(cuda),
                                  get_policy("mirage")).cpu().numpy()
    want = ref.mirage_gemm_ref(torch.from_numpy(x), torch.from_numpy(w))
    assert np.all(np.abs(got - want.numpy()) <= _gemm_tol(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("g,b_m,rounding", [(1, 4, "nearest"),
                                            (8, 2, "truncate"),
                                            (32, 8, "nearest"),
                                            (64, 4, "truncate")])
@pytest.mark.parametrize("shape", [(3, 198, 70), (40, 200, 72)])
def test_cuda_gemm_kernel_group_sizes(cuda, shape, g, b_m, rounding):
    """Groups inside a thread, across lanes and across registers, at both
    routes, on ragged K and N (4-byte copies)."""
    m, k, n = shape
    x, w = _rand((m, k), 3), _rand((k, n), 4)
    policy = get_policy("mirage", b_m=b_m, g=g, rounding=rounding, k=8)
    got = ops.mirage_matmul_fused(torch.from_numpy(x).to(cuda),
                                  torch.from_numpy(w).to(cuda),
                                  policy).cpu().numpy()
    want = ref.mirage_gemm_ref(torch.from_numpy(x), torch.from_numpy(w), b_m,
                               g, rounding)
    xq = ref.bfp_fake_quant_ref(torch.tensor(x), b_m, g, rounding)
    wq = ref.bfp_fake_quant_ref(torch.tensor(w).T, b_m, g, rounding).T
    tol = (1e-5 * (xq.abs().double() @ wq.abs().double()) + 1e-30).numpy()
    assert np.all(np.abs(got - want.numpy()) <= tol)


@pytest.mark.cuda
def test_cuda_flash_kernel_vs_plain(cuda):
    """The path's prefill shapes, L = 1, a partial 16-row warp tile
    (L = 17), no GQA, and windows that cut inside a 32-key tile."""
    cases = [((2, 70, 14, 2), None), ((2, 70, 14, 2), 16),
             ((1, 32, 14, 2), None), ((2, 64, 14, 2), None),
             ((4, 64, 14, 2), None), ((2, 1, 14, 2), None),
             ((2, 17, 14, 2), None), ((2, 77, 14, 14), None),
             ((2, 128, 14, 2), 40), ((1, 100, 8, 2), 7)]
    for i, ((B, L, H, Kv), window) in enumerate(cases):
        q = torch.from_numpy(_rand((B, L, H, 64), 3 * i + 1, 0.5)).to(cuda)
        k = torch.from_numpy(_rand((B, L, Kv, 64), 3 * i + 2, 0.5)).to(cuda)
        v = torch.from_numpy(_rand((B, L, Kv, 64), 3 * i + 3, 0.5)).to(cuda)
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, True, window),
            ref.flash_attention_ref(q, k, v, True, window),
            rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_cuda_flash_kernel_noncausal_vs_plain(cuda):
    """Bidirectional attention: the enc-dec encoder's (B 4, L 1,024, 16 /
    16 heads, D 64) and ragged and GQA cases, twice bitwise."""
    cases = ((4, 1024, 16, 16), (2, 77, 14, 2), (1, 33, 4, 4))
    for i, (B, L, H, Kv) in enumerate(cases):
        q = torch.from_numpy(_rand((B, L, H, 64), 3 * i + 40, 0.5)).to(cuda)
        k = torch.from_numpy(_rand((B, L, Kv, 64), 3 * i + 41, 0.5)).to(cuda)
        v = torch.from_numpy(_rand((B, L, Kv, 64), 3 * i + 42, 0.5)).to(cuda)
        got = ops.flash_attention(q, k, v, causal=False)
        torch.testing.assert_close(
            got, ref.flash_attention_ref(q, k, v, causal=False),
            rtol=2e-5, atol=2e-5)
        assert torch.equal(got, ops.flash_attention(q, k, v, causal=False))


#: the SNR guardian's r = 4 rung: the base moduli and four redundant ones
#: (35 subsets of 3), which no serving path used before slice 7
RRNS_R4 = (31, 32, 33, 37, 41, 43, 47)


def _residues_r4(shape, gen, device):
    return torch.stack([torch.randint(0, m, shape, generator=gen,
                                      device=device, dtype=torch.int32)
                        for m in RRNS_R4])


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(4, 896, 4864), (4, 4864, 896),
                                   (64, 896, 896), (4, 896, 151936)])
def test_cuda_rns_matmul_n_mod_7_vs_plain(cuda, M, K, N):
    """Kernel 4 over the r = 4 moduli at qwen2-0.5b's decode and prefill
    GEMM shapes, bit for bit against its plain version."""
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    G = K // 16
    xr = _residues_r4((G, M, 16), gen, cuda)
    wr = _residues_r4((G, 16, N), gen, cuda)
    assert torch.equal(ops.rns_group_matmul(xr, wr, RRNS_R4),
                       ref.rns_matmul_ref(xr, wr, RRNS_R4))


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["legal_with_errors", "random_tuples"])
def test_cuda_rrns_decode_n_mod_7_vs_plain(cuda, inputs):
    """Kernel 6 over the r = 4 tables: decoded values and votes bit for bit
    against its plain version, on legal values with 0, 1 or 2 residue
    errors at random channels (r = 4 corrects two: each decodes to its
    value) and on random residue tuples (every element runs all 35
    subsets)."""
    from repro_torch.analog import rrns

    psi = (31 * 32 * 33 - 1) // 2
    tables = rrns.get_tables(RRNS_R4, 3, psi)
    assert tables.f32_exact and tables.n_subsets == 35
    gen = torch.Generator(device=cuda).manual_seed(27)
    E = 1_000_003
    if inputs == "random_tuples":
        res = _residues_r4((E,), gen, cuda)
    else:
        xs = torch.randint(-psi, psi + 1, (E,), generator=gen, device=cuda)
        n_err = torch.arange(E, device=cuda) % 3
        first = torch.randint(0, 7, (E,), generator=gen, device=cuda)
        second = (first + torch.randint(1, 7, (E,), generator=gen,
                                        device=cuda)) % 7
        rows = []
        for i, m in enumerate(RRNS_R4):
            hit = ((n_err >= 1) & (first == i)) | \
                ((n_err == 2) & (second == i))
            delta = torch.randint(1, m, (E,), generator=gen, device=cuda)
            rows.append(torch.remainder(xs + torch.where(hit, delta, 0), m))
        res = torch.stack(rows).to(torch.int32).contiguous()
    dec, votes = ops.rrns_decode(res, tables)
    want_dec, want_votes = ref.rrns_decode_ref(res, tables)
    assert torch.equal(dec, want_dec)
    assert torch.equal(votes.view(torch.int32), want_votes.view(torch.int32))
    if inputs == "legal_with_errors":
        assert torch.equal(dec, xs.to(torch.int32))
