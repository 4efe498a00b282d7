"""PyTorch port: BFP quantization and precision policies vs the JAX package.

The same numpy-seeded inputs go through ``repro.core.bfp`` and
``repro_torch.core.bfp``; results must agree bit for bit (int32 views).
XLA on the CPU flushes subnormal inputs to zero while PyTorch keeps IEEE
gradual underflow, so the JAX-parity inputs place subnormals where the
result cannot depend on flushing, and the groups whose max is subnormal are
held against an exact float64 numpy oracle instead.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.core import bfp as jbfp
from repro.core import precision as jprec
from repro_torch.core import bfp as tbfp
from repro_torch.core import precision as tprec

SHAPES = [(64, 200), (7, 33), (128, 1024)]


def _inputs(shape, seed):
    """Magnitudes over 1e-8..1e8, both signs, zero groups, and subnormal
    elements inside groups whose max is normal (far above 2^-100, so every
    subnormal quantizes to +-0 whether or not it is flushed)."""
    rng = np.random.default_rng(seed)
    x = (rng.choice([-1.0, 1.0], size=shape) *
         10.0 ** rng.uniform(-8, 8, size=shape)).astype(np.float32)
    rows, k = shape
    if k >= 32:
        x[::3, 16:32] = 0.0                       # zero groups
        x[1::4, 5] = np.float32(3e-39)            # subnormal elements
        x[2::5, 7] = np.float32(-1e-44)
    return x


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _assert_bitwise(got, want):
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bfp_quantize_and_dequantize_bitwise(shape, rounding):
    x = _inputs(shape, seed=sum(shape))
    jt = jbfp.bfp_quantize(jnp.asarray(x), 4, 16, rounding)
    tt = tbfp.bfp_quantize(torch.from_numpy(x), 4, 16, rounding)
    _assert_bitwise(tt.mantissa, jt.mantissa)
    _assert_bitwise(tt.scale, jt.scale)
    assert tt.orig_k == jt.orig_k
    _assert_bitwise(tbfp.bfp_dequantize(tt), jbfp.bfp_dequantize(jt))
    _assert_bitwise(tbfp.bfp_fake_quant(torch.from_numpy(x), 4, 16, rounding),
                    jbfp.bfp_fake_quant(jnp.asarray(x), 4, 16, rounding))


@pytest.mark.parametrize("rounding", ["nearest", "truncate"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bfp_quantize_contract_bitwise(shape, rounding):
    w = _inputs(shape, seed=7 + sum(shape)).T.copy()     # (K, N), K = shape[1]
    jq, js = jbfp.bfp_quantize_contract(jnp.asarray(w), 4, 16, rounding)
    tq, ts = tbfp.bfp_quantize_contract(torch.from_numpy(w), 4, 16, rounding)
    _assert_bitwise(tq, jq)
    _assert_bitwise(ts, js)


@pytest.mark.parametrize("b_m,g", [(3, 8), (5, 16), (6, 32)])
def test_bfp_other_operating_points_bitwise(b_m, g):
    x = _inputs((16, 96), seed=b_m * g)
    _assert_bitwise(tbfp.bfp_fake_quant(torch.from_numpy(x), b_m, g),
                    jbfp.bfp_fake_quant(jnp.asarray(x), b_m, g))


def _ieee_fake_quant(x, b_m, g):
    """Exact IEEE oracle of BFP fake quantization for one row of whole
    groups: float64 holds every intermediate of the f32 computation
    exactly, numpy rounds half to even."""
    xg = x.astype(np.float64).reshape(-1, g)
    mx = np.abs(xg).max(axis=1, keepdims=True)
    e = np.floor(np.log2(np.maximum(mx, np.finfo(np.float32).tiny)))
    e = np.where(mx > 0, e, 0)
    scale = 2.0 ** np.clip(e - (b_m - 1), -126, 127)
    q = np.clip(np.round(xg / scale), -(2**b_m - 1), 2**b_m - 1)
    return (q * scale).astype(np.float32).reshape(x.shape)


def test_bfp_subnormal_group_max_follows_ieee():
    """Groups whose max is subnormal take the smallest-normal clamp and keep
    gradual underflow (the card's behaviour without fast math)."""
    rng = np.random.default_rng(3)
    x = (rng.choice([-1.0, 1.0], (4, 32)) *
         rng.uniform(1e-45, 1.17e-38, (4, 32))).astype(np.float32)
    x[0, :16] = np.float32(1.1e-38)     # rounds to the smallest normal
    got = tbfp.bfp_fake_quant(torch.from_numpy(x), 4, 16).numpy()
    want = np.stack([_ieee_fake_quant(r, 4, 16) for r in x])
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert got[0, 0] == np.finfo(np.float32).tiny


def test_stochastic_rounding_takes_injected_uniform():
    x = torch.from_numpy(_inputs((8, 48), seed=5))
    with pytest.raises(ValueError, match="uniform"):
        tbfp.bfp_quantize(x, 4, 16, "stochastic")
    u = torch.from_numpy(np.random.default_rng(6).uniform(
        size=(8, 3, 16)).astype(np.float32))
    t = tbfp.bfp_quantize(x, 4, 16, "stochastic", uniform=u)
    near = tbfp.bfp_quantize(x, 4, 16, "nearest")
    v = x.reshape(8, 3, 16) / t.scale
    np.testing.assert_array_equal(
        t.mantissa.numpy(), torch.clamp(torch.floor(v + u), -15, 15).numpy())
    assert torch.equal(t.scale, near.scale)


# --------------------------------------------------------------------------
# precision policies
# --------------------------------------------------------------------------

_TPU_ONLY = {"use_pallas", "interpret"}


def _fields(p, skip=()):
    return {f: getattr(p, f) for f in p.__dataclass_fields__ if f not in skip}


@pytest.mark.parametrize("name", list(jprec.GEMM_MODES) + ["mirage"])
def test_get_policy_parity(name):
    jp, tp = jprec.get_policy(name), tprec.get_policy(name)
    assert _fields(tp) == _fields(jp, _TPU_ONLY)
    assert (tp.moduli, tp.rns_M, tp.psi, tp.mantissa_max,
            tp.converter_bits) == (jp.moduli, jp.rns_M, jp.psi,
                                   jp.mantissa_max, jp.converter_bits)
    assert tprec.GEMM_MODES == jprec.GEMM_MODES
    assert set(jp.__dataclass_fields__) - set(tp.__dataclass_fields__) \
        == _TPU_ONLY


def _raises(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("b_m", [2, 4, 6, 8])
@pytest.mark.parametrize("g", [8, 16, 64])
@pytest.mark.parametrize("k", [3, 5, 7])
def test_eq10_overflow_validation_parity(b_m, g, k):
    """Eq. 10: both packages accept and refuse the same (b_m, g, k)."""
    mk_j = lambda: jprec.MiragePolicy(mode="mirage_fast", b_m=b_m, g=g, k=k)
    mk_t = lambda: tprec.MiragePolicy(mode="mirage_fast", b_m=b_m, g=g, k=k)
    assert _raises(mk_t) == _raises(mk_j)
    assert tprec.required_output_bits(b_m, g) == \
        jprec.required_output_bits(b_m, g)


def test_policy_rejects_unknown_mode_and_rounding():
    with pytest.raises(ValueError):
        tprec.MiragePolicy(mode="nope")
    with pytest.raises(ValueError):
        tprec.MiragePolicy(rounding="up")
    with pytest.raises(ValueError):
        tprec.special_moduli(1)
