"""PyTorch port: the dense LM vs the JAX package's, on the same parameters.

Reduced qwen2-0.5b is initialised by the JAX model (``PRNGKey(0)``) and
carried into the port with ``load_jax_params``; both then run the same
numpy-seeded tokens. Tolerances: rtol = atol = 1e-5 under ``fp32`` (the two
frameworks sum in other orders) and 1e-4 under ``mirage`` (the same, after a
BFP quantization whose folded products are exact).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params
from repro_torch.models import build_model
from repro_torch.models import lm as tlm
from repro_torch.models.lm import LMCallOptions

TOL = {"fp32": 1e-5, "mirage": 1e-4}


def _pair(policy, kv_repeat=1, arch="qwen2-0.5b"):
    cfg = jconfig(arch).reduced()
    jm = jbuild(cfg, jpolicy(policy),
                JOptions(q_chunk=16, kv_chunk=16, kv_repeat=kv_repeat))
    params = jm.init(jax.random.PRNGKey(0))
    fields = {f: getattr(cfg, f) for f in ModelConfig.__dataclass_fields__}
    tm = build_model(ModelConfig(**fields), get_policy(policy),
                     LMCallOptions(q_chunk=16, kv_chunk=16,
                                   kv_repeat=kv_repeat), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module", params=["fp32", "mirage"])
def pair(request):
    return request.param, _pair(request.param)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.int32)


def _close(got, want, policy):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=TOL[policy], atol=TOL[policy])


def test_forward_matches_jax(pair):
    policy, (jm, params, tm) = pair
    toks = _tokens((2, 19))
    want, _, _ = jax.jit(jm.forward)(params, jnp.asarray(toks))
    with torch.inference_mode():
        got = tm(torch.from_numpy(toks))
    _close(got.numpy(), want, policy)


def test_prefill_and_decode_match_jax(pair):
    """Right-padded batched prefill (per-row lens) -> logits at the last
    real token and the KV cache, then 4 per-slot decode steps."""
    policy, (jm, params, tm) = pair
    toks = _tokens((3, 12), seed=1)
    lens = np.array([12, 7, 9], np.int32)
    # jitted JAX references: one XLA compile each instead of eager ops
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        params, jnp.asarray(toks), 24, lens=jnp.asarray(lens))
    jdecode = jax.jit(jm.decode_step)
    with torch.inference_mode():
        tl, tc = tm.prefill(torch.from_numpy(toks), 24,
                            lens=torch.from_numpy(lens))
    _close(tl.numpy(), jl, policy)
    for leaf in ("k", "v"):
        _close(tc[leaf].numpy(), jc[leaf], policy)
    np.testing.assert_array_equal(tc["idx"].numpy(), np.asarray(jc["idx"]))

    tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    for _ in range(4):
        jl, jc = jdecode(params, jc, jnp.asarray(tok))
        with torch.inference_mode():
            tl, tc = tm.decode_step(tc, torch.from_numpy(tok))
        _close(tl.numpy(), jl, policy)
        for leaf in ("k", "v"):
            _close(tc[leaf].numpy(), jc[leaf], policy)
        np.testing.assert_array_equal(tc["idx"].numpy(),
                                      np.asarray(jc["idx"]))
        tok = np.array(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]


def test_scalar_idx_prefill_and_decode_match_jax(pair):
    """Unpadded prefill keeps one scalar position for the whole batch."""
    policy, (jm, params, tm) = pair
    toks = _tokens((2, 10), seed=2)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        params, jnp.asarray(toks), 16)
    with torch.inference_mode():
        tl, tc = tm.prefill(torch.from_numpy(toks), 16)
    assert tc["idx"].dim() == 0 and int(tc["idx"]) == 10
    tok = np.array([[5], [9]], np.int32)
    jl, jc = jax.jit(jm.decode_step)(params, jc, jnp.asarray(tok))
    with torch.inference_mode():
        tl, tc = tm.decode_step(tc, torch.from_numpy(tok))
    _close(tl.numpy(), jl, policy)
    _close(tc["k"].numpy(), jc["k"], policy)


def test_qk_norm_and_kv_repeat_match_jax():
    """qwen3's dense config adds per-head qk-norm (head_rmsnorm); kv heads
    repeated twice (exact duplication)."""
    jm, params, tm = _pair("mirage", kv_repeat=2, arch="qwen3-14b")
    assert tm.layers[0].attn.q_norm is not None
    toks = _tokens((1, 9), seed=3)
    jl, jc = jax.jit(jm.prefill, static_argnums=2)(
        params, jnp.asarray(toks), 12)
    with torch.inference_mode():
        tl, tc = tm.prefill(torch.from_numpy(toks), 12)
    _close(tl.numpy(), jl, "mirage")
    assert tc["k"].shape == jc["k"].shape


def test_cache_insert_drops_out_of_bounds_rows():
    cfg = get_config("qwen2-0.5b").reduced()
    tm = build_model(cfg, get_policy("fp32"), device="cpu")
    live = tm.init_cache(4, 24, per_slot_idx=True)
    rng = np.random.default_rng(0)
    new = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
           for k, v in tm.init_cache(2, 24, per_slot_idx=True).items()}
    new["idx"] = torch.tensor([3, 7], dtype=torch.int32)
    # row 0 -> the out-of-bounds sentinel slot 4 (dropped), row 1 -> slot 1
    tlm.cache_insert(live, new, torch.tensor([4, 1]))
    assert torch.equal(live["k"][:, 1], new["k"][:, 1])
    assert live["idx"].tolist() == [0, 7, 0, 0]
    assert float(live["k"][:, [0, 2, 3]].abs().sum()) == 0.0


def test_load_jax_params_rejects_mismatched_trees():
    jm, params, tm = _pair("fp32")
    tree = jax.tree_util.tree_map(np.asarray, params)
    bad = dict(tree, final_norm={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="final_norm.scale"):
        load_jax_params(tm, bad)
    partial = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="does not cover"):
        load_jax_params(tm, partial)


def test_reduced_seamless_builds_and_equals_jax_prefill():
    """The enc-dec family is ported (it was the last case of the
    unported-families test): the reduced seamless-m4t-large-v2 builds from
    the port's own config as an ``EncDec``, and on the JAX init's weights
    its prefill logits equal JAX's within 1e-5."""
    from repro_torch.models import EncDec

    cfg = jconfig("seamless-m4t-large-v2").reduced()
    jm = jbuild(cfg, jpolicy("fp32"))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("seamless-m4t-large-v2").reduced(),
                     get_policy("fp32"), device="cpu")
    assert isinstance(tm, EncDec)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(2, 12, cfg.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, 256, (2, 9)).astype(np.int32)
    want, _ = jax.jit(lambda p, f, t: jm.prefill(p, f, t, 16))(
        params, frames, toks)
    with torch.no_grad():
        got, _ = tm.prefill(torch.from_numpy(frames), torch.from_numpy(toks),
                            16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_reduced_mamba2_builds_and_equals_jax_forward():
    """The SSM family is ported (it was a case of the test above): the
    reduced mamba2 builds from the port's own config and, on the JAX
    init's weights, its forward logits equal JAX's within 1e-5."""
    cfg = jconfig("mamba2-2.7b").reduced()
    jm = jbuild(cfg, jpolicy("fp32"))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("mamba2-2.7b").reduced(), get_policy("fp32"),
                     device="cpu")
    assert tm.kind == "mamba" and tm.lm_head is not None
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    toks = np.random.default_rng(0).integers(0, 256, (2, 20)).astype(
        np.int32)
    want = jax.jit(lambda p, t: jm.forward(p, t)[0])(params, toks)
    with torch.no_grad():
        got = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_reduced_zamba2_builds_and_equals_jax_forward():
    """The hybrid family is ported (it was a case of the unported-families
    test): the reduced zamba2 builds from the port's own config, with its
    shared block applied after layers 1 and 3, and on the JAX init's
    weights its forward logits equal JAX's within 1e-5."""
    cfg = jconfig("zamba2-2.7b").reduced()
    jm = jbuild(cfg, jpolicy("fp32"))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("zamba2-2.7b").reduced(),
                     get_policy("fp32"), device="cpu")
    assert tm.kind == "mamba" and tm.shared is not None and tm.napp == 2
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    toks = np.random.default_rng(0).integers(0, 256, (2, 20)).astype(
        np.int32)
    want = jax.jit(lambda p, t: jm.forward(p, t)[0])(params, toks)
    with torch.no_grad():
        got = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_config_matches_jax():
    """Every config of the JAX package, ported field by field, and its
    ``reduced()``: the dense qwen2/qwen3 ones, command-r, the vlm, the MoE
    family, mamba2, zamba2 and seamless-m4t."""
    from repro.configs import ARCHS as JARCHS
    from repro_torch.configs import ARCHS
    assert set(ARCHS) == set(JARCHS) == {
        "qwen2-0.5b", "qwen2-1.5b", "qwen3-14b", "command-r-plus-104b",
        "internvl2-2b", "mixtral-8x7b", "qwen3-moe-30b-a3b", "mamba2-2.7b",
        "zamba2-2.7b", "seamless-m4t-large-v2"}
    for arch in ARCHS:
        a, b = jconfig(arch), get_config(arch)
        for f in ModelConfig.__dataclass_fields__:
            assert getattr(a, f) == getattr(b, f), (arch, f)
            assert getattr(a.reduced(), f) == getattr(b.reduced(), f), \
                (arch, f)


@pytest.mark.parametrize("kv_repeat", [1, 2])
def test_paged_init_cache_shapes_equal_jax_cache_spec(kv_repeat):
    """The paged pools, table and idx have JAX's ``cache_spec`` shapes
    (kv heads repeated as the options say); unmapped entries hold the
    sentinel, the pool size."""
    jm, _, tm = _pair("fp32", kv_repeat=kv_repeat)
    want = jm.cache_spec(2, 16, per_slot_idx=True, layout="paged",
                         block_size=4, n_blocks=6)
    cache = tm.init_cache(2, 16, layout="paged", block_size=4, n_blocks=6)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: tuple(s) for k, (s, _) in want.items()}
    assert bool((cache["bt"] == 6).all()) and not cache["kp"].any()
