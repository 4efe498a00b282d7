"""PyTorch port, slice 6d: command-r's parallel block against the JAX package.

Reduced command-r-plus-104b (4 layers, d_model 64, 4 / 2 heads, rope theta
7.5e7, untied head) takes the JAX init's weights (its never-read ``ln2``
included) in both packages. Its layers are parallel blocks: attention and
the MLP both read ``ln1(h)`` and the layer returns ``h + a + m``.

- Forward logits and the loss's value and gradients against JAX, under
  ``fp32`` (rtol = atol = 1e-5: the frameworks sum in other orders) and
  ``mirage`` (1e-4, the same after a BFP quantization whose folded products
  are exact), with and without ``merge_parallel_proj``; the merged forward
  against the unmerged one within 2e-4, the gate
  ``tests/test_merge_parallel.py`` holds JAX to.
- The workload of ``tests/test_spec_prefix.py:59`` under ``mirage``
  through the port's dense (cold and warmed), paged, chunked,
  speculative and per-slot engines, and an engine of a merged model:
  each emits the JAX dense engine's greedy streams token for token.
- ``mirage_rrns`` at 60 dB (every RRNS decode exact, stationary weights):
  the port's dense engine emits the JAX engine's streams.
- The published GQA group of 12 (96 query heads over 8 kv heads), on the
  reduced widths as 12 heads over 1: forward logits, and the dense,
  chunked and speculative engines (the plain, chunked, decode, paged and
  verify attention paths) against the JAX engine.
- The launchers with ``--arch command-r-plus-104b``.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime.server import LMServer as JServer
from repro.runtime.server import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import get_policy
from repro_torch.interop import _by_name, load_jax_params
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.server import LMServer, PerSlotLMServer, Request

ARCH = "command-r-plus-104b"
TOL = {"fp32": 1e-5, "mirage": 1e-4}
MERGE_TOL = 2e-4
ENGINE = dict(cap=24, batch_slots=2)
ENGINES = {
    "dense": {},
    "dense_warmed": {},
    "paged": dict(cache_layout="paged", block_size=4),
    "paged_chunk": dict(cache_layout="paged", block_size=4, prefill_chunk=4),
    "spec": dict(cache_layout="paged", block_size=4, spec_k=2),
    "oracle": None,
    "merged_model": {},
}


def _shared(cls, n=4, prefix_len=8, total_len=12, max_tokens=4, seed=3,
            vocab=256):
    """``tests/test_spec_prefix.py``'s ``_shared_requests``."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, total_len - prefix_len).astype(np.int32)
        out.append(cls(rid=i, prompt=np.concatenate([prefix, tail]),
                       max_tokens=max_tokens))
    return out


def _drain(server, reqs):
    for r in reqs:
        server.submit(r)
    out = {r.rid: r.tokens_out for r in server.run_until_drained()}
    if getattr(server, "alloc", None) is not None:
        server.alloc.check_invariants()
        assert server.alloc.used_count == 0
    return out


def _pair(policy, merge=False, cfg=None, **overrides):
    jcfg = jconfig(ARCH).reduced() if cfg is None else cfg
    jm = jbuild(jcfg, jpolicy(policy, **overrides),
                JOptions(q_chunk=16, kv_chunk=16, merge_parallel_proj=merge))
    params = jm.init(jax.random.PRNGKey(0))
    fields = {f: getattr(jcfg, f) for f in ModelConfig.__dataclass_fields__}
    tm = build_model(ModelConfig(**fields),
                     get_policy(policy, **overrides),
                     LMCallOptions(q_chunk=16, kv_chunk=16,
                                   merge_parallel_proj=merge), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _batch(seed=0, B=2, L=12):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 256, (B, L)).astype(np.int32),
            "labels": rng.integers(0, 256, (B, L)).astype(np.int32)}


@pytest.mark.parametrize("merge", [False, True])
@pytest.mark.parametrize("policy", ["fp32", "mirage"])
def test_forward_loss_and_grads_equal_jax(policy, merge):
    jm, params, tm = _pair(policy, merge)
    assert tm.parallel and tm.opt.merge_parallel_proj == merge
    batch = _batch()
    jl = jax.jit(lambda p, t: jm.forward(p, t)[0])(params, batch["tokens"])
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tl = tm.forward(tb["tokens"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               rtol=TOL[policy], atol=TOL[policy])
    loss, _ = tm.loss(tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=TOL[policy])
    names = [n for n, _ in tm.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in tm.named_parameters()],
                                allow_unused=True)
    want = _by_name(tm, jax.tree_util.tree_map(np.asarray, jg))
    for name, g in zip(names, grads):
        got = np.zeros_like(want[name]) if g is None else g.numpy()
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(got / scale, want[name] / scale,
                                   atol=TOL[policy], err_msg=name)
        if name.endswith("ln2.scale"):
            # initialised (the trees match) and never read
            assert not got.any() and not want[name].any(), name


@pytest.mark.parametrize("policy", ["fp32", "mirage"])
def test_merged_projection_equals_unmerged(policy):
    """One GEMM over ``[a ; silu(gate) * up]`` against ``[w_o ; w_down]``
    is the two projections' sum, in another order of f32 sums."""
    _, _, plain = _pair(policy)
    _, _, merged = _pair(policy, merge=True)
    toks = torch.from_numpy(_batch(seed=1)["tokens"])
    with torch.no_grad():
        a, b = plain.forward(toks), merged.forward(toks)
    rel = float(torch.linalg.norm(a - b) / torch.linalg.norm(a))
    assert rel < MERGE_TOL, rel


@pytest.fixture(scope="module")
def served():
    jm, params, tm = _pair("mirage")
    want = _drain(JServer(jm, params, **ENGINE), _shared(JRequest))
    return want, tm


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_equal_jax_engine(served, engine):
    want, tm = served
    assert len(want) == 4 and all(len(t) == 4 for t in want.values())
    if engine == "oracle":
        server = PerSlotLMServer(tm, **ENGINE)
    elif engine == "merged_model":
        _, _, merged = _pair("mirage", merge=True)
        server = LMServer(merged, **ENGINE)
    else:
        server = LMServer(tm, **ENGINE, **ENGINES[engine])
        if engine == "dense_warmed":
            server.warmup()
    assert _drain(server, _shared(Request)) == want, engine


def test_rrns_60db_engine_equals_jax_engine():
    """At 60 dB every RRNS decode corrects exactly, so the streams do not
    depend on the noise drawn (the port's numbers differ from JAX's)."""
    kw = dict(snr_db=60.0, noise_seed=7)
    jm, params, tm = _pair("mirage_rrns", **kw)
    reqs = lambda cls: _shared(cls, n=2, seed=5)
    want = _drain(JServer(jm, params, **ENGINE), reqs(JRequest))
    server = LMServer(tm, **ENGINE)
    assert server.stationary_weights
    assert _drain(server, reqs(Request)) == want and len(want) == 2
    assert server.health_snapshot()["rrns_uncorrected"] == 0
    # the merged projection concatenates raw weights: no programming
    _, _, merged = _pair("mirage_rrns", merge=True, **kw)
    assert not LMServer(merged, **ENGINE).stationary_weights


def test_gqa_group_of_12_equals_jax():
    """12 query heads over 1 kv head (the published group, 96 / 8)."""
    cfg = dataclasses.replace(jconfig(ARCH).reduced(), n_heads=12,
                              n_kv_heads=1)
    assert get_config(ARCH).n_heads // get_config(ARCH).n_kv_heads == 12
    jm, params, tm = _pair("mirage", cfg=cfg)
    toks = _batch(seed=2)["tokens"]
    jl = jax.jit(lambda p, t: jm.forward(p, t)[0])(params, toks)
    with torch.no_grad():
        tl = tm.forward(torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    want = _drain(JServer(jm, params, **ENGINE), _shared(JRequest))
    for kw in ({}, ENGINES["paged_chunk"], ENGINES["spec"]):
        got = _drain(LMServer(tm, **ENGINE, **kw), _shared(Request))
        assert got == want, kw


def test_launchers_take_the_arch(capsys):
    assert serve.main(["--arch", ARCH, "--reduced", "--layers", "2",
                       "--device", "cpu", "--requests", "2",
                       "--max-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert f"[{ARCH} d_model=64 layers=2" in out
    assert train.main(["--arch", ARCH, "--reduced", "--layers", "2",
                       "--device", "cpu", "--steps", "2"]) == 0
    assert "trained 2 steps" in capsys.readouterr().out
