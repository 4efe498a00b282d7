"""PyTorch port, slice 6f: the serving engine over the hybrid family
(zamba2-2.7b) against the JAX engine.

Reduced zamba2-2.7b (4 Mamba2 layers, d_model 64, chunk 16, the shared
attention + MLP block after layers 1 and 3: 2 applications, GQA 4/2 at
head_dim 16) with the JAX init's weights in both packages. Four requests
share a 16-token prefix and are 17 or 20 tokens long, 5 tokens each, on 2
slots. The JAX engine's rules for the hybrid hold in the port: a page pool
and its ``BlockAllocator`` under ``cache_layout="paged"`` (the shared
block's KV is paged; the ``ssm``/``conv`` state stays dense), the prefix
flag inert with the pool still built, prefill batched by EXACT prompt
length, exact-length final chunks, inactive slots' ``ssm``/``conv`` frozen
in the tick, the speculative verify rolling back ``ssm``/``conv`` only, and
stationary weights on by default.

- Under ``mirage``: the dense (cold and warmed), paged, chunked (chunk
  16: final chunks of 1 and 4 tokens), prefix-flagged, speculative
  (``spec_k=2``), pipelined, resized (2 -> 3 -> 2 slots mid-drain, dense
  and paged, the paged pool resized too) and per-slot engines each emit
  the JAX dense engine's greedy streams token for token;
  ``switch_backend`` ``mirage`` -> ``mirage_rns`` -> ``mirage`` at ticks 2
  and 4 the JAX engine's making the same switches.
- Under ``mirage_rns`` (dense) and ``mirage_rrns`` (paged, clean
  channel): the streams and the health integers of the JAX dense engine
  under the same policy. At 52 dB the port's engine emits the clean
  streams with no uncorrected decode. That neither package counts the
  shared block's GEMMs in the health integers is held in
  ``tests/test_torch_zamba2.py`` (a clean channel counts no event either
  way).
"""

import numpy as np
import jax
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.runtime.server import LMServer as JServer
from repro.runtime.server import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params
from repro_torch.models import build_model
from repro_torch.runtime.server import LMServer, PerSlotLMServer, Request

ARCH = "zamba2-2.7b"
ENGINE = dict(cap=32, batch_slots=2)
PAGED = dict(cache_layout="paged", block_size=4)
ENGINES = {
    "dense": {},
    "dense_warmed": {},
    "paged": PAGED,
    "paged_chunk": dict(PAGED, prefill_chunk=16),
    "prefix": dict(PAGED, prefix_cache=True),
    "spec": dict(PAGED, spec_k=2),
    "pipelined": dict(pipeline_depth=1),
    "resized": {},
    "resized_paged": PAGED,
    "oracle": None,
}
DENSE_LEAVES = ["conv", "idx", "shared_k", "shared_v", "ssm"]
PAGED_LEAVES = ["bt", "conv", "idx", "shared_kp", "shared_vp", "ssm"]


def _requests(cls, n=4, max_tokens=5, seed=3, vocab=256):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 16).astype(np.int32)
    return [cls(rid=i, prompt=np.concatenate(
        [prefix, rng.integers(0, vocab, (1, 4)[i % 2]).astype(np.int32)]),
        max_tokens=max_tokens) for i in range(n)]


def _drain(server, reqs=None):
    for r in reqs if reqs is not None else _requests(
            Request if not isinstance(server, JServer) else JRequest):
        server.submit(r)
    return {r.rid: list(map(int, r.tokens_out))
            for r in server.run_until_drained()}


@pytest.fixture(scope="module")
def jax_model():
    jm = jbuild(jconfig(ARCH).reduced(), jpolicy("mirage"))
    return jm, jm.init(jax.random.PRNGKey(0))


def _port(jax_model, policy):
    tm = build_model(get_config(ARCH).reduced(), policy, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jax_model[1]))
    return tm


def _jax_engine(jax_model, policy, **kw):
    jm, params = jax_model
    jm.policy = policy
    return JServer(jm, params, **ENGINE, **kw)


@pytest.fixture(scope="module")
def jax_streams(jax_model):
    """The JAX dense engine's streams under ``mirage``, and with the
    backend switched to ``mirage_rns`` at tick 2 and back at tick 4."""
    want = _drain(_jax_engine(jax_model, jpolicy("mirage")))
    server = _jax_engine(jax_model, jpolicy("mirage"))
    for r in _requests(JRequest):
        server.submit(r)
    done = server.tick() + server.tick()
    server.switch_backend(jpolicy("mirage_rns"))
    done += server.tick() + server.tick()
    server.switch_backend(jpolicy("mirage"))
    switched = {r.rid: list(map(int, r.tokens_out))
                for r in done + server.run_until_drained()}
    return want, switched


def _resized_drain(server):
    """Two ticks, 2 -> 3 slots (and, paged, the pool grown by 3 blocks),
    two ticks, back to the live slots (at least 2) and the pool cut to
    what is used plus 2 blocks, then the rest."""
    for r in _requests(Request):
        server.submit(r)
    done = server.tick() + server.tick()
    server.resize_slots(3)
    if server.alloc is not None:
        server.resize_block_pool(server.alloc.n_blocks + 3)
    done += server.tick() + server.tick()
    live = sum(r is not None for r in server.slot_req)
    server.resize_slots(max(live, 2))
    if server.alloc is not None:
        server.resize_block_pool(server.alloc.used_count + 2)
    return {r.rid: list(map(int, r.tokens_out))
            for r in done + server.run_until_drained()}


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_equal_jax_engine(jax_model, jax_streams, engine):
    want = jax_streams[0]
    assert len(want) == 4 and all(len(t) == 5 for t in want.values())
    tm = _port(jax_model, get_policy("mirage"))
    if engine == "oracle":
        assert _drain(PerSlotLMServer(tm, **ENGINE)) == want
        return
    server = LMServer(tm, **ENGINE, **ENGINES[engine])
    paged = ENGINES[engine].get("cache_layout") == "paged"
    # the shared block's KV is paged; the recurrent state stays dense and
    # no prefix is ever shared
    assert (server.alloc is not None) == paged and not server.prefix_cache
    assert sorted(server.state["cache"]) == (PAGED_LEAVES if paged
                                             else DENSE_LEAVES)
    assert server.state["cache"]["ssm"].shape[1] == ENGINE["batch_slots"]
    assert not server.pad_prefill
    if engine == "dense_warmed":
        server.warmup()
    if engine.startswith("resized"):
        got = _resized_drain(server)
        assert (server.alloc is not None) == paged
        if paged:
            assert server.state["cache"]["shared_kp"].shape[1] == \
                server.alloc.n_blocks
    else:
        got = _drain(server)
    server.close()
    assert got == want, engine
    m = server.metrics
    assert m["prefix_hits"] == 0 and m["prefix_shared_blocks"] == 0
    counts = server.compile_counts()
    if engine in ("dense", "paged"):
        # exact-length prefill: one shape a distinct length and batch
        assert counts["prefill_insert"] == 2
    if engine == "paged_chunk":
        # chunk 16 then exact-length final chunks of 1 and 4 tokens
        assert m["prefill_chunks"] == 8
        assert server._shapes["chunk_last"] == {(1, 1), (1, 4)}
    if engine == "spec":
        assert m["spec_ticks"] > 0


def test_switch_backend_equals_jax_engine(jax_model, jax_streams):
    """``mirage`` -> ``mirage_rns`` (programmed: stationary weights are the
    family's default) -> ``mirage`` mid-drain, the JAX engine's streams;
    the shared block's projections are re-encoded beside the layers'."""
    tm = _port(jax_model, get_policy("mirage"))
    server = LMServer(tm, **ENGINE)
    for r in _requests(Request):
        server.submit(r)
    done = server.tick() + server.tick()
    server.switch_backend(get_policy("mirage_rns"))
    assert server.stationary_weights
    for mod in (tm.layers[0].mamba.in_proj, tm.shared.proj,
                tm.shared.attn.q, tm.shared.mlp.down, tm.lm_head):
        assert mod.stationary is not None
    done += server.tick() + server.tick()
    server.switch_backend(get_policy("mirage"))
    assert tm.shared.proj.stationary is None
    got = {r.rid: list(map(int, r.tokens_out))
           for r in done + server.run_until_drained()}
    assert got == jax_streams[1] and len(got) == 4


@pytest.mark.parametrize("mode,layout", [("mirage_rns", "dense"),
                                         ("mirage_rrns", "paged")])
def test_rns_engines_equal_jax_engine(jax_model, mode, layout):
    """Stationary weights by default (the JAX rule for ``mamba``, the
    shared block's weights among them); the streams and, on the clean
    RRNS channel, the health integers of the JAX engine under the
    policy (its dense engine's)."""
    js = _jax_engine(jax_model, jpolicy(mode))
    want = _drain(js)
    tm = _port(jax_model, get_policy(mode))
    server = LMServer(tm, **ENGINE, **(PAGED if layout == "paged" else {}))
    assert server.stationary_weights
    assert tm.shared.mlp.gate.stationary is not None
    assert _drain(server) == want
    if mode == "mirage_rrns":
        jh, h = js.health_snapshot(), server.health_snapshot()
        assert jh and {k: h[k] for k in jh} == jh
        assert h["rrns_uncorrected"] == 0


def test_rrns_52db_engine_keeps_the_clean_streams(jax_model):
    tm = _port(jax_model, get_policy("mirage_rrns"))
    clean = _drain(LMServer(tm, **ENGINE))
    tm.policy = get_policy("mirage_rrns", snr_db=52.0, noise_seed=7)
    server = LMServer(tm, **ENGINE)
    assert _drain(server) == clean
    assert server.health_snapshot()["rrns_uncorrected"] == 0


def test_launchers_take_the_arch(capsys):
    """``--layers 2`` keeps one shared application, ``--layers 1`` none
    (the reduced config applies the block every 2 layers)."""
    from repro_torch.launch import serve, train
    for layers in ("2", "1"):
        assert serve.main(["--arch", ARCH, "--reduced", "--layers", layers,
                           "--device", "cpu", "--requests", "2",
                           "--max-tokens", "3", "--cache-layout", "paged",
                           "--prefill-chunk", "8"]) == 0
        out = capsys.readouterr().out
        assert f"[{ARCH} d_model=64 layers={layers}" in out
        assert "served 2 requests" in out
    assert train.main(["--arch", ARCH, "--reduced", "--layers", "2",
                       "--device", "cpu", "--steps", "2"]) == 0
    assert "trained 2 steps" in capsys.readouterr().out
