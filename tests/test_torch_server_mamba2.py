"""PyTorch port, slice 6e: the serving engine over the SSM family
(mamba2-2.7b) against the JAX engine.

Reduced mamba2-2.7b (4 layers, d_model 64, chunk 16) with the JAX init's
weights in both packages. Four requests share a 16-token prefix and are
17 or 20 tokens long (longer than the SSD chunk of 16), 5 tokens each, on
2 slots. The JAX engine's rules for a pure SSM hold in the port: no page
pool under ``cache_layout="paged"`` (no ``BlockAllocator``), the prefix
flag inert (no hit, no shared block), prefill batched by EXACT prompt
length (two prefill shapes, one per length), exact-length final chunks,
inactive slots' ``ssm``/``conv`` frozen in the tick, the speculative
verify rolled back to each slot's accepted position, and stationary
weights on by default where the backend programs them.

- Under ``mirage``: the dense (cold and warmed), paged, chunked (chunk
  16: final chunks of 1 and 4 tokens), prefix-flagged, speculative
  (``spec_k=2``), pipelined, resized (2 -> 3 -> 2 slots mid-drain) and
  per-slot engines each emit the JAX dense engine's greedy streams token
  for token; ``switch_backend`` ``mirage`` -> ``mirage_rns`` -> ``mirage``
  at ticks 2 and 4 the JAX engine's making the same switches.
- Under ``mirage_rns`` and ``mirage_rrns`` (stationary weights, clean and
  60 dB seeded, where every RRNS decode corrects exactly): the streams
  and health counters of the JAX engine under the same policy. At 52 dB
  (seeded) the port's stationary engine emits the clean streams with no
  uncorrected decode, twice alike.
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

ARCH = "mamba2-2.7b"
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
    "oracle": None,
}
SNR60 = dict(snr_db=60.0, noise_seed=7)


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


@pytest.mark.parametrize("engine", list(ENGINES))
def test_engines_equal_jax_engine(jax_model, jax_streams, engine):
    want = jax_streams[0]
    assert len(want) == 4 and all(len(t) == 5 for t in want.values())
    tm = _port(jax_model, get_policy("mirage"))
    if engine == "oracle":
        assert _drain(PerSlotLMServer(tm, **ENGINE)) == want
        return
    server = LMServer(tm, **ENGINE, **ENGINES[engine])
    # a pure SSM has no KV to page and no prefix to share
    assert server.alloc is None and not server.prefix_cache
    assert "bt" not in server.state["cache"]
    assert sorted(server.state["cache"]) == ["conv", "idx", "ssm"]
    assert not server.pad_prefill
    if engine == "dense_warmed":
        server.warmup()
    if engine == "resized":
        for r in _requests(Request):
            server.submit(r)
        done = server.tick() + server.tick()
        server.resize_slots(3)
        done += server.tick() + server.tick()
        live = sum(r is not None for r in server.slot_req)
        server.resize_slots(max(live, 2))
        got = {r.rid: list(map(int, r.tokens_out))
               for r in done + server.run_until_drained()}
    else:
        got = _drain(server)
    server.close()
    assert got == want, engine
    m = server.metrics
    assert m["prefix_hits"] == 0 and m["prefix_shared_blocks"] == 0
    counts = server.compile_counts()
    if engine in ("dense", "resized"):
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
    SSM family's default) -> ``mirage`` mid-drain, the JAX engine's
    streams; the mamba projections and the head are re-encoded."""
    tm = _port(jax_model, get_policy("mirage"))
    server = LMServer(tm, **ENGINE)
    for r in _requests(Request):
        server.submit(r)
    done = server.tick() + server.tick()
    server.switch_backend(get_policy("mirage_rns"))
    assert server.stationary_weights
    for mod in (tm.layers[0].mamba.in_proj, tm.layers[3].mamba.out_proj,
                tm.lm_head):
        assert mod.stationary is not None
    done += server.tick() + server.tick()
    server.switch_backend(get_policy("mirage"))
    assert tm.lm_head.stationary is None
    got = {r.rid: list(map(int, r.tokens_out))
           for r in done + server.run_until_drained()}
    assert got == jax_streams[1] and len(got) == 4


@pytest.mark.parametrize("mode,kw", [("mirage_rns", {}),
                                     ("mirage_rrns", {}),
                                     ("mirage_rrns", SNR60)])
def test_rns_engines_equal_jax_engine(jax_model, mode, kw):
    """Stationary weights by default (the JAX rule for ``mamba``); the
    streams and health integers of the JAX engine under the policy."""
    js = _jax_engine(jax_model, jpolicy(mode, **kw))
    want = _drain(js)
    tm = _port(jax_model, get_policy(mode, **kw))
    server = LMServer(tm, **ENGINE)
    assert server.stationary_weights
    assert _drain(server) == want
    if mode == "mirage_rrns":
        jh, h = js.health_snapshot(), server.health_snapshot()
        assert {k: h[k] for k in jh} == jh
        assert h["rrns_uncorrected"] == 0


def test_rrns_52db_engine_keeps_the_clean_streams(jax_model):
    tm = _port(jax_model, get_policy("mirage_rrns"))
    clean = _drain(LMServer(tm, **ENGINE))
    runs = []
    for _ in range(2):
        tm.policy = get_policy("mirage_rrns", snr_db=52.0, noise_seed=7)
        server = LMServer(tm, **ENGINE)
        runs.append((_drain(server), server.health_snapshot()))
    assert runs[0] == runs[1]
    assert runs[0][0] == clean
    assert runs[0][1]["rrns_uncorrected"] == 0


def test_launchers_take_the_arch(capsys):
    from repro_torch.launch import serve, train
    assert serve.main(["--arch", ARCH, "--reduced", "--layers", "2",
                       "--device", "cpu", "--requests", "2",
                       "--max-tokens", "3", "--cache-layout", "paged",
                       "--prefill-chunk", "8"]) == 0
    out = capsys.readouterr().out
    assert f"[{ARCH} d_model=64 layers=2" in out and "paged KV" not in out
    assert train.main(["--arch", ARCH, "--reduced", "--layers", "2",
                       "--device", "cpu", "--steps", "2"]) == 0
    assert "trained 2 steps" in capsys.readouterr().out


def test_stationary_encodings_equal_jax(jax_model):
    """``encode_stationary_params`` reaches every mamba projection and the
    untied head under the JAX paths' names, and a tree the JAX package
    programmed carries over through ``load_jax_stationary`` bit for bit
    (``conv_w`` and the other small leaves stay raw in both)."""
    from repro.core import stationary as jstationary
    from repro_torch.core import stationary
    from repro_torch.interop import load_jax_stationary

    policy = get_policy("mirage_rrns")
    tm = _port(jax_model, policy)
    ours = stationary.encode_stationary_params(tm, policy)
    nl = tm.cfg.n_layers
    assert set(ours) == {"lm_head"} | {
        f"layers.{i}.mamba.{p}" for i in range(nl)
        for p in ("in_proj", "out_proj")}
    assert stationary.jax_path("layers.3.mamba.in_proj") == \
        "layers/mamba/in_proj/w"
    enc = jax.jit(lambda p: jstationary.encode_stationary_params(
        p, jpolicy("mirage_rrns")))(jax_model[1])
    carried = load_jax_stationary(tm, jax.tree_util.tree_map(np.asarray,
                                                             enc))
    assert set(carried) == set(ours)
    for key, sr in ours.items():
        assert torch.equal(sr.residues, carried[key].residues), key
        assert torch.equal(sr.scale, carried[key].scale), key
