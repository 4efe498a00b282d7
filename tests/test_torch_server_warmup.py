"""PyTorch port, slice 5: ``LMServer.warmup`` and ``compile_counts``
against the JAX engine.

Reduced qwen2 with the JAX init's weights in both packages, served as
``tests/test_serving_mesh.py``'s warmup tests serve it (4 slots, cap 32,
one 16-token bucket, six 12-token prompts of 8 tokens). A warmed engine
runs every serving shape before traffic (on the card it also captures the
tick as a CUDA graph: ``test_cuda_warmed_tick_replays_graph``, which skips
here); a warmed drain adds no shape to ``compile_counts`` and emits the
streams of a cold engine and of the JAX engine, token for token, also
under ``mirage_rrns`` at 60 dB, where it must also leave the noise
generators where they were and give the cold engine's health counters
(and at 46 dB, where the reduced model's detectors flip residues). The
JAX engine runs once per module (``jax_streams``).
"""

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
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.server import LMServer, Request

ENGINE = dict(cap=32, batch_slots=4, buckets=(16,))
#: engine options a warmed drain is checked under
VARIANTS = {
    "dense": {},
    "pipelined": dict(pipeline_depth=2),
    "paged_chunk_prefix": dict(cache_layout="paged", block_size=8,
                               n_blocks=32, prefill_chunk=8,
                               prefix_cache=True),
    "paged_spec": dict(cache_layout="paged", block_size=8, n_blocks=32,
                       spec_k=2),
}


def _requests(cls, n=6, max_tokens=8, vocab=256):
    """``tests/test_serving_mesh.py``'s ``_requests``."""
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 12).astype(np.int32),
                max_tokens=max_tokens) for i in range(n)]


def _drain(server, reqs):
    try:
        for r in reqs:
            server.submit(r)
        server.run_until_drained()
    finally:
        if hasattr(server, "close"):
            server.close()
    return {r.rid: list(map(int, r.tokens_out))
            for r in server.scheduler.finished}


def _jax(policy):
    jm = jbuild(jconfig("qwen2-0.5b").reduced(), policy,
                JOptions(q_chunk=16, kv_chunk=16))
    return jm, jm.init(jax.random.PRNGKey(0))


def _port(params, policy):
    tm = build_model(get_config("qwen2-0.5b").reduced(), policy,
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return tm


@pytest.fixture(scope="module")
def jax_params():
    return _jax(jpolicy("mirage"))[1]


@pytest.fixture(scope="module")
def model(jax_params):
    return _port(jax_params, get_policy("mirage"))


@pytest.fixture(scope="module")
def jax_streams(jax_params):
    """The JAX engine's warmed drain, with its warmup stats and its
    compile counts before and after the drain."""
    jm, params = _jax(jpolicy("mirage"))
    warm = JServer(jm, params, **ENGINE)
    stats = warm.warmup()
    counts = warm.compile_counts()
    streams = _drain(warm, _requests(JRequest))
    assert warm.compile_counts() == counts
    return {"mirage": streams, "stats": stats, "counts": counts}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_warmup_compiles_all_shapes_and_prevents_recompiles(
        model, jax_streams, variant):
    """``tests/test_serving_mesh.py::
    test_warmup_compiles_all_shapes_and_prevents_recompiles``, under each
    engine option: a warmed drain runs no new shape and emits the cold
    engine's streams and the JAX warmed engine's."""
    kw = VARIANTS[variant]
    cold = _drain(LMServer(model, **ENGINE, **kw), _requests(Request))
    warm = LMServer(model, **ENGINE, **kw)
    stats = warm.warmup()
    assert stats["compiled"] >= 2 and stats["seconds"] > 0
    assert stats["graphs"] == 0            # no CUDA graph on the CPU
    counts = warm.compile_counts()
    got = _drain(warm, _requests(Request))
    assert got == cold == jax_streams["mirage"]
    assert warm.compile_counts() == counts, (
        "a new shape ran during a warmed drain", counts,
        warm.compile_counts())
    if variant == "dense":
        # one prefill shape per (bucket, batch) and the tick, as JAX's
        assert stats["compiled"] == jax_streams["stats"]["compiled"]
        assert counts == jax_streams["counts"]
    if variant == "pipelined":
        assert counts["prefill_compute"] == counts["prefill_scatter"] == 3
        assert counts["prefill_insert"] == 0
    reg = warm.scheduler.registry
    assert reg.gauge("serve_warmup_compiled").value == stats["compiled"]


def test_warmup_requires_idle_engine(model):
    srv = LMServer(model, **ENGINE)
    srv.submit(_requests(Request, n=1)[0])
    with pytest.raises(RuntimeError, match="idle"):
        srv.warmup()
    srv.tick()                             # now mid-flight
    with pytest.raises(RuntimeError, match="idle"):
        srv.warmup()
    srv.run_until_drained()
    srv.warmup()                           # idle again


def test_warmup_spec_decode_and_paged(model, jax_streams):
    """``tests/test_serving_mesh.py::test_warmup_spec_decode_and_paged``:
    warmup covers the verify step and the paged layout."""
    srv = LMServer(model, cache_layout="paged", block_size=8, n_blocks=32,
                   spec_k=2, **ENGINE)
    stats = srv.warmup()
    assert stats["compiled"] >= 3          # prefill + tick + verify
    counts = srv.compile_counts()
    assert counts["verify_tick"] >= 1
    assert _drain(srv, _requests(Request)) == jax_streams["mirage"]
    assert srv.compile_counts() == counts
    assert srv.metrics["spec_ticks"] >= 1


def test_warmup_leaves_state_as_it_found_it(model):
    """The control leaves, ``idx`` and the tables after warmup are a fresh
    engine's."""
    for kw in ({}, VARIANTS["paged_chunk_prefix"], VARIANTS["paged_spec"]):
        fresh = LMServer(model, **ENGINE, **kw)
        warm = LMServer(model, **ENGINE, **kw)
        warm.warmup()
        for k, v in fresh.state.items():
            if k != "cache":
                assert torch.equal(warm.state[k], v), k
        for k in ("idx", "bt"):
            if k in fresh.state["cache"]:
                assert torch.equal(warm.state["cache"][k],
                                   fresh.state["cache"][k]), k


@pytest.mark.parametrize("snr_db", [60.0, 46.0])
def test_warmed_rrns_engine_equals_cold_under_noise(jax_params, snr_db):
    """Under per-tick analog noise (``mirage_rrns``) warmup draws from
    generators of its own: the real ones are where a fresh engine's are,
    the health counters read zero, and the warmed drain gives the cold
    drain's streams and health counters."""
    rmodel = _port(jax_params, get_policy("mirage_rrns", snr_db=snr_db,
                                          noise_seed=7))
    cold = LMServer(rmodel, **ENGINE)
    want = _drain(cold, _requests(Request, n=2))
    warm = LMServer(rmodel, **ENGINE)
    fresh = LMServer(rmodel, **ENGINE)
    warm.warmup()
    for s, g in warm._noise_gens.items():
        assert torch.equal(g.get_state(), fresh._noise_gens[s].get_state())
    assert all(v == 0 or set(v) == {0}
               for v in warm.health_snapshot().values())
    assert _drain(warm, _requests(Request, n=2)) == want
    health = warm.health_snapshot()
    assert health == cold.health_snapshot()
    if snr_db < 60:
        assert sum(health["detector_flips"]) > 0 and \
            health["rrns_corrected"] > 0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("policy,kw", [
    ("mirage", {}),
    ("mirage", dict(cache_layout="paged", block_size=8, spec_k=2)),
    ("mirage_rrns", {}),
])
def test_cuda_warmed_tick_replays_graph(cuda, jax_params, policy, kw):
    """On the card the warmed engine replays a captured graph every tick:
    its streams, launch counts and health counters equal a cold engine's,
    and its compile counts hold across the drain."""
    extra = dict(snr_db=46.0, noise_seed=7) \
        if policy == "mirage_rrns" else {}
    tm = build_model(get_config("qwen2-0.5b").reduced(),
                     get_policy(policy, **extra),
                     LMCallOptions(q_chunk=16, kv_chunk=16,
                                   use_flash_kernel=True), device=cuda)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jax_params))
    runs = []
    for warmed in (False, True):
        srv = LMServer(tm, **ENGINE, **kw)
        if warmed:
            assert srv.warmup()["graphs"] == 1
            counts = srv.compile_counts()
        ops.reset_launch_counts()
        streams = _drain(srv, _requests(Request))
        runs.append((streams, dict(ops.LAUNCHES), srv.health_snapshot()))
    assert runs[0] == runs[1]
    assert srv.compile_counts() == counts
