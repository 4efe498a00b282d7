"""PyTorch port: the serving engine vs the JAX package's ``LMServer``.

Both engines serve the workload of ``tests/test_serving.py`` (7 requests of
lengths [8, 11, 6], 5 max tokens, 3 slots, cap 24) with the same weights
(the JAX init carried over by ``load_jax_params``); greedy streams must be
equal under ``fp32`` and under ``mirage``. The remaining tests cover the
engine's own semantics on the port alone.
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
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.faults import FaultInjector, FaultSchedule
from repro_torch.runtime.server import (AdmissionRejected, LMServer,
                                        Request, Scheduler, default_buckets,
                                        pick_bucket)


def _requests(cls, n, lens, max_tokens=5, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, lens[i % len(lens)]
                                           ).astype(np.int32),
                max_tokens=max_tokens) for i in range(n)]


def _port_model(policy, params=None):
    tm = build_model(get_config("qwen2-0.5b").reduced(), get_policy(policy),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    if params is not None:
        load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return tm


@pytest.fixture(scope="module")
def model():
    """Port model with the JAX init's weights (mirage policy)."""
    cfg = jconfig("qwen2-0.5b").reduced()
    jm = jbuild(cfg, jpolicy("mirage"), JOptions(q_chunk=16, kv_chunk=16))
    return _port_model("mirage", jm.init(jax.random.PRNGKey(0)))


def _drain(server, reqs):
    for r in reqs:
        server.submit(r)
    return {r.rid: r.tokens_out for r in server.run_until_drained()}


@pytest.mark.parametrize("policy", ["fp32", "mirage"])
def test_greedy_streams_equal_jax_engine(policy):
    cfg = jconfig("qwen2-0.5b").reduced()
    jm = jbuild(cfg, jpolicy(policy), JOptions(q_chunk=16, kv_chunk=16))
    params = jm.init(jax.random.PRNGKey(0))
    want = _drain(JServer(jm, params, cap=24, batch_slots=3),
                  _requests(JRequest, 7, [8, 11, 6]))
    got = _drain(LMServer(_port_model(policy, params), cap=24,
                          batch_slots=3),
                 _requests(Request, 7, [8, 11, 6]))
    assert set(got) == set(range(7))
    assert got == want


def test_eos_and_max_token_retirement(model):
    [probe] = _requests(Request, 1, [8], max_tokens=6, seed=3)
    [r0] = _drain_one(model, probe)
    eos = r0.tokens_out[2]
    s = LMServer(model, cap=24, batch_slots=2)
    [req_eos] = _requests(Request, 1, [8], max_tokens=20, seed=3)
    req_eos.eos_id = eos
    [req_max] = _requests(Request, 1, [8], max_tokens=4, seed=4)
    req_max.rid = 1
    done = {r.rid: r for r in _drain_reqs(s, [req_eos, req_max])}
    assert done[0].tokens_out[-1] == eos and len(done[0].tokens_out) < 20
    assert len(done[1].tokens_out) == 4
    assert all(r.status == "completed" for r in done.values())


def _drain_one(model, req):
    s = LMServer(model, cap=24, batch_slots=1)
    s.submit(req)
    return s.run_until_drained()


def _drain_reqs(server, reqs):
    for r in reqs:
        server.submit(r)
    return server.run_until_drained()


def test_retire_at_admission(model):
    """A prefill token that is already EOS, or a one-token budget, retires
    at admission with one token and never occupies a decode slot."""
    [probe] = _requests(Request, 1, [8], max_tokens=2, seed=11)
    [r0] = _drain_one(model, probe)
    first = r0.tokens_out[0]
    s = LMServer(model, cap=24, batch_slots=1)
    [req_eos] = _requests(Request, 1, [8], max_tokens=20, seed=11)
    req_eos.eos_id = first
    [req_one] = _requests(Request, 1, [8], max_tokens=1, seed=12)
    req_one.rid = 1
    done = {r.rid: r for r in _drain_reqs(s, [req_eos, req_one])}
    assert done[0].tokens_out == [first]
    assert len(done[1].tokens_out) == 1
    assert s.metrics["completed"] == 2
    assert s.metrics["decode_steps"] == 0


def test_slot_reuse_and_fcfs(model):
    s = LMServer(model, cap=24, batch_slots=2)
    finished = _drain_reqs(s, _requests(Request, 5, [8], max_tokens=3))
    assert len(finished) == 5 and s.metrics["completed"] == 5
    assert all(r is None for r in s.slot_req)
    one = LMServer(model, cap=24, batch_slots=1)
    order = _drain_reqs(one, _requests(Request, 4, [8], max_tokens=3))
    assert [r.rid for r in order] == [0, 1, 2, 3]
    assert all(r.t_enqueue <= r.t_admit <= r.t_first_token <= r.t_done
               for r in order)


def test_one_host_transfer_per_tick(model):
    """Each decode tick moves exactly one (slots, 2) payload to the host;
    admission adds one per prefill batch, and TTFT is stamped after it."""
    s = LMServer(model, cap=24, batch_slots=3)
    shapes = []
    orig = s._to_host

    def spy(payload):
        shapes.append(tuple(payload.shape))
        return orig(payload)

    s._to_host = spy
    for r in _requests(Request, 3, [8], max_tokens=4):
        s.submit(r)
    s.tick()                       # admission (1 batch of 3 -> pow2 4) + decode
    assert shapes == [(4, 2), (3, 2)]
    s.tick()                       # decode only
    assert shapes[2:] == [(3, 2)]
    s.run_until_drained()
    m = s.metrics
    assert len(shapes) == m["decode_steps"] + m["prefill_batches"]
    assert shapes[1:] == [(3, 2)] * m["decode_steps"]


def test_sampled_decode_deterministic_per_seed(model):
    def serve(seed):
        s = LMServer(model, cap=24, batch_slots=2, greedy=False,
                     sample_seed=seed)
        return _drain(s, _requests(Request, 3, [8, 6], max_tokens=6, seed=5))

    a, b, c = serve(1), serve(1), serve(2)
    assert a == b
    assert a != c


@pytest.mark.parametrize("option,value", [
    ("mesh", object()),
    ("fault_injector", FaultInjector(FaultSchedule.parse("worker_crash@0"))),
    ("default_ttl_s", 1.0),
    ("default_queue_ttl_s", 1.0), ("max_queue_depth", 4),
])
def test_unported_options_raise(model, option, value):
    """Only ``mesh`` still waits (slice 8b); the options of slice 7 build
    an engine that holds them."""
    if option == "mesh":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            LMServer(model, cap=24, batch_slots=2, **{option: value})
        return
    s = LMServer(model, cap=24, batch_slots=2, **{option: value})
    held = {"fault_injector": s._injector, "default_ttl_s": s.default_ttl_s,
            "default_queue_ttl_s": s.default_queue_ttl_s,
            "max_queue_depth": s.scheduler.max_queue_depth}
    assert held[option] is value or held[option] == value


def test_unknown_option_and_overlong_prompt_rejected(model):
    with pytest.raises(TypeError):
        LMServer(model, cap=24, batch_slots=2, no_such_option=1)
    s = LMServer(model, cap=24, batch_slots=1)
    with pytest.raises(ValueError):
        s.submit(Request(rid=0, prompt=np.zeros(100, np.int32)))


def test_scheduler_and_buckets():
    sched = Scheduler(max_queue_depth=5)
    for i in range(5):
        sched.submit(Request(rid=i, prompt=np.zeros(4, np.int32)))
    late = Request(rid=5, prompt=np.zeros(4, np.int32))
    with pytest.raises(AdmissionRejected):
        sched.submit(late)
    assert late.status == "rejected" and sched.metrics["rejected"] == 1
    assert [r.rid for r in sched.take(3)] == [0, 1, 2]
    assert default_buckets(64, min_bucket=8) == (8, 16, 32, 64)
    assert pick_bucket(9, (8, 16)) == 16
    with pytest.raises(ValueError):
        pick_bucket(17, (8, 16))


def test_latency_metrics_and_streaming_hook(model):
    streamed = []
    s = LMServer(model, cap=24, batch_slots=2,
                 on_token=lambda req, tok: streamed.append((req.rid, tok)))
    finished = _drain_reqs(s, _requests(Request, 3, [8], max_tokens=4))
    for r in finished:
        assert [t for rid, t in streamed if rid == r.rid] == r.tokens_out
        assert r.ttft >= 0 and r.tpot >= 0
    lat = s.scheduler.latency_summary()
    assert lat["ttft_mean_s"] > 0
    text = s.scheduler.registry.prometheus_text()
    assert "serve_completed_total 3" in text
