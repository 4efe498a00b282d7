"""PyTorch port, slice 7: the chaos harness and request-level robustness
against the JAX package (``tests/test_faults.py``'s twin).

``FaultSchedule`` and every ``FaultInjector`` output are held bit for bit
against ``repro.runtime.faults`` (the port keeps its own numpy copy). The
channel stages under fault controls are held bit for bit in residues and
health records, the JAX package's draws replayed by stage name. The
reduced qwen2 engine (fp32, weights drawn by the port and handed to JAX) under host faults
(corrupted transfers, pool squeezes) is held to the JAX engine's streams,
statuses, retries and chaos log, and to the clean drain's streams;
deadlines, the admission cap, drain and shutdown to the JAX engine's
semantics; a crashing prefill worker to the clean drain. Every JAX engine
of the module runs once (``jax_runs``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.analog import channel as jchannel
from repro.configs import get_config as jconfig
from repro.core import gemm as jgemm
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.obs import health as jhealth
from repro.runtime import faults as jfaults
from repro.runtime.server import LMServer as JServer
from repro.runtime.server import Request as JRequest
from repro_torch.analog import channel
from repro_torch.configs import get_config
from repro_torch.core import gemm
from repro_torch.core.precision import get_policy
from repro_torch.interop import _jax_layout
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.obs import health
from repro_torch.runtime import faults
from repro_torch.runtime.server import (TERMINAL_STATUSES, AdmissionRejected,
                                        LMServer, Request, Scheduler)

SPECS = (
    "snr_drop@4:12:scale=30;worker_crash@2;pool_exhaustion@3:9:blocks=16",
    "snr_drop@0:4:scale=10;snr_drop@2:4:scale=3;"
    "burst_storm@2:3:rate=0.1,width=2;burst_storm@2:3:rate=0.2,width=4;"
    "stuck_channel@2:3:channel=1,level=7;stuck_channel@1:4:channel=9",
    "host_corruption@3:5:rate=0.5;host_corruption@4:6:rate=0.25;"
    "worker_crash@2;worker_crash@5",
    "",
    "burst_storm@1:6",
)
RRNS = (31, 32, 33, 37, 41)


# --------------------------------------------------------------------------
# schedule and injector: bit for bit against repro.runtime.faults
# --------------------------------------------------------------------------

def _events(schedule):
    return [(e.site, e.start, e.stop, e.params) for e in schedule]


@pytest.mark.parametrize("spec", SPECS)
def test_schedule_equals_jax(spec):
    got = faults.FaultSchedule.parse(spec)
    want = jfaults.FaultSchedule.parse(spec)
    assert faults.SITES == jfaults.SITES
    assert _events(got) == _events(want)
    assert len(got) == len(want)
    assert got.describe() == want.describe()
    assert got.horizon == want.horizon
    assert got.sites() == want.sites()
    for site in faults.SITES:
        for t in range(14):
            assert _events(faults.FaultSchedule(got.active(site, t))) == \
                _events(jfaults.FaultSchedule(want.active(site, t)))


@pytest.mark.parametrize("spec", SPECS)
def test_injector_outputs_equal_jax(spec):
    """controls, pool_squeeze, worker_crash, corrupt_tokens and the log,
    tick by tick, for two seeds."""
    toks = np.arange(64, dtype=np.int32).reshape(16, 4) * 3
    for seed in (0, 5):
        got = faults.FaultInjector(faults.FaultSchedule.parse(spec), seed)
        want = jfaults.FaultInjector(jfaults.FaultSchedule.parse(spec), seed)
        assert got.channel_faults_scheduled() == \
            want.channel_faults_scheduled()
        for t in range(14):
            c, jc = got.controls(t, 7), want.controls(t, 7)
            assert c.keys() == jc.keys()
            for k in c:
                assert np.asarray(c[k]).dtype == np.asarray(jc[k]).dtype
                np.testing.assert_array_equal(c[k], jc[k])
            assert got.pool_squeeze(t) == want.pool_squeeze(t)
            assert got.worker_crash(t) == want.worker_crash(t)
            a = got.corrupt_tokens(t, toks, vocab_size=100)
            b = want.corrupt_tokens(t, toks, vocab_size=100)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got.log == want.log


def test_schedule_validation():
    with pytest.raises(ValueError, match="unknown fault site"):
        faults.FaultEvent(site="meteor_strike", start=0, stop=1)
    with pytest.raises(ValueError, match="bad window"):
        faults.FaultEvent(site="snr_drop", start=5, stop=5)
    with pytest.raises(ValueError, match="unknown params"):
        faults.FaultEvent(site="snr_drop", start=0, stop=1,
                          params={"rate": 2})
    with pytest.raises(ValueError, match="expected site@"):
        faults.FaultSchedule.parse("snr_drop")


# --------------------------------------------------------------------------
# the channel under fault controls, JAX's draws replayed
# --------------------------------------------------------------------------

class Replay:
    """Draws that replay the JAX package's for the same stage names."""

    def __init__(self, keys):
        self.keys = keys

    def normal(self, stage, shape):
        return torch.from_numpy(np.array(
            jax.random.normal(self.keys[stage], shape)))

    def uniform(self, stage, shape):
        return torch.from_numpy(np.array(
            jax.random.uniform(self.keys[stage], shape)))

    def randint(self, stage, shape, low, high):
        return torch.from_numpy(np.array(
            jax.random.randint(self.keys[stage], shape, low, high)))


def burst_keys(k_burst, n_moduli):
    k_hit, k_pos, k_err = jax.random.split(k_burst, 3)
    keys = {"burst_hit": k_hit, "burst_pos": k_pos}
    for i in range(n_moduli):
        keys[f"burst_err/{i}"] = jax.random.fold_in(k_err, i)
    return keys


def channel_replay(key, n_moduli):
    """The stage keys the JAX backend's ``_analog_forward`` splits."""
    k_prog, k_det, k_burst = jax.random.split(key, 3)
    return Replay({"drift": k_prog, "detector": k_det,
                   **burst_keys(k_burst, n_moduli)})


CONTROLS = {
    "identity": None,
    "collapse": dict(sigma_scale=1e3),
    "storm": dict(sigma_scale=3.0, burst_rate=0.3, burst_width=2,
                  stuck=(1, 7)),
    "stuck_redundant": dict(stuck=(4, 40)),
}


def _controls(name, n):
    """The same controls for both packages: (port tensors, JAX arrays)."""
    c = {"sigma_scale": np.float32(1.0), "burst_rate": np.float32(0.0),
         "burst_width": np.int32(1), "stuck_mask": np.zeros(n, np.bool_),
         "stuck_level": np.zeros(n, np.int32)}
    spec = CONTROLS[name] or {}
    for k in ("sigma_scale", "burst_rate"):
        if k in spec:
            c[k] = np.float32(spec[k])
    if "burst_width" in spec:
        c["burst_width"] = np.int32(spec["burst_width"])
    if "stuck" in spec:
        ch, level = spec["stuck"]
        c["stuck_mask"][ch] = True
        c["stuck_level"][ch] = level
    return channel.fault_control_tensors(c), \
        {k: jnp.asarray(v) for k, v in c.items()}


def _residues(moduli, shape, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, m, size=shape)
                     for m in moduli]).astype(np.int32)


CHANNEL_CFGS = {"snr30": dict(snr_db=30.0),
                "snr30_xtalk_adc": dict(snr_db=30.0, crosstalk=0.05,
                                        adc_bits=5),
                "clean": dict()}


def _np(values):
    return {k: np.asarray(v) for k, v in values.items()}


@pytest.mark.parametrize("ctl_name", list(CONTROLS))
@pytest.mark.parametrize("cfg_name", list(CHANNEL_CFGS))
def test_readout_channel_under_controls_equals_jax(cfg_name, ctl_name):
    """crosstalk -> noise at the scaled sigma -> stuck clamp (its flips
    counted again) -> ADC: residues and detector_flips bit for bit."""
    kw = CHANNEL_CFGS[cfg_name]
    cfg = channel.AnalogChannelConfig(**kw)
    jcfg = jchannel.AnalogChannelConfig(**kw)
    res = _residues(RRNS, (3, 4, 8), seed=11)
    key = jax.random.PRNGKey(3)
    ctl, jctl = _controls(ctl_name, len(RRNS))
    with jchannel.fault_scope(jctl), jhealth.collect() as jhc:
        want = jchannel.apply_readout_channel(jnp.asarray(res), RRNS, jcfg,
                                              key)
    with channel.fault_scope(ctl), health.collect() as hc:
        got = channel.apply_readout_channel(torch.from_numpy(res), RRNS, cfg,
                                            Replay({"detector": key}))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _np(hc.values).keys() == _np(jhc.values).keys()
    for k, v in _np(jhc.values).items():
        np.testing.assert_array_equal(_np(hc.values)[k], v)
    if ctl_name == "identity" and cfg.snr_db is not None:
        # an identity scope computes what no scope does, from one draw
        with health.collect() as plain_hc:
            plain = channel.apply_readout_channel(
                torch.from_numpy(res), RRNS, cfg, Replay({"detector": key}))
        assert torch.equal(plain, got)
        assert torch.equal(hc.values["detector_flips"],
                           plain_hc.values["detector_flips"])


@pytest.mark.parametrize("ctl_name", ["identity", "storm"])
def test_burst_errors_under_controls_equal_jax(ctl_name):
    """Traced rate and width: residues and burst_hits bit for bit, a hit
    count of 0 at rate 0."""
    res = _residues(RRNS, (3, 5, 16), seed=12)
    key = jax.random.PRNGKey(9)
    ctl, jctl = _controls(ctl_name, len(RRNS))
    rate, width = 0.05, 1
    with jhealth.collect() as jhc:
        want = jchannel.burst_errors(
            jnp.asarray(res), RRNS, rate + jctl["burst_rate"],
            jnp.maximum(jnp.int32(width), jctl["burst_width"]), key)
    with health.collect() as hc:
        got = channel.burst_errors(
            torch.from_numpy(res), RRNS, ctl["burst_rate"] + rate,
            torch.clamp_min(ctl["burst_width"], width),
            Replay(burst_keys(key, len(RRNS))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(hc.values["burst_hits"]) == int(jhc.values["burst_hits"]) > 0


PAPER_RRNS = dict(snr_db=40.0, noise_seed=1)


@jax.jit
def _jax_rrns_gemm(x, w, key, ctl):
    """The JAX mirage_rrns GEMM under ``fault_scope(ctl)``: one compile
    serves every control value (they are traced operands)."""
    with jchannel.fault_scope(ctl), jhealth.collect() as hc:
        out = jgemm.mirage_matmul_nograd(x, w, jpolicy("mirage_rrns",
                                                       **PAPER_RRNS), key=key)
    return out, dict(hc.values)


@pytest.mark.parametrize("ctl_name", ["identity", "collapse", "storm",
                                      "stuck_redundant"])
def test_rrns_gemm_under_scope_equals_jax(ctl_name):
    """The mirage_rrns GEMM at 40 dB under a scope: the health integers
    bit for bit, the output within the f32 order of the group sum; the
    JAX draws (detector and bursts, split from one key) replayed. An
    identity scope gives the unscoped output bitwise."""
    policy = get_policy("mirage_rrns", **PAPER_RRNS)
    rng = np.random.default_rng(21)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    w = (rng.normal(size=(64, 24)) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ctl, jctl = _controls(ctl_name, len(RRNS))
    want, jvalues = _jax_rrns_gemm(jnp.asarray(x), jnp.asarray(w), key, jctl)
    with channel.fault_scope(ctl), health.collect() as hc:
        got = gemm.mirage_matmul_nograd(torch.from_numpy(x),
                                        torch.from_numpy(w), policy,
                                        draws=channel_replay(key, 5))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    for k, v in _np(jvalues).items():
        np.testing.assert_array_equal(_np(hc.values)[k], v)
    assert set(hc.values) == set(jvalues)
    if ctl_name == "identity":
        plain = gemm.mirage_matmul_nograd(torch.from_numpy(x),
                                          torch.from_numpy(w), policy,
                                          draws=channel_replay(key, 5))
        assert torch.equal(plain, got)


def test_fault_scope_nesting_and_inert_scope():
    assert channel.fault_controls() is None
    ident = channel.identity_fault_controls(5)
    with channel.fault_scope(ident):
        assert channel.fault_controls() is ident
        with channel.fault_scope(None):
            assert channel.fault_controls() is None
        assert channel.fault_controls() is ident
    assert channel.fault_controls() is None


# --------------------------------------------------------------------------
# the engine under host faults, deadlines, admission caps: against JAX
# --------------------------------------------------------------------------

PAGED = dict(cache_layout="paged", block_size=4, n_blocks=48)
CORRUPT = ("host_corruption@1:3:rate=1.0", 1)
SQUEEZE = ("pool_exhaustion@1:5:blocks=40", 0)


def _requests(cls, n, lens, max_tokens=4, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, lens[i % len(lens)]
                                           ).astype(np.int32),
                max_tokens=max_tokens) for i in range(n)]


CORRUPT_REQS = dict(n=4, lens=[6, 9], max_tokens=4, seed=3)
SQUEEZE_REQS = dict(n=5, lens=[8, 11], max_tokens=4, seed=2)


@pytest.fixture(scope="module")
def model():
    """The port's reduced qwen2 under fp32, weights drawn from seed 0."""
    return build_model(get_config("qwen2-0.5b").reduced(), get_policy("fp32"),
                       LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu",
                       generator=torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def jax_model(model):
    """The JAX fp32 model on the port's weights (no JAX init compile)."""
    cfg = jconfig("qwen2-0.5b").reduced()
    jm = jbuild(cfg, jpolicy("fp32"), JOptions(q_chunk=16, kv_chunk=16))
    return jm, _jax_layout(model, dict(model.named_parameters()),
                           lambda t: jnp.asarray(t.detach().numpy()),
                           jnp.stack)


def _chaos_run(Server, Req, inj_mod, model_args, spec, reqs_kw, **kw):
    """Drain under ``spec``; per tick, the quarantine and the allocator's
    invariants. Returns (streams, statuses, metrics, log, quarantine)."""
    inj = inj_mod.FaultInjector(inj_mod.FaultSchedule.parse(spec[0]),
                                seed=spec[1])
    server = Server(*model_args, cap=24, batch_slots=2, fault_injector=inj,
                    **kw)
    for r in _requests(Req, **reqs_kw):
        server.submit(r)
    squeezed = []
    while server.scheduler.waiting or \
            any(s is not None for s in server.slot_req):
        server.tick()
        if server.alloc is not None:
            server.alloc.check_invariants()
            squeezed.append(len(server.alloc.quarantined))
    fin = server.scheduler.finished
    return ({r.rid: list(map(int, r.tokens_out)) for r in fin},
            {r.rid: (r.status, r.retries, r.error) for r in fin},
            {k: server.metrics[k] for k in ("retried", "failed", "completed",
                                            "admitted", "ticks")},
            list(inj.log), squeezed, server)


@pytest.fixture(scope="module")
def jax_runs(jax_model):
    """Every JAX engine of the module, run once."""
    jm, params = jax_model
    out = {}
    for name, spec, reqs_kw, kw in (
            ("corrupt", CORRUPT, CORRUPT_REQS, dict(max_retries=8)),
            ("squeeze", SQUEEZE, SQUEEZE_REQS, PAGED)):
        out[name] = _chaos_run(JServer, JRequest, jfaults, (jm, params),
                               spec, reqs_kw, **kw)[:5]
    return out


def _clean_streams(model, reqs_kw, **kw):
    server = LMServer(model, cap=24, batch_slots=2, **kw)
    for r in _requests(Request, **reqs_kw):
        server.submit(r)
    return {r.rid: list(map(int, r.tokens_out))
            for r in server.run_until_drained()}


def test_host_corruption_retried_and_equal_jax(model, jax_runs):
    """A corrupted device->host transfer is caught by the vocab range, the
    slot aborted and the request retried from scratch: the same retries,
    statuses, log and streams as the JAX engine, and the committed streams
    equal the clean drain's."""
    streams, status, metrics, log, _, server = _chaos_run(
        LMServer, Request, faults, (model,), CORRUPT, CORRUPT_REQS,
        max_retries=8)
    assert (streams, status, metrics, log) == jax_runs["corrupt"][:4]
    assert metrics["retried"] >= 1
    assert any("host_corruption flipped" in line for line in log)
    assert all(s in TERMINAL_STATUSES for s, _, _ in status.values())
    clean = _clean_streams(model, CORRUPT_REQS)
    assert {rid: clean[rid] for rid in streams} == streams
    assert all(s is None for s in server.slot_req)


def test_pool_exhaustion_equal_jax(model, jax_runs):
    """A quarantine squeeze on the paged pool: the same per-tick
    quarantine as the JAX engine, the clean drain's streams, the
    quarantine returned when the window closes, invariants every tick."""
    streams, status, metrics, log, squeezed, server = _chaos_run(
        LMServer, Request, faults, (model,), SQUEEZE, SQUEEZE_REQS, **PAGED)
    assert (streams, status, metrics, log, squeezed) == jax_runs["squeeze"]
    assert streams == _clean_streams(model, SQUEEZE_REQS, **PAGED)
    assert max(squeezed) > 0 and not server.alloc.quarantined
    assert all(s == "completed" for s, _, _ in status.values())


def test_queue_deadline_expires_waiting_requests(model, jax_model):
    """A zero queue TTL retires every request before admission, as in the
    JAX engine (whose drain then never compiles a step); a roomy TTL
    completes them."""
    out = []
    for Server, Req, args in ((LMServer, Request, (model,)),
                              (JServer, JRequest, jax_model)):
        server = Server(*args, cap=24, batch_slots=1,
                        default_queue_ttl_s=0.0)
        reqs = _requests(Req, 4, [6], max_tokens=3)
        for r in reqs:
            server.submit(r)
        finished = server.run_until_drained()
        out.append(([(r.rid, r.status, r.error, r.t_admit) for r in finished],
                    {k: server.metrics[k] for k in (
                        "timed_out", "completed", "admitted", "ticks")},
                    server.scheduler.latency_summary()))
    assert out[0] == out[1]
    assert all(s == "timed_out" for _, s, _, _ in out[0][0])
    assert out[0][1]["timed_out"] == 4
    roomy = LMServer(model, cap=24, batch_slots=1, default_queue_ttl_s=600.0)
    reqs = _requests(Request, 3, [6], max_tokens=3)
    for r in reqs:
        roomy.submit(r)
    roomy.run_until_drained()
    assert all(r.status == "completed" for r in reqs)


def test_decode_deadline_aborts_mid_flight_and_frees_blocks(model):
    """A TTL expiring mid-decode retires the requests as timed_out, clears
    their slots and device active bits, and returns their blocks (shared
    prefix refcounts included)."""
    server = LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                      block_size=4, n_blocks=32, prefix_cache=True)
    shared = np.random.default_rng(0).integers(0, 256, 8).astype(np.int32)
    reqs = [Request(rid=i, prompt=shared.copy(), max_tokens=12)
            for i in range(2)]
    for r in reqs:
        server.submit(r)
    server.tick()
    for r in reqs:
        r.ttl_s = 1e-9
    finished = server.run_until_drained()
    assert {r.rid for r in finished} == {0, 1}
    assert all(r.status == "timed_out" and r.error for r in reqs)
    assert all(s is None for s in server.slot_req)
    assert not bool(server.state["active"].any())
    server.alloc.check_invariants()
    assert server.alloc.used_count == 0
    assert server.metrics["timed_out"] == 2


def test_admission_cap_rejects_with_retry_after(model, jax_model):
    """The queue cap refuses the same requests with the same retry-after
    hints as the JAX engine; the admitted ones complete."""
    out = []
    for Server, Req, args in ((LMServer, Request, (model,)),
                              (JServer, JRequest, jax_model)):
        server = Server(*args, cap=24, batch_slots=1, max_queue_depth=2)
        rejected = []
        for r in _requests(Req, 5, [6], max_tokens=3):
            try:
                server.submit(r)
            except AdmissionRejected as e:
                rejected.append((r.rid, r.status, r.error, e.retry_after_s))
            except Exception as e:   # the JAX package's own class
                assert type(e).__name__ == "AdmissionRejected"
                rejected.append((r.rid, r.status, r.error, e.retry_after_s))
        out.append((rejected, server.metrics["rejected"]))
        if Server is LMServer:
            server.run_until_drained()
            done = server.scheduler.finished
            assert [r.status for r in done] == ["completed"] * 2
    assert out[0] == out[1]
    assert len(out[0][0]) == 3 and all(e > 0 for *_, e in out[0][0])


def test_drain_refuses_new_work_and_shutdown_flushes(model):
    server = LMServer(model, cap=24, batch_slots=2)
    reqs = _requests(Request, 2, [6], max_tokens=3)
    for r in reqs:
        server.submit(r)
    server.drain()
    assert all(r.status == "completed" for r in reqs)
    # drain() is a flush, not a teardown: admission reopens afterwards
    late = _requests(Request, 1, [6], max_tokens=3, seed=9)[0]
    late.rid += 100
    server.submit(late)
    server.drain()
    assert late.status == "completed"

    server2 = LMServer(model, cap=24, batch_slots=1)
    active = _requests(Request, 1, [6], max_tokens=3)[0]
    queued = _requests(Request, 2, [6], max_tokens=3, seed=1)
    server2.submit(active)
    for q in queued:
        q.rid += 10
        server2.submit(q)
    server2.tick()
    server2.shutdown()
    assert active.status == "completed"
    assert all(q.status == "rejected" and q.error == "server shutting down"
               for q in queued)
    with pytest.raises(AdmissionRejected, match="draining") as e:
        server2.submit(_requests(Request, 1, [6], seed=9)[0])
    assert e.value.retry_after_s > 0


def test_latency_summary_empty_and_phase_guards():
    sched = Scheduler()
    s = sched.latency_summary()
    assert len(s) == 9 and all(v == 0.0 for v in s.values())
    r = Request(rid=0, prompt=np.zeros(4, np.int32), max_tokens=4)
    r.t_enqueue = 1.0
    sched.retire(r, status="timed_out")
    assert all(v == 0.0 for v in sched.latency_summary().values())
    assert sched.metrics["timed_out"] == 1
    with pytest.raises(ValueError, match="non-terminal"):
        sched.retire(r, status="active")


def test_pipelined_worker_crash_retried_to_clean_streams(model):
    """``worker_crash`` fails the job the prefill worker picks up next:
    its requests return to the queue and complete with the clean drain's
    streams; ``retried`` counts the requests of the crashed jobs."""
    reqs_kw = dict(n=4, lens=[6, 9], max_tokens=4, seed=3)
    clean = LMServer(model, cap=24, batch_slots=2)
    for r in _requests(Request, **reqs_kw):
        clean.submit(r)
    want = {r.rid: r.tokens_out for r in clean.run_until_drained()}
    inj = faults.FaultInjector(faults.FaultSchedule.parse(
        "worker_crash@0;worker_crash@3"), seed=0)
    server = LMServer(model, cap=24, batch_slots=2, pipeline_depth=1,
                      fault_injector=inj, max_retries=4)
    try:
        for r in _requests(Request, **reqs_kw):
            server.submit(r)
        server.run_until_drained()
    finally:
        server.close()
    fin = server.scheduler.finished
    assert {r.rid: r.tokens_out for r in fin} == want
    assert all(r.status == "completed" for r in fin)
    fired = sum("worker_crash fired" in line for line in inj.log)
    assert fired == 2
    assert server.metrics["retried"] == sum(r.retries for r in fin) >= fired
    assert "injected prefill worker crash" in repr(server.last_prefill_error)
