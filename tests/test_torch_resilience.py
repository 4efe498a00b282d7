"""PyTorch port, slice 7: the SNR guardian and crash-consistent snapshots
against the JAX package (``tests/test_resilience.py``'s twin), on the
reduced qwen2 engine (weights drawn by the port, handed to JAX).

The collapse gate: under ``snr_drop`` at scale 1e6 from tick 0 the
guardian's verify-before-commit windows roll back every window with an
uncorrected RRNS decode, walk the ladder r=2 -> r=4 -> fp32 and stream
exactly the fp32 engine's tokens, which are held to the JAX fp32 engine's;
the transitions name the JAX ladder's rungs (the uncorrected counts in
them follow each package's own noise draws). The JAX guardian's drain is
not rerun here: its recompiles per rung took 370 s of one worker
(``tests/test_resilience.py``). Without the guardian the collapse streams
garbage. Snapshots resume token-identical streams in a fresh engine:
dense and paged + prefix under fp32 (held to JAX's streams), and under a
noisy channel, whose per-tick draws come back with the generators'
states. Every JAX engine of the module runs once (``jax_streams``).
"""

import pickle
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime import resilience as jresilience
from repro.runtime.server import LMServer as JServer
from repro.runtime.server import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core.precision import get_policy
from repro_torch.interop import _jax_layout
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.faults import FaultInjector, FaultSchedule
from repro_torch.runtime.resilience import (SNRGuardian, _rung_name,
                                            degradation_ladder)
from repro_torch.runtime.server import LMServer, Request

COLLAPSE = "snr_drop@0:100000:scale=1e6"   # -120 dB: nothing survives
PAGED_PREFIX = dict(cache_layout="paged", block_size=4, n_blocks=48,
                    prefix_cache=True)


def _requests(cls=Request, n=4, lens=(6, 9), max_tokens=4, seed=3,
              vocab=256):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, lens[i % len(lens)]
                                           ).astype(np.int32),
                max_tokens=max_tokens) for i in range(n)]


def _streams(server, reqs, runner=None):
    for r in reqs:
        server.submit(r)
    (runner or server.run_until_drained)()
    return {r.rid: list(map(int, r.tokens_out))
            for r in server.scheduler.finished}


@pytest.fixture(scope="module")
def model():
    """The port's reduced qwen2, weights drawn from seed 0; each engine
    sets its policy (the guardian switches it)."""
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


@pytest.fixture(scope="module")
def jax_streams(jax_model):
    """The JAX fp32 engine's streams: the gate's requests, and the
    snapshot requests on the dense and the paged + prefix engines."""
    jm, params = jax_model
    return {
        "gate": _streams(JServer(jm, params, cap=24, batch_slots=2),
                         _requests(JRequest, n=2)),
        "dense": _streams(JServer(jm, params, cap=24, batch_slots=2),
                          _requests(JRequest, max_tokens=6)),
        "paged": _streams(JServer(jm, params, cap=24, batch_slots=2,
                                  **PAGED_PREFIX),
                          _requests(JRequest, max_tokens=6))}


def _engine(model, policy, **kw):
    model.policy = policy
    return LMServer(model, cap=24, batch_slots=2, **kw)


RRNS60 = get_policy("mirage_rrns", snr_db=60.0, noise_seed=7)


# --------------------------------------------------------------------------
# ladder and guardian preconditions
# --------------------------------------------------------------------------

def test_degradation_ladder_equals_jax():
    pol = RRNS60
    jpol = jpolicy("mirage_rrns", snr_db=60.0, noise_seed=7)
    ladder, jladder = degradation_ladder(pol, max_r=4), \
        jresilience.degradation_ladder(jpol, max_r=4)
    assert [p.mode for p in ladder] == [p.mode for p in jladder] == \
        ["mirage_rrns", "mirage_rrns", "fp32"]
    assert ladder[0] is pol
    assert [tuple(p.redundant_moduli) for p in ladder] == \
        [tuple(p.redundant_moduli) for p in jladder]
    assert len(ladder[1].redundant_moduli) == 4
    assert ladder[1].k == pol.k and ladder[1].moduli == pol.moduli
    assert [_rung_name(p) for p in ladder] == \
        [jresilience._rung_name(p) for p in jladder]
    assert [p.snr_db for p in ladder] == [60.0] * 3
    with pytest.raises(ValueError, match="mirage_rrns"):
        degradation_ladder(get_policy("fp32"))


def test_guardian_preconditions(model):
    plain = _engine(model, RRNS60, instrument=False)
    assert plain.health_snapshot() == {} and "health" not in plain.state
    with pytest.raises(ValueError, match="instrument"):
        SNRGuardian(plain)
    piped = _engine(model, RRNS60, pipeline_depth=1)
    try:
        with pytest.raises(ValueError, match="pipeline"):
            SNRGuardian(piped)
    finally:
        piped.close()


# --------------------------------------------------------------------------
# the chaos parity gate
# --------------------------------------------------------------------------

def _rungs(transitions):
    """Each transition with its uncorrected count masked."""
    return [re.sub(r": \d+ uncorrected", ": N uncorrected", t)
            for t in transitions]


def test_chaos_parity_guardian_vs_fp32(model, jax_streams):
    want = jax_streams["gate"]
    assert _streams(_engine(model, get_policy("fp32")),
                    _requests(n=2)) == want

    # guardian ON: every committed window certifies rrns_uncorrected == 0,
    # and under a from-tick-0 collapse every committed window ran on the
    # fp32 rung, so the streams are exactly the fp32 engine's
    inj = FaultInjector(FaultSchedule.parse(COLLAPSE), seed=0)
    guarded = _engine(model, RRNS60, fault_injector=inj)
    guardian = SNRGuardian(guarded, window=2, cooldown=10_000)
    got = _streams(guarded, _requests(n=2),
                   runner=guardian.run_until_drained)
    assert got == want
    assert guardian.level == len(guardian.ladder) - 1
    jladder = jresilience.degradation_ladder(
        jpolicy("mirage_rrns", snr_db=60.0, noise_seed=7))
    assert _rungs(guardian.transitions) == [
        f"tick 0: N uncorrected in window -> escalate to "
        f"{jresilience._rung_name(p)}" for p in jladder[1:]]
    assert all(r.status == "completed" for r in guarded.scheduler.finished)
    assert inj.log == ["tick 0: snr_drop enters window"]

    # guardian OFF: the same collapse streams uncorrectable garbage (the
    # first two tokens of each stream suffice: greedy streams are prefixes)
    naked = _engine(model, RRNS60, fault_injector=FaultInjector(
        FaultSchedule.parse(COLLAPSE), seed=0))
    assert _streams(naked, _requests(n=2, max_tokens=2)) != \
        {rid: toks[:2] for rid, toks in want.items()}
    assert naked.health_snapshot()["rrns_uncorrected"] > 0


def test_guardian_recovers_after_transient_collapse(model):
    """A bounded SNR hole: the guardian escalates through it, then the
    cooldown probe steps back down once windows verify clean again."""
    inj = FaultInjector(FaultSchedule.parse("snr_drop@0:4:scale=1e6"),
                        seed=0)
    srv = _engine(model, RRNS60, fault_injector=inj)
    guardian = SNRGuardian(srv, window=2, cooldown=1)
    reqs = _requests(n=2)
    _streams(srv, reqs, runner=guardian.run_until_drained)
    assert all(r.status == "completed" for r in reqs)
    assert any("escalate" in t for t in guardian.transitions)
    assert any("probe down" in t for t in guardian.transitions)
    assert guardian.level < len(guardian.ladder) - 1


def test_channel_faults_inside_the_correction_radius(model):
    """r=2 corrects one residue error an output: width-1 burst storms and
    a stuck redundant channel leave every decode corrected, and the
    streams equal the clean channel's; the warmed engine (warmup() with
    the injector, every step under identity controls) streams what the
    cold one does, reading the live controls each tick."""
    reqs = dict(n=2, max_tokens=3)
    clean = _streams(_engine(model, get_policy("mirage_rrns", noise_seed=7),
                             buckets=(16,)), _requests(**reqs))
    spec = "burst_storm@0:1:rate=0.2,width=1;stuck_channel@1:100:channel=4"
    runs = []
    for warm in (False, True):
        inj = FaultInjector(FaultSchedule.parse(spec), seed=0)
        srv = _engine(model, RRNS60, fault_injector=inj, buckets=(16,))
        if warm:
            srv.warmup()
        runs.append((_streams(srv, _requests(**reqs)),
                     srv.health_snapshot(), inj.log))
    (cold, h, log), (warmed, hw, wlog) = runs
    assert cold == clean == warmed
    assert h["rrns_uncorrected"] == 0 and h["rrns_corrected"] > 0
    assert h == hw and log == wlog
    assert any("stuck_channel enters" in line for line in log)


# --------------------------------------------------------------------------
# crash-consistent snapshots: fresh-engine resume
# --------------------------------------------------------------------------

def _snapshot_resume(model, policy, kw, reqs, ticks=3):
    """The uninterrupted drain, and a drain snapshotted after ``ticks``
    ticks (through pickle) and resumed by a fresh engine."""
    want = _streams(_engine(model, policy, **kw), _requests(**reqs))
    half = _engine(model, policy, **kw)
    for r in _requests(**reqs):
        half.submit(r)
    for _ in range(ticks):
        half.tick()
    snap = pickle.loads(pickle.dumps(half.snapshot()))
    fresh = _engine(model, policy, **kw)
    fresh.restore(snap)
    fresh.run_until_drained()
    got = {r.rid: list(map(int, r.tokens_out))
           for r in fresh.scheduler.finished}
    if fresh.alloc is not None:
        fresh.alloc.check_invariants()
        assert fresh.alloc.used_count == 0
    return want, got, fresh, half


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_snapshot_restore_fresh_engine(model, jax_streams, layout):
    kw = PAGED_PREFIX if layout == "paged" else {}
    want, got, fresh, _ = _snapshot_resume(model, get_policy("fp32"), kw,
                                           dict(max_tokens=6))
    assert got == want == jax_streams[layout]
    assert fresh.metrics["completed"] == 4


def test_snapshot_restore_under_noise(model):
    """At 20 dB the streams depend on each tick's draws (uncorrected
    decodes occur): a fresh engine restored from the snapshot draws the
    uninterrupted engine's numbers, health counters included."""
    noisy = get_policy("mirage_rrns", snr_db=20.0, noise_seed=7)
    want, got, fresh, half = _snapshot_resume(model, noisy, {},
                                              dict(n=2), ticks=2)
    assert got == want
    half.run_until_drained()
    assert fresh.health_snapshot() == half.health_snapshot()
    assert fresh.health_snapshot()["rrns_uncorrected"] > 0


def test_restore_refuses_mismatches(model):
    srv = _engine(model, get_policy("fp32"))
    snap = srv.snapshot()
    with pytest.raises(ValueError, match="slots"):
        LMServer(model, cap=24, batch_slots=3).restore(snap)
    with pytest.raises(ValueError, match="version"):
        srv.restore({**snap, "version": 0})
