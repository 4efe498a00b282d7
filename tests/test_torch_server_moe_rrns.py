"""PyTorch port: the serving engine over the reduced MoE configs (8
experts, top-2, d_model 64) under ``mirage_rrns``, against the JAX engine.

At 60 dB detector SNR every RRNS decode corrects exactly, so the greedy
streams do not depend on which noise was drawn, and no residue moves: the
port's engines must give the JAX dense engine's streams token for token
and its health counters. The default engine encodes the weights per call
(the JAX engine's rule for the MoE family); ``stationary_weights=True``
programs every Dense weight and expert stack once, the router left raw.
``switch_backend`` takes an engine from ``mirage`` to ``mirage_rrns`` and
back, each drain against the JAX engine under that policy. A stationary
tree the JAX package programmed (drift per layer and expert) carries over
bit for bit. The weights are the JAX package's ``init``, loaded into the
port; JAX compiles are shared through a module-scoped fixture.
"""

import numpy as np
import jax
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core import stationary as jstationary
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime.server import LMServer as JServer
from repro.runtime.server import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core import stationary
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params, load_jax_stationary
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.server import LMServer, Request

ARCHS = ["qwen3-moe-30b-a3b", "mixtral-8x7b"]
SNR = dict(snr_db=60.0, noise_seed=7)
OPTS = dict(q_chunk=16, kv_chunk=16)


def _requests(cls):
    """Two requests of one prompt length: one JAX prefill compile."""
    rng = np.random.default_rng(9)
    return [cls(rid=i, prompt=rng.integers(0, 256, 6).astype(np.int32),
                max_tokens=3) for i in range(2)]


def _drain(server):
    for r in _requests(Request if isinstance(server, LMServer)
                       else JRequest):
        server.submit(r)
    return {r.rid: r.tokens_out for r in server.run_until_drained()}


def _port(served, policy):
    """The port's reduced model holding the JAX engine's weights."""
    tm = build_model(get_config(served["arch"]).reduced(), policy,
                     LMCallOptions(**OPTS), device="cpu")
    load_jax_params(tm, served["params"])
    return tm


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One reduced MoE config: the port's weights in the JAX layout, and
    the JAX dense engine's streams under ``mirage`` and under
    ``mirage_rrns`` at 60 dB (with its health counters)."""
    arch = request.param
    out = {"arch": arch}
    for mode, kw in (("mirage", {}), ("mirage_rrns", SNR)):
        jm = jbuild(jconfig(arch).reduced(), jpolicy(mode, **kw),
                    JOptions(**OPTS))
        if mode == "mirage":
            params = jm.init(jax.random.PRNGKey(0))
            out["params"] = jax.tree_util.tree_map(np.asarray, params)
        js = JServer(jm, params, cap=20, batch_slots=2)
        assert not js.stationary_weights
        out[mode] = _drain(js)
        out[f"{mode}_health"] = js.health_snapshot()
    return out


@pytest.mark.parametrize("stationary_weights", [None, True])
def test_rrns_engine_equals_jax_dense_engine(served, stationary_weights):
    """The greedy streams and health counters of the JAX engine, with the
    default engine (per-call encoding on a MoE model) and with every
    weight programmed once."""
    tm = _port(served, get_policy("mirage_rrns", **SNR))
    server = LMServer(tm, cap=20, batch_slots=2,
                      stationary_weights=stationary_weights)
    assert server.stationary_weights == bool(stationary_weights)
    moes = [m for _, m in stationary._moe_modules(tm)]
    assert len(moes) == tm.cfg.n_layers
    for m in moes:
        assert m.router.stationary is None
        if stationary_weights:
            assert set(m.stationary) == set(stationary.MOE_STACKS)
            assert m.stationary["up"].n_experts == tm.cfg.n_experts
            assert m.stationary["down"].residues.shape[:2] == \
                (5, tm.cfg.n_experts)
        else:
            assert m.stationary is None
    assert _drain(server) == served["mirage_rrns"]
    health = server.health_snapshot()
    assert health == served["mirage_rrns_health"]
    assert set(health) == {"rrns_corrected", "rrns_uncorrected",
                           "detector_flips"}
    assert health["rrns_uncorrected"] == 0


def test_switch_backend_to_rrns_and_back(served):
    """An engine built under ``mirage`` drains the JAX ``mirage`` streams;
    switched to ``mirage_rrns`` (the auto rule keeps per-call encoding for
    the MoE family) it drains the JAX ``mirage_rrns`` streams with its
    health counters, and switched back the ``mirage`` ones again. An
    engine that programs its weights reprograms the expert stacks at each
    switch."""
    tm = _port(served, get_policy("mirage"))
    server = LMServer(tm, cap=20, batch_slots=2)
    assert _drain(server) == served["mirage"]
    server.switch_backend(get_policy("mirage_rrns", **SNR))
    assert not server.stationary_weights and tm.policy.mode == "mirage_rrns"
    assert _drain(server) == served["mirage_rrns"]
    assert server.health_snapshot() == served["mirage_rrns_health"]
    server.switch_backend(get_policy("mirage"))
    assert server.health_snapshot() == {} and tm.policy.mode == "mirage_fast"
    assert _drain(server) == served["mirage"]
    tm.policy = get_policy("mirage_rns")
    programmed = LMServer(tm, cap=20, batch_slots=2,
                          stationary_weights=True)
    assert tm.layers[0].moe.stationary["gate"].moduli == (31, 32, 33)
    programmed.switch_backend(get_policy("mirage"))
    assert tm.layers[0].moe.stationary is None
    programmed.switch_backend(get_policy("mirage_rrns", **SNR))
    assert tm.layers[0].moe.stationary["gate"].moduli == \
        (31, 32, 33, 37, 41)
    assert _drain(programmed) == served["mirage_rrns"]


def test_load_jax_stationary_carries_expert_stacks(served):
    """A JAX-programmed MoE tree (drift per layer, then per expert)
    carried across: each layer's stacks in the port's (n_mod, E, ...)
    layout, bit for bit, installed on the MoE module; the router stays
    raw."""
    if served["arch"] != ARCHS[0]:
        pytest.skip("one config carries the layout")
    tm = _port(served, get_policy("mirage"))
    jp = jpolicy("mirage_rrns", phase_drift_sigma=0.5, noise_seed=13)
    moe_tree = {"layers": {"moe": served["params"]["layers"]["moe"]}}
    enc = jax.jit(lambda t: jstationary.encode_stationary_params(
        t, jp))(moe_tree)
    carried = load_jax_stationary(tm, jax.tree_util.tree_map(np.asarray,
                                                             enc))
    assert set(carried) == {f"layers.{i}.moe.{k}"
                            for i in range(tm.cfg.n_layers)
                            for k in stationary.MOE_STACKS}
    jsr = enc["layers"]["moe"]["down"]
    sr = carried["layers.1.moe.down"]
    np.testing.assert_array_equal(
        sr.residues.numpy(), np.moveaxis(np.asarray(jsr.residues[1]), 0, 1))
    np.testing.assert_array_equal(sr.scale.numpy(), np.asarray(jsr.scale[1]))
    assert not torch.equal(sr.residues[:, 0], sr.residues[:, 1])
    stationary.install(tm, carried)
    assert tm.layers[1].moe.stationary["down"] is sr
    stationary.install(tm, None)
    assert tm.layers[1].moe.stationary is None
