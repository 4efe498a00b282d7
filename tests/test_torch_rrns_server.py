"""PyTorch port, RNS/RRNS slice: the serving engine under the RNS-family
backends against the JAX engine, at reduced size (qwen2-0.5b ``.reduced()``:
4 layers, d_model 64).

Greedy token streams must be identical to the JAX engine's under
``mirage_rns`` and clean ``mirage_rrns``, both engines programming
stationary weights (exact: every GEMM output equals the JAX one up to the
order of the cross-group f32 sum, and the test's greedy choices are not at
ties). Under a noisy channel the two packages draw different numbers, so
the port is held to determinism per seed and to the health counters'
contract instead. ``load_jax_stationary`` is held bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from repro.configs import get_config as jconfig
from repro.core import gemm as jgemm
from repro.core import stationary as jstationary
from repro.core.backends import mirage_rrns as jmirage_rrns
from repro.analog import channel as jchannel
from repro.core.precision import get_policy as jpolicy
from repro.models import build_model as jbuild
from repro.models.lm import LMCallOptions as JOptions
from repro.runtime.server import LMServer as JServer
from repro.runtime.server import Request as JRequest
from repro_torch.analog import channel
from repro_torch.configs import get_config
from repro_torch.core import gemm, stationary
from repro_torch.core.backends import grouped
from repro_torch.core.backends import mirage_rrns as tmirage_rrns
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params, load_jax_stationary
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.obs import health
from repro_torch.runtime.server import LMServer, Request


def _requests(cls, n, lens, max_tokens=5, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, lens[i % len(lens)]
                                           ).astype(np.int32),
                max_tokens=max_tokens) for i in range(n)]


def _drain(server, reqs):
    for r in reqs:
        server.submit(r)
    return {r.rid: r.tokens_out for r in server.run_until_drained()}


def _jax_model(policy):
    cfg = jconfig("qwen2-0.5b").reduced()
    jm = jbuild(cfg, policy, JOptions(q_chunk=16, kv_chunk=16))
    return jm, jm.init(jax.random.PRNGKey(0))


def _port_model(policy, params):
    tm = build_model(get_config("qwen2-0.5b").reduced(), policy,
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return tm


@pytest.fixture(scope="module")
def params():
    return _jax_model(jpolicy("mirage_rns"))[1]


@pytest.mark.parametrize("mode", ["mirage_rns", "mirage_rrns"])
def test_greedy_streams_equal_jax_engine(mode, params):
    jm, _ = _jax_model(jpolicy(mode))
    jserver = JServer(jm, params, cap=24, batch_slots=3)
    assert jserver.stationary_weights
    # one prompt bucket and one admission wave: one JAX prefill compile
    want = _drain(jserver, _requests(JRequest, 3, [8, 6, 7]))
    server = LMServer(_port_model(get_policy(mode), params), cap=24,
                      batch_slots=3)
    assert server.stationary_weights
    got = _drain(server, _requests(Request, 3, [8, 6, 7]))
    assert set(got) == set(range(3))
    assert got == want


def test_stationary_weights_option(params):
    """Auto-on for the RNS backends (installed on every Dense), off leaves
    per-call encoding with the same streams, refused where unsupported."""
    model = _port_model(get_policy("mirage_rns"), params)
    auto = LMServer(model, cap=24, batch_slots=2)
    assert auto.stationary_weights
    dense = [m for m in model.modules() if hasattr(m, "stationary")]
    assert len(dense) == 7 * 4 and all(
        isinstance(m.stationary, stationary.StationaryResidues)
        for m in dense)
    assert not hasattr(model.embed, "stationary")  # the tied head stays raw
    a = _drain(auto, _requests(Request, 3, [8, 6], seed=2))
    off = LMServer(model, cap=24, batch_slots=2, stationary_weights=False)
    assert not off.stationary_weights
    assert all(m.stationary is None for m in dense)
    assert _drain(off, _requests(Request, 3, [8, 6], seed=2)) == a
    fast = _port_model(get_policy("mirage"), params)
    assert not LMServer(fast, cap=24, batch_slots=2).stationary_weights
    with pytest.raises(ValueError, match="stationary"):
        LMServer(fast, cap=24, batch_slots=2, stationary_weights=True)


def _noisy_server(params, seed, snr_db=20.0):
    policy = get_policy("mirage_rrns", snr_db=snr_db, noise_seed=seed)
    return LMServer(_port_model(policy, params), cap=24, batch_slots=2)


def test_noisy_rrns_deterministic_per_seed_with_health(params):
    runs = []
    for seed in (7, 7, 8):
        s = _noisy_server(params, seed)
        toks = _drain(s, _requests(Request, 3, [8, 6], max_tokens=4, seed=3))
        runs.append((toks, s.health_snapshot()))
    (a, ha), (b, hb), (_, hc) = runs
    assert a == b and ha == hb
    assert ha != hc
    spec = health.spec(get_policy("mirage_rrns", snr_db=20.0))
    assert set(ha) == set(spec) == {"rrns_corrected", "rrns_uncorrected",
                                    "detector_flips"}
    assert len(ha["detector_flips"]) == 5 and min(ha["detector_flips"]) > 0
    assert ha["rrns_corrected"] > 0
    # at 20 dB the channel is past the correction radius some of the time;
    # a clean channel reports nothing
    clean = LMServer(_port_model(get_policy("mirage_rrns"), params), cap=24,
                     batch_slots=2)
    _drain(clean, _requests(Request, 2, [8], max_tokens=3))
    assert clean.health_snapshot() == {"rrns_corrected": 0,
                                       "rrns_uncorrected": 0}
    rns = LMServer(_port_model(get_policy("mirage_rns"), params), cap=24,
                   batch_slots=2)
    assert rns.health_snapshot() == {} and "health" not in rns.state


def test_load_jax_stationary_bitwise(params):
    """A JAX-programmed tree (with drift) carried across: the same residues,
    and the port's backend reads them to the JAX backend's residues."""
    pol_kw = dict(phase_drift_sigma=0.6, noise_seed=11, dac_bits=5)
    jp, p = jpolicy("mirage_rrns", **pol_kw), get_policy("mirage_rrns",
                                                         **pol_kw)
    enc = jax.jit(jstationary.encode_stationary_params,
                  static_argnums=1)(params, jp)
    model = _port_model(p, params)
    carried = load_jax_stationary(model, jax.tree_util.tree_map(np.asarray,
                                                                enc))
    assert len(carried) == 7 * 4
    jsr = enc["layers"]["attn"]["q"]["w"]
    sr = carried["layers.2.attn.q"]
    np.testing.assert_array_equal(sr.residues.numpy(),
                                  np.asarray(jsr.residues[2]))
    np.testing.assert_array_equal(sr.scale.numpy(), np.asarray(jsr.scale[2]))
    jsr2 = jax.tree_util.tree_map(lambda a: a[2], jsr)
    x = np.random.default_rng(4).normal(size=(3, 64)).astype(np.float32)
    moduli = sr.moduli
    cfg = channel.AnalogChannelConfig.from_policy(p)
    xr, wr, _, _, _ = tmirage_rrns._prepare(torch.from_numpy(x), sr, p,
                                            moduli, cfg, None, True)
    jxr, jwr, _, _, _ = jmirage_rrns._prepare(
        jnp.asarray(x), jsr2, jp, moduli,
        jchannel.AnalogChannelConfig.from_policy(jp), None, True)
    np.testing.assert_array_equal(
        grouped.residue_dots(xr, wr, moduli).numpy(),
        np.asarray(jmirage_rrns._residue_dots_jnp(jxr, jwr, moduli)))
    got = gemm.mirage_matmul_nograd(torch.from_numpy(x), sr, p).numpy()
    want = np.asarray(jgemm.mirage_matmul_nograd(jnp.asarray(x), jsr2, jp))
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=2e-5 * np.abs(want).max())
    stationary.install(model, carried)
    assert model.layers[2].attn.q.stationary is sr


def test_serve_launcher_snr_flags(capsys):
    assert serve.main(["--reduced", "--device", "cpu", "--policy",
                       "mirage_rrns", "--snr-db", "24", "--noise-seed", "3",
                       "--requests", "2", "--prompt-len", "6",
                       "--max-tokens", "3", "--slots", "2"]) == 0
    out = capsys.readouterr().out
    assert "served 2 requests" in out
    assert "analog health" in out and "rrns_corrected" in out
