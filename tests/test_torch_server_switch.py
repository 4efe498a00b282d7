"""PyTorch port, slice 5: ``LMServer.switch_backend`` against the JAX
engine.

Reduced qwen2 under ``mirage`` with the JAX init's weights in both
packages. Two requests are admitted, and after two ticks the engine moves
from ``mirage`` to ``fp32`` or to ``mirage_rrns`` (re-encoding the
stationary residues); each port engine's streams must equal the JAX
engine making the same switch, token for token. A switch from ``mirage``
to ``mirage`` changes no stream. The JAX engines run once per module
(``jax_streams``); the resize twins are in
``tests/test_torch_server_elastic.py``.
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
from repro_torch.runtime.server import LMServer, Request

SWITCHES = ("fp32", "mirage_rrns")


def _requests(cls, n=2, max_tokens=6, seed=9, vocab=256):
    """Two 8-token prompts, both admitted before the switch, so the JAX
    engine compiles only the new backend's tick after it."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 8).astype(np.int32),
                max_tokens=max_tokens) for i in range(n)]


def _submit(server, reqs, ticks=2):
    for r in reqs:
        server.submit(r)
    for _ in range(ticks):
        server.tick()
    return server


def _streams(server):
    return {r.rid: list(map(int, r.tokens_out))
            for r in server.run_until_drained()}


@pytest.fixture(scope="module")
def jax_model():
    jm = jbuild(jconfig("qwen2-0.5b").reduced(), jpolicy("mirage"),
                JOptions(q_chunk=16, kv_chunk=16))
    return jm, jm.init(jax.random.PRNGKey(0))


def _port_model(jax_model):
    tm = build_model(get_config("qwen2-0.5b").reduced(), get_policy("mirage"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jax_model[1]))
    return tm


@pytest.fixture(scope="module")
def jax_streams(jax_model):
    jm, params = jax_model
    out = {}
    for target in SWITCHES:
        s = _submit(JServer(jm, params, cap=24, batch_slots=2),
                    _requests(JRequest))
        s.switch_backend(jpolicy(target))
        out[target] = _streams(s)
    return out


def _stationary(model):
    return [m for m in model.modules()
            if getattr(m, "stationary", None) is not None]


@pytest.mark.parametrize("target", SWITCHES)
def test_switch_backend_at_tick_2(jax_model, jax_streams, target):
    """``mirage`` -> ``target`` after two ticks: the JAX engine's streams.
    Into ``mirage_rrns`` the engine programs stationary residues and opens
    health counters; into ``fp32`` it has neither."""
    tm = _port_model(jax_model)
    server = _submit(LMServer(tm, cap=24, batch_slots=2),
                     _requests(Request))
    assert not server.stationary_weights and not _stationary(tm)
    server.switch_backend(get_policy(target))
    assert tm.policy.mode == target
    rrns = target == "mirage_rrns"
    assert server.stationary_weights == rrns
    assert bool(_stationary(tm)) == rrns
    assert ("health" in server.state) == rrns
    assert _streams(server) == jax_streams[target]
    if rrns:
        h = server.health_snapshot()
        assert h["rrns_uncorrected"] == 0 and h["rrns_corrected"] == 0
        # and back: the residues are cleared again
        server.switch_backend(get_policy("mirage"))
        assert not _stationary(tm) and "health" not in server.state


def test_switch_to_same_policy_keeps_streams(jax_model):
    """A switch from ``mirage`` to ``mirage`` mid-flight changes nothing a
    stream can see."""
    want = _streams(_submit(LMServer(_port_model(jax_model), cap=24,
                                     batch_slots=2), _requests(Request)))
    tm = _port_model(jax_model)
    server = _submit(LMServer(tm, cap=24, batch_slots=2), _requests(Request))
    server.switch_backend(get_policy("mirage"))
    assert _streams(server) == want
