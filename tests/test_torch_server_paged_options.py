"""PyTorch port, slice 5: speculative decoding, the paged engine's options
together, a sliding window and the noisy channel, against the JAX engine.

Reduced qwen2 with the JAX init's weights in both packages:

  * speculative decoding alone serves ``tests/test_spec_prefix.py:59``'s
    workload, and chunked prefill, the prefix cache and speculative
    decoding at once ``tests/test_spec_prefix.py:95``'s, to the JAX
    engine's streams, token for token (``mirage``);
  * with ``sliding_window = 16`` set on both configs
    (``dataclasses.replace``), the paged engine frees blocks behind the
    window mid-flight and still emits the JAX paged engine's tokens;
  * under ``mirage_rrns`` at 28 dB each seed gives the same streams and
    health counters twice (prefix, speculative and chunked engines).
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
from repro_torch.core.precision import get_policy
from repro_torch.interop import load_jax_params
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.server import LMServer, Request


def _shared(cls, n, prefix_len, total_len, max_tokens=4, seed=3, vocab=256):
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
    if server.alloc is not None:
        server.alloc.check_invariants()
        assert server.alloc.used_count == 0
    return out


def _pair(jpol, tpol, **cfg_changes):
    jcfg = dataclasses.replace(jconfig("qwen2-0.5b").reduced(), **cfg_changes)
    tcfg = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                               **cfg_changes)
    jm = jbuild(jcfg, jpol, JOptions(q_chunk=16, kv_chunk=16))
    params = jm.init(jax.random.PRNGKey(0))
    tm = build_model(tcfg, tpol, LMCallOptions(q_chunk=16, kv_chunk=16),
                     device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


ALL_THREE = dict(cache_layout="paged", block_size=4, prefill_chunk=4,
                 prefix_cache=True, spec_k=3)


@pytest.fixture(scope="module")
def pair():
    return _pair(jpolicy("mirage"), get_policy("mirage"))


def test_spec_equals_jax_engine(pair):
    jm, params, tm = pair
    mk = lambda cls: _shared(cls, 4, 8, 12, max_tokens=4)
    opts = dict(cache_layout="paged", block_size=4, spec_k=3)
    want = _drain(JServer(jm, params, cap=24, batch_slots=2, **opts),
                  mk(JRequest))
    s = LMServer(tm, cap=24, batch_slots=2, **opts)
    assert _drain(s, mk(Request)) == want and len(want) == 4
    m = s.metrics
    assert m["spec_ticks"] >= 1 and m["decode_steps"] == 0
    assert m["spec_accepted"] >= m["spec_slot_ticks"]


def test_all_three_options_equal_jax_engine(pair):
    jm, params, tm = pair
    mk = lambda cls: _shared(cls, 5, 8, 13, max_tokens=5, seed=6)
    want = _drain(JServer(jm, params, cap=32, batch_slots=2, **ALL_THREE),
                  mk(JRequest))
    s = LMServer(tm, cap=32, batch_slots=2, **ALL_THREE)
    assert _drain(s, mk(Request)) == want and len(want) == 5
    m = s.metrics
    assert m["prefix_hits"] >= 1 and m["spec_ticks"] >= 1
    assert m["prefill_chunks"] >= 1 and m["prefill_batches"] == 0
    # chunk steps never decode: the slots mid-prefill stay frozen
    assert _drain(LMServer(tm, cap=32, batch_slots=2), mk(Request)) == want


def _run_window(server, req):
    server.submit(req)
    trimmed = 0
    for _ in range(200):
        if not server.scheduler.waiting and server.slot_req[0] is None:
            break
        server.tick()
        if server.alloc is not None:
            trimmed = max(trimmed, int(server.alloc.lo[0]))
    return req.tokens_out, trimmed


def test_sliding_window_trim_equals_jax_engine():
    """qwen2 with a 16-token window: blocks wholly behind the window go
    back to the pool mid-flight, and the stream is the JAX paged engine's
    (and the port's dense ring's)."""
    jm, params, tm = _pair(jpolicy("mirage"), get_policy("mirage"),
                           sliding_window=16)
    mk = lambda cls: _shared(cls, 1, 4, 8, max_tokens=30, seed=7)[0]
    kw = dict(cache_layout="paged", block_size=4)
    want, jtrim = _run_window(JServer(jm, params, cap=48, batch_slots=1,
                                      **kw), mk(JRequest))
    s = LMServer(tm, cap=48, batch_slots=1, **kw)
    got, trimmed = _run_window(s, mk(Request))
    assert got == want and len(got) == 30
    assert trimmed == jtrim and trimmed >= 2
    s.alloc.check_invariants()
    assert s.alloc.used_count == 0
    dense, _ = _run_window(LMServer(tm, cap=48, batch_slots=1), mk(Request))
    assert dense == want


@pytest.mark.parametrize("opts", [dict(prefix_cache=True), dict(spec_k=3),
                                  dict(prefill_chunk=4)])
def test_rrns_28db_streams_deterministic_per_seed(opts):
    policy = get_policy("mirage_rrns", snr_db=28.0, noise_seed=9)
    jm = jbuild(jconfig("qwen2-0.5b").reduced(), jpolicy("mirage_rrns"),
                JOptions(q_chunk=16, kv_chunk=16))
    tm = build_model(get_config("qwen2-0.5b").reduced(), policy,
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))))
    runs = []
    for _ in range(2):
        s = LMServer(tm, cap=24, batch_slots=2, cache_layout="paged",
                     block_size=4, **opts)
        runs.append((_drain(s, _shared(Request, 3, 8, 12, seed=8)),
                     s.health_snapshot()))
    assert runs[0] == runs[1]
    assert runs[0][1]["rrns_corrected"] > 0
