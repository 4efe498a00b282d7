"""PyTorch port, slice 5: the paged serving engine against the JAX engine.

Reduced qwen2 under ``mirage`` with the JAX init's weights in both
packages. Each engine option (paged KV, chunked prefill, the prefix cache,
speculative decoding) serves the workloads of
``tests/test_serving_paged.py:52`` and ``tests/test_spec_prefix.py:59`` in
both packages, and the greedy streams must be equal token for token; so
must the per-slot oracle's (speculative decoding alone, all three options
at once, sliding windows and the noisy channel:
``tests/test_torch_server_paged_options.py``; the exact channel at 60 dB:
``tests/test_torch_server_paged_rrns.py``). After
every drain the port's block pool is empty and its invariants hold. The
JAX engines run once per module
(``jax_streams``); the rest covers the engine's own semantics on the port:
the constructor's checks, TTFT of chunked and full-hit admissions,
copy-on-write isolation, head-of-line queueing on a small pool, the one
host transfer per tick, and the launcher's flags.
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
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.server import (LMServer, PerSlotLMServer, Request,
                                        _lookup_draft)


def _requests(cls, n, lens, max_tokens=4, seed=0, vocab=256):
    """``tests/test_serving_paged.py``'s ``_mk_requests``."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, lens[i % len(lens)]
                                           ).astype(np.int32),
                max_tokens=max_tokens) for i in range(n)]


def _shared(cls, n, prefix_len, total_len, max_tokens=4, seed=3, vocab=256):
    """``tests/test_spec_prefix.py``'s ``_shared_requests``: n prompts
    sharing their first ``prefix_len`` tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, prefix_len).astype(np.int32)
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, total_len - prefix_len).astype(np.int32)
        out.append(cls(rid=i, prompt=np.concatenate([prefix, tail]),
                       max_tokens=max_tokens))
    return out


#: workload -> (request maker, engine kwargs shared by every variant)
WORKLOADS = {
    # tests/test_serving_paged.py:52 — mixed lengths, slot and block reuse
    "mixed": (lambda cls: _requests(cls, 7, [8, 11, 6], max_tokens=5),
              dict(cap=24, batch_slots=3)),
    # tests/test_spec_prefix.py:59 — four prompts sharing 8 tokens
    "shared": (lambda cls: _shared(cls, 4, 8, 12, max_tokens=4),
               dict(cap=24, batch_slots=2)),
}
#: (workload, variant) -> the paged options under test
VARIANTS = {
    ("mixed", "paged"): dict(cache_layout="paged", block_size=8),
    ("mixed", "paged_chunk"): dict(cache_layout="paged", block_size=8,
                                   prefill_chunk=4),
    ("shared", "prefix"): dict(cache_layout="paged", block_size=4,
                               prefix_cache=True),
    ("shared", "prefix_spec"): dict(cache_layout="paged", block_size=4,
                                    prefix_cache=True, spec_k=3),
}
#: the JAX variant whose streams a workload's port dense engine and oracle
#: are held to (the JAX package's own tests hold it to its dense engine)
ORACLE_REF = {"mixed": "paged", "shared": "prefix"}


@pytest.fixture(scope="module")
def jax_model():
    cfg = jconfig("qwen2-0.5b").reduced()
    jm = jbuild(cfg, jpolicy("mirage"), JOptions(q_chunk=16, kv_chunk=16))
    return jm, jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def model(jax_model):
    tm = build_model(get_config("qwen2-0.5b").reduced(), get_policy("mirage"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jax_model[1]))
    return tm


def _drain(server, reqs):
    for r in reqs:
        server.submit(r)
    out = {r.rid: r.tokens_out for r in server.run_until_drained()}
    if getattr(server, "alloc", None) is not None:
        server.alloc.check_invariants()
        assert server.alloc.used_count == 0
    return out


@pytest.fixture(scope="module")
def jax_streams(jax_model):
    """Every JAX engine of the module, run once: each paged variant."""
    jm, params = jax_model
    out = {}
    for (name, variant), opts in VARIANTS.items():
        mk, kw = WORKLOADS[name]
        out[(name, variant)] = _drain(JServer(jm, params, **kw, **opts),
                                      mk(JRequest))
    return out


@pytest.mark.parametrize("workload,variant", sorted(VARIANTS))
def test_paged_streams_equal_jax_engine(model, jax_streams, workload,
                                        variant):
    mk, kw = WORKLOADS[workload]
    server = LMServer(model, **kw, **VARIANTS[(workload, variant)])
    got = _drain(server, mk(Request))
    want = jax_streams[(workload, variant)]
    assert set(got) == set(range(len(mk(Request))))
    assert got == want
    m = server.metrics
    if server.prefix_cache:
        assert m["prefix_hits"] >= 1 and m["prefix_shared_blocks"] >= 2
    if server.spec_k:
        assert m["spec_ticks"] >= 1
        assert m["spec_accepted"] >= m["spec_slot_ticks"]
    assert server.alloc.peak_in_use > 0


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_dense_and_oracle_equal_jax_engine(model, jax_streams, workload):
    mk, kw = WORKLOADS[workload]
    want = jax_streams[(workload, ORACLE_REF[workload])]
    assert _drain(LMServer(model, **kw), mk(Request)) == want
    oracle = PerSlotLMServer(model, kw["cap"], batch_slots=kw["batch_slots"])
    assert _drain(oracle, mk(Request)) == want
    assert oracle.metrics["completed"] == len(want)


def test_flag_validation(model):
    """The JAX constructor's checks, word for word."""
    with pytest.raises(ValueError, match="prefix_cache"):
        LMServer(model, cap=24, batch_slots=2, prefix_cache=True)
    with pytest.raises(ValueError, match="spec_k"):
        LMServer(model, cap=24, batch_slots=2, spec_k=3)
    with pytest.raises(ValueError, match="greedy"):
        LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                 spec_k=3, greedy=False)
    with pytest.raises(ValueError, match="spec_k"):
        LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                 spec_k=-1)
    with pytest.raises(ValueError, match="prefill_chunk requires"):
        LMServer(model, cap=24, batch_slots=2, prefill_chunk=4)
    with pytest.raises(ValueError, match="prefill_chunk must be"):
        LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                 prefill_chunk=0)
    with pytest.raises(ValueError, match="unknown cache_layout"):
        LMServer(model, cap=24, batch_slots=2, cache_layout="ring")
    with pytest.raises(ValueError, match="placement"):
        LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                 block_placement="nowhere")
    with pytest.raises(ValueError, match="pipeline_depth overlaps"):
        LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                 prefill_chunk=4, pipeline_depth=1)


def test_chunked_ttft_stamped_after_final_chunk(model):
    """TTFT stamps at the token of the FINAL chunk; the prefilling gauge
    counts chunk-pending requests and drains to zero."""
    server = LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                      block_size=8, prefill_chunk=4)
    [req] = _requests(Request, 1, [10], max_tokens=3)
    server.submit(req)
    server.tick()                       # admit + chunk 1 of [4, 4, 2]
    assert server.metrics["prefilling"] == 1
    assert req.tokens_out == [] and req.t_first_token == 0.0 and \
        req.t_admit > 0
    server.tick()
    assert req.tokens_out == [] and req.t_first_token == 0.0
    server.tick()                       # final chunk + a decode
    assert len(req.tokens_out) == 2 and req.t_first_token > 0
    server.run_until_drained()
    assert server.metrics["prefilling"] == 0
    assert server.metrics["prefill_chunks"] == 3
    assert server.metrics["prefill_batches"] == 0
    text = server.scheduler.registry.prometheus_text()
    assert "serve_block_pool_in_use 0" in text


def test_full_prefix_hit_skips_prefill(model):
    server = LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                      block_size=4, prefix_cache=True)
    prompt = (np.arange(12) % 256).astype(np.int32)
    r0 = Request(rid=0, prompt=prompt.copy(), max_tokens=6)
    r1 = Request(rid=1, prompt=prompt.copy(), max_tokens=6)
    server.submit(r0)
    server.tick()
    chunks = server.metrics["prefill_chunks"]
    server.submit(r1)
    server.tick()
    assert server.metrics["prefix_full_hits"] == 1
    assert server.metrics["prefill_chunks"] == chunks   # no prefill at all
    assert len(r1.tokens_out) == 1 and r1.t_first_token >= r1.t_admit > 0
    done = {r.rid: r for r in server.run_until_drained()}
    assert done[0].tokens_out == done[1].tokens_out
    assert server.metrics["cow_forks"] >= 1
    server.alloc.check_invariants()
    assert server.alloc.used_count == 0


def test_cow_fork_isolates_sharers(model):
    mk = lambda: _shared(Request, 2, 8, 12, max_tokens=6, seed=11)
    solo = {}
    for r in mk():
        solo.update(_drain(LMServer(model, cap=24, batch_slots=1), [r]))
    shared = LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                      block_size=4, prefix_cache=True)
    assert _drain(shared, mk()) == solo
    assert shared.metrics["prefix_hits"] == 1


def test_small_pool_queues_head_of_line(model):
    """A pool too small for both lifetimes admits the second request only
    after the first retires; the streams stay the dense engine's."""
    reqs = lambda: _requests(Request, 2, [8], max_tokens=6, seed=1)
    dense = _drain(LMServer(model, cap=24, batch_slots=2), reqs())
    small = LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                     block_size=4, n_blocks=5)
    for r in reqs():
        small.submit(r)
    small.tick()
    assert sum(r is not None for r in small.slot_req) == 1
    assert len(small.scheduler.waiting) == 1
    out = {r.rid: r.tokens_out for r in small.run_until_drained()}
    assert out == dense and small.alloc.peak_in_use <= 5
    with pytest.raises(ValueError, match="pool holds"):
        small.submit(Request(rid=9, prompt=np.zeros(16, np.int32),
                             max_tokens=8))
    with pytest.raises(ValueError, match="linear capacity"):
        LMServer(model, cap=24, batch_slots=1, cache_layout="paged",
                 block_size=4, prefill_chunk=4).submit(
            Request(rid=9, prompt=np.zeros(20, np.int32), max_tokens=8))


def test_one_host_transfer_per_verify_tick(model):
    s = LMServer(model, cap=24, batch_slots=2, cache_layout="paged",
                 block_size=4, spec_k=3)
    shapes = []
    orig = s._to_host

    def spy(payload):
        shapes.append(tuple(payload.shape))
        return orig(payload)

    s._to_host = spy
    _drain(s, _shared(Request, 2, 8, 12, max_tokens=5))
    m = s.metrics
    assert shapes.count((2, 5)) == m["spec_ticks"] and m["decode_steps"] == 0
    assert len(shapes) == m["spec_ticks"] + m["prefill_batches"]


def test_lookup_draft_matches_jax():
    from repro.runtime.server import _lookup_draft as jdraft
    rng = np.random.default_rng(0)
    for _ in range(50):
        ctx = rng.integers(0, 4, int(rng.integers(0, 12))).astype(np.int32)
        k = int(rng.integers(1, 5))
        np.testing.assert_array_equal(_lookup_draft(ctx, k), jdraft(ctx, k))


@pytest.mark.parametrize("flags", [
    ["--engine", "oracle"],
    ["--cache-layout", "paged", "--block-size", "4"],
    ["--cache-layout", "paged", "--block-size", "4", "--prefill-chunk", "4",
     "--prefix-cache", "--shared-prefix", "8", "--spec-k", "2"],
])
def test_serve_launcher_engines(capsys, flags):
    assert serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "12", "--max-tokens", "4",
                       "--slots", "2"] + flags) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    if "--cache-layout" in flags:
        assert "paged KV: block_size=4" in out
    if "--prefix-cache" in flags:
        assert "prefix cache:" in out and "speculative k=2" in out


@pytest.mark.parametrize("flags", [
    ["--engine", "oracle", "--cache-layout", "paged"],
    ["--engine", "oracle", "--sample"],
    ["--prefix-cache"], ["--spec-k", "2"],
    ["--cache-layout", "paged", "--spec-k", "2", "--sample"],
])
def test_serve_launcher_flag_checks(flags):
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu"] + flags)
