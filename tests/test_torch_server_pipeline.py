"""PyTorch port, slice 5: pipelined prefill and the retry path against the
JAX engine.

Reduced qwen2 under ``mirage`` with the JAX init's weights in both
packages, served as ``tests/test_serving_mesh.py``'s in-process pipeline
tests serve it (4 slots, cap 32, one 16-token bucket, six 12-token prompts
of 8 tokens). With ``pipeline_depth`` the bucketed prefill's forward pass
runs on the engine's worker thread (on the CPU here; on a CUDA stream of
its own on the card), and the streams must equal the port's synchronous
engine's and the JAX pipelined engine's token for token. A prefill job
that fails releases its slots and blocks, retries within the budget and
then retires its requests as ``failed`` with the error. The JAX engine
runs once per module (``jax_streams``).
"""

import sys
import threading

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
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.runtime.server import LMServer, Request

ENGINE = dict(cap=32, batch_slots=4, buckets=(16,))


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
        server.close()
    return {r.rid: list(map(int, r.tokens_out))
            for r in server.scheduler.finished}


@pytest.fixture(scope="module")
def jax_model():
    jm = jbuild(jconfig("qwen2-0.5b").reduced(), jpolicy("mirage"),
                JOptions(q_chunk=16, kv_chunk=16))
    return jm, jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def model(jax_model):
    tm = build_model(get_config("qwen2-0.5b").reduced(), get_policy("mirage"),
                     LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jax_model[1]))
    return tm


@pytest.fixture(scope="module")
def jax_streams(jax_model):
    """The JAX engine's pipelined drain (its own tests hold it equal to
    its synchronous one)."""
    jm, params = jax_model
    return _drain(JServer(jm, params, pipeline_depth=2, **ENGINE),
                  _requests(JRequest))


@pytest.mark.parametrize("depth", [1, 2])
def test_pipelined_prefill_token_parity(model, jax_streams, depth):
    """``tests/test_serving_mesh.py::test_pipelined_prefill_token_parity``:
    depth 1 and 2 emit the synchronous engine's streams and the JAX
    pipelined engine's."""
    want = _drain(LMServer(model, **ENGINE), _requests(Request))
    piped = LMServer(model, pipeline_depth=depth, **ENGINE)
    got = _drain(piped, _requests(Request))
    assert got == want == jax_streams
    m = piped.metrics
    assert m["completed"] == 6 and m["prefilling"] == 0
    assert m["prefill_batches"] >= 2 and not piped.prefilling


def test_pipelined_paged_equals_synchronous(model):
    """The paged layout's blocks are claimed at submission and the
    prefill scatters through the tables."""
    kw = dict(cache_layout="paged", block_size=8, n_blocks=16)
    want = _drain(LMServer(model, **ENGINE, **kw), _requests(Request))
    piped = LMServer(model, pipeline_depth=2, **ENGINE, **kw)
    assert _drain(piped, _requests(Request)) == want
    piped.alloc.check_invariants()
    assert piped.alloc.used_count == 0


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_pipelined_prefill_crash_retries_then_fails(model, layout):
    """``tests/test_serving_mesh.py::
    test_pipelined_prefill_crash_retries_then_fails``: a permanently broken
    compute step costs each request its retry budget, then retires it as
    ``failed`` with the error; the slots (and blocks) are free again and
    the drain ends."""
    kw = dict(cache_layout="paged", block_size=8) if layout == "paged" \
        else {}
    piped = LMServer(model, pipeline_depth=1, **ENGINE, **kw)
    try:
        piped._prefill_compute = None   # a permanently dead step
        reqs = _requests(Request, n=2)
        for r in reqs:
            piped.submit(r)
        finished = piped.run_until_drained()
    finally:
        piped.close()
    assert {r.rid for r in finished} == {0, 1}
    assert all(r.status == "failed" and r.terminal for r in reqs)
    assert all(r.retries >= 1 and r.tokens_out == [] for r in reqs)
    assert all("prefill worker crash" in r.error for r in reqs)
    assert isinstance(piped.last_prefill_error, TypeError)
    assert all(s is None for s in piped.slot_req)
    assert not piped.prefilling
    m = piped.metrics
    assert m["retried"] >= 2 and m["failed"] == 2 and m["completed"] == 0
    if piped.alloc is not None:
        piped.alloc.check_invariants()
        assert piped.alloc.used_count == 0


def test_transient_crash_recovers_with_retry(model):
    """A job that fails once costs one retry and nothing else: the retried
    prefill reproduces the streams of an engine that never failed (the
    JAX package's injected-crash test, with the failure made here)."""
    want = _drain(LMServer(model, **ENGINE), _requests(Request))
    piped = LMServer(model, pipeline_depth=2, max_retries=3, **ENGINE)
    real = piped._prefill_compute
    calls = []

    def flaky(tokens, lens):
        calls.append(tokens.shape)
        if len(calls) == 1:
            raise RuntimeError("transient")
        return real(tokens, lens)

    piped._prefill_compute = flaky
    assert _drain(piped, _requests(Request)) == want
    assert piped.metrics["retried"] >= 1
    assert all(r.status == "completed" for r in piped.scheduler.finished)


def test_close_is_idempotent_and_checks(model):
    piped = LMServer(model, pipeline_depth=2, **ENGINE)
    thread = piped._pipe._thread
    piped.close()
    piped.close()
    assert piped._pipe is None and not thread.is_alive()
    LMServer(model, **ENGINE).close()       # no pipeline: nothing to stop
    with pytest.raises(ValueError, match="pipeline_depth overlaps"):
        LMServer(model, pipeline_depth=1, cache_layout="paged",
                 prefill_chunk=4, **ENGINE)
    with pytest.raises(ValueError, match="pipeline_depth overlaps"):
        LMServer(model, pipeline_depth=1, cache_layout="paged",
                 prefix_cache=True, **ENGINE)
    with pytest.raises(ValueError, match="pipeline_depth must be"):
        LMServer(model, pipeline_depth=-1, **ENGINE)


def test_switch_backend_refused_with_prefills_in_flight(model):
    """A job held on the worker while a decodable slot keeps the loop
    ticking: the switch raises, and the drain then ends."""
    piped = LMServer(model, pipeline_depth=2, **ENGINE)
    try:
        gate = threading.Event()
        gate.set()
        real = piped._prefill_compute

        def held(tokens, lens):
            assert gate.wait(timeout=60)
            return real(tokens, lens)

        piped._prefill_compute = held
        first, second = _requests(Request, n=2)
        piped.submit(first)
        piped.tick()                 # nothing else to do: waits for it
        gate.clear()
        piped.submit(second)
        piped.tick()                 # submits, decodes the first meanwhile
        assert piped._pipe.inflight == 1 and len(piped.prefilling) == 1
        with pytest.raises(RuntimeError, match="in flight"):
            piped.switch_backend(get_policy("mirage"))
        gate.set()
        piped.run_until_drained()
    finally:
        gate.set()
        piped.close()
    assert piped.metrics["completed"] == 2


def test_launch_counts_survive_concurrent_wrappers():
    """The kernel wrappers count launches from the decode thread and the
    prefill worker at once: no count may be lost."""
    ops.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                ops.add_launch_counts({"mirage_gemm": 1})
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert ops.LAUNCHES["mirage_gemm"] == 8 * 2000
    ops.reset_launch_counts()


@pytest.mark.parametrize("flags", [
    ["--pipeline-depth", "2", "--max-retries", "2"],
    ["--pipeline-depth", "1", "--warmup", "--cache-layout", "paged"],
])
def test_serve_launcher_pipeline_flags(capsys, flags):
    assert serve.main(["--reduced", "--device", "cpu", "--requests", "3",
                       "--prompt-len", "12", "--max-tokens", "4",
                       "--slots", "2"] + flags) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out
    assert ("warmup:" in out) == ("--warmup" in flags)


@pytest.mark.parametrize("flags", [
    ["--engine", "oracle", "--pipeline-depth", "2"],
    ["--engine", "oracle", "--warmup"],
])
def test_serve_launcher_pipeline_flag_checks(flags):
    with pytest.raises(SystemExit):
        serve.main(["--reduced", "--device", "cpu"] + flags)
