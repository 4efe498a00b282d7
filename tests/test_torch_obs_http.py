"""PyTorch port, slice 7: the metrics exporter, the tracer's markers and
profile windows, and the serve launcher's robustness and observability
flags, against the JAX package's ``repro.obs`` where both run.

``MetricsServer`` binds loopback on an ephemeral port: ``/metrics`` must be
the registry's Prometheus text, ``/metrics.json`` its snapshot, ``/trace``
the tracer's Chrome trace, as the JAX exporter serves them (the same
registry contents give both packages the same bytes). The launcher runs
the reduced config on the CPU.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.obs import http as jhttp
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core import stationary
from repro_torch.core.precision import get_policy
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.lm import LMCallOptions
from repro_torch.obs import http, metrics, trace
from repro_torch.runtime.faults import FaultInjector, FaultSchedule
from repro_torch.runtime.server import LMServer, Request


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read()


def _fill(reg, tracer):
    """The same instruments and spans in either package's objects."""
    c = reg.counter("serve_timed_out_total", help="requests timed out")
    c.inc(3)
    g = reg.gauge("serve_health_detector_flips", help="per-channel",
                  label_names=("channel",))
    for ch, v in ((31, 1), (41, 7)):
        g.labels(str(ch)).set(v)
    h = reg.histogram("serve_tick_seconds", help="tick walltime")
    for v in (0.002, 0.01, 0.5):
        h.observe(v)
    tracer.configure(enabled=True)
    with tracer.span("serve.tick", {"slots": 2}):
        tracer.instant("chaos", {"site": "snr_drop"})


def test_metrics_server_equals_jax_exporter():
    reg, tracer = metrics.MetricsRegistry(), trace.SpanTracer()
    jreg, jtr = jmetrics.MetricsRegistry(), jtrace.SpanTracer()
    _fill(reg, tracer)
    _fill(jreg, jtr)
    srv = http.serve_metrics(port=0, registry=reg, tracer=tracer)
    jsrv = jhttp.serve_metrics(port=0, registry=jreg, tracer=jtr)
    try:
        assert srv.port > 0 and srv.url == f"http://127.0.0.1:{srv.port}"
        code, ctype, body = _get(f"{srv.url}/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert body.decode() == reg.prometheus_text()
        assert body == _get(f"{jsrv.url}/metrics")[2]
        assert _get(f"{srv.url}/")[2] == body
        assert json.loads(_get(f"{srv.url}/metrics.json")[2]) == \
            reg.snapshot() == json.loads(_get(f"{jsrv.url}/metrics.json")[2])
        tr = json.loads(_get(f"{srv.url}/trace")[2])
        jtr_json = json.loads(_get(f"{jsrv.url}/trace")[2])
        assert [(e["name"], e["ph"], e.get("s"), "dur" in e, e["args"])
                for e in tr["traceEvents"]] == \
            [(e["name"], e["ph"], e.get("s"), "dur" in e, e["args"])
             for e in jtr_json["traceEvents"]] == \
            [("chaos", "i", "t", False, {"site": "snr_drop"}),
             ("serve.tick", "X", None, True, {"slots": 2})]
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{srv.url}/nope")
        assert e.value.code == 404
    finally:
        srv.stop()
        jsrv.stop()


def test_instant_off_records_nothing():
    tracer = trace.SpanTracer()
    tracer.instant("x")
    assert tracer.n_recorded == 0
    assert obs.profile_window is trace.profile_window
    assert obs.get_tracer() is trace.get_tracer()


@pytest.fixture(scope="module")
def model():
    return build_model(get_config("qwen2-0.5b").reduced(), get_policy("fp32"),
                       LMCallOptions(q_chunk=16, kv_chunk=16), device="cpu",
                       generator=torch.Generator().manual_seed(0))


def test_engine_metrics_over_http(model):
    """An engine's registry behind the exporter: the robustness counters
    (``serve_timed_out_total``, ``serve_retried_total``) and, under an
    RRNS policy, the analog-health gauges, one transfer a scrape."""
    model.policy = get_policy("mirage_rrns", snr_db=40.0, noise_seed=1)
    inj = FaultInjector(FaultSchedule.parse("host_corruption@1:2:rate=1.0"),
                        seed=1)
    server = LMServer(model, cap=24, batch_slots=2, fault_injector=inj,
                      max_retries=4, buckets=(16,))
    rng = np.random.default_rng(0)
    for i in range(2):
        server.submit(Request(rid=i, prompt=rng.integers(0, 256, 6).astype(
            np.int32), max_tokens=3))
    late = Request(rid=9, prompt=np.arange(6, dtype=np.int32), max_tokens=3,
                   queue_ttl_s=0.0)
    server.submit(late)
    server.run_until_drained()
    srv = http.MetricsServer(port=0, registry=server.scheduler.registry)
    srv.start()
    try:
        text = _get(f"{srv.url}/metrics")[2].decode()
        snap = json.loads(_get(f"{srv.url}/metrics.json")[2])
    finally:
        srv.stop()
    model.policy = get_policy("fp32")
    stationary.install(model, None)
    assert text == server.scheduler.registry.prometheus_text()
    assert late.status == "timed_out"
    assert "serve_timed_out_total 1" in text.splitlines()
    assert f"serve_retried_total {server.metrics['retried']}" in \
        text.splitlines() and server.metrics["retried"] > 0
    health = server.health_snapshot()
    for ch, v in zip((31, 32, 33, 37, 41), health["detector_flips"]):
        assert f'serve_health_detector_flips{{channel="{ch}"}} {v}' in text
    assert f"serve_health_rrns_corrected {health['rrns_corrected']}" in text
    assert snap["serve_timed_out_total"]["series"] == {"_": 1.0}


def test_profile_window_writes_a_trace(tmp_path):
    tracer = trace.SpanTracer()
    with trace.profile_window(str(tmp_path / "prof"), tracer):
        assert tracer.enabled and tracer.annotate
        with tracer.span("step"):
            torch.ones((8, 8)) @ torch.ones((8, 8))
    assert not tracer.enabled and not tracer.annotate
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name") for e in events["traceEvents"]}
    assert "step" in names


# --------------------------------------------------------------------------
# the launcher's flags
# --------------------------------------------------------------------------

BASE = ["--reduced", "--device", "cpu", "--requests", "3", "--prompt-len",
        "6", "--max-tokens", "3", "--slots", "2"]


def test_serve_launcher_chaos_and_observability(capsys, tmp_path):
    dump, tr = tmp_path / "m.json", tmp_path / "t.json"
    assert serve.main(BASE + [
        "--policy", "fp32", "--chaos", "host_corruption@1:2:rate=1.0",
        "--chaos-seed", "1", "--max-retries", "3", "--ttl-s", "600",
        "--queue-ttl-s", "600", "--max-queue-depth", "8",
        "--metrics-port", "0", "--metrics-dump", str(dump),
        "--trace-export", str(tr)]) == 0
    out = capsys.readouterr().out
    assert "chaos: host_corruption@[1,2)" in out
    assert "terminal statuses: {'completed': 3}" in out
    assert "host_corruption flipped" in out
    assert "scraped" in out and "metrics at http://127.0.0.1:" in out
    snap = json.loads(dump.read_text())
    assert "serve_retried_total" in json.dumps(snap)
    names = {e["name"] for e in json.loads(tr.read_text())["traceEvents"]}
    assert {"serve.tick", "serve.admit", "serve.decode",
            "serve.host_sync", "serve.prefill_batch"} <= names
    trace.configure(enabled=False)


def test_serve_launcher_guardian(capsys):
    assert serve.main(BASE + [
        "--policy", "mirage_rrns", "--snr-db", "60", "--chaos",
        "snr_drop@0:100000:scale=1e6", "--guardian", "--guardian-window",
        "2", "--requests", "2"]) == 0
    out = capsys.readouterr().out
    assert "terminal statuses: {'completed': 2}" in out
    assert "escalate to mirage_rrns[r=4]" in out
    assert "escalate to fp32" in out
    assert "tick 0: snr_drop enters window" in out


@pytest.mark.parametrize("flags", [
    ["--engine", "oracle", "--chaos", "worker_crash@0"],
    ["--engine", "oracle", "--ttl-s", "1"],
    ["--guardian", "--policy", "mirage"],
    ["--guardian", "--policy", "mirage_rrns", "--pipeline-depth", "1"],
])
def test_serve_launcher_refusals(flags):
    with pytest.raises(SystemExit):
        serve.parse_args(BASE + flags)
