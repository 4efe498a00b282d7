"""Tiny stdlib HTTP endpoint exposing the registry and tracer (port of
``repro.obs.http``, standard library only).

Started from ``launch/serve.py --metrics-port``; serves

  /metrics        Prometheus text exposition (scrape target)
  /metrics.json   registry snapshot as JSON (same data, tooling-friendly)
  /trace          Chrome-trace JSON of the span ring buffer

Runs a ``ThreadingHTTPServer`` on a daemon thread so it never blocks the
serving loop or prevents process exit. ``port=0`` binds an ephemeral port
(the bound port is on :attr:`MetricsServer.port`), which avoids port
races. The registry's collectors (e.g. the lazy analog-health fetch)
run inside the scrape handler, i.e. on the HTTP thread, which is exactly
the "one host transfer per snapshot, never per tick" contract.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import metrics as metrics_mod
from . import trace as trace_mod


class MetricsServer:
    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry=None, tracer=None):
        self.registry = registry or metrics_mod.get_registry()
        self.tracer = tracer or trace_mod.get_tracer()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # silence per-request stderr
                pass

            def _send(self, body: bytes, ctype: str, code: int = 200):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path in ("/metrics", "/"):
                        body = outer.registry.prometheus_text().encode()
                        self._send(body, "text/plain; version=0.0.4")
                    elif path == "/metrics.json":
                        body = json.dumps(outer.registry.snapshot()).encode()
                        self._send(body, "application/json")
                    elif path == "/trace":
                        body = json.dumps(outer.tracer.chrome_trace()).encode()
                        self._send(body, "application/json")
                    else:
                        self._send(b"not found\n", "text/plain", 404)
                except BrokenPipeError:
                    pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def serve_metrics(port: int = 0, host: str = "127.0.0.1",
                  registry=None, tracer=None) -> MetricsServer:
    """Start a daemon-threaded metrics endpoint; returns the running server
    (check ``.port`` when started with ``port=0``)."""
    return MetricsServer(port=port, host=host, registry=registry,
                         tracer=tracer).start()
