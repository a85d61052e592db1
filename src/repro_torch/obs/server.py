"""Per-host observability HTTP endpoint (stdlib `http.server`).

A copy of `repro.obs.server` (stdlib only) for the port.

Every engine host can serve its registry over HTTP so a scraper
(Prometheus), a fleet aggregator (`obs/aggregate.FleetAggregator` pulling
``/snapshot``), or an operator with curl can read it without touching the
process:

  * ``GET /metrics``  — Prometheus text exposition of the registry
    (`export.render_prometheus`);
  * ``GET /snapshot`` — the lossless wire JSON (`MetricsRegistry.to_wire`),
    the shipping format fleet aggregation merges;
  * ``GET /healthz``  — JSON health verdict derived from the registered
    health sources (engines register dispatch-drift checks, heartbeat
    registries their liveness); 200 when every source reports ok, 503
    otherwise, so load balancers and process supervisors can act on it.

The server runs a daemon `ThreadingHTTPServer` — request handling never
touches the engine hot path beyond the registry's per-metric locks.  Port
0 binds an ephemeral port (`server.port` after `start()`), which is what
tests and multi-process examples use to avoid collisions.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from repro_torch.obs.export import render_prometheus
from repro_torch.obs.metrics import MetricsRegistry

HealthSource = Callable[[], dict]


class ObsServer:
    """Serves one registry's /metrics, /snapshot, and /healthz.

    `health_sources` maps a check name to a zero-arg callable returning a
    JSON-serializable dict with at least ``{"ok": bool}``; sources can be
    added after construction via `register_health` (engines do this when
    they attach to a shared `Observability` bundle).  A source that raises
    is reported as ``{"ok": False, "error": ...}`` — a broken check must
    fail health, not hide it.
    """

    def __init__(
        self,
        registry: MetricsRegistry,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        health_sources: Optional[dict[str, HealthSource]] = None,
        snapshot_fn: Optional[Callable[[], dict]] = None,
    ):
        self.registry = registry
        self.host = host
        self._want_port = port
        self.snapshot_fn = snapshot_fn
        self._health: dict[str, HealthSource] = dict(health_sources or {})
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def register_health(self, name: str, source: HealthSource) -> None:
        with self._lock:
            self._health[name] = source

    def health(self) -> dict:
        """Evaluate every health source; overall ok = all sources ok."""
        with self._lock:
            sources = dict(self._health)
        checks = {}
        ok = True
        for name, fn in sorted(sources.items()):
            try:
                res = dict(fn())
            except Exception as err:  # noqa: BLE001 — a broken check fails
                res = {"ok": False, "error": f"{type(err).__name__}: {err}"}
            res.setdefault("ok", False)
            ok = ok and bool(res["ok"])
            checks[name] = res
        return {"ok": ok, "host": self.registry.host, "checks": checks}

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    @property
    def url(self) -> Optional[str]:
        return f"http://{self.host}:{self.port}" if self._httpd is not None else None

    def start(self) -> "ObsServer":
        if self._httpd is not None:
            return self
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr chatter per request
                pass

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        body = render_prometheus(server.registry)
                        self._reply(200, body.encode(), "text/plain; version=0.0.4")
                    elif path == "/snapshot":
                        snap = (
                            server.snapshot_fn()
                            if server.snapshot_fn is not None
                            else server.registry.to_wire()
                        )
                        self._reply(200, json.dumps(snap).encode(), "application/json")
                    elif path == "/healthz":
                        health = server.health()
                        code = 200 if health["ok"] else 503
                        self._reply(code, json.dumps(health).encode(), "application/json")
                    else:
                        self._reply(404, b'{"error": "not found"}', "application/json")
                except BrokenPipeError:  # client went away mid-reply
                    pass

        self._httpd = ThreadingHTTPServer((self.host, self._want_port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-http", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
        self._httpd = None
        self._thread = None

    def __enter__(self) -> "ObsServer":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


__all__ = ["ObsServer"]
