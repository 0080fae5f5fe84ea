"""feedscope: zero-dependency live ops endpoint.

A tiny stdlib ``http.server`` surface for poking a running
``FeedManager`` from a browser, ``curl``, or a Prometheus scraper — no
third-party dependency, opt-in via ``FeedManager.serve_obs(port=...)``:

  ``GET /metrics``   Prometheus text exposition, merged across every
                     active feed (plus per-feed ``feed_health`` gauges)
  ``GET /health``    JSON health per feed (core/obs/health.py); status
                     200 when every feed is ok/degraded, 503 when any
                     feed is stalled
  ``GET /profile``   JSON ``ProfileReport`` per profiled feed
                     (core/obs/profile.py)
  ``GET /trace``     the newest raw spans per profiled feed (bounded
                     by ``ProfileSpec.trace_keep``); never drains the
                     tracer — ``/trace`` is a window, not a consumer

Read-path discipline: every handler works from ``snapshot()``s,
``exposition()`` strings, and the profiler's *already-drained* span
copies.  Handlers take no feed, holder, or storage lock — the only
locks touched are the registry's own instrument locks (inside
``exposition``/``merge``) and the profiler/health private locks, each
leaf locks with no ordering edges — so serving traffic cannot contend
with, deadlock against, or reorder the ingest hot path, and feedlint's
LOCK_ORDER needs no new entries (see docs/CONCURRENCY.md).
"""

from __future__ import annotations

import http.server
import json
import threading
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.obs.metrics import MetricsRegistry


class _ObsHandler(http.server.BaseHTTPRequestHandler):
    """Request handler; the owning ``ObsServer`` hangs off the server
    object (``self.server.obs``)."""

    server_version = "feedscope/1"

    # silence per-request stderr chatter from BaseHTTPRequestHandler
    def log_message(self, format: str, *args: Any) -> None:
        pass

    def _send(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self) -> None:  # noqa: N802 (http.server naming)
        obs: "ObsServer" = self.server.obs  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        try:
            if path == "/metrics":
                self._send(200, obs.render_metrics(),
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/health":
                code, body = obs.render_health()
                self._send(code, body, "application/json")
            elif path == "/profile":
                self._send(200, obs.render_profile(), "application/json")
            elif path == "/trace":
                self._send(200, obs.render_trace(), "application/json")
            elif path == "/":
                self._send(200, json.dumps(
                    {"endpoints": ["/metrics", "/health", "/profile",
                                   "/trace"]}), "application/json")
            else:
                self._send(404, json.dumps({"error": "not found",
                                            "path": path}),
                           "application/json")
        except Exception as exc:  # surface, don't kill the thread
            try:
                self._send(500, json.dumps({"error": repr(exc)}),
                           "application/json")
            except OSError:
                pass  # client went away mid-error


class ObsServer:
    """Background HTTP surface over one ``FeedManager``.  Construction
    binds the socket (``port=0`` picks a free port); ``start()`` spawns
    the daemon serving thread; ``stop()`` shuts it down.  All state the
    handlers read is reached through ``manager.active_feeds()`` — a
    snapshot method, so no manager lock is held while rendering."""

    def __init__(self, manager: Any, host: str = "127.0.0.1",
                 port: int = 0):
        self._manager = manager
        self._httpd = http.server.ThreadingHTTPServer(
            (host, port), _ObsHandler)
        self._httpd.daemon_threads = True
        self._httpd.obs = self  # type: ignore[attr-defined]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    @property
    def address(self) -> Tuple[str, int]:
        """(host, port) actually bound — useful with ``port=0``."""
        host, port = self._httpd.server_address[:2]
        return (str(host), int(port))

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ObsServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="feedscope-obs", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # ------------------------------------------------------------- renderers
    def _feeds(self) -> Dict[str, Any]:
        return dict(self._manager.active_feeds())

    def render_metrics(self) -> str:
        """Prometheus text across every active feed.  One feed renders
        its registry directly; several merge into a scratch registry
        (counters add, gauges last-write, histograms bucket-wise).
        ``health()`` runs ``_collect_metrics`` internally, so one call
        per feed refreshes both the published-on-read instruments and
        the ``feed_health`` gauge."""
        feeds = self._feeds()
        for handle in feeds.values():
            health = getattr(handle, "health", None)
            if health is not None:
                health()
            else:
                refresh = getattr(handle, "_collect_metrics", None)
                if refresh is not None:
                    refresh()
        registries = [h.obs.registry for h in feeds.values()
                      if getattr(h, "obs", None) is not None]
        if not registries:
            return "# no active feeds\n"
        if len(registries) == 1:
            return registries[0].exposition()
        scratch = MetricsRegistry()
        for reg in registries:
            scratch.merge(reg)
        return scratch.exposition()

    def render_health(self) -> Tuple[int, str]:
        """(status_code, JSON body): 503 iff any feed is stalled."""
        out: Dict[str, Any] = {}
        worst = 0
        for name, handle in self._feeds().items():
            health = getattr(handle, "health", None)
            if health is None:
                continue
            report = health()
            worst = max(worst, report.code)
            out[name] = report.to_dict()
        body = json.dumps({"feeds": out,
                           "stalled": worst >= 2}, indent=2)
        return (503 if worst >= 2 else 200), body

    def render_profile(self) -> str:
        out: Dict[str, Any] = {}
        for name, handle in self._feeds().items():
            profile = getattr(handle, "profile", None)
            report = profile() if profile is not None else None
            if report is not None:
                out[name] = report.to_dict()
        return json.dumps({"feeds": out}, indent=2)

    def render_trace(self) -> str:
        out: Dict[str, Any] = {}
        for name, handle in self._feeds().items():
            profiler = getattr(handle, "profiler", None)
            if profiler is not None:
                out[name] = profiler.recent_spans()
        return json.dumps({"feeds": out}, indent=2)


def http_get(url: str, timeout: float = 5.0) -> Tuple[int, str]:
    """Tiny stdlib GET helper for tests and benchmarks (no requests
    dependency): returns (status, body)."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode("utf-8")


__all__ = ["ObsServer", "http_get"]
