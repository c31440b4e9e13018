"""Live metrics endpoints: a daemon-thread HTTP server per process. The
port's copy of ``rabit_tpu/telemetry/live.py`` (stdlib only); the
``endpoint`` announce speaks the port tracker's wire
(``rabit_tpu_torch/tracker/tracker.py``).

The post-mortem exporters only speak at shutdown — a hung or aborted
world is exactly the world they cannot show. This module serves the
recorder's state while the run is still alive:

- ``/metrics``  Prometheus text exposition (``telemetry/prom.py``):
  counters, log2-µs histograms, recorder occupancy, plus whatever
  gauges the owner registered (watchdog expiries, tracker poll state,
  straggler snapshots).
- ``/healthz``  small JSON liveness document (rank/world/pid).
- ``/summary``  the raw ``telemetry_summary/v1`` JSON — what the
  tracker's poller scrapes, so fleet aggregation reuses the exact
  merge path the end-of-run table uses.

Off by default: a server starts only when ``rabit_metrics_port`` is
configured (port 0 auto-assigns). The server runs on daemon threads
(``ThreadingHTTPServer``) and never blocks process exit; nothing here
imports torch and nothing touches a collective.

Workers announce their endpoint to the tracker with the ``endpoint``
wire command right after engine init (the native engines' C++
``start`` handshake is composed natively and stays untouched), riding
the same env rendezvous and connect-retry path the ``metrics`` shipment
uses.
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Iterable, Optional, Tuple

from .export import build_summary
from .prom import GaugeSpec, render_prometheus

_POLL_MS_DEFAULT = 2000


class MetricsServer:
    """One daemon-thread HTTP server exposing recorder state.

    ``sources_fn`` returns ``[(base_labels, summary_doc)]`` for
    ``/metrics`` (a worker has one source; the tracker one per polled
    rank); ``summary_fn`` returns the single JSON document for
    ``/summary``; ``gauges_fn`` contributes extra gauge families;
    ``routes`` maps extra paths to ``fn() -> dict`` JSON providers.
    """

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 sources_fn: Optional[Callable[[], Iterable]] = None,
                 summary_fn: Optional[Callable[[], dict]] = None,
                 gauges_fn: Optional[Callable[[], Iterable[GaugeSpec]]]
                 = None,
                 identity: Optional[Dict] = None,
                 routes: Optional[Dict[str, Callable[[], dict]]] = None):
        self._sources_fn = sources_fn or (lambda: [])
        self._summary_fn = summary_fn
        self._gauges_fn = gauges_fn or (lambda: [])
        self._identity = dict(identity or {})
        self._routes = dict(routes or {})
        self._httpd = ThreadingHTTPServer((host, int(port)),
                                          self._make_handler())
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return (self.host, self.port)

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="rabit-metrics", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        try:
            self._httpd.shutdown()
            self._httpd.server_close()
        except OSError:
            pass

    # -- request handling -------------------------------------------------
    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # silence per-request stderr
                pass

            def _reply(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        text = render_prometheus(
                            server._sources_fn(),
                            gauges=server._gauges_fn())
                        self._reply(200,
                                    "text/plain; version=0.0.4; "
                                    "charset=utf-8", text.encode())
                    elif path == "/healthz":
                        doc = {"ok": True, "pid": os.getpid()}
                        doc.update(server._identity)
                        self._reply(200, "application/json",
                                    json.dumps(doc).encode())
                    elif path == "/summary" and \
                            server._summary_fn is not None:
                        self._reply(200, "application/json",
                                    json.dumps(
                                        server._summary_fn()).encode())
                    elif path in server._routes:
                        self._reply(200, "application/json",
                                    json.dumps(
                                        server._routes[path]()).encode())
                    else:
                        self._reply(404, "text/plain", b"not found\n")
                except Exception as e:  # noqa: BLE001 - a scrape must
                    # never take the serving process down with it
                    try:
                        self._reply(500, "text/plain",
                                    f"error: {e}\n".encode())
                    except OSError:
                        pass

        return Handler


def start_rank_server(port: int, rank: int, world: int,
                      gauges_fn: Optional[Callable[[], Iterable[GaugeSpec]]]
                      = None) -> MetricsServer:
    """Worker-side server over the process-global recorder."""
    from . import snapshot  # late import: avoids a module-import cycle

    def summary():
        return build_summary(snapshot(), rank=rank, world_size=world)

    return MetricsServer(
        port=port,
        sources_fn=lambda: [({"rank": str(rank)}, summary())],
        summary_fn=summary,
        gauges_fn=gauges_fn,
        identity={"rank": rank, "world": world, "role": "worker"},
    ).start()


# The last announce's (host, port, rank) — what ``reannounce`` replays
# toward a tracker that came back (the skew poller's dead->alive
# transition): the worker re-presenting its own endpoint makes the
# tracker's view converge without any re-registration.
_last_announce: Optional[tuple] = None


def announce_endpoint(host: str, port: int, rank: int,
                      timeout: float = 5.0) -> bool:
    """Tell the tracker where this rank's metrics endpoint lives (the
    ``endpoint`` wire command). Best-effort, like the shutdown-time
    metrics shipment: a run without a tracker returns False."""
    global _last_announce
    _last_announce = (host, int(port), int(rank))
    tr_host = (os.environ.get("RABIT_TRACKER_URI")
               or os.environ.get("DMLC_TRACKER_URI") or "")
    tr_port = (os.environ.get("RABIT_TRACKER_PORT")
               or os.environ.get("DMLC_TRACKER_PORT") or "")
    if not tr_host or tr_host == "NULL" or not tr_port:
        return False
    task_id = (os.environ.get("RABIT_TASK_ID")
               or os.environ.get("DMLC_TASK_ID") or "0")
    payload = json.dumps({"host": host, "port": int(port),
                          "rank": int(rank)})
    from ..tracker.tracker import MAGIC, _recv_u32, _send_str, _send_u32
    from ..utils import retry
    try:
        with retry.connect_with_retry(
                tr_host, int(tr_port), timeout=timeout,
                deadline=retry.Deadline(timeout)) as conn:
            _send_u32(conn, MAGIC)
            _send_str(conn, "endpoint")
            _send_str(conn, task_id)
            _send_u32(conn, 0)  # num_attempt (informational)
            _send_str(conn, payload)
            return _recv_u32(conn) == 1
    except (OSError, ValueError, ConnectionError, retry.RetryError):
        return False


def reannounce(timeout: float = 5.0) -> bool:
    """Replay the last successful endpoint announce (reconnecting
    pollers call this on a dead->alive tracker transition). False when
    this process never announced."""
    if _last_announce is None:
        return False
    host, port, rank = _last_announce
    return announce_endpoint(host, port, rank, timeout=timeout)


def poll_interval_s(cfg_or_none=None) -> float:
    """``rabit_metrics_poll_ms`` as seconds (tracker-side knob; env
    ``RABIT_METRICS_POLL_MS``), floored at 50 ms."""
    raw: Optional[str] = None
    if cfg_or_none is not None:
        raw = cfg_or_none.get("rabit_metrics_poll_ms")
    if raw is None:
        raw = os.environ.get("RABIT_METRICS_POLL_MS")
    try:
        ms = float(raw) if raw else _POLL_MS_DEFAULT
    except ValueError:
        ms = _POLL_MS_DEFAULT
    return max(0.05, ms / 1e3)


def scrape_json(host: str, port: int, path: str = "/summary",
                timeout: float = 2.0) -> Optional[dict]:
    """GET a JSON document from a metrics endpoint; None on any error
    (a dead rank must not take the poller down)."""
    import urllib.request
    url = f"http://{host}:{port}{path}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            doc = json.load(resp)
        return doc if isinstance(doc, dict) else None
    except Exception:  # noqa: BLE001 - poller is best-effort by contract
        return None
