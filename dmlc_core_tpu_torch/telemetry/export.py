"""Exporters over registry snapshots: Prometheus text exposition, JSON,
and a background interval Reporter.

Everything here consumes the plain-dict snapshot shape produced by
``MetricRegistry.snapshot()`` (and by ``aggregate.merge_snapshots``), so
the same renderer serves a live registry, a worker heartbeat payload,
and the tracker's cluster-wide aggregate.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, Optional, TextIO, Union

from .registry import MetricRegistry, default_registry, render_key, split_key

__all__ = ["Reporter", "serve_metrics_http", "to_json", "to_prometheus"]

logger = logging.getLogger("dmlc_core_tpu_torch.telemetry")

Snapshot = Dict[str, Any]


def to_json(source: Union[MetricRegistry, Snapshot, None] = None) -> Snapshot:
    """JSON-able snapshot of ``source`` (default: the process registry).
    A dict passes through unchanged — callers can treat 'registry or
    already-snapshot' uniformly."""
    if source is None:
        source = default_registry()
    if isinstance(source, MetricRegistry):
        return source.snapshot()
    return source


def _prom_name(name: str) -> str:
    """Prometheus metric names have no dots: mangle the hierarchy
    separator and prefix the namespace."""
    return "dmlc_" + name.replace(".", "_")


def _fmt(v: float) -> str:
    f = float(v)
    if not math.isfinite(f):
        # Gauge.value() returns NaN for a broken set_fn probe; the
        # exposition spec spells these NaN/+Inf/-Inf — int(f) below
        # would raise and kill the whole render for one bad series
        if math.isnan(f):
            return "NaN"
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _series(name: str, labels: Dict[str, str]) -> str:
    key = render_key(_prom_name(name), labels)
    return key


def to_prometheus(
    source: Union[MetricRegistry, Snapshot, None] = None,
    extra_labels: Optional[Dict[str, str]] = None,
    registry_for_help: Optional[MetricRegistry] = None,
) -> str:
    """Prometheus text exposition (version 0.0.4) of a snapshot.

    ``extra_labels`` are stamped onto every series (the tracker uses
    ``{"rank": "3"}`` for per-rank series next to the unlabeled cluster
    totals). Histograms render cumulative ``_bucket{le=...}`` series
    plus ``_sum``/``_count``, as scrapers expect.
    """
    snap = to_json(source)
    help_reg = registry_for_help or (
        source if isinstance(source, MetricRegistry) else None
    )
    lines = []
    typed = set()

    def family_order(key: str):
        # group by metric NAME, not raw key: 'name' < 'name_out{...}' <
        # 'name{...}' under plain string sort ('_' < '{'), which would
        # split a family's unlabeled and labeled series around another
        # family — invalid exposition (all lines of one metric must be
        # one contiguous group)
        return (split_key(key)[0], key)

    def head(name: str, kind: str) -> None:
        pname = _prom_name(name)
        if pname in typed:
            return
        typed.add(pname)
        if help_reg is not None:
            h = help_reg.help_for(name)
            if h:
                lines.append(f"# HELP {pname} {h}")
        lines.append(f"# TYPE {pname} {kind}")

    def labels_of(key: str) -> (str, Dict[str, str]):
        name, labels = split_key(key)
        if extra_labels:
            labels = {**labels, **extra_labels}
        return name, labels

    for key in sorted(snap.get("counters", {}), key=family_order):
        name, labels = labels_of(key)
        head(name, "counter")
        lines.append(
            f"{_series(name, labels)} {_fmt(snap['counters'][key])}"
        )
    for key in sorted(snap.get("gauges", {}), key=family_order):
        name, labels = labels_of(key)
        head(name, "gauge")
        lines.append(f"{_series(name, labels)} {_fmt(snap['gauges'][key])}")
    for key in sorted(snap.get("histograms", {}), key=family_order):
        name, labels = labels_of(key)
        hist = snap["histograms"][key]
        head(name, "histogram")
        pname = _prom_name(name)
        cum = 0
        for bound, n in zip(hist["le"], hist["n"]):
            cum += n
            blabels = {**labels, "le": _fmt(bound)}
            lines.append(f"{render_key(pname + '_bucket', blabels)} {cum}")
        cum += hist["n"][len(hist["le"])] if len(hist["n"]) > len(
            hist["le"]
        ) else 0
        lines.append(
            f"{render_key(pname + '_bucket', {**labels, 'le': '+Inf'})} {cum}"
        )
        lines.append(f"{_series(name + '_sum', labels)} {_fmt(hist['sum'])}")
        lines.append(
            f"{_series(name + '_count', labels)} {_fmt(hist['count'])}"
        )
    return "\n".join(lines) + "\n"


class _ClosableHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with an IDEMPOTENT ``server_close``:
    teardown paths race (atexit + explicit close, a daemon's SIGTERM
    handler + its finally block), and a second ``server_close`` on a
    vanilla server would close an fd the OS may have already handed to
    someone else. ``shutdown()`` is already safe to repeat; this makes
    the close half match (the tracker-exporter idempotence contract)."""

    daemon_threads = True

    def __init__(self, *args, **kwargs) -> None:
        self._dmlc_closed = False
        super().__init__(*args, **kwargs)

    def server_close(self) -> None:
        if self._dmlc_closed:
            return
        self._dmlc_closed = True
        super().server_close()


def serve_metrics_http(
    port: int,
    registry: Optional[MetricRegistry] = None,
    json_provider: Optional[Callable[[], Dict[str, Any]]] = None,
    name: str = "metrics-http",
):
    """Loopback ``/metrics`` server over a process registry — the
    single-process exporter every foreground daemon (the block-cache
    daemon, the point-read serve daemon) rides instead of hand-rolling
    its own handler. Serves Prometheus text on ``/metrics`` and, when
    ``json_provider`` is given, its dict as JSON on ``/metrics.json``,
    ``/json`` and ``/stats``. Render failures answer 500 per request,
    never kill the server thread. Returns the started server
    (``shutdown()`` + ``server_close()`` to stop; both idempotent)."""
    from http.server import BaseHTTPRequestHandler

    reg = registry or default_registry()

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self) -> None:  # noqa: N802 (http.server contract)
            path = self.path.split("?", 1)[0]
            try:
                if path == "/metrics":
                    body = to_prometheus(reg).encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif json_provider is not None and path in (
                    "/metrics.json", "/json", "/stats"
                ):
                    body = json.dumps(json_provider()).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
            except Exception:
                logger.exception("metrics render failed")
                self.send_response(500)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt: str, *args) -> None:
            logger.debug("metrics http: " + fmt, *args)

    server = _ClosableHTTPServer(("127.0.0.1", port), _Handler)
    threading.Thread(
        target=server.serve_forever, daemon=True, name=name
    ).start()
    return server


class Reporter:
    """Background interval flusher + close-time dump.

    Every ``interval`` seconds (monotonic schedule — L008 territory) the
    reporter takes a registry snapshot and hands it to the sink:

    - ``path``: append one JSON line per flush
      (``{"ts": wall-clock, "uptime_secs": ..., "snapshot": {...}}``) —
      a perf trajectory a later run can diff;
    - ``sink``: any callable taking the flush dict (e.g. a logger, a
      pusher);
    - neither: log a compact summary at INFO.

    ``close()`` flushes one final snapshot and joins the thread; it is
    idempotent and also runs via context manager exit.
    """

    def __init__(
        self,
        registry: Optional[MetricRegistry] = None,
        interval: float = 60.0,
        path: Optional[str] = None,
        sink: Optional[Callable[[Dict[str, Any]], None]] = None,
    ) -> None:
        self._registry = registry or default_registry()
        self.interval = max(0.01, float(interval))
        self._path = path
        self._sink = sink
        self._stop = threading.Event()
        self._t0 = time.perf_counter()
        self.flushes = 0
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="telemetry-reporter"
        )
        self._thread.start()

    def _emit(self, out: Optional[TextIO] = None) -> None:
        record = {
            "ts": time.time(),  # noqa: L008 (wall-clock timestamp for the log record, not a duration)
            "uptime_secs": round(time.perf_counter() - self._t0, 6),
            "snapshot": self._registry.snapshot(),
        }
        with self._lock:
            self.flushes += 1
            if self._sink is not None:
                try:
                    self._sink(record)
                except Exception:
                    logger.exception("telemetry sink failed")
            elif self._path is not None:
                with open(self._path, "a") as f:
                    f.write(json.dumps(record) + "\n")
            else:
                snap = record["snapshot"]
                logger.info(
                    "telemetry: %d counters, %d gauges, %d histograms",
                    len(snap["counters"]),
                    len(snap["gauges"]),
                    len(snap["histograms"]),
                )

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._emit()
            except Exception:
                logger.exception("telemetry flush failed")

    def close(self) -> None:
        """Stop the thread and write the final snapshot. A failing
        close-time dump (disk full, path removed) is logged, not
        raised — telemetry must never crash a caller's teardown."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        try:
            self._emit()
        except Exception:
            logger.exception("telemetry close-time flush failed")

    def __enter__(self) -> "Reporter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
