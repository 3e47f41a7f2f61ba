"""Tracker-side aggregation: per-rank snapshots → cluster-wide series,
served over a local HTTP ``/metrics`` endpoint.

Workers piggyback compact registry snapshots on tracker heartbeats
(``RabitWorker.heartbeat`` → cmd=metrics); the tracker feeds each
payload into a ``ClusterAggregator``, which keeps the latest snapshot
per rank and derives cluster totals on demand:

- counters and gauges sum across ranks (gauges of the same name are
  assumed additive fleet-wide — queue depths, in-flight bytes; per-rank
  readings stay available under the ``rank`` label);
- histograms merge by elementwise bucket addition (identical ``le``
  arrays — all ranks run the same code; a rank that diverges is kept
  per-rank and skipped from the merge rather than corrupting it);
- percentiles are recomputed from the merged buckets.

``serve_metrics`` binds a loopback-only HTTP server: ``GET /metrics``
is the Prometheus exposition (cluster totals unlabeled, per-rank series
labeled ``rank="N"``), ``GET /metrics.json`` the full JSON report. The
same report is written at end of job (``DMLC_METRICS_REPORT``).
"""

from __future__ import annotations

import json
import logging
import math
import threading
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from .export import _ClosableHTTPServer, to_prometheus
from .registry import render_key, split_key
from .timeseries import ClusterTimeSeries

__all__ = ["ClusterAggregator", "merge_snapshots", "serve_metrics"]

logger = logging.getLogger("dmlc_core_tpu_torch.telemetry")

Snapshot = Dict[str, Any]


def _num(v) -> bool:
    # non-finite values are dropped too: json.dumps(nan) is not valid
    # JSON, so one NaN gauge would corrupt /metrics.json and the
    # end-of-job report file for strict parsers
    return (
        isinstance(v, (int, float))
        and not isinstance(v, bool)
        and math.isfinite(v)
    )


def _sanitize(payload: Dict[str, Any]) -> Snapshot:
    """Keep only well-formed series from a heartbeat payload. Workers
    may be buggy, version-skewed or hostile; one malformed series must
    cost that series, never a poisoned per-rank snapshot that breaks
    every later merge/scrape/end-of-job report."""
    out: Snapshot = {"counters": {}, "gauges": {}, "histograms": {}}
    for kind in ("counters", "gauges"):
        vals = payload.get(kind)
        if isinstance(vals, dict):
            out[kind] = {
                str(k): v for k, v in vals.items() if _num(v)
            }
    hists = payload.get("histograms")
    if isinstance(hists, dict):
        for k, h in hists.items():
            if not isinstance(h, dict):
                continue
            le, n = h.get("le"), h.get("n")
            if not (
                isinstance(le, list)
                and le  # empty bounds would crash percentile math
                and isinstance(n, list)
                and len(n) == len(le) + 1
                and all(_num(b) for b in le)
                and all(_num(c) and c >= 0 for c in n)
                and _num(h.get("count"))
                and _num(h.get("sum"))
            ):
                continue
            keep = {
                "le": list(le),
                "n": list(n),
                "count": h["count"],
                "sum": h["sum"],
            }
            for opt in ("min", "max"):
                if _num(h.get(opt)):
                    keep[opt] = h[opt]
            out["histograms"][str(k)] = keep
    return out


def _merge_hist(a: Dict[str, Any], b: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Elementwise bucket merge; None when the edges disagree."""
    if a["le"] != b["le"] or len(a["n"]) != len(b["n"]):
        return None
    out: Dict[str, Any] = {
        "le": list(a["le"]),
        "n": [x + y for x, y in zip(a["n"], b["n"])],
        "count": a["count"] + b["count"],
        "sum": a["sum"] + b["sum"],
    }
    mins = [h["min"] for h in (a, b) if "min" in h]
    maxs = [h["max"] for h in (a, b) if "max" in h]
    if mins:
        out["min"] = min(mins)
    if maxs:
        out["max"] = max(maxs)
    return out


def merge_snapshots(snaps: List[Snapshot]) -> Snapshot:
    """Sum counters/gauges and merge histogram buckets across snapshots
    (series align by their rendered key). Percentiles are recomputed
    from the merged buckets."""
    from .registry import percentiles

    out: Snapshot = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in snaps:
        for kind in ("counters", "gauges"):
            for k, v in (snap.get(kind) or {}).items():
                out[kind][k] = out[kind].get(k, 0) + v
        for k, h in (snap.get("histograms") or {}).items():
            prev = out["histograms"].get(k)
            if prev is None:
                out["histograms"][k] = {
                    key: (list(v) if isinstance(v, list) else v)
                    for key, v in h.items()
                }
                continue
            merged = _merge_hist(prev, h)
            if merged is None:
                logger.warning(
                    "histogram %s has mismatched bucket edges across "
                    "ranks; keeping the first and skipping the rest", k
                )
                continue
            out["histograms"][k] = merged
    for k, h in out["histograms"].items():
        h.update(percentiles(h))
    return out


class ClusterAggregator:
    """Latest snapshot per rank + derived cluster totals."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_rank: Dict[int, Snapshot] = {}
        self.updates = 0
        #: per-rank windowed sample store fed by the heartbeats'
        #: ``timeseries`` key (telemetry/timeseries.py); the tracker's
        #: own registry samples ride it under the ``tracker`` pseudo-
        #: rank (how queue-depth history reaches /metrics.json?window=)
        self.timeseries = ClusterTimeSeries()
        #: extra report sections contributed by OTHER subsystems:
        #: name -> zero-arg callable returning a JSON-able dict,
        #: evaluated per report. The tracker registers its autoscale
        #: controller's status here ("autoscale"), keeping telemetry
        #: free of tracker imports. A failing section is dropped, not
        #: fatal — a status bug must never break /metrics.json.
        self.extra_sections: Dict[str, Any] = {}

    def update(self, rank: int, payload) -> None:
        """Record ``payload`` (a snapshot dict or its JSON string) as
        rank's latest; its ``timeseries`` key (new ring samples since
        the last heartbeat) feeds the per-rank sample store. Malformed
        payloads are dropped with a warning — a worker's bad heartbeat
        must never hurt the tracker."""
        if isinstance(payload, (str, bytes)):
            try:
                payload = json.loads(payload)
            except ValueError:
                logger.warning("rank %d sent unparseable metrics", rank)
                return
        if not isinstance(payload, dict):
            logger.warning("rank %d sent non-dict metrics", rank)
            return
        samples = payload.get("timeseries")
        if samples is not None:
            self.timeseries.add(int(rank), samples)
        clean = _sanitize(payload)
        with self._lock:
            self._by_rank[int(rank)] = clean
            self.updates += 1

    def per_rank(self) -> Dict[int, Snapshot]:
        with self._lock:
            return dict(self._by_rank)

    def cluster(self) -> Snapshot:
        return merge_snapshots(list(self.per_rank().values()))

    def windowed(self, seconds: float) -> Dict[str, Any]:
        """Windowed rates per rank + cluster over the sample store
        (the ``/metrics.json?window=N`` body's ``windowed`` key)."""
        return self.timeseries.window(seconds)

    def report(self, window: Optional[float] = None) -> Dict[str, Any]:
        """End-of-job shape: cluster totals + per-rank snapshots + the
        full retained time series (the trajectory BENCH runs diff).
        ``window`` swaps the heavy full series for the live
        windowed-rate view — the ``?window=`` polls a dashboard issues
        every couple of seconds only read ``windowed``, and
        re-serializing minutes of full snapshots per refresh would tax
        the tracker for bytes nobody reads (the plain ``/metrics.json``
        and the end-of-job report keep the full series)."""
        by_rank = self.per_rank()
        out = {
            "n_ranks": len(by_rank),
            "cluster": merge_snapshots(list(by_rank.values())),
            "per_rank": {str(r): s for r, s in sorted(by_rank.items())},
        }
        if window is not None:
            out["windowed"] = self.windowed(window)
        else:
            out["timeseries"] = self.timeseries.report()
        for name, section in list(self.extra_sections.items()):
            try:
                out[str(name)] = section()
            except Exception:
                logger.exception("report section %r failed", name)
        return out

    def prometheus(self) -> str:
        """One VALID scrape body: cluster totals (unlabeled) and
        per-rank series (labeled ``rank="N"``) folded into a single
        snapshot before rendering, so each metric family gets exactly
        one ``# TYPE`` line with all its series contiguous — a real
        Prometheus scraper rejects a body with duplicate TYPE lines or
        interleaved families (which naive per-rank concatenation
        produces)."""
        by_rank = self.per_rank()
        combined = merge_snapshots(list(by_rank.values()))
        for rank, snap in sorted(by_rank.items()):
            for kind in ("counters", "gauges", "histograms"):
                for key, v in (snap.get(kind) or {}).items():
                    name, labels = split_key(key)
                    labels["rank"] = str(rank)
                    combined[kind][render_key(name, labels)] = v
        return to_prometheus(combined)


class _MetricsHandler(BaseHTTPRequestHandler):
    aggregator: ClusterAggregator  # set by serve_metrics on the subclass

    def do_GET(self) -> None:  # noqa: N802 (http.server contract)
        parts = urlsplit(self.path)
        path = parts.path
        try:
            if path == "/metrics":
                body = self.aggregator.prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path in ("/metrics.json", "/json"):
                # ?window=SECONDS adds the windowed-rate view computed
                # over the per-rank sample store (the JAX package's docs/observability.md
                # "Time series"); a malformed value degrades to the
                # plain report instead of a 500
                window = None
                raw = parse_qs(parts.query).get("window")
                if raw:
                    try:
                        window = max(0.001, float(raw[0]))
                    except ValueError:
                        window = None
                body = json.dumps(
                    self.aggregator.report(window=window)
                ).encode()
                ctype = "application/json"
            else:
                self.send_response(404)
                self.end_headers()
                return
        except Exception:
            # a render failure costs this scrape, not the server
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


def serve_metrics(
    aggregator: ClusterAggregator,
    host: str = "127.0.0.1",
    port: int = 0,
) -> Tuple[_ClosableHTTPServer, int]:
    """Start the loopback metrics endpoint on a daemon thread; returns
    (server, bound_port). ``server.shutdown()`` + ``server_close()``
    stop it (both idempotent — export.py's _ClosableHTTPServer)."""
    handler = type(
        "_BoundMetricsHandler", (_MetricsHandler,), {"aggregator": aggregator}
    )
    server = _ClosableHTTPServer((host, port), handler)
    threading.Thread(
        target=server.serve_forever, daemon=True, name="metrics-http"
    ).start()
    return server, server.server_address[1]
