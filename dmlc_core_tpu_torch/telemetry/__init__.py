"""Host-side telemetry (the port's copy of ``dmlc_core_tpu/telemetry``,
with the same names, metric names, label keys, env knobs and wire/JSON
forms, so that processes of either package share a tracker, a
``/metrics`` scrape and a merged trace). Nothing here imports torch.

- **registry**: the process-global ``MetricRegistry`` of ``Counter`` /
  ``Gauge`` / log-bucketed ``Histogram`` series; thread-sharded
  lock-free writes, hierarchical names + labels, cardinality cap,
  ``ScopedView`` counter deltas.
- **export**: Prometheus text exposition, JSON snapshots and a
  background interval ``Reporter``.
- **aggregate**: the tracker's per-rank/cluster merge of worker
  heartbeat snapshots, served over a loopback HTTP ``/metrics``
  endpoint and an end-of-job JSON report.
- **tracing**: the flight recorder: per-thread span rings with
  Chrome/Perfetto export, cross-process merge, stall attribution and
  RPC flow events (``profiler.annotate`` feeds it).
- **timeseries**: windowed rates: a bounded per-process ring of
  timestamped registry samples, shipped on tracker heartbeats into a
  cluster store behind ``/metrics.json?window=N`` (what ``tools top``
  renders).
"""

from . import timeseries as timeseries
from . import tracing as tracing
from .aggregate import ClusterAggregator, merge_snapshots, serve_metrics
from .export import Reporter, serve_metrics_http, to_json, to_prometheus
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricRegistry,
    ScopedView,
    default_registry,
    log_bounds,
    render_key,
    split_key,
)

__all__ = [
    "ClusterAggregator",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "Reporter",
    "ScopedView",
    "default_registry",
    "log_bounds",
    "merge_snapshots",
    "render_key",
    "serve_metrics",
    "serve_metrics_http",
    "split_key",
    "timeseries",
    "to_json",
    "to_prometheus",
    "tracing",
]
