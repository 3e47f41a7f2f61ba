"""Windowed time series over the metric registry: the sensor substrate
for closed-loop control (ROADMAP item 3) and the live ``tools top``
dashboard.

The registry (registry.py) answers "what is the total now"; the flight
recorder (tracing.py) answers "what happened, after the fact". Neither
answers the controller's question — "what is the ROWS/S and the stall
fraction over the last 30 seconds, per rank, right now" — which needs a
time dimension:

- **TimeSeriesRing** — a bounded per-process ring of timestamped
  registry snapshots, sampled every ``DMLC_TS_INTERVAL`` seconds
  (default 2; a sample is one registry snapshot ≈ tens of µs) and
  retained for ``DMLC_TS_WINDOW`` seconds (default 120). Samples carry
  a monotonically increasing ``seq`` so incremental consumers (the
  tracker heartbeat) ship only what is new.
- **windowed()** — the pure query both tiers share: counter deltas →
  rates (Prometheus-style counter-reset handling, so a relaunched
  worker's restarted counters read as "rate since restart", never a
  negative), gauge last/min/max, histogram bucket deltas → windowed
  p50/p90/p99, plus derived signals (rows/s, per-stage stall
  fractions from the ``trace.stall_seconds`` mirror, cache hit rates,
  lookup/dsserve QPS).
- **ClusterTimeSeries** — the tracker-side store: per-rank bounded
  series fed by ``cmd=metrics`` heartbeat payloads (each payload's
  ``timeseries`` key carries the ring's new samples). Sample time must
  be monotone per rank — a relaunched worker resumes the SAME rank's
  series, and a replayed/stale sample is dropped rather than making
  the clock go backwards. The tracker feeds its OWN registry in under
  the ``tracker`` pseudo-rank, which is how ``tracker.shards.
  queue_depth`` history reaches ``/metrics.json?window=``.

``/metrics.json?window=30`` (telemetry/aggregate.py) returns the
windowed view per rank and cluster-wide; the end-of-job report embeds
the full retained series, so a BENCH run records a trajectory instead
of one number (the JAX package's docs/observability.md "Time series").
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .registry import (
    MetricRegistry,
    default_registry,
    percentiles,
    split_key,
)

__all__ = [
    "TRACKER_RANK",
    "ClusterTimeSeries",
    "TimeSeriesRing",
    "default_ring",
    "ensure_default",
    "merge_windows",
    "summary_line",
    "windowed",
]

#: pseudo-rank the tracker's own samples live under in the cluster
#: store (rendered "tracker" in JSON — never collides with worker ranks)
TRACKER_RANK = -1

Sample = Dict[str, Any]


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def take_sample(
    registry: Optional[MetricRegistry] = None, seq: int = 0
) -> Sample:
    """One timestamped registry snapshot. ``t`` is the WALL clock —
    samples cross process restarts (the relaunched worker's series
    continues the dead one's) and hosts, which monotonic clocks cannot
    do; rates divide wall deltas, where NTP slew is noise against a
    2 s cadence."""
    snap = (registry or default_registry()).snapshot()
    return {
        "t": time.time(),  # noqa: L008 (series timestamp, not a duration)
        "seq": int(seq),
        "counters": snap.get("counters", {}),
        "gauges": snap.get("gauges", {}),
        "histograms": snap.get("histograms", {}),
    }


class TimeSeriesRing:
    """Bounded per-process sample ring with an optional sampler thread.

    ``sample()`` appends one snapshot now (heartbeats force one so the
    shipped series always reaches the present); ``start()`` runs the
    interval sampler on a daemon thread; ``samples(since=seq)`` returns
    the increments an incremental consumer has not shipped yet;
    ``window(seconds)`` is the windowed view over the retained ring.
    Thread-safe; retention is time-based (``DMLC_TS_WINDOW``) with a
    hard sample cap as the backstop against a misconfigured interval.
    """

    _MAX_SAMPLES = 4096

    def __init__(
        self,
        registry: Optional[MetricRegistry] = None,
        interval: Optional[float] = None,
        retention: Optional[float] = None,
        on_sample: Optional[Callable[[Sample], None]] = None,
    ) -> None:
        self._registry = registry or default_registry()
        self.interval = max(
            0.05,
            interval
            if interval is not None
            else _env_float("DMLC_TS_INTERVAL", 2.0),
        )
        self.retention = max(
            self.interval,
            retention
            if retention is not None
            else _env_float("DMLC_TS_WINDOW", 120.0),
        )
        self._on_sample = on_sample
        self._lock = threading.Lock()
        self._samples: List[Sample] = []
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producing ------------------------------------------------------------
    def sample(self) -> Sample:
        """Take one snapshot now, append it, and return it. The whole
        allocate-snapshot-append sequence runs under the ring lock:
        the sampler thread and a heartbeat's forced sample run
        concurrently by design, and splitting the lock would let their
        samples land out of seq/time order — the cluster store would
        then drop the younger-seq sample as stale. A snapshot is tens
        of µs, so holding the lock across it costs nothing at a 2 s
        cadence."""
        with self._lock:
            self._seq += 1
            s = take_sample(self._registry, self._seq)
            if self._samples and s["t"] <= self._samples[-1]["t"]:
                # same-tick samples (or a wall-clock hiccup): nudge
                # forward so per-ring time stays strictly monotone
                s["t"] = self._samples[-1]["t"] + 1e-6
            self._samples.append(s)
            cutoff = s["t"] - self.retention
            while len(self._samples) > self._MAX_SAMPLES or (
                len(self._samples) > 1 and self._samples[0]["t"] < cutoff
            ):
                self._samples.pop(0)
        if self._on_sample is not None:
            try:
                self._on_sample(s)
            except Exception:
                pass  # a sink failure must never kill the sampler
        return s

    def start(self) -> "TimeSeriesRing":
        """Start the interval sampler (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="telemetry-timeseries"
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.sample()
            except Exception:
                pass  # sampling must never kill its own thread

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    # -- consuming ------------------------------------------------------------
    def samples(self, since: int = 0) -> List[Sample]:
        """Samples with ``seq > since``, oldest first (the heartbeat's
        incremental ship; ``since=0`` returns the whole ring)."""
        with self._lock:
            return [s for s in self._samples if s["seq"] > since]

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._seq

    def window(self, seconds: float) -> Dict[str, Any]:
        with self._lock:
            samples = list(self._samples)
        return windowed(samples, seconds)


# -- the default per-process ring ---------------------------------------------

_DEFAULT: Optional[TimeSeriesRing] = None
_DEFAULT_LOCK = threading.Lock()


def default_ring(create: bool = True) -> Optional[TimeSeriesRing]:
    """The process's shared ring (None when ``create=False`` and none
    exists yet — how the heartbeat asks 'is sampling on?')."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None and create:
            _DEFAULT = TimeSeriesRing()
        return _DEFAULT


def ensure_default() -> TimeSeriesRing:
    """Create AND start the default ring (idempotent) — called by
    ``RabitWorker.start()`` so every rendezvoused worker samples by
    default; ``DMLC_TS_INTERVAL=0`` is rejected to a 50 ms floor, use
    ``DMLC_TS=off`` to disable sampling entirely."""
    ring = default_ring()
    assert ring is not None
    return ring.start()


def sampling_enabled() -> bool:
    return os.environ.get("DMLC_TS", "on").strip().lower() not in (
        "",
        "0",
        "off",
        "false",
        "no",
    )


# -- the windowed query --------------------------------------------------------

#: histogram families whose windowed delta is itself a wait signal,
#: mapped onto the flight recorder's stall-stage vocabulary (most
#: stall fractions come from the trace.stall_seconds mirror; these are
#: the registry-native ones that predate it)
_WAIT_HISTS = {
    "dsserve.recv_wait_seconds": "dsserve_recv_wait",
    "io.fetch.span_wait_seconds": "fetch_wait",
}


def _counter_delta(new: float, old: Optional[float]) -> float:
    """Prometheus counter-reset semantics: a value below its baseline
    means the process restarted — the delta since restart is the value
    itself, never a negative rate."""
    if old is None or new < old:
        return new
    return new - old


def windowed(
    samples: List[Sample], seconds: float, now: Optional[float] = None
) -> Dict[str, Any]:
    """Windowed view over one series of samples (oldest-first).

    The baseline is the newest sample at or before ``now - seconds``
    (else the oldest retained); the head is the newest sample. Returns
    counter deltas+rates, gauge last/min/max, histogram windowed
    percentiles, and the ``derived`` block ``tools top`` renders.
    """
    out: Dict[str, Any] = {
        "window_secs": float(seconds),
        "samples": len(samples),
    }
    if not samples:
        return out
    head = samples[-1]
    if now is None:
        now = head["t"]
    cutoff = now - seconds
    base: Optional[Sample] = None
    in_window = [samples[-1]]
    for s in samples[:-1]:
        if s["t"] <= cutoff:
            base = s
        else:
            in_window.append(s)
    out["t_head"] = head["t"]
    gauges: Dict[str, Any] = {}
    for key, last in (head.get("gauges") or {}).items():
        vals = [
            s["gauges"][key]
            for s in in_window
            if key in (s.get("gauges") or {})
        ]
        gauges[key] = {
            "last": last,
            "min": min(vals) if vals else last,
            "max": max(vals) if vals else last,
        }
    out["gauges"] = gauges
    if base is None:
        base = samples[0]
    dt = head["t"] - base["t"]
    out["span_secs"] = round(dt, 3)
    if base is head or dt <= 0:
        # one sample (or a zero-width window): no rates yet
        out["counters"] = {}
        out["histograms"] = {}
        out["derived"] = _derive({}, {}, gauges, 0.0)
        return out
    base_counters = base.get("counters") or {}
    counters: Dict[str, Any] = {}
    for key, v in (head.get("counters") or {}).items():
        delta = _counter_delta(v, base_counters.get(key))
        counters[key] = {
            "delta": round(delta, 6),
            "per_sec": round(delta / dt, 6),
        }
    out["counters"] = counters
    hists: Dict[str, Any] = {}
    base_hists = base.get("histograms") or {}
    for key, h in (head.get("histograms") or {}).items():
        d = _hist_delta(h, base_hists.get(key))
        if d is not None:
            d["per_sec"] = round(d["count"] / dt, 6)
            hists[key] = d
    out["histograms"] = hists
    out["derived"] = _derive(counters, hists, gauges, dt)
    return out


def _hist_delta(
    new: Dict[str, Any], old: Optional[Dict[str, Any]]
) -> Optional[Dict[str, Any]]:
    """Windowed histogram = bucketwise difference; a mismatched-edge or
    shrunk-count baseline (restart) degrades to 'since restart' — the
    head snapshot alone."""
    try:
        le, n = list(new["le"]), list(new["n"])
        if (
            old is not None
            and list(old.get("le") or []) == le
            and len(old.get("n") or []) == len(n)
            and old.get("count", 0) <= new.get("count", 0)
        ):
            dn = [a - b for a, b in zip(n, old["n"])]
            if all(x >= 0 for x in dn):
                n = dn
                count = new.get("count", 0) - old.get("count", 0)
                total = new.get("sum", 0.0) - old.get("sum", 0.0)
            else:
                count, total = new.get("count", 0), new.get("sum", 0.0)
        else:
            count, total = new.get("count", 0), new.get("sum", 0.0)
        d: Dict[str, Any] = {
            "le": le,
            "n": n,
            "count": count,
            "sum": round(float(total), 9),
        }
        if "max" in new:
            d["max"] = new["max"]  # window upper bound estimate
        if count:
            d.update(percentiles(d))
        return d
    except (KeyError, TypeError, ValueError):
        return None


def _gauge_last(gauges: Dict[str, Any], name: str):
    """Windowed-last of a gauge family; tolerates both the windowed
    ``{last,min,max}`` shape and a bare snapshot scalar."""
    g = gauges.get(name)
    if isinstance(g, dict):
        return g.get("last")
    return g


def _rate(counters: Dict[str, Any], name: str) -> float:
    """Summed per-sec rate of every series in a counter family."""
    total = 0.0
    for key, v in counters.items():
        if split_key(key)[0] == name:
            total += v.get("per_sec", 0.0)
    return total


def _derive(
    counters: Dict[str, Any],
    hists: Dict[str, Any],
    gauges: Dict[str, Any],
    dt: float,
) -> Dict[str, Any]:
    """The signals the dashboard/controller consumes, computed once
    here so every consumer (tools top, diag exits, the future
    autoscaler) agrees on definitions."""
    rows = _rate(counters, "staging.rows_out") or _rate(
        counters, "io.split.records"
    )
    stall: Dict[str, float] = {}
    for key, v in counters.items():
        name, labels = split_key(key)
        if name == "trace.stall_seconds" and dt > 0:
            stage = labels.get("stage", "?")
            stall[stage] = round(
                stall.get(stage, 0.0) + v["delta"] / dt, 4
            )
    for key, h in hists.items():
        name, _labels = split_key(key)
        stage = _WAIT_HISTS.get(name)
        if stage is not None and dt > 0 and stage not in stall:
            stall[stage] = round(h.get("sum", 0.0) / dt, 4)
    out: Dict[str, Any] = {
        "rows_per_sec": round(rows, 2),
        "stall_fraction": dict(sorted(stall.items())),
    }
    hits = _rate(counters, "io.blockcache.hits")
    misses = _rate(counters, "io.blockcache.misses")
    if hits + misses > 0:
        out["block_cache_hit_rate"] = round(hits / (hits + misses), 4)
    dh = _rate(counters, "io.codec.cache_hits")
    dm = _rate(counters, "io.codec.cache_misses")
    if dh + dm > 0:
        out["decode_cache_hit_rate"] = round(dh / (dh + dm), 4)
    lookup_qps = _rate(counters, "io.lookup.requests")
    if lookup_qps:
        out["lookup_qps"] = round(lookup_qps, 2)
        h = hists.get("io.lookup.request_seconds")
        if h and h.get("count"):
            out["lookup_p99_ms"] = round(h.get("p99", 0.0) * 1e3, 3)
    slots = _rate(counters, "dsserve.slots_served")
    if slots:
        out["dsserve_slots_per_sec"] = round(slots, 2)
    # data-plane efficiency: wire ratio < 1.0 means the adaptive codec
    # is winning (bytes on the wire per raw payload byte); shm_frac is
    # the slice of slots that skipped TCP entirely via shared memory
    wire = _rate(counters, "dsserve.bytes_wire")
    raw = _rate(counters, "dsserve.bytes_raw")
    if raw > 0:
        out["dsserve_wire_ratio"] = round(wire / raw, 4)
    shm = _rate(counters, "dsserve.shm_slots")
    tcp = _rate(counters, "dsserve.tcp_slots")
    if shm + tcp > 0:
        out["dsserve_shm_frac"] = round(shm / (shm + tcp), 4)
    qd = gauges.get("tracker.shards.queue_depth")
    if qd is not None:
        out["shard_queue_depth"] = qd
    # streaming follow: how stale is this rank's tail reader? (reader-
    # side gauges, stream/source.py; the writer publishes the same
    # watermark/lag family from its vantage)
    lag_r = _gauge_last(gauges, "stream.lag_records")
    lag_s = _gauge_last(gauges, "stream.lag_seconds")
    wm = _gauge_last(gauges, "stream.watermark_records")
    if wm is not None or lag_r is not None:
        out["stream_watermark_records"] = wm or 0.0
        out["stream_lag_records"] = lag_r or 0.0
        out["stream_lag_seconds"] = round(lag_s or 0.0, 3)
    return out


def summary_line(view: Dict[str, Any]) -> str:
    """One-line human summary of a windowed view — the shared exit
    print the diag tools emit (one implementation, so the two
    benchmarks cannot drift their formats apart)."""
    import json as _json

    d = view.get("derived") or {}
    return "windowed(last %gs of %d samples): rows/s=%s stall=%s" % (
        view.get("window_secs", 0.0),
        view.get("samples", 0),
        d.get("rows_per_sec", 0.0),
        _json.dumps(d.get("stall_fraction", {})),
    )


def merge_windows(views: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Cluster view from per-rank windowed views: counter deltas/rates
    sum; stall fractions and hit rates average over the ranks that
    reported them (a fraction is per-process — summing 3 ranks' 0.9
    into 2.7 would read as nonsense); gauges sum (queue depths and
    in-flight bytes are additive fleet-wide, matching the aggregate
    snapshot's convention)."""
    ranks = [v for v in views.values() if v.get("samples")]
    out: Dict[str, Any] = {"n_ranks": len(ranks)}
    if not ranks:
        return out
    counters: Dict[str, Dict[str, float]] = {}
    for v in ranks:
        for key, c in (v.get("counters") or {}).items():
            agg = counters.setdefault(key, {"delta": 0.0, "per_sec": 0.0})
            agg["delta"] = round(agg["delta"] + c.get("delta", 0.0), 6)
            agg["per_sec"] = round(agg["per_sec"] + c.get("per_sec", 0.0), 6)
    out["counters"] = counters
    gauges: Dict[str, Dict[str, float]] = {}
    for v in ranks:
        for key, g in (v.get("gauges") or {}).items():
            agg = gauges.get(key)
            if agg is None:
                gauges[key] = dict(g)
            else:
                for k in ("last", "min", "max"):
                    agg[k] = agg.get(k, 0) + g.get(k, 0)
    out["gauges"] = gauges
    derived: Dict[str, Any] = {"rows_per_sec": 0.0}
    stall: Dict[str, List[float]] = {}
    fracs: Dict[str, List[float]] = {}
    for v in ranks:
        d = v.get("derived") or {}
        derived["rows_per_sec"] = round(
            derived["rows_per_sec"] + d.get("rows_per_sec", 0.0), 2
        )
        for stage, f in (d.get("stall_fraction") or {}).items():
            stall.setdefault(stage, []).append(f)
        for k in (
            "block_cache_hit_rate",
            "decode_cache_hit_rate",
            "dsserve_wire_ratio",
            "dsserve_shm_frac",
        ):
            if k in d:
                fracs.setdefault(k, []).append(d[k])
        for k in ("lookup_qps", "dsserve_slots_per_sec"):
            if k in d:
                derived[k] = round(derived.get(k, 0.0) + d[k], 2)
        if "lookup_p99_ms" in d:
            derived["lookup_p99_ms"] = max(
                derived.get("lookup_p99_ms", 0.0), d["lookup_p99_ms"]
            )
        if "shard_queue_depth" in d:
            derived["shard_queue_depth"] = d["shard_queue_depth"]
        # cluster staleness is the SLOWEST follower's, not an average —
        # a lagging rank is exactly what the lag column must surface
        for k in (
            "stream_lag_seconds",
            "stream_lag_records",
            "stream_watermark_records",
        ):
            if k in d:
                derived[k] = max(derived.get(k, 0.0), d[k])
    derived["stall_fraction"] = {
        k: round(sum(v) / len(v), 4) for k, v in sorted(stall.items())
    }
    for k, v in fracs.items():
        derived[k] = round(sum(v) / len(v), 4)
    out["derived"] = derived
    return out


# -- tracker-side cluster store ------------------------------------------------


class ClusterTimeSeries:
    """Per-rank bounded sample series fed by heartbeat payloads.

    ``add`` enforces per-rank time monotonicity: a sample at or before
    the rank's newest retained timestamp is dropped — a relaunched
    worker re-sending its dead predecessor's tail (or a skewed clock)
    must never make the series go backwards; counter resets inside the
    accepted samples are ``windowed()``'s business. Retention mirrors
    the process ring (``DMLC_TS_WINDOW`` + a hard cap)."""

    _MAX_SAMPLES = 4096

    def __init__(self, retention: Optional[float] = None) -> None:
        self.retention = max(
            1.0,
            retention
            if retention is not None
            else _env_float("DMLC_TS_WINDOW", 120.0),
        )
        self._lock = threading.Lock()
        self._by_rank: Dict[int, List[Sample]] = {}
        self.dropped_stale = 0

    @staticmethod
    def _clean(sample) -> Optional[Sample]:
        if not isinstance(sample, dict):
            return None
        t = sample.get("t")
        if not isinstance(t, (int, float)) or isinstance(t, bool) or t <= 0:
            return None
        out: Sample = {"t": float(t), "seq": int(sample.get("seq", 0) or 0)}
        for kind in ("counters", "gauges", "histograms"):
            v = sample.get(kind)
            out[kind] = v if isinstance(v, dict) else {}
        return out

    def add(self, rank: int, samples) -> int:
        """Append a heartbeat's new samples; returns how many were
        accepted (malformed and non-monotone ones are dropped and
        counted, never raised — heartbeats may be hostile)."""
        if not isinstance(samples, (list, tuple)):
            return 0
        accepted = 0
        with self._lock:
            series = self._by_rank.setdefault(int(rank), [])
            for raw in samples:
                s = self._clean(raw)
                if s is None:
                    continue
                if series and s["t"] <= series[-1]["t"]:
                    self.dropped_stale += 1
                    continue
                series.append(s)
                accepted += 1
            if series:
                cutoff = series[-1]["t"] - self.retention
                while len(series) > self._MAX_SAMPLES or (
                    len(series) > 1 and series[0]["t"] < cutoff
                ):
                    series.pop(0)
        return accepted

    def ranks(self) -> List[int]:
        with self._lock:
            return sorted(self._by_rank)

    @staticmethod
    def _rank_key(rank: int) -> str:
        return "tracker" if rank == TRACKER_RANK else str(rank)

    def window(self, seconds: float) -> Dict[str, Any]:
        """The ``/metrics.json?window=`` body: per-rank windowed views
        plus the cluster merge (the JAX package's docs/observability.md)."""
        with self._lock:
            series = {r: list(s) for r, s in self._by_rank.items()}
        per_rank = {
            self._rank_key(r): windowed(s, seconds)
            for r, s in series.items()
        }
        workers = {
            k: v for k, v in per_rank.items() if k != "tracker"
        }
        return {
            "window_secs": float(seconds),
            "per_rank": per_rank,
            "cluster": merge_windows(workers),
        }

    def report(self) -> Dict[str, Any]:
        """Full retained series per rank (the end-of-job trajectory)."""
        with self._lock:
            return {
                "retention_secs": self.retention,
                "dropped_stale": self.dropped_stale,
                "per_rank": {
                    self._rank_key(r): list(s)
                    for r, s in sorted(self._by_rank.items())
                },
            }
