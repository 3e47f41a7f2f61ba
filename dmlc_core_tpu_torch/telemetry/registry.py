"""Process-global metric registry: counters, gauges, log-bucketed
histograms (the port's copy of ``dmlc_core_tpu/telemetry/registry.py``;
bucket edges, names and snapshot forms are the same, so snapshots of
the two packages merge).

- **Hierarchical names + labels**: ``io.retry.retries``,
  ``staging.stage_seconds{stage="host_pull"}``. A (name, labels) pair
  identifies one time series; registering it twice returns the SAME
  metric object, so producers anywhere in the process share series
  without plumbing references through constructors.
- **Thread-sharded writes**: the hot path (``Counter.inc``,
  ``Histogram.observe``) touches only a per-thread cell: no lock, no
  contention with other writer threads (parse pools, the staging and
  transfer threads all tick concurrently). Cells are merged at snapshot
  time under a lock that only creation/snapshot take. A finished
  thread's cell is folded into a retired total on the next read:
  cumulative semantics survive the thread, memory does not grow with
  thread churn.
- **Log-bucketed histograms**: geometric bucket bounds (factor 2 from
  1µs by default) hold five decades of duration in ~35 ints per thread;
  snapshots carry the raw buckets (mergeable across ranks) plus
  interpolated p50/p90/p99.
- **Label cardinality cap**: a family accepts at most
  ``DMLC_METRIC_LABEL_CAP`` (64) distinct label sets; beyond that,
  new label sets collapse into one ``{overflow="true"}`` series and the
  ``telemetry.label_overflow`` counter ticks.
- **Scoped views** (``ScopedView``): snapshot the counters you care
  about at construction, read ``delta()`` later, ``rebase()`` to reset.
  Reads go through ``counter_values`` (counters only, no histogram
  merging); ``io/retry.py``'s ``stats()`` / ``reset_stats()`` are a
  ScopedView over its three series.

Durations observed into histograms come from ``perf_counter`` /
``monotonic``, never ``time.time()``.
"""

from __future__ import annotations

import os
import re
import threading
import weakref
from bisect import bisect_left
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricRegistry",
    "ScopedView",
    "default_registry",
    "log_bounds",
    "render_key",
    "split_key",
]

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_.]*$")
_LABEL_KEY_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _check_name(name: str) -> None:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")


def render_key(name: str, labels: Optional[Dict[str, str]] = None) -> str:
    """Canonical series key: ``name`` or ``name{k="v",...}`` with label
    keys sorted and values escaped — Prometheus label syntax, so the
    key doubles as the exposition series (after name mangling)."""
    if not labels:
        return name
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{v}"')
    return name + "{" + ",".join(parts) + "}"


_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def split_key(key: str) -> Tuple[str, Dict[str, str]]:
    """Inverse of ``render_key`` (used by the exporters and the tracker
    aggregator, which work from snapshot dicts keyed by series)."""
    i = key.find("{")
    if i < 0:
        return key, {}
    labels = {
        k: v.replace('\\"', '"').replace("\\\\", "\\")
        for k, v in _LABEL_RE.findall(key[i + 1 : -1])
    }
    return key[:i], labels


def log_bounds(lo: float, hi: float, factor: float = 2.0) -> Tuple[float, ...]:
    """Geometric bucket upper bounds from ``lo`` up to (at least) ``hi``."""
    if not (lo > 0 and hi > lo and factor > 1):
        raise ValueError("need 0 < lo < hi and factor > 1")
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


#: default duration buckets: 1µs … ~137s in factor-2 steps (28 buckets);
#: beyond the last bound lands in the +Inf overflow bucket
DEFAULT_DURATION_BOUNDS = log_bounds(1e-6, 100.0)


class _Cell:
    """One thread's private accumulator (no lock on the write path)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0


class _AlwaysAlive:
    @staticmethod
    def is_alive() -> bool:
        return True


_ALWAYS_ALIVE = _AlwaysAlive()


def _owner_ref():
    """Weakref to the writing thread, so read paths can detect a
    finished thread and fold its cell into a retired total (an
    is_alive()==False thread has returned from run(), so its final cell
    write happened-before the fold) — per-metric memory and read cost
    stay proportional to LIVE threads under thread churn, not to every
    thread that ever ticked the metric."""
    try:
        return weakref.ref(threading.current_thread())
    except TypeError:  # exotic thread objects: keep the cell forever
        return lambda: _ALWAYS_ALIVE


class Counter:
    """Monotonic counter with thread-sharded, lock-free increments.

    Cells of finished threads are folded into ``_retired`` on the next
    read — cumulative semantics preserved, no unbounded growth under
    thread churn."""

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._cells: List[Tuple[Callable[[], object], _Cell]] = []
        self._retired = 0.0
        self._local = threading.local()

    def _make_cell(self) -> _Cell:
        cell = _Cell()
        with self._lock:
            self._cells.append((_owner_ref(), cell))
        self._local.cell = cell
        return cell

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError("counters only go up (use a Gauge)")
        try:
            cell = self._local.cell
        except AttributeError:
            cell = self._make_cell()
        cell.value += n  # thread-private: no lock, no race

    def value(self) -> float:
        with self._lock:
            total = self._retired
            live = []
            for ref, cell in self._cells:
                owner = ref()
                if owner is None or not owner.is_alive():
                    self._retired += cell.value  # fold: thread is done
                else:
                    live.append((ref, cell))
                total += cell.value
            self._cells = live
        return total


class Gauge:
    """Point-in-time value: ``set``/``inc``/``dec``, or a callable
    sampled at snapshot time (``set_fn``) for values owned elsewhere
    (queue depths, ring occupancy). Not a hot-path type — one lock."""

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None
        self._peak = False  # ever written through set_max()

    def set(self, v: float) -> None:
        with self._lock:
            self._fn = None
            self._value = float(v)

    def set_max(self, v: float) -> None:
        """High-water-mark write: keep the larger of current and ``v``
        and mark this gauge peak-style, so ``reset_max()`` /
        ``MetricRegistry.reset_peak_gauges()`` can rewind it between
        measurement scopes (bench configs). A plain ``set`` race
        between two writers would lose the larger reading; this is the
        one atomic compare-and-keep site."""
        with self._lock:
            self._peak = True
            self._fn = None
            v = float(v)
            if v > self._value:
                self._value = v

    def reset_max(self) -> None:
        """Rewind a peak-style gauge to 0 (no-op on gauges never
        written through ``set_max`` — live inc/dec accounting must not
        be zeroed by a scope reset)."""
        with self._lock:
            if self._peak:
                self._value = 0.0

    def is_peak(self) -> bool:
        with self._lock:
            return self._peak

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1) -> None:
        self.inc(-n)

    def set_fn(self, fn: Optional[Callable[[], float]]) -> None:
        with self._lock:
            self._fn = fn

    def value(self) -> float:
        with self._lock:
            fn = self._fn
            if fn is None:
                return self._value
        try:
            return float(fn())
        except Exception:  # a broken probe must not kill a snapshot
            return float("nan")


class _HistCell:
    """One thread's private histogram shard."""

    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * n_buckets
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")


class Histogram:
    """Log-bucketed histogram, thread-sharded like ``Counter``.

    ``bounds`` are upper bucket edges (``v <= bound`` lands in the
    bucket — Prometheus ``le`` semantics); an implicit +Inf overflow
    bucket catches the rest. The default edges suit durations in
    seconds (1µs…137s, factor 2).
    """

    def __init__(
        self,
        name: str,
        help: str = "",
        bounds: Optional[Iterable[float]] = None,
    ) -> None:
        self.name = name
        self.help = help
        self.bounds: Tuple[float, ...] = tuple(
            bounds if bounds is not None else DEFAULT_DURATION_BOUNDS
        )
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError("histogram bounds must be strictly increasing")
        self._lock = threading.Lock()
        self._cells: List[Tuple[Callable[[], object], _HistCell]] = []
        # folded shard of finished threads' cells (see Counter)
        self._retired = _HistCell(len(self.bounds) + 1)
        self._local = threading.local()

    def _make_cell(self) -> _HistCell:
        cell = _HistCell(len(self.bounds) + 1)
        with self._lock:
            self._cells.append((_owner_ref(), cell))
        self._local.cell = cell
        return cell

    def observe(self, v: float) -> None:
        try:
            cell = self._local.cell
        except AttributeError:
            cell = self._make_cell()
        # first bound >= v (le semantics); past the end = overflow bucket
        cell.counts[bisect_left(self.bounds, v)] += 1
        cell.sum += v
        cell.count += 1
        if v < cell.min:
            cell.min = v
        if v > cell.max:
            cell.max = v

    def snapshot(self) -> Dict[str, Any]:
        """Raw buckets + moments + interpolated percentiles. ``le`` has
        the finite bounds; ``n`` has one extra trailing entry (the +Inf
        overflow bucket). Mergeable across processes by elementwise
        bucket addition when ``le`` matches (telemetry/aggregate.py)."""
        with self._lock:
            retired = self._retired
            live = []
            cells = [retired]
            for ref, cell in self._cells:
                owner = ref()
                if owner is None or not owner.is_alive():
                    # fold the finished thread's shard (see Counter)
                    for i, n in enumerate(cell.counts):
                        retired.counts[i] += n
                    retired.count += cell.count
                    retired.sum += cell.sum
                    retired.min = min(retired.min, cell.min)
                    retired.max = max(retired.max, cell.max)
                else:
                    live.append((ref, cell))
                    cells.append(cell)
            self._cells = live
        counts = [0] * (len(self.bounds) + 1)
        total, acc = 0, 0.0
        lo, hi = float("inf"), float("-inf")
        for c in cells:
            for i, n in enumerate(c.counts):
                counts[i] += n
            total += c.count
            acc += c.sum
            lo = min(lo, c.min)
            hi = max(hi, c.max)
        out: Dict[str, Any] = {
            "le": list(self.bounds),
            "n": counts,
            "count": total,
            "sum": acc,
        }
        if total:
            out["min"] = lo
            out["max"] = hi
            out.update(percentiles(out))
        return out


def percentiles(
    hist: Dict[str, Any], qs: Tuple[float, ...] = (0.5, 0.9, 0.99)
) -> Dict[str, float]:
    """Interpolated quantiles from a bucketed snapshot (``le``/``n``
    arrays as produced by ``Histogram.snapshot``). Linear interpolation
    within the winning bucket; the overflow bucket reports the max (or
    the last finite bound when max is unknown)."""
    bounds = hist["le"]
    counts = hist["n"]
    total = sum(counts)
    out: Dict[str, float] = {}
    if not total:
        return out
    # a lazy fallback chain: "max" when known, else the last finite
    # bound, else 0 — never index an empty bounds list (a foreign
    # snapshot with le=[] must degrade, not crash the whole scrape)
    ceiling = hist.get("max")
    if ceiling is None:
        ceiling = bounds[-1] if bounds else 0.0
    ceiling = float(ceiling)
    for q in qs:
        target = q * total
        seen = 0.0
        val = ceiling
        for i, n in enumerate(counts):
            if n == 0:
                continue
            if seen + n >= target:
                if i >= len(bounds):  # overflow bucket
                    val = ceiling
                else:
                    hi = bounds[i]
                    lo = bounds[i - 1] if i > 0 else 0.0
                    val = lo + (hi - lo) * ((target - seen) / n)
                break
            seen += n
        out[f"p{int(q * 100)}"] = val
    return out


def _label_cap() -> int:
    try:
        return max(1, int(os.environ.get("DMLC_METRIC_LABEL_CAP", "64")))
    except ValueError:
        return 64


class _Family:
    """All series sharing one metric name: type, help, bounds, children
    keyed by their sorted label tuple, and the cardinality cap."""

    def __init__(self, kind: str, help: str, bounds) -> None:
        self.kind = kind
        self.help = help
        self.bounds = bounds
        self.children: Dict[Tuple[Tuple[str, str], ...], Any] = {}


class MetricRegistry:
    """Get-or-create registry of metric families.

    ``counter``/``gauge``/``histogram`` return the existing series when
    (name, labels) was seen before — re-registration anywhere in the
    process yields the same object, which is what makes a process-global
    registry usable without threading references around.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- registration ---------------------------------------------------------
    def _series(
        self,
        kind: str,
        name: str,
        help: str,
        labels: Optional[Dict[str, str]],
        bounds=None,
    ):
        _check_name(name)
        for k in labels or ():
            if not _LABEL_KEY_RE.match(k):
                raise ValueError(f"invalid label key {k!r}")
        lkey = tuple(sorted((k, str(v)) for k, v in (labels or {}).items()))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(kind, help, bounds)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            child = fam.children.get(lkey)
            if child is not None:
                return child
            if lkey and len(fam.children) >= _label_cap():
                # cardinality cap: collapse into the overflow series
                # (created on first overflow). The overflowed lkey is
                # deliberately NOT memoized — storing it would grow
                # children unboundedly, the exact failure the cap
                # prevents — so every registration past the cap re-takes
                # this branch: cache the returned metric at the call
                # site (every in-repo producer does) rather than
                # re-registering per event.
                okey = (("overflow", "true"),)
                child = fam.children.get(okey)
                if child is None:
                    child = self._make(kind, name, help, fam.bounds)
                    fam.children[okey] = child
                overflow = True
            else:
                child = self._make(kind, name, help, fam.bounds)
                fam.children[lkey] = child
                overflow = False
        if overflow and name != "telemetry.label_overflow":
            # counts REGISTRATIONS collapsed, not distinct label sets —
            # deduping distinct sets would need unbounded memory
            self.counter(
                "telemetry.label_overflow",
                help="metric registrations collapsed by the label "
                "cardinality cap",
            ).inc()
        return child

    @staticmethod
    def _make(kind: str, name: str, help: str, bounds):
        if kind == "counter":
            return Counter(name, help)
        if kind == "gauge":
            return Gauge(name, help)
        return Histogram(name, help, bounds)

    def counter(
        self,
        name: str,
        help: str = "",
        labels: Optional[Dict[str, str]] = None,
    ) -> Counter:
        return self._series("counter", name, help, labels)

    def gauge(
        self,
        name: str,
        help: str = "",
        labels: Optional[Dict[str, str]] = None,
    ) -> Gauge:
        return self._series("gauge", name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Optional[Dict[str, str]] = None,
        bounds: Optional[Iterable[float]] = None,
    ) -> Histogram:
        return self._series(
            "histogram",
            name,
            help,
            labels,
            tuple(bounds) if bounds is not None else None,
        )

    # -- reading --------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-able point-in-time view:

        ``{"counters": {key: value}, "gauges": {key: value},
        "histograms": {key: {le, n, count, sum, min, max, p50, p90,
        p99}}}``

        Keys are ``render_key(name, labels)`` strings, so snapshots from
        different ranks merge by plain key equality
        (telemetry/aggregate.py) and render directly to the Prometheus
        exposition (telemetry/export.py).
        """
        with self._lock:
            items = [
                (name, fam.kind, dict(fam.children))
                for name, fam in self._families.items()
            ]
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, kind, children in items:
            for lkey, metric in children.items():
                key = render_key(name, dict(lkey))
                if kind == "counter":
                    out["counters"][key] = metric.value()
                elif kind == "gauge":
                    out["gauges"][key] = metric.value()
                else:
                    out["histograms"][key] = metric.snapshot()
        return out

    def counter_values(
        self,
        prefix: str = "",
        names: Optional[Iterable[str]] = None,
    ) -> Dict[str, float]:
        """Read ONLY counter series (no gauge sampling, no histogram
        cell merges) — the cheap read ScopedView/io_stats() sit on.
        ``names`` restricts to exact series keys; ``prefix`` to a name
        subtree."""
        want = frozenset(names) if names is not None else None
        with self._lock:
            items = [
                (name, dict(fam.children))
                for name, fam in self._families.items()
                if fam.kind == "counter"
                and (not prefix or name.startswith(prefix) or want)
            ]
        out: Dict[str, float] = {}
        for name, children in items:
            for lkey, metric in children.items():
                key = render_key(name, dict(lkey))
                if want is not None and key not in want:
                    continue
                if prefix and not key.startswith(prefix):
                    continue
                out[key] = metric.value()
        return out

    def _peak_gauges(self, prefix: str = "") -> List[Tuple[str, Gauge]]:
        with self._lock:
            items = [
                (name, dict(fam.children))
                for name, fam in self._families.items()
                if fam.kind == "gauge"
                and (not prefix or name.startswith(prefix))
            ]
        out: List[Tuple[str, Gauge]] = []
        for name, children in items:
            for lkey, g in children.items():
                if g.is_peak():
                    out.append((render_key(name, dict(lkey)), g))
        return out

    def peak_gauge_values(self, prefix: str = "") -> Dict[str, float]:
        """Current values of every ``set_max``-style gauge (the
        per-config peaks the bench report records)."""
        return {k: g.value() for k, g in self._peak_gauges(prefix)}

    def reset_peak_gauges(self, prefix: str = "") -> int:
        """Rewind every peak-style gauge in the subtree to 0; returns
        how many were rewound. The scope boundary for high-water marks
        (``io.fetch.concurrency_peak`` et al.): without it, the first
        bench config's peak shadows every later config's."""
        gauges = self._peak_gauges(prefix)
        for _k, g in gauges:
            g.reset_max()
        return len(gauges)

    def help_for(self, name: str) -> str:
        with self._lock:
            fam = self._families.get(name)
            return fam.help if fam is not None else ""

    def scoped(
        self, prefix: str = "", names: Optional[Iterable[str]] = None
    ) -> "ScopedView":
        return ScopedView(self, prefix, names)


class ScopedView:
    """Counter deltas since construction — the registry-backed
    replacement for the delta-since-construction idiom (each split used
    to snapshot the retry globals in its ``__init__``);
    ``io/retry.py``'s ``stats()`` is one of these over its three series.

    ``prefix`` restricts the view to one subtree (``"io.retry."``);
    ``names`` to exact series keys. Reads go through
    ``counter_values`` — no gauge sampling or histogram merging, cheap
    enough for the ``io_stats()`` path. Deltas are process-global like
    the counters beneath them: exact when one producer is active,
    overlapping attributions otherwise (the same caveat the old idiom
    documented).
    """

    def __init__(
        self,
        registry: MetricRegistry,
        prefix: str = "",
        names: Optional[Iterable[str]] = None,
    ) -> None:
        self._registry = registry
        self._prefix = prefix
        self._names = tuple(names) if names is not None else None
        self._base = self._read()

    def _read(self) -> Dict[str, float]:
        return self._registry.counter_values(self._prefix, self._names)

    def delta(self) -> Dict[str, float]:
        now = self._read()
        out = {k: v - self._base.get(k, 0.0) for k, v in now.items()}
        # series born after the base snapshot count from zero, which the
        # dict.get default above already handles; series that vanished
        # cannot happen (registries never drop families)
        return out

    def rebase(self) -> None:
        """Move the baseline to now (the registry-side reset: counters
        stay monotonic, the view's deltas restart from zero)."""
        self._base = self._read()


_DEFAULT = MetricRegistry()


def default_registry() -> MetricRegistry:
    """The process-global registry every producer in dmlc_core_tpu_torch
    writes to (and the exporters/heartbeats read from)."""
    return _DEFAULT
