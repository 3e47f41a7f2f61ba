"""Concurrent ranged span fetcher for non-local window loads (the port
of ``dmlc_core_tpu/io/spanfetch.py``, whole).

The window loader (``io/split.py``) plans a shuffle window as coalesced
byte spans. Local files keep the zero-copy mmap ``_SpanReader``; a file
behind any other filesystem (``fault://`` here, object stores in the
JAX package) would otherwise read them one ``seek`` + ``read`` at a time
on one connection, so its fill time would be ``span_latency × n_spans``.

``SpanFetcher`` owns a small pool of per-file seekable streams, each
wrapped in ``RetryingReadStream`` so backoff and resume hold PER
CONNECTION, and issues a window's spans as parallel ranged reads:

- **bounded in-flight bytes** (``DMLC_FETCH_INFLIGHT_MB``, default 64):
  the submission loop never commits more than the budget to flight (one
  span is always allowed, so a span larger than the budget still
  fetches, serially);
- **cgroup-aware default concurrency** (``DMLC_FETCH_THREADS``; default
  ``min(16, 2 × available_cpus())`` over ``utils/cpus.py``: fetch
  threads park on I/O, so they oversubscribe cores 2× but respect a
  container quota). ``DMLC_FETCH_THREADS=1`` is the serial baseline;
- **adaptive concurrency**: an AIMD ramp, +1 stream per evaluation
  window while delivered bandwidth holds, halved when it collapses, and
  one stream when the spans are byte-contiguous (a sequential read is
  already optimal);
- **completion-order delivery** (``fetch_iter``): the compressed window
  loader hands each landed span's blocks to the decode pool at once;
- **in-place reassembly** (``fetch_into``): each span is written at its
  planned position in one preallocated window buffer.

The fetcher changes WHEN bytes arrive, never what they are: window
buffers and epoch order are bit-identical to the serial path.

Telemetry, under the JAX package's names: ``io.fetch.inflight_bytes``
and ``io.fetch.concurrency_peak`` gauges, ``io.fetch.span_wait_seconds``
histogram, ``io.fetch.spans`` / ``io.fetch.bytes`` / ``io.fetch.reopens``
counters; spans ``dmlc:span_fetch`` (a ranged read on a worker thread)
and ``dmlc:fetch_wait`` (the consumer's wait, a stall stage).
"""

from __future__ import annotations

import bisect
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ..telemetry import default_registry as _default_registry
from ..telemetry import tracing as _tracing
from ..utils.cpus import available_cpus
from ..utils.env import get_env
from ..utils.logging import Error, check
from .retry import RetryingReadStream, RetryPolicy
from .stream import SeekStream

__all__ = [
    "SpanFetcher",
    "count_stream_reopen",
    "fetch_threads",
    "inflight_budget_bytes",
    "iter_file_segments",
    "reopens_total",
]

_REG = _default_registry()
_INFLIGHT = _REG.gauge(
    "io.fetch.inflight_bytes",
    help="span-fetch bytes currently committed to flight",
)
_PEAK = _REG.gauge(
    "io.fetch.concurrency_peak",
    help="max concurrent span fetches observed",
)
_WAIT = _REG.histogram(
    "io.fetch.span_wait_seconds",
    help="consumer wait for the next completed span",
)
_FETCH_SPANS = _REG.counter(
    "io.fetch.spans", help="ranged span reads completed by the fetcher"
)
_FETCH_BYTES = _REG.counter(
    "io.fetch.bytes", help="bytes delivered by the span fetcher"
)
_REOPENS = _REG.counter(
    "io.fetch.reopens",
    help="remote stream connections torn down by a repositioning seek",
)
# same series the split layer ticks (registry get-or-create returns the
# shared counter): a fetcher positioned read IS a seek in the I/O shape
_SEEKS = _REG.counter("io.split.seeks", help="stream seek() calls")


def count_stream_reopen(n: int = 1) -> None:
    """Called by a remote stream when a ``seek()`` to a non-current
    offset drops a live connection (the next read re-establishes it), so
    a seek storm shows as this counter racing ``io.split.seeks``
    (``cloudfs.HttpReadStream.seek`` calls it)."""
    _REOPENS.inc(n)


def reopens_total() -> int:
    """Process-total reopen count (io_stats snapshots delta against it)."""
    return int(_REOPENS.value())


def fetch_threads() -> int:
    """Fetch pool size: ``DMLC_FETCH_THREADS`` wins (1 = the serial
    baseline: the fetcher disengages entirely), else
    ``min(16, 2 × available_cpus())``: fetch threads park on I/O, so they
    oversubscribe the usable-CPU count (affinity and cgroup-quota aware,
    ``utils/cpus.py``) 2×, capped where more connections stop helping."""
    env = get_env("DMLC_FETCH_THREADS", 0)
    if env > 0:
        return env
    return max(2, min(16, 2 * available_cpus()))


def inflight_budget_bytes() -> int:
    """In-flight byte budget (``DMLC_FETCH_INFLIGHT_MB``, default 64):
    bounds fetch memory no matter how wide the concurrency ramps."""
    return max(1, get_env("DMLC_FETCH_INFLIGHT_MB", 64)) << 20


def iter_file_segments(
    file_offset: List[int], n_files: int, offset: int, size: int
) -> Iterator[Tuple[int, int, int, int]]:
    """Walk the per-file segments covering absolute dataset range
    ``[offset, offset + size)``: yields ``(file_ptr, rel_offset, take,
    out_base)`` per segment. The ONE copy of the boundary arithmetic
    every span read shares (``_SpanReader.read`` / ``readinto`` and the
    fetcher's workers); callers do the I/O and stop iterating on a short
    segment."""
    written = 0
    while written < size:
        fp = bisect.bisect_right(file_offset, offset) - 1
        if fp >= n_files:
            return
        avail = file_offset[fp + 1] - offset
        if avail <= 0:
            return
        take = min(size - written, avail)
        yield fp, offset - file_offset[fp], take, written
        written += take
        offset += take


# AIMD evaluation window: completions per bandwidth sample
_AIMD_WINDOW = 8
# ramp thresholds, deliberately asymmetric: +1 stream while delivered
# bandwidth holds (a plateau means latency still dominates; the pool
# cap and byte budget bound the overshoot), halve only on a genuine
# collapse (>60% down: a saturated link). Latency spikes land
# stochastically, so twitchier thresholds read one unlucky burst as
# saturation and give the overlap back mid-drain.
_AIMD_UP = 0.9
_AIMD_DOWN = 0.4


class SpanFetcher:
    """Parallel positioned reads over a split's file table, by absolute
    dataset offset (spans may cross file boundaries — the index is
    global, mirroring ``_SpanReader``).

    One fetcher serves one splitter; the window loader calls it from
    the readahead thread, one batch of spans at a time. Streams are
    pooled per file on a free-list — a worker acquires a connection,
    seeks (contiguous reuse is a no-op seek), reads its span, and
    returns the connection for the next span that lands nearby.
    """

    def __init__(
        self,
        files,
        file_offset: List[int],
        filesys,
        threads: Optional[int] = None,
        inflight_bytes: Optional[int] = None,
    ) -> None:
        self._files = files
        self._file_offset = file_offset
        self._filesys = filesys
        self._threads = max(1, threads if threads else fetch_threads())
        self._budget = (
            inflight_bytes if inflight_bytes else inflight_budget_bytes()
        )
        self._pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()
        self._free: Dict[int, List[SeekStream]] = {}
        self._closed = False
        # AIMD state: current target concurrency + last sampled bandwidth
        self._target = min(2, self._threads)
        self._last_bw = 0.0
        self._win_bytes = 0
        self._win_done = 0
        self._win_t0 = 0.0
        # I/O-shape counters (io_stats plumbing)
        self.spans = 0
        self.bytes = 0
        self.seeks = 0
        self.concurrency_peak = 0

    # -- stream pool ---------------------------------------------------------
    def _open_stream(self, fp: int) -> SeekStream:
        path = self._files[fp].path
        fs = self._filesys

        def open_inner() -> SeekStream:
            s = fs.open(path, "r")
            check(
                isinstance(s, SeekStream), "input files must be seekable"
            )
            return s  # type: ignore[return-value]

        # one RetryPolicy per CONNECTION: its cumulative backoff budget
        # bounds a single limping stream, not the whole window
        return RetryingReadStream(open_inner, policy=RetryPolicy())

    def _acquire(self, fp: int) -> SeekStream:
        with self._lock:
            free = self._free.get(fp)
            if free:
                return free.pop()
        return self._open_stream(fp)

    def _release(self, fp: int, stream: SeekStream) -> None:
        with self._lock:
            if not self._closed:
                self._free.setdefault(fp, []).append(stream)
                return
        # a worker finishing after close(): the free-list snapshot is
        # gone, so pooling would leak the connection — close it here
        try:
            stream.close()
        except (OSError, Error):
            pass

    def _read_span_into(self, begin: int, out: memoryview) -> int:
        """Fill ``out`` with the span at absolute dataset offset
        ``begin``; returns bytes written. Crosses file boundaries via
        the shared segment walk; each per-file segment is one
        positioned read on a pooled connection."""
        written = 0
        for fp, rel, take, base in iter_file_segments(
            self._file_offset, len(self._files), begin, len(out)
        ):
            stream = self._acquire(fp)
            try:
                if stream.tell() != rel:
                    # pool workers race on this attribute: the lock
                    # keeps the per-splitter io_stats() count exact
                    # next to the thread-sharded registry series
                    with self._lock:
                        self.seeks += 1
                    _SEEKS.inc()
                stream.seek(rel)
                got = 0
                while got < take:
                    data = stream.read(take - got)
                    if not data:
                        break
                    out[base + got : base + got + len(data)] = data
                    got += len(data)
            finally:
                self._release(fp, stream)
            written = base + got
            if got < take:
                break
        return written

    # -- scheduler -----------------------------------------------------------
    def _observe(self, nbytes: int) -> None:
        """AIMD bandwidth sampling: every ``_AIMD_WINDOW`` completions,
        compare delivered bandwidth against the last sample — additive
        increase while it improves, multiplicative decrease when it
        collapses."""
        now = time.perf_counter()
        if self._win_done == 0:
            self._win_t0 = now
        self._win_done += 1
        self._win_bytes += nbytes
        if self._win_done < _AIMD_WINDOW:
            return
        dt = max(now - self._win_t0, 1e-9)
        bw = self._win_bytes / dt
        if self._last_bw <= 0.0 or bw >= self._last_bw * _AIMD_UP:
            self._target = min(self._target + 1, self._threads)
        elif bw < self._last_bw * _AIMD_DOWN:
            self._target = max(1, self._target // 2)
        else:
            self._target = max(1, self._target - 1)
        self._last_bw = bw
        self._win_done = 0
        self._win_bytes = 0

    def _run(
        self,
        spans: List[Tuple[int, int]],
        make_sink: Callable[[int, int], memoryview],
    ) -> Iterator[Tuple[int, memoryview]]:
        """Fetch ``spans`` (``[(begin, nbytes), ...]``) concurrently,
        yielding ``(span_index, filled_view)`` in COMPLETION order.
        ``make_sink(si, nbytes)`` returns the writable view worker
        ``si`` fills (a fresh buffer for ``fetch_iter``, a slice of the
        shared window buffer for ``fetch_into``). Worker errors
        re-raise here (after the in-flight ones drain, so no worker is
        left writing into a buffer the caller discards)."""
        n = len(spans)
        if n == 0:
            return
        contiguous = all(
            spans[i][0] + spans[i][1] == spans[i + 1][0]
            for i in range(n - 1)
        )
        if self._pool is None and not (contiguous or self._threads <= 1):
            self._pool = ThreadPoolExecutor(
                max_workers=self._threads,
                thread_name_prefix="span-fetch",
            )
        if self._pool is None or contiguous or self._threads <= 1:
            # serial fast path: contiguous spans stream best on ONE
            # connection — no seeks to overlap, parallelism would only
            # split a sequential read into racing ranged requests
            for si, (begin, nbytes) in enumerate(spans):
                sink = make_sink(si, nbytes)
                with _tracing.span("dmlc:span_fetch", bytes=nbytes):
                    got = self._read_span_into(begin, sink)
                check(got == nbytes, "span read truncated")
                self.spans += 1
                self.bytes += nbytes
                self.concurrency_peak = max(self.concurrency_peak, 1)
                _FETCH_SPANS.inc()
                _FETCH_BYTES.inc(nbytes)
                yield si, sink
            return

        # fresh bandwidth sample per batch: a partial window carried
        # across _run() calls would fold the consumer's decode/gather
        # time between batches into dt and read a healthy link as a
        # collapse (spurious halving at every batch boundary)
        self._win_done = 0
        self._win_bytes = 0
        out: "queue.SimpleQueue" = queue.SimpleQueue()
        state = {"inflight": 0, "inflight_bytes": 0, "next": 0}

        def worker(si: int, begin: int, nbytes: int) -> None:
            try:
                sink = make_sink(si, nbytes)
                with _tracing.span("dmlc:span_fetch", bytes=nbytes):
                    got = self._read_span_into(begin, sink)
                out.put((si, sink, nbytes, got, None))
            except BaseException as e:  # re-raised on the consumer side
                out.put((si, None, nbytes, 0, e))

        def submit_ready() -> None:
            # contiguous plans never reach here (serial fast path above)
            limit = min(self._target, self._threads)
            while state["next"] < n and state["inflight"] < limit:
                begin, nbytes = spans[state["next"]]
                if (
                    state["inflight"] > 0
                    and state["inflight_bytes"] + nbytes > self._budget
                ):
                    return  # budget full; resubmit as completions land
                si = state["next"]
                state["next"] += 1
                state["inflight"] += 1
                state["inflight_bytes"] += nbytes
                _INFLIGHT.inc(nbytes)
                if state["inflight"] > self.concurrency_peak:
                    self.concurrency_peak = state["inflight"]
                    # high-water mark: the gauge only rises within a
                    # measurement scope, so a later low-concurrency
                    # fetcher cannot clobber an earlier one's peak;
                    # reset_peak_gauges() rewinds it between scopes
                    _PEAK.set_max(self.concurrency_peak)
                self._pool.submit(worker, si, begin, nbytes)

        submit_ready()
        done = 0
        error: Optional[BaseException] = None
        try:
            while done < n and (error is None or state["inflight"] > 0):
                t0 = time.perf_counter()
                with _tracing.span("dmlc:fetch_wait"):
                    si, sink, nbytes, got, err = out.get()
                _WAIT.observe(time.perf_counter() - t0)
                done += 1
                state["inflight"] -= 1
                state["inflight_bytes"] -= nbytes
                _INFLIGHT.dec(nbytes)
                if err is not None:
                    error = error or err
                    continue  # drain in-flight workers before raising
                if error is None and got != nbytes:
                    error = Error("span read truncated")
                    continue
                if error is not None:
                    continue
                self.spans += 1
                self.bytes += nbytes
                _FETCH_SPANS.inc()
                _FETCH_BYTES.inc(nbytes)
                self._observe(nbytes)
                submit_ready()
                yield si, sink
            if error is not None:
                raise error
        finally:
            # an abandoned generator (consumer raised mid-iteration)
            # leaves submitted-but-unconsumed spans in flight; settle
            # their gauge contribution here — the orphan workers finish
            # into a dead queue and release their streams normally
            if state["inflight_bytes"]:
                _INFLIGHT.dec(state["inflight_bytes"])
                state["inflight_bytes"] = 0

    # -- public API ----------------------------------------------------------
    def fetch_iter(
        self, spans: List[Tuple[int, int]]
    ) -> Iterator[Tuple[int, memoryview]]:
        """Yield ``(span_index, span_bytes_view)`` in COMPLETION order —
        the compressed window loader hands each landed span's blocks to
        the decode pool immediately, overlapping fetch and decode."""
        return self._run(
            spans, lambda _si, nbytes: memoryview(bytearray(nbytes))
        )

    def fetch_into(
        self,
        spans: List[Tuple[int, int]],
        out: memoryview,
        bases: List[int],
    ) -> None:
        """Fetch every span into ``out`` at its planned base offset
        (disjoint slices — workers write concurrently without overlap);
        blocks until the whole window buffer is assembled."""
        check(len(spans) == len(bases), "spans/bases length mismatch")
        sink = memoryview(out)
        for _ in self._run(
            spans,
            lambda si, nbytes: sink[bases[si] : bases[si] + nbytes],
        ):
            pass

    def close(self) -> None:
        """Release pooled connections and the worker pool WITHOUT
        joining in-flight reads: a stalled fetch (an orphaned read-ahead
        window limping through its retry budget) must not block the
        splitter's close. Workers that finish later find ``_closed`` set
        and close their own streams in ``_release``."""
        with self._lock:
            self._closed = True
            streams = [s for free in self._free.values() for s in free]
            self._free.clear()
        for s in streams:
            try:
                s.close()
            except (OSError, Error):
                pass
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None
