"""Flight-recorder tracing: always-on per-thread span rings with
Perfetto/Chrome export, cross-process merge and stall attribution (the
port's copy of ``dmlc_core_tpu/telemetry/tracing.py``: the same event
schema, env knobs, trace-context encoding and file names, so traces of
the two packages merge into one timeline).

The registry answers how much time a stage took in all; this module
answers what the pipeline was doing at a given instant and why a ring
starved. ``torch.profiler`` records ``profiler.annotate`` spans only
inside an active capture, and only on the thread that started it; the
rings record every thread of every process, the tracker included.

- **span rings**: every thread records begin/end spans, instant
  events and counter samples into its own bounded ring buffer
  (``perf_counter_ns`` timestamps, no locks on the hot path, oldest
  events overwritten with a drop counter: a flight recorder, not a
  log).
- **export**: ``to_chrome_trace()``/``dump()`` render the rings as
  Chrome trace-event JSON (the ``traceEvents`` array format) loadable
  in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``,
  stamped with pid / rank / role / thread names. Timestamps are
  rebased onto the wall clock at dump time, so same-host processes
  share a timeline with no clock handshake.
- **merge**: ``merge_traces()`` joins per-process trace files from a
  submit run (workers + tracker) into one timeline; colliding pids are
  remapped, process labels kept.
- **stall attribution**: ``stall_report()`` computes per-stage
  busy/stall seconds, ring-starvation gaps (wait spans longer than a
  threshold) and a critical-path estimate.

Dump-on-demand: SIGUSR2 (``install_signal_dump``, installed on first
use from the main thread; ``tools trace dump <pid>`` sends it) writes
the rings to ``DMLC_TRACE_DIR`` (or the temp dir) without stopping the
process, and an atexit hook dumps automatically when ``DMLC_TRACE_DIR``
is set: that is how every process of a submit run leaves a trace file
behind for ``tools trace merge``. A process killed by SIGKILL runs no
atexit hook and leaves no file.

Env knobs: ``DMLC_TRACE`` (``off``/``0``/``false`` disables; default
on), ``DMLC_TRACE_BUF_KB`` (per-thread ring budget, default 256, about
4k events), ``DMLC_TRACE_DIR`` (dump directory + the atexit-dump
switch), ``DMLC_TRACE_ID`` (the job's trace id, exported by submit).

Every layer records through this API, so the event schema, clock
rebasing and drop accounting cannot fork per call site.
"""

from __future__ import annotations

import atexit
import json
import os
import random
import signal
import sys
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

__all__ = [
    "TraceRing",
    "add_complete",
    "begin",
    "clock_offset_ns",
    "counter",
    "decode_context",
    "default_trace_path",
    "dump",
    "enabled",
    "encode_context",
    "end",
    "flow_recv",
    "flow_send_id",
    "handler_flow",
    "handler_span",
    "install_signal_dump",
    "instant",
    "load_trace",
    "merge_traces",
    "reset",
    "rpc_context",
    "set_clock_offset",
    "set_enabled",
    "set_process_label",
    "span",
    "stall_report",
    "stats",
    "to_chrome_trace",
    "write_trace",
]

# one ring slot ~= a 5-tuple + a small tuple/dict of args; ~56 bytes of
# pointers plus the shared name strings. The KB knob is a budget, not
# an exact accounting — what matters is that the ring is bounded.
_SLOT_BYTES = 56
_MIN_SLOTS = 64
_MAX_RETAINED_RINGS = 256  # rings of finished threads kept for export

# wall-clock sync point captured once per process: exported timestamps
# are (perf_ns - _SYNC_PERF_NS + _SYNC_WALL_NS), so traces from
# processes on one host line up with no cross-process handshake
# (time_ns is the wall clock; perf_counter_ns the monotonic span clock)
_SYNC_WALL_NS = time.time_ns()
_SYNC_PERF_NS = time.perf_counter_ns()

_ENABLED_OVERRIDE: Optional[bool] = None
_ENABLED_ENV: Optional[bool] = None  # resolved once; reset() clears

_RINGS: Dict[int, "TraceRing"] = {}
_RINGS_LOCK = threading.Lock()
_TLS = threading.local()
_TID_SEQ = iter(range(1, 1 << 62))  # synthetic per-ring tids (see _ring)
_RESET_GEN = 0  # bumped by reset(); stale TLS rings re-register
_PROCESS_LABEL: Optional[str] = None
_SIGNAL_INSTALLED = False
_DROPPED_RINGS = 0


def enabled() -> bool:
    """Is the flight recorder on? ``set_enabled()`` wins over the
    ``DMLC_TRACE`` env (``off``/``0``/``false``/empty disables; the
    default — variable unset — is ON)."""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    global _ENABLED_ENV
    if _ENABLED_ENV is None:
        raw = os.environ.get("DMLC_TRACE", "on").strip().lower()
        _ENABLED_ENV = raw not in ("", "0", "off", "false", "no")
    return _ENABLED_ENV


def set_enabled(on: Optional[bool]) -> None:
    """Force the recorder on/off for this process (None restores the
    ``DMLC_TRACE`` env default). Used by tests and the bench overhead
    probe; production uses the env knob."""
    global _ENABLED_OVERRIDE, _ENABLED_ENV
    _ENABLED_OVERRIDE = on
    _ENABLED_ENV = None  # re-read the env when the override lifts


def set_process_label(label: str) -> None:
    """Name this process on the merged timeline (``tracker``,
    ``blockcache-daemon``, ...). Defaults to role+task from the
    DMLC launcher env contract."""
    global _PROCESS_LABEL
    _PROCESS_LABEL = str(label)


def _process_label() -> str:
    if _PROCESS_LABEL is not None:
        return _PROCESS_LABEL
    role = os.environ.get("DMLC_ROLE")
    task = os.environ.get("DMLC_TASK_ID")
    if role:
        return f"{role}{task}" if task is not None else role
    return os.path.basename(sys.argv[0] or "proc") or "proc"


def _ring_capacity() -> int:
    try:
        kb = int(os.environ.get("DMLC_TRACE_BUF_KB", "256"))
    except ValueError:
        kb = 256
    return max(_MIN_SLOTS, (max(kb, 1) * 1024) // _SLOT_BYTES)


class TraceRing:
    """One thread's bounded event ring. Events are appended by the
    owning thread only (no lock on the write path); ``events()`` is
    called from the exporting thread — a torn read can at worst see a
    slot twice/miss the newest slot, acceptable for a flight recorder.
    Overflow overwrites the OLDEST event and counts the drop — drops
    are never silent (exported per thread and in ``stats()``)."""

    __slots__ = ("tid", "name", "cap", "buf", "n", "start", "dropped",
                 "stack", "gen")

    def __init__(self, tid: int, name: str, cap: int, gen: int) -> None:
        self.tid = tid
        self.name = name
        self.cap = cap
        self.gen = gen  # _RESET_GEN at registration (see _ring)
        self.buf: List[Optional[tuple]] = [None] * cap
        self.n = 0
        self.start = 0
        self.dropped = 0
        self.stack: List[Tuple[str, int]] = []  # begin()/end() pairing

    def add(self, ev: tuple) -> None:
        if self.n < self.cap:
            self.buf[(self.start + self.n) % self.cap] = ev
            self.n += 1
        else:
            self.buf[self.start] = ev
            self.start = (self.start + 1) % self.cap
            self.dropped += 1

    def events(self) -> List[tuple]:
        """Oldest-first snapshot (append order == per-thread time
        order: one writer, monotonic timestamps)."""
        return [
            self.buf[(self.start + i) % self.cap] for i in range(self.n)
        ]


def _ring() -> TraceRing:
    ring = getattr(_TLS, "ring", None)
    # a stale generation means reset() emptied the registry AFTER this
    # thread registered: its TLS ring is no longer exported, so the
    # thread must re-register — without this, every long-lived pool
    # thread (decode pool, readahead) would keep writing into an
    # invisible ring after the first reset, silently losing its events
    if ring is None or ring.gen != _RESET_GEN:
        t = threading.current_thread()
        # synthetic tid, NOT t.ident: the OS recycles thread ids, and
        # two sequential pool threads sharing one Perfetto row would
        # interleave their (individually monotonic) event streams
        with _RINGS_LOCK:
            tid = next(_TID_SEQ)
            gen = _RESET_GEN
        ring = TraceRing(tid, t.name, _ring_capacity(), gen)
        _TLS.ring = ring
        with _RINGS_LOCK:
            global _DROPPED_RINGS
            # bounded retention under thread churn: a dead thread's
            # ring stays exportable until the retention cap pushes it
            # out (oldest first — dict preserves insertion order)
            while len(_RINGS) >= _MAX_RETAINED_RINGS:
                _RINGS.pop(next(iter(_RINGS)))
                _DROPPED_RINGS += 1
            _RINGS[id(ring)] = ring
        _maybe_install_signal()
    return ring


# -- recording API -------------------------------------------------------------
# Event tuples: ("X", name, t0_ns, dur_ns, args) complete span,
#               ("i", name, ts_ns, 0, args) instant,
#               ("C", name, ts_ns, value, None) counter sample,
#               ("s"/"f", name, ts_ns, flow_id, None) flow start/finish
#               (the causal arrows binding a client wait span to the
#               remote handler span that answers it).


# wait-stage span durations are ALSO mirrored into the metric registry
# (``trace.stall_seconds{stage=...}`` counters) so the time-series layer
# (telemetry/timeseries.py) can answer "what stall fraction over the
# last 30 s" without a trace dump — the registry is the windowed-rate
# substrate, the ring stays the timeline. Memoized per span name; one
# dict hit per completed NON-wait span, one thread-local counter add
# per wait span.
_STALL_COUNTERS: Dict[str, Optional[Any]] = {}
_STALL_LOCK = threading.Lock()


def _stall_counter(name: str):
    try:
        return _STALL_COUNTERS[name]
    except KeyError:
        pass
    stage = _stage_name(name)
    ctr = None
    if stage in _WAIT_STAGES:
        from .registry import default_registry

        ctr = default_registry().counter(
            "trace.stall_seconds",
            help="cumulative wait-stage span seconds (flight recorder "
            "mirror; the windowed stall-fraction source)",
            labels={"stage": stage},
        )
    with _STALL_LOCK:
        _STALL_COUNTERS.setdefault(name, ctr)
    return ctr


def _record_complete(
    name: str, t0_ns: int, dur_ns: int, args: Optional[dict]
) -> None:
    _ring().add(("X", name, t0_ns, dur_ns, args))
    ctr = _stall_counter(name)
    if ctr is not None:
        ctr.inc(dur_ns / 1e9)


def add_complete(
    name: str, t0_ns: int, dur_ns: int, args: Optional[dict] = None
) -> None:
    """Record one finished span (begin timestamp + duration, both from
    ``perf_counter_ns``). The raw hook ``profiler.annotate`` feeds —
    its ``_TimedSpan`` already holds the timestamps, so the seam costs
    one call + one append."""
    if enabled():
        _record_complete(name, t0_ns, dur_ns, args)


class _Span:
    """``with span("name"):`` — times the region and records one
    complete event on exit."""

    __slots__ = ("_name", "_args", "_t0")

    def __init__(self, name: str, args: Optional[dict]) -> None:
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t0 = self._t0
        _record_complete(
            self._name, t0, time.perf_counter_ns() - t0, self._args
        )
        return False


class _NullSpan:
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


def span(name: str, **args) -> Union[_Span, _NullSpan]:
    """Context manager recording a complete span; keyword args land in
    the event's ``args`` (keep them small and JSON-native — they are
    serialized verbatim at dump time)."""
    if not enabled():
        return _NULL
    return _Span(name, args or None)


def begin(name: str) -> None:
    """Open a non-lexical span on this thread (pair with ``end()``;
    spans nest per thread)."""
    if enabled():
        _ring().stack.append((name, time.perf_counter_ns()))


def end(args: Optional[dict] = None) -> None:
    """Close the innermost ``begin()`` span. Unmatched ``end()`` is a
    counted drop, never an exception — the recorder must not take down
    the flight it records."""
    if not enabled():
        return
    ring = _ring()
    if not ring.stack:
        ring.dropped += 1
        return
    name, t0 = ring.stack.pop()
    _record_complete(name, t0, time.perf_counter_ns() - t0, args)


def instant(name: str, **args) -> None:
    """Mark a point in time (an eviction, a relaunch, a fault)."""
    if enabled():
        _ring().add(
            ("i", name, time.perf_counter_ns(), 0, args or None)
        )


def counter(name: str, value: float) -> None:
    """Sample a counter series (ring occupancy, queue depth) — renders
    as a stacked chart row in Perfetto."""
    if enabled():
        _ring().add(("C", name, time.perf_counter_ns(), value, None))


# -- causal RPC trace context --------------------------------------------------
#
# A compact trace context — trace id + parent span id, 16 hex digits
# each, encoded "<trace>-<span>" — rides every wire protocol in the
# repo (tracker cmd strings, collective DCL1 frames, dsserve slot meta,
# blockcache control frames, lookup requests) so a server-side handler
# span can be causally bound to the client wait span that triggered it.
# The binding renders as Chrome/Perfetto FLOW events: the client emits
# a flow-start ("s") inside its wait span at request time
# (``rpc_context``), the server a flow-finish ("f") inside its handler
# span (``handler_flow``/``handler_span``) — Perfetto draws the arrow.
#
# Encoding and decoding live HERE and only here (lint L017, the
# L006-L016 single-site pattern): every other module carries the
# context as an opaque string (or, on the collective's binary frames,
# the raw 64-bit flow id), so the format cannot fork per protocol.

#: flow s/f events must agree on name+cat to bind; one constant name
_FLOW_NAME = "rpc"

_TRACE_ID: Optional[int] = None
_CLOCK_OFFSET_NS: Optional[float] = None
_CLOCK_OFFSET_SOURCE: Optional[str] = None


def _job_trace_id() -> int:
    """This process's trace id: ``DMLC_TRACE_ID`` (hex — dmlc-submit
    exports one id for the whole job so every process's spans share a
    trace), else a random per-process id."""
    global _TRACE_ID
    if _TRACE_ID is None:
        raw = os.environ.get("DMLC_TRACE_ID", "").strip()
        tid = 0
        if raw:
            try:
                tid = int(raw, 16) & ((1 << 64) - 1)
            except ValueError:
                tid = 0
        _TRACE_ID = tid or (random.getrandbits(63) | 1)
    return _TRACE_ID


def encode_context(trace_id: int, span_id: int) -> str:
    """Wire form of a trace context (the ONLY place it is spelled)."""
    return f"{trace_id & ((1 << 64) - 1):016x}-{span_id & ((1 << 64) - 1):016x}"


def decode_context(ctx) -> Optional[Tuple[int, int]]:
    """(trace_id, span_id) or None — never raises: contexts arrive
    from the wire and a malformed one costs the arrow, not the
    request."""
    if not isinstance(ctx, str) or len(ctx) != 33 or ctx[16] != "-":
        return None
    try:
        return int(ctx[:16], 16), int(ctx[17:], 16)
    except ValueError:
        return None


def rpc_context() -> Optional[str]:
    """Mint a context for an outgoing request and record its flow-start
    on this thread's ring. Call INSIDE the client's wait span (the
    flow arrow starts from the slice enclosing the event). None when
    the recorder is off — callers simply omit the wire field."""
    if not enabled():
        return None
    span_id = random.getrandbits(63) | 1
    _ring().add(("s", _FLOW_NAME, time.perf_counter_ns(), span_id, None))
    return encode_context(_job_trace_id(), span_id)


def handler_flow(ctx) -> None:
    """Record the flow-finish for a received context. Call INSIDE the
    server-side handler span; a missing/malformed context is a no-op."""
    if not enabled():
        return
    dec = decode_context(ctx)
    if dec is not None:
        _ring().add(("f", _FLOW_NAME, time.perf_counter_ns(), dec[1], None))


class _HandlerSpan(_Span):
    """A span that also lands the incoming flow arrow just after its
    own start (the "f" event must be temporally enclosed by the
    handler slice for Perfetto to bind it)."""

    __slots__ = ("_ctx",)

    def __init__(self, name: str, args: Optional[dict], ctx) -> None:
        super().__init__(name, args)
        self._ctx = ctx

    def __enter__(self) -> "_HandlerSpan":
        super().__enter__()
        handler_flow(self._ctx)
        return self


def handler_span(
    name: str, ctx=None, **args
) -> Union[_HandlerSpan, _NullSpan]:
    """Server-side handler span carrying the client's trace context:
    records one complete span AND (when ``ctx`` decodes) the
    flow-finish binding it to the client's wait span. The context is
    kept in the span args (``tc``) for grep-ability on a raw trace."""
    if not enabled():
        return _NULL
    if ctx:
        args["tc"] = ctx
    return _HandlerSpan(name, args or None, ctx)


def flow_send_id() -> int:
    """Binary-frame variant of :func:`rpc_context` (the collective's
    DCL1 header carries a raw u64, not a string): records the
    flow-start, returns the id — 0 when the recorder is off (receivers
    skip 0)."""
    if not enabled():
        return 0
    span_id = random.getrandbits(63) | 1
    _ring().add(("s", _FLOW_NAME, time.perf_counter_ns(), span_id, None))
    return span_id


def flow_recv(flow_id: int) -> None:
    """Binary-frame variant of :func:`handler_flow`."""
    if flow_id and enabled():
        _ring().add(
            ("f", _FLOW_NAME, time.perf_counter_ns(), int(flow_id), None)
        )


def set_clock_offset(offset_ns: float, source: str = "heartbeat_rtt") -> None:
    """Record this process's estimated wall-clock offset against the
    job's reference clock (the tracker): ``local_wall - tracker_wall``
    in ns, estimated from a request/reply RTT midpoint
    (client.py heartbeat). Exported in the trace's ``otherData`` so a
    multi-HOST merge can align timelines (``merge_traces(...,
    align_clocks=True)`` / ``tools trace merge --align-clocks``);
    same-host processes already agree through the shared wall clock."""
    global _CLOCK_OFFSET_NS, _CLOCK_OFFSET_SOURCE
    _CLOCK_OFFSET_NS = float(offset_ns)
    _CLOCK_OFFSET_SOURCE = str(source)


def clock_offset_ns() -> Optional[float]:
    return _CLOCK_OFFSET_NS


def stats() -> Dict[str, Any]:
    """Recorder shape: per-thread event/drop counts (drops are the
    proof overflow is never silent)."""
    with _RINGS_LOCK:
        rings = list(_RINGS.values())
    return {
        "enabled": enabled(),
        "threads": {
            r.name: {"events": r.n, "dropped": r.dropped, "cap": r.cap}
            for r in rings
        },
        # exact recorded-event total (resident + overwritten), summed
        # over RINGS — the per-name dict above folds threads sharing a
        # pool name, this does not (the bench overhead probe deltas it)
        "total_events": sum(r.n + r.dropped for r in rings),
        "dropped_rings": _DROPPED_RINGS,
    }


def reset() -> None:
    """Drop every recorded event and re-read the env knobs (test
    isolation). EVERY thread's ring re-registers lazily at its next
    event — the generation bump invalidates other threads' TLS rings
    too, so a long-lived pool thread cannot keep writing into a ring
    the registry no longer exports."""
    global _ENABLED_ENV, _DROPPED_RINGS, _RESET_GEN
    global _TRACE_ID, _CLOCK_OFFSET_NS, _CLOCK_OFFSET_SOURCE
    with _RINGS_LOCK:
        _RINGS.clear()
        _DROPPED_RINGS = 0
        _RESET_GEN += 1
    _TLS.__dict__.pop("ring", None)
    _ENABLED_ENV = None
    _TRACE_ID = None  # re-read DMLC_TRACE_ID (test isolation)
    _CLOCK_OFFSET_NS = None
    _CLOCK_OFFSET_SOURCE = None


# -- Chrome trace-event export -------------------------------------------------


def _ts_us(ts_ns: int) -> float:
    """perf_counter_ns → wall-clock microseconds (per-process rebase;
    same-host processes line up on the merged timeline)."""
    return (ts_ns - _SYNC_PERF_NS + _SYNC_WALL_NS) / 1000.0


def to_chrome_trace(extra_meta: Optional[dict] = None) -> dict:
    """Snapshot every ring as a Chrome trace-event JSON object
    (``{"traceEvents": [...]}``) loadable in Perfetto. Span events are
    complete ("X") events with microsecond ``ts``/``dur``; process and
    thread names ride metadata ("M") events; drop counts and the
    process identity land in ``otherData``."""
    pid = os.getpid()
    label = _process_label()
    events: List[dict] = [
        {
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": f"{label} (pid {pid})"},
        }
    ]
    dropped: Dict[str, int] = {}
    with _RINGS_LOCK:
        rings = list(_RINGS.values())
    for ring in rings:
        events.append(
            {
                "ph": "M", "name": "thread_name", "pid": pid,
                "tid": ring.tid, "args": {"name": ring.name},
            }
        )
        if ring.dropped:
            dropped[ring.name] = ring.dropped
        for ph, name, ts_ns, extra, args in ring.events():
            ev: Dict[str, Any] = {
                "ph": ph, "name": name, "cat": "dmlc", "pid": pid,
                "tid": ring.tid, "ts": _ts_us(ts_ns),
            }
            if ph == "X":
                ev["dur"] = extra / 1000.0
                if args:
                    ev["args"] = args
            elif ph == "i":
                ev["s"] = "t"  # thread-scoped instant
                if args:
                    ev["args"] = args
            elif ph in ("s", "f"):
                # flow start/finish: id+cat+name must agree for
                # Perfetto to draw the arrow; bp="e" binds the finish
                # to its ENCLOSING slice (the handler span), not the
                # next slice to start
                ev["cat"] = "dmlc.flow"
                ev["id"] = f"{extra:x}"
                if ph == "f":
                    ev["bp"] = "e"
            else:  # "C"
                ev["args"] = {"value": extra}
            events.append(ev)
    other = {
        "pid": pid,
        "label": label,
        "rank": os.environ.get("DMLC_TASK_ID"),
        "role": os.environ.get("DMLC_ROLE"),
        "dropped_events": dropped,
        "dropped_rings": _DROPPED_RINGS,
    }
    if _CLOCK_OFFSET_NS is not None:
        # local_wall - reference_wall (see set_clock_offset): a
        # multi-host merge subtracts this from every ts to align
        other["clock_offset_ns"] = _CLOCK_OFFSET_NS
        other["clock_offset_source"] = _CLOCK_OFFSET_SOURCE
    if extra_meta:
        other.update(extra_meta)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": other,
    }


def default_trace_path(directory: Optional[str] = None) -> str:
    """Where this process dumps: ``<dir>/dmlc-trace-<label>-<pid>.json``
    with ``dir`` = argument, else ``DMLC_TRACE_DIR``, else the temp
    dir. The label/pid suffix keeps per-process files of one submit run
    collision-free in a shared directory."""
    import tempfile

    directory = (
        directory
        or os.environ.get("DMLC_TRACE_DIR")
        or tempfile.gettempdir()
    )
    label = _process_label().replace("/", "_").replace(" ", "_")
    return os.path.join(
        directory, f"dmlc-trace-{label}-{os.getpid()}.json"
    )


def write_trace(trace: dict, path: str) -> str:
    """Serialize a trace object to ``path`` (atomic rename so a reader
    — or a SIGUSR2 racing an atexit dump — never sees a half-written
    file)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)
    return path


def dump(path: Optional[str] = None) -> str:
    """Write this process's rings as one Chrome trace JSON file;
    returns the path. The rings keep recording — a dump is a snapshot,
    not a stop."""
    return write_trace(to_chrome_trace(), path or default_trace_path())


def load_trace(path: str) -> dict:
    """Read a trace file back (merge/report input); checked errors for
    files that are not Chrome trace JSON."""
    with open(path) as f:
        trace = json.load(f)
    if isinstance(trace, list):  # bare traceEvents array form is legal
        trace = {"traceEvents": trace}
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError(
            f"{path}: not a Chrome trace (no traceEvents key)"
        )
    return trace


# -- dump-on-demand ------------------------------------------------------------


def install_signal_dump(signum: int = signal.SIGUSR2) -> bool:
    """Install the dump-on-demand handler (``kill -USR2 <pid>`` / the
    ``tools trace dump`` CLI): writes the rings to the default path
    without stopping the process. Only the main thread may install
    signal handlers — returns False elsewhere (callers on other
    threads lose the signal hook, never crash). An explicit call
    installs unconditionally; the lazy auto-install on first event
    (``_maybe_install_signal``) defers to any handler the application
    already registered."""
    global _SIGNAL_INSTALLED

    def _dump_handler(_signum, _frame):
        try:
            path = dump()
            sys.stderr.write(f"dmlc trace dumped to {path}\n")
        except OSError:
            pass  # a broken dump dir must not kill the process

    try:
        signal.signal(signum, _dump_handler)
    except ValueError:  # not the main thread
        return False
    _SIGNAL_INSTALLED = True
    return True


def _maybe_install_signal() -> None:
    if _SIGNAL_INSTALLED or not hasattr(signal, "SIGUSR2"):
        return
    if threading.current_thread() is not threading.main_thread():
        return
    # never clobber an application's own SIGUSR2 handler (tracing is on
    # by default — a library must not steal a signal the host job uses,
    # e.g. checkpoint-on-preemption); explicit install_signal_dump()
    # remains the operator's override
    try:
        existing = signal.getsignal(signal.SIGUSR2)
    except (ValueError, OSError):
        return
    if existing not in (signal.SIG_DFL, None):
        return
    install_signal_dump()


@atexit.register
def _dump_at_exit() -> None:
    """When ``DMLC_TRACE_DIR`` is set, every process that recorded
    anything leaves a trace file behind at exit — the per-process
    files ``tools trace merge`` joins after a ``dmlc-submit`` run."""
    if not os.environ.get("DMLC_TRACE_DIR") or not enabled():
        return
    with _RINGS_LOCK:
        has_events = any(r.n for r in _RINGS.values())
    if not has_events:
        return
    try:
        dump()
    except OSError:
        pass


# -- cross-process merge -------------------------------------------------------


def merge_traces(
    inputs: Iterable[Union[str, dict]], align_clocks: bool = False
) -> dict:
    """Join per-process traces into ONE timeline keyed by rank/pid.

    Inputs are paths or already-loaded trace dicts. Events keep their
    wall-rebased timestamps (same-host processes already agree);
    colliding pids across files (containers, recycled pids) are
    remapped to unique synthetic pids so Perfetto never folds two
    processes into one row group. Per-file ``otherData`` — labels,
    ranks, drop counts, the heartbeat-estimated ``clock_offset_ns`` —
    is kept under ``otherData.processes``. ``align_clocks`` subtracts
    each file's recorded clock offset from its timestamps, mapping
    every process onto the tracker's clock (multi-HOST merges; the
    default keeps raw timestamps because on one host the RTT estimate
    is pure noise against an already-shared wall clock)."""
    events: List[dict] = []
    processes: List[dict] = []
    seen_pids: Dict[int, int] = {}  # original pid -> assigned pid
    next_pid = 1 << 20  # synthetic range, clear of real pids
    for i, item in enumerate(inputs):
        trace = load_trace(item) if isinstance(item, str) else item
        other = dict(trace.get("otherData") or {})
        other.setdefault("source", item if isinstance(item, str) else i)
        processes.append(other)
        shift_us = 0.0
        if align_clocks:
            off = other.get("clock_offset_ns")
            if isinstance(off, (int, float)):
                shift_us = float(off) / 1000.0
        remap: Dict[int, int] = {}
        for ev in trace.get("traceEvents", ()):
            pid = ev.get("pid", 0)
            if pid not in remap:
                if pid in seen_pids:
                    remap[pid] = next_pid  # collision: new synthetic pid
                    next_pid += 1
                else:
                    seen_pids[pid] = i
                    remap[pid] = pid
            ev = dict(ev)
            ev["pid"] = remap[pid]
            if shift_us and "ts" in ev:
                ev["ts"] = ev["ts"] - shift_us
            events.append(ev)
    # stable timeline order (metadata events carry no ts; keep first)
    events.sort(key=lambda e: e.get("ts", float("-inf")))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"merged": len(processes), "processes": processes},
    }


# -- stall attribution ---------------------------------------------------------

# wait-shaped stages: a long one of these IS a stall (the thread is
# parked on someone else), where a long parse/decode span is just work
_WAIT_STAGES = frozenset(
    {
        "host_pull",          # transfer thread starved by the parse ring
        "dispatch_slot_wait",  # slot reuse gated on an unfinished DMA
        "transfer_wait",      # consumer blocked on an incomplete transfer
        "retry_backoff",      # remote IO healing a transient failure
        "gather_refill",      # split consumer starved by the window loader
        "fetch_wait",         # window loader starved by remote span reads
        "shard_lease_wait",   # dynamic-shard worker idle: every micro-shard
                              # is leased out (or the tracker is slow)
        "allreduce_wait",     # collective round blocked on peer links —
                              # a straggling/dead peer, or recovery in
                              # flight (tracker/collective.py)
        "dsserve_recv_wait",  # trainer starved by the remote
                              # preprocessing tier: network-bound or
                              # under-provisioned dsserve workers
                              # (the JAX package's dsserve/client.py)
        "lookup_wait",        # point-read client blocked on the serve
                              # daemon's answer: a cold cache, an
                              # overloaded tier, or network latency
                              # (the JAX package's io/lookup.py)
        "stream_tail_wait",   # tail-following reader caught up to the
                              # writer's committed watermark: parked on
                              # the next commit/rotation/EOS
                              # (the JAX package's stream/source.py)
        "slot_wait",
    }
)


def _stage_name(name: str) -> str:
    return name[5:] if name.startswith("dmlc:") else name


def _union_seconds(ivals: List[Tuple[float, float]]) -> float:
    """Total coverage of possibly-nested/overlapping [start, end) µs
    intervals, in seconds."""
    if not ivals:
        return 0.0
    ivals.sort()
    total = 0.0
    cur_lo, cur_hi = ivals[0]
    for lo, hi in ivals[1:]:
        if lo > cur_hi:
            total += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    total += cur_hi - cur_lo
    return total / 1e6


def stall_report(trace: dict, gap_ms: float = 10.0) -> dict:
    """Per-stage busy/stall attribution over a (possibly merged) trace.

    - ``busy_seconds_by_stage`` / ``stall_seconds_by_stage``: summed
      span durations, split by whether the stage is work or a wait
      (``host_pull``/``dispatch_slot_wait``/``transfer_wait``/
      ``retry_backoff`` are waits — a long one is a starving ring, not
      progress).
    - ``starvation_gaps``: every wait span >= ``gap_ms``, worst first
      (capped at 50) — each one a quantified "the pipeline sat here".
    - ``threads``: per (process, thread) busy/idle/wall from the union
      of its span intervals.
    - ``critical_path``: estimate per process — wall clock of its span
      extent, attributed to the busiest thread's per-stage totals with
      the remainder explicit as ``unattributed_seconds``. An estimate
      (threads overlap; spans under-cover uninstrumented code), not a
      proof — the honest version of what ``diag_infeed`` eyeballs.
    """
    by_thread: Dict[Tuple[int, int], List[dict]] = {}
    thread_names: Dict[Tuple[int, int], str] = {}
    proc_names: Dict[int, str] = {}
    for ev in trace.get("traceEvents", ()):
        ph = ev.get("ph")
        key = (ev.get("pid", 0), ev.get("tid", 0))
        if ph == "M":
            if ev.get("name") == "thread_name":
                thread_names[key] = ev.get("args", {}).get("name", "?")
            elif ev.get("name") == "process_name":
                proc_names[key[0]] = ev.get("args", {}).get("name", "?")
            continue
        if ph != "X":
            continue
        by_thread.setdefault(key, []).append(ev)

    busy: Dict[str, float] = {}
    stall: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    gaps: List[dict] = []
    threads: Dict[str, dict] = {}
    proc_extent: Dict[int, Tuple[float, float]] = {}
    proc_thread_stage: Dict[int, Dict[Tuple[int, int], Dict[str, float]]]
    proc_thread_stage = {}
    proc_thread_busy: Dict[int, Dict[Tuple[int, int], float]] = {}

    for key, evs in by_thread.items():
        pid, _tid = key
        ivals: List[Tuple[float, float]] = []
        lo = float("inf")
        hi = float("-inf")
        stage_secs: Dict[str, float] = {}
        for ev in evs:
            ts = float(ev.get("ts", 0.0))
            dur = float(ev.get("dur", 0.0))
            stage = _stage_name(str(ev.get("name", "?")))
            secs = dur / 1e6
            counts[stage] = counts.get(stage, 0) + 1
            stage_secs[stage] = stage_secs.get(stage, 0.0) + secs
            if stage in _WAIT_STAGES:
                stall[stage] = stall.get(stage, 0.0) + secs
                if dur >= gap_ms * 1000.0:
                    gaps.append(
                        {
                            "stage": stage,
                            "process": proc_names.get(pid, str(pid)),
                            "thread": thread_names.get(key, str(key[1])),
                            "start_us": round(ts, 1),
                            "duration_ms": round(dur / 1000.0, 3),
                        }
                    )
            else:
                busy[stage] = busy.get(stage, 0.0) + secs
            ivals.append((ts, ts + dur))
            lo = min(lo, ts)
            hi = max(hi, ts + dur)
        covered = _union_seconds(ivals)
        wall = (hi - lo) / 1e6 if hi > lo else 0.0
        tname = thread_names.get(key, str(key[1]))
        tkey = f"{proc_names.get(pid, pid)}/{tname}"
        if tkey in threads:  # pool threads share a name; keep each row
            tkey = f"{tkey}#{key[1]}"
        threads[tkey] = {
            "spans": len(evs),
            "busy_seconds": round(covered, 6),
            "idle_seconds": round(max(wall - covered, 0.0), 6),
            "wall_seconds": round(wall, 6),
        }
        ext = proc_extent.get(pid)
        proc_extent[pid] = (
            (min(ext[0], lo), max(ext[1], hi)) if ext else (lo, hi)
        )
        proc_thread_stage.setdefault(pid, {})[key] = stage_secs
        proc_thread_busy.setdefault(pid, {})[key] = covered

    critical = {}
    for pid, (lo, hi) in proc_extent.items():
        wall = (hi - lo) / 1e6
        thread_busy = proc_thread_busy[pid]
        busiest = max(thread_busy, key=thread_busy.get)
        attributed = {
            k: round(v, 6)
            for k, v in sorted(
                proc_thread_stage[pid][busiest].items(),
                key=lambda kv: -kv[1],
            )
        }
        critical[proc_names.get(pid, str(pid))] = {
            "wall_seconds": round(wall, 6),
            "bottleneck_thread": thread_names.get(busiest, str(busiest[1])),
            "attributed_seconds": attributed,
            "unattributed_seconds": round(
                max(wall - thread_busy[busiest], 0.0), 6
            ),
        }

    gaps.sort(key=lambda g: -g["duration_ms"])
    return {
        "busy_seconds_by_stage": {
            k: round(v, 6) for k, v in sorted(busy.items())
        },
        "stall_seconds_by_stage": {
            k: round(v, 6) for k, v in sorted(stall.items())
        },
        "span_counts_by_stage": dict(sorted(counts.items())),
        "starvation_gaps": gaps[:50],
        "gap_threshold_ms": gap_ms,
        "threads": threads,
        "critical_path": critical,
    }
