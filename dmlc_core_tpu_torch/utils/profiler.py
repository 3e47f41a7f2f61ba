"""Tracing/profiling hooks: host-side spans + ``torch.profiler`` capture
(the port of ``dmlc_core_tpu/utils/profiler.py``; the module loads no
torch).

- ``annotate(name)``: a ``torch.profiler.record_function(name)`` while a
  torch profiler records on the calling thread (the span then sits on
  the capture's host timeline beside the kernels it launched), else
  nothing. ``record_function`` costs a dispatcher call even when no
  profiler is active, so it is entered only when one is: the same
  no-op-when-idle meaning as the JAX package's ``TraceAnnotation``.
  torch is looked up only once the process has imported it.
- ``trace(logdir, device=None)``: context manager around
  ``torch.profiler.profile`` with CPU and, on the card, CUDA
  activities; it writes a Chrome trace into ``logdir`` on exit.
- span → telemetry bridge: with ``DMLC_PROFILE_HIST=1`` (or
  ``enable_histograms(True)``), every ``annotate`` span also records its
  duration into the registry histogram
  ``profiler.span_seconds{span=<name>}``. Off by default.
- span → flight-recorder bridge: while the trace ring is on
  (``DMLC_TRACE``, telemetry/tracing.py), every ``annotate`` span also
  lands on the per-thread ring as a Chrome trace-event: one call site
  feeds the torch capture, the span histogram and the Perfetto
  timeline.

StagingPipeline wires ``annotate`` around its pull/stage/wait phases.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional

from ..telemetry import tracing as _tracing

__all__ = ["annotate", "enable_histograms", "histograms_enabled", "trace"]


_TORCH = False  # unresolved sentinel; None = torch absent


def _torch(force: bool = False):
    global _TORCH
    if _TORCH is False:  # resolve once: annotate() sits on the hot loop
        if not force and "torch" not in sys.modules:
            # a process that never imported torch cannot have an active
            # torch profiler (the tracker, tools, the numpy workers); the
            # sentinel stays unresolved, so a later import is picked up
            return None
        try:
            import torch
            import torch.profiler  # noqa: F401

            _TORCH = torch
        except ImportError:
            _TORCH = None
    return _TORCH


def _recording(torch) -> bool:
    """Does a torch profiler record on this thread? (Its state is
    thread-local: a capture started on the trainer's thread records no
    ``record_function`` of the staging threads.)"""
    return torch.autograd._profiler_enabled()


# -- span duration histograms (opt-in) ----------------------------------------

_HIST_OVERRIDE: Optional[bool] = None  # enable_histograms() wins over env
_SPAN_HISTS: Dict[str, object] = {}  # name -> Histogram (memoized lookup)


def histograms_enabled() -> bool:
    """Are annotate() spans feeding duration histograms?"""
    if _HIST_OVERRIDE is not None:
        return _HIST_OVERRIDE
    return os.environ.get("DMLC_PROFILE_HIST", "0") not in ("", "0", "false")


def enable_histograms(on: Optional[bool]) -> None:
    """Force span histograms on/off for this process (None restores the
    ``DMLC_PROFILE_HIST`` env default)."""
    global _HIST_OVERRIDE
    _HIST_OVERRIDE = on


_SPAN_MEMO_CAP = 256  # span names are static call sites, not data
_SPAN_MEMO_LOCK = threading.Lock()


def _span_hist(name: str):
    hist = _SPAN_HISTS.get(name)  # lock-free fast path (GIL-atomic get)
    if hist is None:
        from ..telemetry import default_registry  # deferred: cold path only

        hist = default_registry().histogram(
            "profiler.span_seconds",
            help="annotate() span durations (secs)",
            labels={"span": name},
        )
        # the memo skips the registry lock per span; dynamic names must
        # not grow it forever: past the cap each call goes through the
        # registry (whose own cardinality cap collapses the series). The
        # cap check and the insert are one step under the lock, so
        # racing first calls keep exactly one histogram per name.
        with _SPAN_MEMO_LOCK:
            if len(_SPAN_HISTS) < _SPAN_MEMO_CAP:
                hist = _SPAN_HISTS.setdefault(name, hist)
    return hist


class _TimedSpan:
    """annotate() with histograms and/or the trace ring on: enter the
    inner annotation (if any), time the region with perf_counter_ns,
    observe/record on exit; one clock read feeds both sinks."""

    __slots__ = ("_inner", "_hist", "_name", "_t0")

    def __init__(self, inner, hist, name: Optional[str]) -> None:
        self._inner = inner
        self._hist = hist
        self._name = name  # non-None = also record on the trace ring

    def __enter__(self):
        if self._inner is not None:
            self._inner.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt_ns = time.perf_counter_ns() - self._t0
        if self._hist is not None:
            self._hist.observe(dt_ns * 1e-9)
        if self._name is not None:
            _tracing.add_complete(self._name, self._t0, dt_ns)
        if self._inner is not None:
            return self._inner.__exit__(*exc)
        return False


def annotate(name: str):
    """Context manager marking a host-side span: on the torch profiler's
    timeline while one records on this thread, in
    ``profiler.span_seconds{span=name}`` when histograms are enabled,
    and on the flight-recorder ring while tracing is on."""
    torch = _torch()
    inner = (
        torch.profiler.record_function(name)
        if torch is not None and _recording(torch)
        else None
    )
    hist = _span_hist(name) if histograms_enabled() else None
    traced = _tracing.enabled()
    if hist is not None or traced:
        return _TimedSpan(inner, hist, name if traced else None)
    return inner if inner is not None else nullcontext()


class Capture:
    """What ``trace`` yields: the running ``torch.profiler.profile``
    and, once the block has exited, the Chrome trace's ``path``."""

    def __init__(self, profile, path: str) -> None:
        self.profile = profile
        self.path = path


@contextmanager
def trace(logdir: str, device=None):
    """Capture a ``torch.profiler`` trace of the enclosed region and
    write it to ``logdir/torch-trace-<pid>.json`` (Chrome trace-event
    JSON: Perfetto or ``chrome://tracing``). CPU activity always; CUDA
    activity (kernels, copies) on the card, which is the default device
    and raises when there is none (``device="cpu"`` records the host
    only). Host annotations from ``annotate`` appear on the thread that
    entered ``trace``; spans of other threads are on the flight
    recorder's rings (telemetry/tracing.py)."""
    torch = _torch(force=True)
    if torch is None:
        raise RuntimeError("profiler trace requires torch")
    from .device import resolve_device

    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"torch-trace-{os.getpid()}.json")
    with torch.profiler.profile(activities=acts) as prof:
        cap = Capture(prof, path)
        yield cap
    prof.export_chrome_trace(path)
