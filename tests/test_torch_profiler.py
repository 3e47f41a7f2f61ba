"""The port's utils/profiler.py (copies of tests/test_profiler.py with
"without torch" in place of "without jax"): annotate() degrades to a
no-op without torch, trace() fails loudly without torch, and spans feed
the profiler.span_seconds duration histograms when enabled. Then the
torch half: annotate() enters record_function only while a profiler
records on the calling thread, and trace(logdir, device="cpu") writes a
Chrome trace holding the dmlc:* spans of that thread."""

import json
import os
import threading

import pytest
import torch

from dmlc_core_tpu_torch.telemetry import default_registry, tracing
from dmlc_core_tpu_torch.utils import profiler
from dmlc_core_tpu_torch.utils.logging import Error


@pytest.fixture
def no_torch(monkeypatch):
    """Simulate a torch-less environment (the resolved-torch cache is
    module state; None means 'import failed')."""
    monkeypatch.setattr(profiler, "_TORCH", None)


@pytest.fixture
def hist_off():
    """Leave histogram enablement as the test found it."""
    yield
    profiler.enable_histograms(None)


@pytest.fixture
def trace_off():
    """Force the flight recorder off (it is on by default, and an
    enabled ring makes annotate() a recording span, not a no-op)."""
    tracing.set_enabled(False)
    yield
    tracing.set_enabled(None)


def test_annotate_is_noop_context_manager_without_torch(
    no_torch, hist_off, trace_off
):
    profiler.enable_histograms(False)
    cm = profiler.annotate("dmlc:test")
    with cm as inner:
        assert inner is None  # nullcontext yields None
    # reentrant: annotate() hands out fresh context managers
    with profiler.annotate("dmlc:test"):
        pass


def test_trace_raises_clean_runtime_error_without_torch(no_torch):
    with pytest.raises(RuntimeError, match="requires torch"):
        with profiler.trace("/tmp/nowhere"):
            pass


def test_annotate_feeds_duration_histograms_when_enabled(no_torch, hist_off):
    profiler.enable_histograms(True)
    key = 'profiler.span_seconds{span="dmlc:test_span"}'
    before = (
        default_registry()
        .snapshot()["histograms"]
        .get(key, {})
        .get("count", 0)
    )
    for _ in range(3):
        with profiler.annotate("dmlc:test_span"):
            pass
    snap = default_registry().snapshot()["histograms"][key]
    assert snap["count"] - before == 3
    assert snap["sum"] >= 0
    # disabled again: no further samples recorded
    profiler.enable_histograms(False)
    with profiler.annotate("dmlc:test_span"):
        pass
    snap2 = default_registry().snapshot()["histograms"][key]
    assert snap2["count"] - before == 3


def test_histograms_env_default(monkeypatch, hist_off):
    profiler.enable_histograms(None)
    monkeypatch.delenv("DMLC_PROFILE_HIST", raising=False)
    assert profiler.histograms_enabled() is False
    monkeypatch.setenv("DMLC_PROFILE_HIST", "1")
    assert profiler.histograms_enabled() is True
    monkeypatch.setenv("DMLC_PROFILE_HIST", "0")
    assert profiler.histograms_enabled() is False
    # explicit override beats the env
    profiler.enable_histograms(True)
    assert profiler.histograms_enabled() is True


def test_annotate_with_torch_still_times_spans(hist_off):
    """With torch present, annotate() still observes the duration
    histogram (and wraps record_function while a profiler records)."""
    profiler.enable_histograms(True)
    key = 'profiler.span_seconds{span="dmlc:torch_span"}'
    with profiler.annotate("dmlc:torch_span"):
        pass
    snap = default_registry().snapshot()["histograms"][key]
    assert snap["count"] >= 1


def test_span_memo_concurrent_first_annotate_race(no_torch, hist_off):
    """Concurrent FIRST annotate() calls must not
    double-register a span name (last-writer-wins in the memo would
    hand different threads different histogram objects) nor mis-account
    the memo cap (racing check-then-set inserts past it). All threads
    must land their observations on ONE histogram per name."""
    import threading

    profiler.enable_histograms(True)
    profiler._SPAN_HISTS.clear()
    n_threads, n_names = 8, 16
    seen = [[None] * n_names for _ in range(n_threads)]
    gate = threading.Barrier(n_threads)

    def worker(slot):
        gate.wait()  # maximize first-annotate collisions
        for i in range(n_names):
            with profiler.annotate(f"dmlc:race_{i}"):
                pass
            seen[slot][i] = profiler._SPAN_HISTS.get(f"dmlc:race_{i}")

    threads = [
        threading.Thread(target=worker, args=(s,))
        for s in range(n_threads)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    # one memoized histogram per name, shared by every thread
    for i in range(n_names):
        hists = {id(seen[s][i]) for s in range(n_threads)}
        assert len(hists) == 1, f"name {i} double-registered"
    assert len(profiler._SPAN_HISTS) == n_names  # cap accounting exact
    # and every observation landed on that one series
    key = 'profiler.span_seconds{span="dmlc:race_0"}'
    snap = default_registry().snapshot()["histograms"][key]
    assert snap["count"] >= n_threads


def _count_record_functions(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        made.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return made


def test_annotate_skips_record_function_while_no_profiler_records(
    monkeypatch, hist_off
):
    """record_function costs a dispatcher call even when idle: annotate()
    builds one only while a profiler records on this thread."""
    profiler.enable_histograms(False)
    made = _count_record_functions(monkeypatch)
    with profiler.annotate("dmlc:idle_span"):
        pass
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.annotate("dmlc:live_span"):
            torch.ones(4).sum()
    assert made == ["dmlc:live_span"]


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path, hist_off):
    """trace(logdir, device="cpu"): the capture holds the calling
    thread's dmlc:* spans; a staging-style thread's spans are not in it
    (the profiler's state is per thread) but are on the flight
    recorder's ring."""
    tracing.set_enabled(True)
    tracing.reset()
    try:
        def other():
            with profiler.annotate("dmlc:other_thread_span"):
                torch.ones(4).sum()

        with profiler.trace(str(tmp_path), device="cpu") as cap:
            with profiler.annotate("dmlc:main_thread_span"):
                torch.ones(8).sum()
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
        assert cap.path == os.path.join(str(tmp_path), f"torch-trace-{os.getpid()}.json")
        names = {e.get("name") for e in json.load(open(cap.path))["traceEvents"]}
        assert "dmlc:main_thread_span" in names
        assert "dmlc:other_thread_span" not in names
        ring = {e["name"] for e in tracing.to_chrome_trace()["traceEvents"]
                if e.get("ph") == "X"}
        assert {"dmlc:main_thread_span", "dmlc:other_thread_span"} <= ring
    finally:
        tracing.set_enabled(None)
        tracing.reset()


def test_trace_defaults_to_the_card(tmp_path, monkeypatch):
    """The port's device rule: trace() captures CUDA activity by default
    and raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Error, match="torch.cuda.is_available"):
        with profiler.trace(str(tmp_path)):
            pass
    assert not os.listdir(tmp_path)


def test_span_memo_bounded_on_dynamic_names(no_torch, hist_off):
    """annotate(f'step_{i}') with histograms on must not grow the memo
    dict forever — past the cap, lookups fall through to the registry
    (whose cardinality cap collapses the series). Runs LAST: it
    saturates the default registry's profiler.span_seconds family on
    purpose, so span-key assertions must precede it."""
    profiler.enable_histograms(True)
    before = len(profiler._SPAN_HISTS)
    for i in range(profiler._SPAN_MEMO_CAP + 50):
        with profiler.annotate(f"dmlc:dyn_{i}"):
            pass
    assert len(profiler._SPAN_HISTS) <= profiler._SPAN_MEMO_CAP, before
