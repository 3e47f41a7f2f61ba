"""The port's flight recorder (copies of tests/test_tracing.py run
against dmlc_core_tpu_torch.telemetry.tracing): bounded per-thread span rings whose overflow is COUNTED (never
silent), valid Chrome trace-event export, per-thread monotonic order,
cross-process merge round-trips, stall attribution, and a port submit
run (workers + tracker in one merged timeline, and with ``--block-cache``
the cache daemon too). Then both packages on
the same trace files: ``stall_report`` and ``merge_traces`` agree, and
a JAX process's trace merges with a port process's."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from dmlc_core_tpu.telemetry import tracing as jax_tracing
from dmlc_core_tpu_torch.telemetry import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fresh(monkeypatch):
    """Isolated recorder: cleared rings, tracing forced ON regardless
    of the environment, restored afterwards."""
    tracing.reset()
    tracing.set_enabled(True)
    yield
    tracing.set_enabled(None)
    tracing.reset()


# -- ring semantics ------------------------------------------------------------


def test_overflow_drops_are_counted_never_silent(fresh, monkeypatch):
    monkeypatch.setenv("DMLC_TRACE_BUF_KB", "1")  # -> minimum capacity
    tracing.reset()
    tracing.set_enabled(True)
    cap = tracing._ring_capacity()
    n = cap + 37
    for i in range(n):
        tracing.instant(f"ev_{i}")
    st = tracing.stats()
    (tstats,) = st["threads"].values()
    assert tstats["events"] == cap
    assert tstats["dropped"] == 37  # exact drop accounting
    # the SURVIVING events are the newest (drop-oldest), still in order
    trace = tracing.to_chrome_trace()
    names = [
        e["name"] for e in trace["traceEvents"] if e["ph"] == "i"
    ]
    assert names[0] == f"ev_{n - cap}" and names[-1] == f"ev_{n - 1}"
    # and the export declares the drops
    assert trace["otherData"]["dropped_events"] != {}


def test_disabled_records_nothing(fresh):
    tracing.set_enabled(False)
    with tracing.span("off_span"):
        pass
    tracing.instant("off_instant")
    tracing.begin("off_open")
    tracing.end()
    assert tracing.stats()["threads"] == {}


def test_env_knob_disables(fresh, monkeypatch):
    tracing.set_enabled(None)
    for off in ("off", "0", "false", ""):
        monkeypatch.setenv("DMLC_TRACE", off)
        tracing.reset()
        assert tracing.enabled() is False, off
    monkeypatch.setenv("DMLC_TRACE", "on")
    tracing.reset()
    assert tracing.enabled() is True
    monkeypatch.delenv("DMLC_TRACE")
    tracing.reset()
    assert tracing.enabled() is True  # always-on default


def test_unmatched_end_is_a_counted_drop_not_an_error(fresh):
    tracing.end()  # nothing open
    (tstats,) = tracing.stats()["threads"].values()
    assert tstats["dropped"] == 1


# -- export format -------------------------------------------------------------


def _span_events(trace):
    return [e for e in trace["traceEvents"] if e.get("ph") == "X"]


def test_export_is_valid_chrome_trace_format(fresh):
    with tracing.span("outer", label="x"):
        with tracing.span("inner"):
            pass
    tracing.instant("mark", n=2)
    tracing.counter("depth", 3)
    trace = tracing.to_chrome_trace()
    # round-trips through JSON (the on-disk format)
    trace = json.loads(json.dumps(trace))
    assert isinstance(trace["traceEvents"], list)
    phs = {e["ph"] for e in trace["traceEvents"]}
    assert phs == {"M", "X", "i", "C"}
    for ev in trace["traceEvents"]:
        assert {"ph", "name", "pid", "tid"} <= set(ev)
        if ev["ph"] == "M":
            assert ev["name"] in ("process_name", "thread_name")
            assert "name" in ev["args"]
            continue
        assert isinstance(ev["ts"], float)
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0
        if ev["ph"] == "i":
            assert ev["s"] == "t"
        if ev["ph"] == "C":
            assert ev["args"] == {"value": 3}
    # nested spans: inner's interval lies within outer's
    spans = {e["name"]: e for e in _span_events(trace)}
    outer, inner = spans["outer"], spans["inner"]
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert outer["args"] == {"label": "x"}


def test_per_thread_event_order_is_monotonic(fresh):
    def work():
        for _ in range(50):
            with tracing.span("t_span"):
                pass
            tracing.instant("t_mark")

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    work()  # main thread too
    trace = tracing.to_chrome_trace()
    by_tid = {}
    for ev in trace["traceEvents"]:
        if ev["ph"] in ("X", "i"):
            by_tid.setdefault(ev["tid"], []).append(ev["ts"])
    assert len(by_tid) == 5  # every thread has its own ring
    for tid, ts in by_tid.items():
        assert ts == sorted(ts), f"tid {tid} out of order"


def test_annotate_seam_feeds_the_ring(fresh):
    """ONE profiler.annotate call site feeds XProf, the histogram AND
    the flight recorder."""
    from dmlc_core_tpu_torch.utils.profiler import annotate

    with annotate("dmlc:seam_check"):
        time.sleep(0.001)
    spans = _span_events(tracing.to_chrome_trace())
    assert [s["name"] for s in spans] == ["dmlc:seam_check"]
    assert spans[0]["dur"] >= 1000.0  # slept >= 1ms, dur is in us


def test_dump_and_load_roundtrip(fresh, tmp_path):
    with tracing.span("persisted"):
        pass
    path = tracing.dump(str(tmp_path / "t.json"))
    trace = tracing.load_trace(path)
    assert [s["name"] for s in _span_events(trace)] == ["persisted"]
    assert trace["otherData"]["pid"] == os.getpid()
    with pytest.raises(ValueError, match="traceEvents"):
        bad = tmp_path / "bad.json"
        bad.write_text('{"not": "a trace"}')
        tracing.load_trace(str(bad))


def test_sigusr2_dump_on_demand(fresh, tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_TRACE_DIR", str(tmp_path))
    prev = signal.getsignal(signal.SIGUSR2)
    try:
        assert tracing.install_signal_dump() is True
        with tracing.span("pre_signal"):
            pass
        os.kill(os.getpid(), signal.SIGUSR2)
        # the handler runs between bytecodes; force a checkpoint
        time.sleep(0.01)
        files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
        assert len(files) == 1
        trace = tracing.load_trace(str(tmp_path / files[0]))
        assert "pre_signal" in {e["name"] for e in _span_events(trace)}
    finally:
        signal.signal(signal.SIGUSR2, prev)


def test_reset_reregisters_long_lived_pool_threads(fresh):
    """reset() must not orphan OTHER threads' rings: a pool thread that
    recorded before the reset keeps recording VISIBLY after it (the
    generation bump re-registers its TLS ring at the next event)."""
    import concurrent.futures as cf

    pool = cf.ThreadPoolExecutor(max_workers=1)
    try:
        pool.submit(tracing.instant, "before").result()
        tracing.reset()
        pool.submit(tracing.instant, "after").result()
        names = {
            e["name"]
            for e in tracing.to_chrome_trace()["traceEvents"]
            if e["ph"] == "i"
        }
        assert names == {"after"}
    finally:
        pool.shutdown()


def test_auto_install_defers_to_existing_sigusr2_handler(
    fresh, monkeypatch
):
    """The lazy signal auto-install must never clobber a handler the
    application already registered (checkpoint-on-preemption etc.) —
    only explicit install_signal_dump() overrides."""
    prev = signal.getsignal(signal.SIGUSR2)
    app_handler = lambda *_a: None  # noqa: E731
    try:
        signal.signal(signal.SIGUSR2, app_handler)
        monkeypatch.setattr(tracing, "_SIGNAL_INSTALLED", False)
        tracing.reset()  # force ring re-registration on next event
        tracing.instant("poke")  # triggers _maybe_install_signal
        assert signal.getsignal(signal.SIGUSR2) is app_handler
        # the explicit call is the sanctioned override
        assert tracing.install_signal_dump() is True
        assert signal.getsignal(signal.SIGUSR2) is not app_handler
    finally:
        signal.signal(signal.SIGUSR2, prev)


def test_trace_dump_cli_accepts_positional_pid():
    from dmlc_core_tpu_torch import tools

    # no pid at all: usage error
    assert tools.main(["trace", "dump"]) == 2
    # a positional pid parses (the signal then fails on the bogus pid,
    # proving the value reached os.kill)
    assert tools.main(["trace", "dump", "999999999"]) == 1
    assert tools.main(["trace", "dump", "--pid", "999999999"]) == 1


# -- cross-process merge -------------------------------------------------------

_PROC_SNIPPET = """
import sys
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.telemetry import tracing
with tracing.span("work", who={who!r}):
    pass
tracing.instant("done")
# atexit dumps into DMLC_TRACE_DIR (how submit-run processes leave
# their trace files behind)
"""


def test_merge_round_trips_a_two_process_run(tmp_path):
    """Two REAL processes dump traces (atexit + DMLC_TRACE_DIR); the
    ``tools trace merge`` CLI joins them into one loadable timeline
    with both processes distinguishable."""
    env = {
        **os.environ, "DMLC_TRACE_DIR": str(tmp_path), "DMLC_TRACE": "on",
    }
    for who, rank in (("alpha", "0"), ("beta", "1")):
        proc_env = {
            **env, "DMLC_ROLE": "worker", "DMLC_TASK_ID": rank,
        }
        out = subprocess.run(
            [sys.executable, "-c",
             _PROC_SNIPPET.format(repo=REPO, who=who)],
            capture_output=True, text=True, env=proc_env, timeout=60,
        )
        assert out.returncode == 0, out.stderr
    files = sorted(
        str(tmp_path / f)
        for f in os.listdir(tmp_path)
        if f.startswith("dmlc-trace-")
    )
    assert len(files) == 2
    from dmlc_core_tpu_torch import tools

    merged_path = str(tmp_path / "merged.json")
    rc = tools.main(["trace", "merge"] + files + ["-o", merged_path])
    assert rc == 0
    merged = tracing.load_trace(merged_path)
    assert merged["otherData"]["merged"] == 2
    pids = {
        e["pid"] for e in merged["traceEvents"] if e["ph"] == "X"
    }
    assert len(pids) == 2  # two processes, distinct rows
    labels = {
        e["args"]["name"]
        for e in merged["traceEvents"]
        if e["ph"] == "M" and e["name"] == "process_name"
    }
    assert any("worker0" in lb for lb in labels)
    assert any("worker1" in lb for lb in labels)
    whos = {
        e["args"]["who"]
        for e in merged["traceEvents"]
        if e["ph"] == "X" and e["name"] == "work"
    }
    assert whos == {"alpha", "beta"}
    # events stay time-sorted after the merge
    ts = [e["ts"] for e in merged["traceEvents"] if "ts" in e]
    assert ts == sorted(ts)


def test_merge_remaps_colliding_pids(fresh, tmp_path):
    with tracing.span("dup"):
        pass
    p = tracing.dump(str(tmp_path / "a.json"))
    merged = tracing.merge_traces([p, p])  # same pid twice
    pids = {e["pid"] for e in merged["traceEvents"]}
    assert len(pids) == 2  # the collision got a synthetic pid


# -- stall attribution ---------------------------------------------------------


def _fake_trace():
    """Synthetic timeline: a transfer thread doing 3 x 10ms of pack
    work with one 50ms host_pull stall, a consumer with a 20ms
    transfer_wait — known numbers for the report to recover."""
    pid = 7
    mk = lambda name, tid, ts_ms, dur_ms: {
        "ph": "X", "name": name, "pid": pid, "tid": tid,
        "ts": ts_ms * 1000.0, "dur": dur_ms * 1000.0,
    }
    events = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": "worker0 (pid 7)"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 1,
         "args": {"name": "staging-xfer"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 2,
         "args": {"name": "MainThread"}},
        mk("dmlc:dispatch_pack", 1, 0, 10),
        mk("dmlc:host_pull", 1, 10, 50),   # the starvation gap
        mk("dmlc:dispatch_pack", 1, 60, 10),
        mk("dmlc:dispatch_pack", 1, 70, 10),
        mk("dmlc:transfer_wait", 2, 5, 20),
    ]
    return {"traceEvents": events}


def test_stall_report_attributes_busy_and_stalls():
    rep = tracing.stall_report(_fake_trace(), gap_ms=25.0)
    assert rep["busy_seconds_by_stage"] == {"dispatch_pack": 0.03}
    assert rep["stall_seconds_by_stage"] == {
        "host_pull": 0.05, "transfer_wait": 0.02,
    }
    # exactly one gap clears the 25ms threshold, quantified
    (gap,) = rep["starvation_gaps"]
    assert gap["stage"] == "host_pull"
    assert gap["duration_ms"] == 50.0
    assert gap["thread"] == "staging-xfer"
    # thread rollup: xfer thread busy 80ms over an 80ms extent
    xfer = rep["threads"]["worker0 (pid 7)/staging-xfer"]
    assert xfer["busy_seconds"] == pytest.approx(0.08)
    assert xfer["idle_seconds"] == pytest.approx(0.0)
    # critical path lands on the busiest thread with the stall visible
    crit = rep["critical_path"]["worker0 (pid 7)"]
    assert crit["bottleneck_thread"] == "staging-xfer"
    assert crit["attributed_seconds"]["host_pull"] == 0.05


def test_report_cli_prints_busy_idle_and_gaps(tmp_path, capsys):
    from dmlc_core_tpu_torch import tools

    path = str(tmp_path / "t.json")
    tracing.write_trace(_fake_trace(), path)
    rc = tools.main(["trace", "report", path, "--gap-ms", "25"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "host_pull" in out and "stall" in out
    assert "dispatch_pack" in out and "busy" in out
    assert "starvation gaps >= 25.0 ms: 1" in out
    assert "50.00 ms" in out
    assert "critical-path" in out


def test_union_seconds_handles_nesting():
    # nested + overlapping intervals must not double count
    assert tracing._union_seconds(
        [(0.0, 100.0), (10.0, 50.0), (90.0, 150.0)]
    ) == pytest.approx(150.0 / 1e6)


# -- instrumented layers feed the ring -----------------------------------------


def test_windowed_drain_leaves_spans_on_the_ring(fresh, tmp_path):
    """The split layer's instrumentation end-to-end: a compressed
    windowed drain records window loads, refills and decode spans."""
    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io import split as io_split
    from dmlc_core_tpu_torch.io.stream import FileStream

    rec = str(tmp_path / "d.rec")
    idx = str(tmp_path / "d.rec.idx")
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec="zlib", block_bytes=1024)
        for i in range(400):
            w.write_record(f"record-{i:06d}".encode() * 4)
        w.flush_block()
    sp = io_split.create(
        f"{rec}?index={idx}&shuffle=record&window=100",
        type="recordio", threaded=False,
    )
    rows = 0
    while True:
        g = sp.next_gather_batch(64)
        if g is None:
            break
        rows += len(g[1])
    sp.close()
    assert rows == 400
    names = {e["name"] for e in _span_events(tracing.to_chrome_trace())}
    assert "dmlc:window_load" in names
    assert "dmlc:gather_refill" in names
    assert "dmlc:window_span_decode" in names
    assert "dmlc:decode_block" in names


def test_retry_backoff_spans_recorded(fresh):
    from dmlc_core_tpu_torch.io.retry import RetryPolicy

    pol = RetryPolicy(base_secs=0.001, cap_secs=0.002, sleep=lambda s: None)
    pol.pause(what="GET s3://bucket/key")
    spans = _span_events(tracing.to_chrome_trace())
    assert [s["name"] for s in spans] == ["dmlc:retry_backoff"]
    assert spans[0]["args"]["what"] == "GET s3://bucket/key"
    assert spans[0]["args"]["delay_ms"] > 0


# -- the dmlc-submit acceptance path -------------------------------------------

_SUBMIT_WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from dmlc_core_tpu_torch.tracker.client import RabitWorker
from dmlc_core_tpu_torch.tracker.collective import Collective
from dmlc_core_tpu_torch.io import split as io_split
w = RabitWorker()
rank = w.start()
coll = Collective(w)
sp = io_split.create(
    {rec!r} + "?index=" + {idx!r} + "&shuffle=record&window=128",
    type="recordio", threaded=False)
rows = 0
while True:
    g = sp.next_gather_batch(64)
    if g is None:
        break
    rows += len(g[1])
sp.close()
assert rows == 500, rows
total = coll.allreduce(np.array([rows], dtype=np.int64))
assert int(total[0]) == 1000, total
w.heartbeat()
coll.close()
w.shutdown()
"""


def test_submit_run_merges_workers_and_tracker(tmp_path):
    """A port ``submit --trace-dir`` run with 2 workers leaves one trace
    file per process (each worker and the tracker) that ``tools trace
    merge`` joins into one timeline with spans of all three, flow arrows
    between the ranks' allreduce frames and from each worker to the
    tracker's handling of its requests; ``trace report`` attributes
    the stages. (``test_submit_run_merges_workers_daemon_and_tracker``
    adds the block-cache daemon, as the JAX test does.)"""
    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io.stream import FileStream

    rec = str(tmp_path / "corpus.rec")
    idx = rec + ".idx"
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec="zlib", block_bytes=2048)
        for i in range(500):
            w.write_record(f"row-{i:06d}|".encode() * 8)
        w.flush_block()
    trace_dir = tmp_path / "traces"
    script = tmp_path / "worker.py"
    script.write_text(_SUBMIT_WORKER.format(repo=REPO, rec=rec, idx=idx))
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
         "--cluster", "local", "--num-workers", "2",
         "--host-ip", "127.0.0.1",
         "--trace-dir", str(trace_dir),
         sys.executable, str(script)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "DMLC_TRACE": "on", "JAX_PLATFORMS": "cpu"},
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    files = sorted(
        str(trace_dir / f)
        for f in os.listdir(trace_dir)
        if f.startswith("dmlc-trace-")
    )
    assert len(files) == 3, files  # 2 workers + the tracker (submit)
    from dmlc_core_tpu_torch import tools

    merged_path = str(tmp_path / "job.json")
    rc = tools.main(["trace", "merge"] + files + ["-o", merged_path])
    assert rc == 0
    merged = tracing.load_trace(merged_path)
    labels = {
        e["args"]["name"]
        for e in merged["traceEvents"]
        if e["ph"] == "M" and e["name"] == "process_name"
    }
    assert any("worker0" in lb for lb in labels), labels
    assert any("worker1" in lb for lb in labels), labels
    assert any("tracker" in lb for lb in labels), labels
    names = {
        e["name"] for e in merged["traceEvents"] if e["ph"] == "X"
    }
    assert "dmlc:window_load" in names          # worker spans
    assert "dmlc:allreduce_wait" in names
    assert "dmlc:tracker_heartbeat" in names    # tracker spans
    instants = {
        e["name"] for e in merged["traceEvents"] if e["ph"] == "i"
    }
    assert "dmlc:tracker_start" in instants      # tracker events
    assert "dmlc:tracker_rank_assigned" in instants
    # flow arrows: a start in one process finished in another
    starts = {e["id"]: e["pid"] for e in merged["traceEvents"] if e["ph"] == "s"}
    crossed = [e for e in merged["traceEvents"]
               if e["ph"] == "f" and e["id"] in starts and starts[e["id"]] != e["pid"]]
    assert crossed
    # the report over the merged run: per-stage busy/idle + >=1 gap
    rep = tracing.stall_report(
        tracing.load_trace(merged_path), gap_ms=0.05
    )
    assert rep["busy_seconds_by_stage"], rep
    assert rep["threads"]
    assert len(rep["starvation_gaps"]) >= 1, rep


@pytest.mark.blockcache
def test_submit_run_merges_workers_daemon_and_tracker(tmp_path):
    """A port ``submit --block-cache --trace-dir`` run with 2 workers
    leaves a trace file per process, the ``tools cached serve`` daemon's
    included, that ``tools trace merge`` joins into one timeline with a
    ``blockcache-daemon`` row holding its ``dmlc:blockcache_*`` handler
    spans beside the workers' and the tracker's."""
    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io.stream import FileStream

    rec = str(tmp_path / "corpus.rec")
    idx = rec + ".idx"
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec="zlib", block_bytes=2048)
        for i in range(500):
            w.write_record(f"row-{i:06d}|".encode() * 8)
        w.flush_block()
    trace_dir = tmp_path / "traces"
    script = tmp_path / "worker.py"
    script.write_text(_SUBMIT_WORKER.format(repo=REPO, rec=rec, idx=idx))
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
         "--cluster", "local", "--num-workers", "2", "--host-ip", "127.0.0.1",
         "--block-cache", "--trace-dir", str(trace_dir), sys.executable, str(script)],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "DMLC_TRACE": "on", "JAX_PLATFORMS": "cpu"}, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    files = sorted(str(trace_dir / f) for f in os.listdir(trace_dir)
                   if f.startswith("dmlc-trace-"))
    assert len(files) == 4, files  # 2 workers, the daemon and the tracker
    from dmlc_core_tpu_torch import tools

    merged_path = str(tmp_path / "job.json")
    assert tools.main(["trace", "merge"] + files + ["-o", merged_path]) == 0
    merged = tracing.load_trace(merged_path)
    labels = {e["args"]["name"] for e in merged["traceEvents"]
              if e["ph"] == "M" and e["name"] == "process_name"}
    for want in ("worker0", "worker1", "blockcache-daemon", "tracker"):
        assert any(want in lb for lb in labels), labels
    names = {e["name"] for e in merged["traceEvents"] if e["ph"] == "X"}
    assert "dmlc:window_load" in names
    assert any(n.startswith("dmlc:blockcache_") for n in names), names


# -- causal RPC trace context ---------------------------------------------------


def test_trace_context_roundtrip_and_malformed(fresh):
    ctx = tracing.rpc_context()
    dec = tracing.decode_context(ctx)
    assert dec is not None and dec[0] > 0 and dec[1] > 0
    assert tracing.encode_context(*dec) == ctx
    # malformed contexts cost the arrow, never an exception
    for bad in (None, "", "zz", "123", "a" * 33, "g" * 16 + "-" + "f" * 16,
                42, b"x"):
        assert tracing.decode_context(bad) is None
        tracing.handler_flow(bad)  # no-op, no raise


def test_flow_events_bind_wait_span_to_handler_span(fresh):
    """The export contract Perfetto needs: the client's "s" flow is
    temporally inside its wait span, the server's "f" (same id, same
    cat, bp=e) inside the handler span."""
    with tracing.span("dmlc:lookup_wait"):
        ctx = tracing.rpc_context()
    with tracing.handler_span("dmlc:lookup_lookup", ctx):
        time.sleep(0.001)
    trace = tracing.to_chrome_trace()
    evs = trace["traceEvents"]
    starts = [e for e in evs if e["ph"] == "s"]
    ends = [e for e in evs if e["ph"] == "f"]
    assert len(starts) == 1 and len(ends) == 1
    s, f = starts[0], ends[0]
    assert s["id"] == f["id"] and s["cat"] == f["cat"] == "dmlc.flow"
    assert s["name"] == f["name"]
    assert f["bp"] == "e"
    wait = next(e for e in evs if e.get("name") == "dmlc:lookup_wait")
    handler = next(
        e for e in evs if e.get("name") == "dmlc:lookup_lookup"
    )
    assert wait["ts"] <= s["ts"] <= wait["ts"] + wait["dur"]
    assert handler["ts"] <= f["ts"] <= handler["ts"] + handler["dur"]
    # the handler span records the context for grep-ability
    assert handler["args"]["tc"] == ctx
    # and the flow id IS the context's span id
    assert int(s["id"], 16) == tracing.decode_context(ctx)[1]


def test_binary_flow_ids_for_frame_protocols(fresh):
    """The collective's DCL1 header carries the raw 64-bit id."""
    with tracing.span("send_side"):
        fid = tracing.flow_send_id()
    assert fid > 0
    with tracing.span("dmlc:allreduce_wait"):
        tracing.flow_recv(fid)
    tracing.flow_recv(0)  # recorder-off sender: no event, no raise
    evs = tracing.to_chrome_trace()["traceEvents"]
    assert [e["ph"] for e in evs if e["ph"] in "sf"] == ["s", "f"]
    s, f = (e for e in evs if e["ph"] in "sf")
    assert s["id"] == f["id"] == f"{fid:x}"


def test_rpc_context_none_when_disabled(fresh):
    tracing.set_enabled(False)
    assert tracing.rpc_context() is None
    assert tracing.flow_send_id() == 0


def test_wait_spans_mirror_into_stall_counters(fresh):
    """Completed wait-stage spans tick trace.stall_seconds{stage=} —
    the registry mirror the windowed stall-fraction query reads."""
    from dmlc_core_tpu_torch.telemetry import default_registry

    key = 'trace.stall_seconds{stage="shard_lease_wait"}'
    before = default_registry().counter_values(names=[key]).get(key, 0.0)
    with tracing.span("dmlc:shard_lease_wait"):
        time.sleep(0.01)
    with tracing.span("dmlc:window_load"):  # busy stage: NOT mirrored
        time.sleep(0.001)
    after = default_registry().counter_values(names=[key])[key]
    assert after - before >= 0.009
    busy = default_registry().counter_values(
        names=['trace.stall_seconds{stage="window_load"}']
    )
    assert not busy


def test_clock_offset_recorded_and_merge_aligns(fresh, tmp_path):
    tracing.set_clock_offset(2_000_000.0)  # this process runs 2ms fast
    tracing.instant("dmlc:mark")
    trace = tracing.to_chrome_trace()
    assert trace["otherData"]["clock_offset_ns"] == 2_000_000.0
    assert trace["otherData"]["clock_offset_source"] == "heartbeat_rtt"
    raw_ts = next(
        e["ts"] for e in trace["traceEvents"] if e["ph"] == "i"
    )
    # default merge: timestamps untouched (same-host runs)
    merged = tracing.merge_traces([trace])
    assert any(
        e.get("ts") == raw_ts for e in merged["traceEvents"]
    )
    # align_clocks subtracts the offset (ns -> us)
    aligned = tracing.merge_traces([trace], align_clocks=True)
    shifted = next(
        e["ts"] for e in aligned["traceEvents"] if e["ph"] == "i"
    )
    assert shifted == pytest.approx(raw_ts - 2000.0)
    # per-file otherData (offset included) is preserved for forensics
    assert aligned["otherData"]["processes"][0]["clock_offset_ns"] == (
        2_000_000.0
    )


# -- both packages on the same trace files ---------------------------------------


def _record_pipeline_shape(mod, label):
    """A staging-shaped timeline on ``mod``'s recorder: a producer thread
    (parse work, host_pull waits), a consumer (transfer_wait stalls and
    steps), an RPC flow and counter samples."""
    mod.reset()
    mod.set_enabled(True)
    mod.set_process_label(label)

    def producer():
        for i in range(6):
            with mod.span("dmlc:parse_chunk", i=i):
                time.sleep(0.002)
            with mod.span("dmlc:host_pull"):
                time.sleep(0.004 if i % 2 else 0.0005)

    t = threading.Thread(target=producer, name="staging")
    t.start()
    for i in range(6):
        with mod.span("dmlc:transfer_wait"):
            time.sleep(0.003)
            mod.rpc_context()
        with mod.span("dmlc:step", i=i):
            time.sleep(0.001)
        mod.counter("rows", 64 * (i + 1))
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.mark.parametrize("recorder", ["port", "jax"])
def test_stall_report_equals_jax_on_the_same_file(tmp_path, recorder):
    mod = tracing if recorder == "port" else jax_tracing
    try:
        _record_pipeline_shape(mod, f"{recorder}-proc")
        path = mod.dump(str(tmp_path / "t.json"))
    finally:
        mod.set_enabled(None)
        mod.reset()
    for gap in (0.5, 2.0, 10.0):
        rep = tracing.stall_report(tracing.load_trace(path), gap_ms=gap)
        assert rep == jax_tracing.stall_report(jax_tracing.load_trace(path), gap_ms=gap)
    assert rep["stall_seconds_by_stage"]["transfer_wait"] > 0


def test_merge_joins_a_jax_trace_and_a_port_trace(tmp_path):
    paths = []
    for name, mod in (("port", tracing), ("jax", jax_tracing)):
        try:
            _record_pipeline_shape(mod, f"{name}-proc")
            paths.append(mod.dump(str(tmp_path / f"{name}.json")))
        finally:
            mod.set_enabled(None)
            mod.reset()
    merged = tracing.merge_traces(paths)
    assert merged == jax_tracing.merge_traces(paths)
    labels = {e["args"]["name"] for e in merged["traceEvents"]
              if e["ph"] == "M" and e["name"] == "process_name"}
    assert any("port-proc" in lb for lb in labels), labels
    assert any("jax-proc" in lb for lb in labels), labels
    # both files came from this one pid: the merge keeps them apart
    pids = {e["pid"] for e in merged["traceEvents"] if e["ph"] == "X"}
    assert len(pids) == 2
    out = str(tmp_path / "merged.json")
    from dmlc_core_tpu_torch import tools

    assert tools.main(["trace", "merge", *paths, "-o", out]) == 0
    assert tracing.load_trace(out) == merged
