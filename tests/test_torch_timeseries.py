"""The port's windowed time series (copies of tests/test_timeseries.py
run against dmlc_core_tpu_torch.telemetry.timeseries): the
per-process sample ring, the windowed-rate query (counter-reset
handling, histogram deltas), the tracker-side cluster store's
monotone-clock contract under worker relaunch, heartbeat transport of
ring samples, the ``/metrics.json?window=`` contract, and the ``tools
top --once --json`` smoke against an in-process tracker. Then both
packages on the same samples: ``windowed``, ``merge_windows`` and the
cluster store give the same numbers."""

import json
import time

import pytest

import numpy as np

from dmlc_core_tpu.telemetry import timeseries as jax_ts
from dmlc_core_tpu_torch.telemetry import MetricRegistry
from dmlc_core_tpu_torch.telemetry import timeseries as ts


def _mk_registry():
    return MetricRegistry()


# -- windowed() pure query ----------------------------------------------------


def test_windowed_counter_rates_and_gauges():
    reg = _mk_registry()
    c = reg.counter("io.split.records")
    g = reg.gauge("tracker.shards.queue_depth")
    samples = []
    c.inc(100)
    g.set(7)
    s = ts.take_sample(reg, 1)
    s["t"] = 100.0
    samples.append(s)
    c.inc(300)
    g.set(3)
    s = ts.take_sample(reg, 2)
    s["t"] = 110.0
    samples.append(s)
    win = ts.windowed(samples, 30.0)
    assert win["samples"] == 2
    rec = win["counters"]["io.split.records"]
    assert rec["delta"] == 300.0
    assert rec["per_sec"] == pytest.approx(30.0)
    qd = win["gauges"]["tracker.shards.queue_depth"]
    assert qd["last"] == 3.0 and qd["max"] == 7.0 and qd["min"] == 3.0
    assert win["derived"]["rows_per_sec"] == pytest.approx(30.0)
    assert win["derived"]["shard_queue_depth"]["last"] == 3.0


def test_windowed_picks_baseline_at_window_edge():
    """The baseline is the newest sample AT/BEFORE the window start —
    a 10 s window over a 60 s series must rate the last 10 s only."""
    reg = _mk_registry()
    c = reg.counter("io.split.records")
    samples = []
    for i in range(7):
        c.inc(100 if i < 6 else 10_000)  # the last step is much hotter
        s = ts.take_sample(reg, i + 1)
        s["t"] = 100.0 + i * 10.0
        samples.append(s)
    win = ts.windowed(samples, 10.0)
    assert win["counters"]["io.split.records"]["delta"] == 10_000.0
    assert win["counters"]["io.split.records"]["per_sec"] == pytest.approx(
        1000.0
    )


def test_windowed_counter_reset_is_rate_since_restart():
    """A relaunched worker's counters restart at zero; the windowed
    delta must be the value-since-restart, never negative (Prometheus
    counter-reset semantics)."""
    samples = [
        {"t": 100.0, "seq": 1, "counters": {"io.split.records": 5000.0},
         "gauges": {}, "histograms": {}},
        {"t": 110.0, "seq": 2, "counters": {"io.split.records": 400.0},
         "gauges": {}, "histograms": {}},
    ]
    win = ts.windowed(samples, 60.0)
    assert win["counters"]["io.split.records"]["delta"] == 400.0
    assert win["counters"]["io.split.records"]["per_sec"] >= 0


def test_windowed_histogram_delta_percentiles():
    reg = _mk_registry()
    h = reg.histogram("io.lookup.request_seconds")
    for _ in range(100):
        h.observe(1e-3)
    s1 = ts.take_sample(reg, 1)
    s1["t"] = 100.0
    for _ in range(100):
        h.observe(0.5)  # the WINDOW is all-slow even if history is fast
    s2 = ts.take_sample(reg, 2)
    s2["t"] = 130.0
    win = ts.windowed([s1, s2], 60.0)
    d = win["histograms"]["io.lookup.request_seconds"]
    assert d["count"] == 100
    assert d["p50"] > 0.1  # the fast pre-window observations are gone


def test_windowed_histogram_mismatched_edges_degrade_to_head():
    """A baseline with foreign bucket edges (version skew, restart with
    different bounds) must not corrupt the delta — the head snapshot
    stands alone."""
    base = {"t": 100.0, "seq": 1, "counters": {}, "gauges": {},
            "histograms": {"h": {"le": [1.0, 2.0], "n": [1, 1, 0],
                                 "count": 2, "sum": 2.0}}}
    head = {"t": 110.0, "seq": 2, "counters": {}, "gauges": {},
            "histograms": {"h": {"le": [1.0, 4.0], "n": [3, 1, 0],
                                 "count": 4, "sum": 5.0}}}
    win = ts.windowed([base, head], 60.0)
    assert win["histograms"]["h"]["count"] == 4  # head, not a bad delta


def test_stall_fraction_derived_from_trace_mirror():
    samples = []
    for i, stall in enumerate((0.0, 6.0)):
        samples.append({
            "t": 100.0 + i * 10.0, "seq": i + 1,
            "counters": {
                'trace.stall_seconds{stage="shard_lease_wait"}': stall,
                "io.split.records": 100.0 * (i + 1),
            },
            "gauges": {}, "histograms": {},
        })
    win = ts.windowed(samples, 60.0)
    assert win["derived"]["stall_fraction"]["shard_lease_wait"] == (
        pytest.approx(0.6)
    )


# -- TimeSeriesRing ------------------------------------------------------------


def test_ring_incremental_samples_and_retention():
    reg = _mk_registry()
    ring = ts.TimeSeriesRing(registry=reg, interval=0.05, retention=3600)
    for _ in range(5):
        ring.sample()
    assert [s["seq"] for s in ring.samples(since=3)] == [4, 5]
    assert ring.last_seq == 5
    # retention: a tiny window evicts all but the newest tail
    tight = ts.TimeSeriesRing(registry=reg, interval=0.05, retention=0.05)
    tight.sample()
    time.sleep(0.12)
    tight.sample()
    assert len(tight.samples()) == 1  # the stale head fell out


def test_ring_sampler_thread_samples_on_interval():
    reg = _mk_registry()
    ring = ts.TimeSeriesRing(registry=reg, interval=0.05, retention=60)
    ring.start()
    try:
        time.sleep(0.4)
        assert len(ring.samples()) >= 3
    finally:
        ring.stop()


# -- ClusterTimeSeries ---------------------------------------------------------


def test_cluster_store_clock_never_goes_backwards():
    """A relaunched rank re-shipping its dead predecessor's tail (or a
    skewed clock) must be dropped, not splice the series backwards —
    the satellite's restart contract."""
    store = ts.ClusterTimeSeries(retention=3600)
    ok = store.add(0, [
        {"t": 100.0, "seq": 1, "counters": {"c": 1.0}, "gauges": {},
         "histograms": {}},
        {"t": 102.0, "seq": 2, "counters": {"c": 2.0}, "gauges": {},
         "histograms": {}},
    ])
    assert ok == 2
    # the relaunch: seq restarts, counters restart, and the FIRST
    # sample replays a stale timestamp
    ok = store.add(0, [
        {"t": 101.0, "seq": 1, "counters": {"c": 0.5}, "gauges": {},
         "histograms": {}},   # stale: dropped
        {"t": 104.0, "seq": 2, "counters": {"c": 3.0}, "gauges": {},
         "histograms": {}},   # fresh: accepted
    ])
    assert ok == 1
    assert store.dropped_stale == 1
    view = store.window(60.0)["per_rank"]["0"]
    assert view["samples"] == 3, view
    # and the reset counter still rates non-negatively
    assert view["counters"]["c"]["delta"] >= 0


def test_cluster_store_rejects_malformed_samples():
    store = ts.ClusterTimeSeries()
    assert store.add(1, "nonsense") == 0
    assert store.add(1, [{"t": "soon"}, {"no_t": 1}, 42]) == 0
    assert store.ranks() == [1]


def test_dsserve_data_plane_derivations():
    """The dashboard's data-plane signals: wire ratio = wire/raw byte
    rates (codec win when < 1), shm fraction = shm/(shm+tcp) slots."""
    samples = []
    for i, (w, r, shm, tcp) in enumerate(
        ((0.0, 0.0, 0.0, 0.0), (50.0, 100.0, 3.0, 1.0))
    ):
        samples.append({
            "t": 100.0 + i * 10.0, "seq": i + 1,
            "counters": {
                "dsserve.bytes_wire": w, "dsserve.bytes_raw": r,
                "dsserve.shm_slots": shm, "dsserve.tcp_slots": tcp,
            },
            "gauges": {}, "histograms": {},
        })
    win = ts.windowed(samples, 60.0)
    assert win["derived"]["dsserve_wire_ratio"] == pytest.approx(0.5)
    assert win["derived"]["dsserve_shm_frac"] == pytest.approx(0.75)


def test_merge_windows_averages_data_plane_fracs():
    """Wire ratio and shm fraction are per-process fractions: the
    cluster view averages them over reporting ranks (summing would read
    as nonsense, the stall-fraction rule)."""
    views = {
        str(i): {
            "samples": 2, "counters": {}, "gauges": {},
            "derived": {
                "rows_per_sec": 1.0,
                "dsserve_wire_ratio": ratio,
                "dsserve_shm_frac": frac,
            },
        }
        for i, (ratio, frac) in enumerate(((0.4, 1.0), (0.6, 0.5)))
    }
    merged = ts.merge_windows(views)
    assert merged["derived"]["dsserve_wire_ratio"] == pytest.approx(0.5)
    assert merged["derived"]["dsserve_shm_frac"] == pytest.approx(0.75)


def test_merge_windows_sums_rows_and_averages_fractions():
    views = {
        "0": {"samples": 2, "counters": {"io.split.records":
                                         {"delta": 10, "per_sec": 1.0}},
              "gauges": {},
              "derived": {"rows_per_sec": 100.0,
                          "stall_fraction": {"fetch_wait": 0.2}}},
        "1": {"samples": 2, "counters": {"io.split.records":
                                         {"delta": 30, "per_sec": 3.0}},
              "gauges": {},
              "derived": {"rows_per_sec": 300.0,
                          "stall_fraction": {"fetch_wait": 0.4}}},
    }
    merged = ts.merge_windows(views)
    assert merged["n_ranks"] == 2
    assert merged["derived"]["rows_per_sec"] == 400.0
    assert merged["derived"]["stall_fraction"]["fetch_wait"] == (
        pytest.approx(0.3)
    )
    assert merged["counters"]["io.split.records"]["per_sec"] == 4.0


# -- heartbeat transport + the /metrics.json?window= contract ------------------


def _start_tracker(n_workers=1):
    from dmlc_core_tpu_torch.tracker.tracker import RabitTracker

    tr = RabitTracker(host_ip="127.0.0.1", n_workers=n_workers)
    tr.start(n_workers)
    return tr


def test_heartbeat_ships_samples_and_window_endpoint(monkeypatch):
    """End-to-end: worker ring samples ride cmd=metrics; the tracker's
    /metrics.json?window=N answers nonzero per-rank windowed rows/s;
    the end-of-job report embeds the full series; the heartbeat RTT
    reply yields a clock-offset estimate for the trace otherData."""
    monkeypatch.setenv("DMLC_TS_INTERVAL", "0.1")
    from dmlc_core_tpu_torch.io import retry
    from dmlc_core_tpu_torch.telemetry import default_registry, tracing
    from dmlc_core_tpu_torch.tracker.client import RabitWorker

    tracing.reset()
    tr = _start_tracker(1)
    try:
        w = RabitWorker(
            tracker_uri="127.0.0.1", tracker_port=tr.port, jobid="0"
        )
        w.start(1)
        c = default_registry().counter("io.split.records")
        for _ in range(4):
            c.inc(500)
            time.sleep(0.12)
        w.heartbeat()
        url = (
            f"http://127.0.0.1:{tr.metrics_port}/metrics.json?window=30"
        )
        with retry.request(url) as resp:
            rep = json.loads(resp.read().decode())
        win = rep["windowed"]
        assert win["window_secs"] == 30.0
        rank0 = win["per_rank"]["0"]
        assert rank0["samples"] >= 2
        assert rank0["derived"]["rows_per_sec"] > 0
        assert win["cluster"]["derived"]["rows_per_sec"] > 0
        # the tracker's own registry rides the "tracker" pseudo-rank
        assert "tracker" in win["per_rank"]
        # windowed polls are LIGHT: the heavy full series stays off
        # them (a dashboard refresh must not re-download minutes of
        # snapshots) and is served by the plain report instead
        assert "timeseries" not in rep
        full_url = f"http://127.0.0.1:{tr.metrics_port}/metrics.json"
        with retry.request(full_url) as resp:
            full = json.loads(resp.read().decode())
        assert full["timeseries"]["per_rank"]["0"]
        # the RTT midpoint produced a clock-offset estimate
        assert tracing.clock_offset_ns() is not None
        # a second heartbeat ships only NEW samples (incremental seq)
        first_total = len(full["timeseries"]["per_rank"]["0"])
        time.sleep(0.15)
        w.heartbeat()
        with retry.request(full_url) as resp:
            full2 = json.loads(resp.read().decode())
        assert len(full2["timeseries"]["per_rank"]["0"]) > first_total
        w.shutdown()
        tr.join()
    finally:
        tr.close()
        tracing.reset()


def test_tools_top_once_json_against_in_process_tracker(monkeypatch, capsys):
    """The tier-1 smoke the satellite asks for: ``tools top --once
    --json`` against a live in-process tracker reports per-rank rows/s
    within 10% of the value computed from the shipped samples."""
    monkeypatch.setenv("DMLC_TS_INTERVAL", "0.1")
    from dmlc_core_tpu_torch import tools
    from dmlc_core_tpu_torch.tracker.tracker import RabitTracker

    tr = _start_tracker(1)
    try:
        # hand-crafted heartbeat payload: a precise 1000 rows/s series
        samples = [
            {"t": 1000.0 + i, "seq": i + 1,
             "counters": {"io.split.records": 1000.0 * (i + 1)},
             "gauges": {}, "histograms": {}}
            for i in range(5)
        ]
        tr.metrics.update(0, {"counters": {}, "gauges": {},
                              "histograms": {}, "timeseries": samples})
        rc = tools.main([
            "top", str(tr.metrics_port), "--once", "--json",
            "--window", "30",
        ])
        assert rc == 0
        model = json.loads(capsys.readouterr().out)
        got = model["ranks"]["0"]["rows_per_sec"]
        assert abs(got - 1000.0) / 1000.0 < 0.10, got
        assert model["cluster"]["rows_per_sec"] == pytest.approx(
            got
        )
        # the human rendering works off the same model
        rc = tools.main([
            "top", str(tr.metrics_port), "--once", "--window", "30",
        ])
        out = capsys.readouterr().out
        assert rc == 0 and "rows/s" in out and "dmlc top" in out
    finally:
        tr.close()


def test_top_model_pure():
    from dmlc_core_tpu_torch.tools import _top_model

    report = {
        "windowed": {
            "per_rank": {
                "0": {"samples": 3, "derived": {
                    "rows_per_sec": 10.0,
                    "stall_fraction": {"fetch_wait": 0.5},
                    "lookup_qps": 12.0, "lookup_p99_ms": 4.0}},
                "tracker": {"samples": 3, "derived": {},
                            "gauges": {"tracker.shards.queue_depth":
                                       {"last": 5, "min": 1, "max": 9}}},
            },
            "cluster": {"n_ranks": 1,
                        "derived": {"rows_per_sec": 10.0,
                                    "stall_fraction": {}}},
        }
    }
    model = _top_model(report, 30.0)
    assert model["ranks"]["0"]["rows_per_sec"] == 10.0
    assert model["ranks"]["0"]["lookup_qps"] == 12.0
    assert model["shard_queue_depth"]["last"] == 5
    assert model["n_ranks"] == 1


def test_sampling_enabled_knob(monkeypatch):
    assert ts.sampling_enabled()
    monkeypatch.setenv("DMLC_TS", "off")
    assert not ts.sampling_enabled()
    monkeypatch.setenv("DMLC_TS", "1")
    assert ts.sampling_enabled()


# -- the submit run -------------------------------------------------------------

_SUBMIT_WORKER = """
import os, sys, time
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
    type="recordio", threaded=False, part_index=rank, num_parts=2)
rows = 0
while True:
    g = sp.next_gather_batch(32)
    if g is None:
        break
    rows += len(g[1])
    time.sleep(0.01)  # pace the drain across a few sample intervals
    w.heartbeat()
sp.close()
if rank == 1:
    time.sleep(0.3)  # rank 0 waits on this rank in the allreduce
coll.allreduce(np.array([rows], dtype=np.int64))
w.heartbeat()  # ships the ring's samples + estimates the clock offset
coll.close()
w.shutdown()
"""


def test_submit_run_windowed_rates_and_heartbeat_flow_arrows(tmp_path):
    """A 2-worker port ``submit`` run yields (a) an end-of-job report
    whose per-rank time series window to NONZERO rows/s, with rank 0's
    allreduce_wait stall fraction nonzero, and (b) a merged trace where
    every worker ``heartbeat`` span has a flow event binding it to the
    tracker's server-side ``metrics`` handler span. (The JAX test drains
    dynamic shards over the block cache; both are not ported, so the
    lease RPC's arrow is the heartbeat's here.)"""
    import os
    import subprocess
    import sys

    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io.stream import FileStream
    from dmlc_core_tpu_torch.telemetry import tracing

    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    rec = str(tmp_path / "corpus.rec")
    idx = rec + ".idx"
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec="zlib", block_bytes=2048)
        for i in range(400):
            w.write_record(f"row-{i:06d}|".encode() * 8)
        w.flush_block()
    trace_dir = tmp_path / "traces"
    report_path = tmp_path / "metrics_report.json"
    script = tmp_path / "worker.py"
    script.write_text(_SUBMIT_WORKER.format(repo=REPO, rec=rec, idx=idx))
    out = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
         "--cluster", "local", "--num-workers", "2",
         "--host-ip", "127.0.0.1",
         "--trace-dir", str(trace_dir),
         sys.executable, str(script)],
        capture_output=True, text=True, timeout=150,
        env={**os.environ, "DMLC_TRACE": "on", "JAX_PLATFORMS": "cpu",
             "DMLC_TS_INTERVAL": "0.1",
             "DMLC_METRICS_REPORT": str(report_path)},
        cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]

    # (a) the report's per-rank series windows to nonzero rates
    report = json.loads(report_path.read_text())
    per_rank = report["timeseries"]["per_rank"]
    assert "0" in per_rank and "1" in per_rank, sorted(per_rank)
    for rank in ("0", "1"):
        win = ts.windowed(per_rank[rank], 60.0)
        assert win["samples"] >= 2, (rank, win)
        assert win["derived"]["rows_per_sec"] > 0, (rank, win)
    win0 = ts.windowed(per_rank["0"], 60.0)
    assert win0["derived"]["stall_fraction"].get("allreduce_wait", 0) > 0, win0

    # (b) merged trace: every heartbeat span carries its arrow
    files = sorted(
        str(trace_dir / f)
        for f in os.listdir(trace_dir)
        if f.startswith("dmlc-trace-")
    )
    assert len(files) == 3, files  # 2 workers + tracker
    merged = tracing.merge_traces(files)
    evs = merged["traceEvents"]
    waits = [
        e for e in evs
        if e["ph"] == "X" and e["name"] == "dmlc:heartbeat"
    ]
    assert waits, "no heartbeat spans on the merged timeline"
    handlers = [
        e for e in evs
        if e["ph"] == "X" and e["name"] == "dmlc:tracker_metrics"
    ]
    assert handlers, "tracker recorded no metrics handler spans"
    flows_s = [e for e in evs if e["ph"] == "s"]
    flows_f = {e["id"]: e for e in evs if e["ph"] == "f"}
    for w in waits:
        enclosed = [
            s for s in flows_s
            if s["pid"] == w["pid"] and s["tid"] == w["tid"]
            and w["ts"] <= s["ts"] <= w["ts"] + w["dur"]
        ]
        assert enclosed, f"heartbeat at ts={w['ts']} has no flow"
        landed = [
            flows_f[s["id"]] for s in enclosed if s["id"] in flows_f
        ]
        assert landed, "heartbeat flow never landed in the tracker"
        hit = any(
            h["pid"] == f["pid"] and h["tid"] == f["tid"]
            and h["ts"] <= f["ts"] <= h["ts"] + h["dur"]
            for f in landed
            for h in handlers
        )
        assert hit, "flow-finish outside every metrics handler span"

    # workers measured a clock offset off the heartbeat RTT reply
    offsets = [
        p.get("clock_offset_ns")
        for p in merged["otherData"]["processes"]
        if str(p.get("label", "")).startswith("worker")
    ]
    assert any(o is not None for o in offsets), offsets


# -- both packages on the same samples -----------------------------------------


def _seeded_samples(seed, n=12):
    """A rank's series from a real registry: rows, stall mirrors, codec
    cache hits, a lookup histogram, a queue gauge, and one counter reset
    (a relaunched worker) partway through."""
    rng = np.random.default_rng(seed)
    reg = _mk_registry()
    rows = reg.counter("staging.rows_out")
    stall = reg.counter("trace.stall_seconds", labels={"stage": "transfer_wait"})
    hits = reg.counter("io.codec.cache_hits")
    misses = reg.counter("io.codec.cache_misses")
    lk = reg.counter("io.lookup.requests")
    lh = reg.histogram("io.lookup.request_seconds")
    gq = reg.gauge("tracker.shards.queue_depth")
    out = []
    t = 1000.0 + seed
    for i in range(n):
        rows.inc(int(rng.integers(100, 5000)))
        stall.inc(float(rng.uniform(0, 0.5)))
        hits.inc(int(rng.integers(0, 9)))
        misses.inc(int(rng.integers(0, 3)))
        lk.inc(int(rng.integers(0, 40)))
        for v in rng.exponential(2e-3, 5):
            lh.observe(float(v))
        gq.set(float(rng.integers(0, 20)))
        t += float(rng.uniform(0.5, 1.5))
        snap = reg.snapshot()
        sample = {"t": t, "seq": i + 1, **{k: snap[k] for k in ("counters", "gauges", "histograms")}}
        if i == n // 2:  # the relaunched worker's counters restart
            sample["counters"] = {k: 1.0 for k in sample["counters"]}
        out.append(json.loads(json.dumps(sample)))
    return out


@pytest.mark.parametrize("window", [2.5, 6.0, 60.0])
def test_windowed_and_merge_windows_equal_jax(window):
    per_rank = {str(r): _seeded_samples(r) for r in range(3)}
    views = {r: ts.windowed(s, window) for r, s in per_rank.items()}
    jviews = {r: jax_ts.windowed(s, window) for r, s in per_rank.items()}
    assert views == jviews
    assert ts.merge_windows(views) == jax_ts.merge_windows(jviews)
    assert ts.summary_line(views["0"]) == jax_ts.summary_line(jviews["0"])


def test_cluster_stores_equal_jax():
    store, jstore = ts.ClusterTimeSeries(), jax_ts.ClusterTimeSeries()
    for rank in range(2):
        samples = _seeded_samples(10 + rank)
        assert store.add(rank, samples) == jstore.add(rank, samples)
    for window in (3.0, 30.0):
        assert store.window(window) == jstore.window(window)
    assert store.report() == jstore.report()
