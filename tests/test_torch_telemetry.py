"""The port's telemetry (copies of tests/test_telemetry.py run against
dmlc_core_tpu_torch.telemetry): registry semantics (thread-sharded
merge, histogram bucket edges, label cardinality cap), exporters
(Prometheus exposition, JSON, Reporter), tracker-wide aggregation over
real heartbeats, and the registry-backed io_stats() views. Then both
packages on the same inputs: exporter bytes, snapshots and heartbeats
exchanged both ways, and the registry deltas of one drain of the same
files through both staging pipelines."""

import json
import re
import threading
import time

import numpy as np
import pytest

import dmlc_core_tpu.telemetry as jax_telemetry
import dmlc_core_tpu_torch.telemetry as port_telemetry
from dmlc_core_tpu_torch.telemetry import (
    ClusterAggregator,
    MetricRegistry,
    Reporter,
    default_registry,
    log_bounds,
    merge_snapshots,
    render_key,
    split_key,
    to_json,
    to_prometheus,
)

JOIN_S = 60  # every tracker join in this file is bounded


# -- registry semantics -------------------------------------------------------

def test_counter_merge_under_concurrent_writers():
    reg = MetricRegistry()
    c = reg.counter("t.hits")
    barrier = threading.Barrier(8)

    def writer():
        barrier.wait()
        for _ in range(10_000):
            c.inc()

    threads = [threading.Thread(target=writer) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value() == 80_000
    # contributions of finished threads survive: counters are cumulative
    assert reg.snapshot()["counters"]["t.hits"] == 80_000
    # ...but their cells are folded into the retired total, so memory
    # does not grow with thread churn
    assert len(c._cells) <= 1  # only this (reading) thread, if any
    assert c.value() == 80_000  # folding is idempotent


def test_counter_float_and_monotonic():
    reg = MetricRegistry()
    c = reg.counter("t.secs")
    c.inc(0.25)
    c.inc(0.5)
    assert c.value() == 0.75
    with pytest.raises(ValueError):
        c.inc(-1)


def test_get_or_create_returns_same_series():
    reg = MetricRegistry()
    a = reg.counter("t.x", labels={"k": "1"})
    b = reg.counter("t.x", labels={"k": "1"})
    other = reg.counter("t.x", labels={"k": "2"})
    assert a is b and a is not other
    with pytest.raises(ValueError):
        reg.gauge("t.x")  # same name, different type
    with pytest.raises(ValueError):
        reg.counter("bad name!")


def test_gauge_set_and_callable():
    reg = MetricRegistry()
    g = reg.gauge("t.depth")
    g.set(3)
    g.inc()
    assert g.value() == 4
    g.set_fn(lambda: 7)
    assert g.value() == 7
    assert reg.snapshot()["gauges"]["t.depth"] == 7


def test_histogram_bucket_edges_le_semantics():
    reg = MetricRegistry()
    h = reg.histogram("t.lat", bounds=[1.0, 2.0, 4.0])
    for v in (0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 5.0, 100.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap["le"] == [1.0, 2.0, 4.0]
    # v <= bound lands in the bucket (Prometheus le); 5.0/100.0 overflow
    assert snap["n"] == [2, 2, 2, 2]
    assert snap["count"] == 8
    assert snap["sum"] == pytest.approx(117.0)
    assert snap["min"] == 0.5 and snap["max"] == 100.0
    assert set(snap) >= {"p50", "p90", "p99"}


def test_histogram_default_log_buckets_and_percentiles():
    reg = MetricRegistry()
    h = reg.histogram("t.dur")
    for _ in range(100):
        h.observe(1e-3)
    snap = h.snapshot()
    assert snap["count"] == 100
    # all mass in one log2 bucket → p50 interpolates inside it
    assert 5e-4 <= snap["p50"] <= 2e-3
    bounds = log_bounds(1e-6, 100.0)
    assert snap["le"] == list(bounds)
    assert all(b == pytest.approx(a * 2) for a, b in zip(bounds, bounds[1:]))


def test_histogram_concurrent_observers_exact_count():
    reg = MetricRegistry()
    h = reg.histogram("t.conc", bounds=[0.5, 1.5])

    def obs():
        for _ in range(5000):
            h.observe(1.0)

    threads = [threading.Thread(target=obs) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    snap = h.snapshot()
    assert snap["count"] == 20_000 and snap["n"] == [0, 20_000, 0]
    # dead observers' shards folded; totals unchanged on re-read
    assert len(h._cells) == 0
    assert h.snapshot()["count"] == 20_000


def test_label_cardinality_cap(monkeypatch):
    monkeypatch.setenv("DMLC_METRIC_LABEL_CAP", "4")
    reg = MetricRegistry()
    for i in range(10):
        reg.counter("t.byuser", labels={"user": str(i)}).inc()
    snap = reg.snapshot()["counters"]
    series = [k for k in snap if k.startswith("t.byuser")]
    # 4 real series + the one overflow series everything else collapsed to
    assert len(series) == 5
    assert snap['t.byuser{overflow="true"}'] == 6
    assert snap["telemetry.label_overflow"] == 6


def test_scoped_view_delta():
    reg = MetricRegistry()
    a = reg.counter("io.a")
    b = reg.counter("net.b")
    a.inc(5)
    view = reg.scoped("io.")
    a.inc(2)
    b.inc(9)
    d = view.delta()
    assert d == {"io.a": 2}
    # a series born after the base snapshot counts from zero
    reg.counter("io.new").inc(3)
    assert view.delta()["io.new"] == 3
    # rebase(): deltas restart from zero, counters stay monotonic
    view.rebase()
    assert view.delta() == {"io.a": 0.0, "io.new": 0.0}
    a.inc()
    assert view.delta()["io.a"] == 1
    # exact-series views read only what they name
    named = reg.scoped(names=["net.b"])
    b.inc(4)
    assert named.delta() == {"net.b": 4}


def test_render_split_key_roundtrip():
    key = render_key("a.b", {"z": 'he said "hi"', "a": "x\\y"})
    name, labels = split_key(key)
    assert name == "a.b"
    assert labels == {"z": 'he said "hi"', "a": "x\\y"}
    assert split_key("plain") == ("plain", {})


# -- exporters ----------------------------------------------------------------

def _sample_registry():
    reg = MetricRegistry()
    reg.counter("io.retry.retries", help="retries healed").inc(3)
    reg.gauge("staging.ring_depth").set(3)
    h = reg.histogram(
        "staging.stage_seconds", labels={"stage": "host_pull"},
        bounds=[0.001, 0.01, 0.1],
    )
    for v in (0.0005, 0.005, 0.05, 0.5):
        h.observe(v)
    return reg


_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z0-9_]+=\"[^\"]*\""
    r"(,[a-zA-Z0-9_]+=\"[^\"]*\")*\})? [^ ]+$"
)


def test_prometheus_exposition_parses():
    text = to_prometheus(_sample_registry())
    saw_types = {}
    samples = {}
    for line in text.strip().splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            saw_types[name] = kind
            continue
        if line.startswith("#"):
            continue
        assert _PROM_LINE.match(line), line
        series, value = line.rsplit(" ", 1)
        samples[series] = float(value)
    assert saw_types["dmlc_io_retry_retries"] == "counter"
    assert saw_types["dmlc_staging_ring_depth"] == "gauge"
    assert saw_types["dmlc_staging_stage_seconds"] == "histogram"
    assert samples["dmlc_io_retry_retries"] == 3
    # histogram buckets are CUMULATIVE and end with le="+Inf" == _count
    buckets = [
        (s, v) for s, v in samples.items()
        if s.startswith("dmlc_staging_stage_seconds_bucket")
    ]
    counts = [v for _s, v in buckets]
    assert counts == sorted(counts) and counts == [1, 2, 3, 4]
    inf = [s for s, _ in buckets if 'le="+Inf"' in s]
    assert len(inf) == 1
    assert samples['dmlc_staging_stage_seconds_count{stage="host_pull"}'] == 4


def test_prometheus_renders_non_finite_values():
    """A broken gauge probe yields NaN by contract; the render must
    spell it NaN (exposition spec), not crash the scrape."""
    reg = MetricRegistry()
    g = reg.gauge("t.broken")
    g.set_fn(lambda: 1 / 0)  # probe raises -> value() is NaN
    reg.gauge("t.inf").set(float("inf"))
    text = to_prometheus(reg)
    assert "dmlc_t_broken NaN" in text
    assert "dmlc_t_inf +Inf" in text
    # ...and the heartbeat sanitizer drops them (json.dumps(nan) is not
    # valid JSON for strict report consumers)
    agg = ClusterAggregator()
    agg.update(0, {"gauges": {"g": float("nan"), "ok": 2.0}})
    assert agg.report()["cluster"]["gauges"] == {"ok": 2.0}


def test_json_snapshot_and_merge():
    snap = to_json(_sample_registry())
    json.dumps(snap)  # JSON-able as-is
    merged = merge_snapshots([snap, snap])
    assert merged["counters"]["io.retry.retries"] == 6
    key = 'staging.stage_seconds{stage="host_pull"}'
    assert merged["histograms"][key]["count"] == 8
    assert merged["histograms"][key]["n"] == [2, 2, 2, 2]
    assert merged["histograms"][key]["max"] == 0.5
    assert "p50" in merged["histograms"][key]
    # a rank with mismatched edges is skipped, not corrupting the merge
    bad = json.loads(json.dumps(snap))
    bad["histograms"][key]["le"] = [1, 2, 3]
    merged2 = merge_snapshots([snap, bad])
    assert merged2["histograms"][key]["count"] == 4


def test_reporter_interval_flush_and_close_dump(tmp_path):
    reg = MetricRegistry()
    reg.counter("t.n").inc(1)
    out = tmp_path / "telemetry.jsonl"
    rep = Reporter(reg, interval=0.05, path=str(out))
    deadline = time.perf_counter() + 5.0
    while rep.flushes == 0 and time.perf_counter() < deadline:
        time.sleep(0.01)
    assert rep.flushes >= 1, "interval flush never fired"
    reg.counter("t.n").inc(41)
    rep.close()
    rep.close()  # idempotent
    lines = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(lines) == rep.flushes >= 2
    # the close-time dump sees the final counter value
    assert lines[-1]["snapshot"]["counters"]["t.n"] == 42
    assert lines[-1]["uptime_secs"] >= 0


def test_default_registry_is_process_global():
    assert default_registry() is default_registry()
    c = default_registry().counter("test.telemetry.global")
    before = c.value()
    c.inc()
    assert default_registry().counter("test.telemetry.global").value() == (
        before + 1
    )


# -- tracker aggregation over real heartbeats ---------------------------------

def _http_get(port, path):
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=10) as s:
        s.sendall(
            f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
            "Connection: close\r\n\r\n".encode()
        )
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    head, _, body = buf.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    return status, body.decode()


def test_cluster_aggregator_merges_per_rank():
    agg = ClusterAggregator()
    agg.update(0, json.dumps({"counters": {"app.rows": 10}}))
    agg.update(1, {"counters": {"app.rows": 32}, "gauges": {"q": 1}})
    agg.update(1, {"counters": {"app.rows": 40}})  # latest-per-rank wins
    agg.update(0, "not json")  # dropped, not fatal
    report = agg.report()
    assert report["n_ranks"] == 2
    assert report["cluster"]["counters"]["app.rows"] == 50
    assert report["per_rank"]["0"]["counters"]["app.rows"] == 10
    text = agg.prometheus()
    assert "dmlc_app_rows 50" in text
    assert 'dmlc_app_rows{rank="0"} 10' in text
    assert 'dmlc_app_rows{rank="1"} 40' in text
    # ONE valid exposition: exactly one # TYPE line per metric family
    # (a scraper rejects duplicate TYPE lines / interleaved families)
    type_names = [
        ln.split()[2] for ln in text.splitlines() if ln.startswith("# TYPE")
    ]
    assert len(type_names) == len(set(type_names)), type_names


def test_cluster_aggregator_sanitizes_malformed_series():
    """A buggy/hostile worker's type-skewed payload costs its bad
    series only — later merges, scrapes and the end-of-job report keep
    working (the 'aggregator validates/drops' contract)."""
    agg = ClusterAggregator()
    agg.update(0, {"counters": {"good": 1, "bad": "abc", "b2": None}})
    agg.update(1, {"histograms": {"h": {}, "ok": {
        "le": [1.0], "n": [1, 0], "count": 1, "sum": 0.5}}})
    agg.update(2, {"counters": "nope", "gauges": {"g": True}})
    # empty-bounds histograms pass the arithmetic shape check but would
    # crash percentile math — dropped by the sanitizer
    agg.update(3, {"histograms": {"empty": {
        "le": [], "n": [5], "count": 5, "sum": 1.0, "max": 2.0}}})
    report = agg.report()  # must not raise
    assert report["cluster"]["counters"] == {"good": 1}
    assert list(report["cluster"]["histograms"]) == ["ok"]
    assert report["cluster"]["gauges"] == {}  # bools are not numbers
    agg.prometheus()  # renders without raising


def test_percentiles_degrade_on_foreign_empty_bounds():
    """percentiles() over a foreign snapshot with le=[] degrades to the
    known max instead of crashing the scrape (registries themselves
    reject empty bounds at registration)."""
    from dmlc_core_tpu_torch.telemetry.registry import percentiles

    out = percentiles({"le": [], "n": [5], "count": 5, "sum": 1.0, "max": 2.0})
    assert out == {"p50": 2.0, "p90": 2.0, "p99": 2.0}
    with pytest.raises(ValueError):
        MetricRegistry().histogram("t.empty", bounds=[])


def test_prometheus_families_stay_contiguous():
    """'name' vs 'name_out': '_' sorts before '{', so a raw-key sort
    would split the shorter family around the longer one — every
    family's samples must form one contiguous group."""
    agg = ClusterAggregator()
    agg.update(0, {"counters": {"staging.rows": 1, "staging.rows_out": 2}})
    agg.update(1, {"counters": {"staging.rows": 3, "staging.rows_out": 4}})
    text = agg.prometheus()
    fams = [
        ln.split("{")[0].split(" ")[0]
        for ln in text.splitlines()
        if ln.strip() and not ln.startswith("#")
    ]
    seen = []
    for f in fams:
        if seen and seen[-1] == f:
            continue
        assert f not in seen, (f, fams)  # family re-opened = split
        seen.append(f)


def test_tracker_rejects_out_of_range_metrics_rank():
    """A fabricated rank must not mint unbounded per-rank snapshots:
    cmd=metrics is bounded like shutdown (0 <= rank < n_workers)."""
    import socket as socket_mod

    from dmlc_core_tpu_torch.tracker.client import RabitWorker
    from dmlc_core_tpu_torch.tracker.protocol import MAGIC, FramedSocket
    from dmlc_core_tpu_torch.tracker.tracker import RabitTracker

    tracker = RabitTracker("127.0.0.1", 1)
    tracker.start(1)
    w = RabitWorker("127.0.0.1", tracker.port, jobid="0")
    w.start(world_size=1)

    def send_metrics(rank, payload):
        fs = FramedSocket(
            socket_mod.create_connection(("127.0.0.1", tracker.port), 10)
        )
        fs.send_int(MAGIC)
        assert fs.recv_int() == MAGIC
        fs.send_int(rank)
        fs.send_int(-1)
        fs.send_str("x")
        fs.send_str("metrics")
        fs.send_str(json.dumps(payload))
        fs.close()

    send_metrics(2**31 - 1, {"counters": {"bogus": 1}})
    send_metrics(-7, {"counters": {"bogus": 1}})
    w.heartbeat({"counters": {"real": 1}})
    deadline = time.perf_counter() + 10
    while tracker.metrics.updates < 1 and time.perf_counter() < deadline:
        time.sleep(0.02)
    time.sleep(0.2)  # give the bogus frames time to be (dropped)
    assert set(tracker.metrics.per_rank()) == {0}
    w.shutdown()
    assert tracker.join(timeout=JOIN_S), "the tracker never saw every shutdown"
    tracker.close()


def test_heartbeat_before_start_raises():
    """heartbeat() without a rank would be silently discarded by the
    tracker; the client fails loudly instead."""
    from dmlc_core_tpu_torch.tracker.client import RabitWorker

    w = RabitWorker("127.0.0.1", 1, jobid="x")
    with pytest.raises(RuntimeError, match="before start"):
        w.heartbeat({"counters": {}})


def test_tracker_metrics_endpoint_multi_worker():
    """Two real RabitWorkers heartbeat snapshots; the tracker's local
    /metrics endpoint serves per-rank series + cluster totals, and the
    end-of-job report aggregates them."""
    from dmlc_core_tpu_torch.tracker.client import RabitWorker
    from dmlc_core_tpu_torch.tracker.tracker import RabitTracker

    n = 2
    tracker = RabitTracker("127.0.0.1", n)
    tracker.start(n)
    assert tracker.metrics_port is not None

    ranks = {}
    errors = []

    def one(i):
        try:
            w = RabitWorker("127.0.0.1", tracker.port, jobid=str(i))
            rank = w.start(world_size=n if i == 0 else -1)
            ranks[i] = rank
            w.heartbeat(
                {
                    "counters": {"worker.rows": 100 * (rank + 1)},
                    "histograms": {
                        "worker.lat": {
                            "le": [1.0, 2.0],
                            "n": [rank + 1, 0, 0],
                            "count": rank + 1,
                            "sum": float(rank + 1),
                        }
                    },
                }
            )
            # wait until the tracker's state thread applied both updates
            # (heartbeats ride the same event queue as everything else)
            deadline = time.perf_counter() + 10
            while (
                tracker.metrics.updates < n
                and time.perf_counter() < deadline
            ):
                time.sleep(0.02)
            w.shutdown()
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    # scrape while the job is live (that is the point of the endpoint)
    deadline = time.perf_counter() + 10
    while tracker.metrics.updates < n and time.perf_counter() < deadline:
        time.sleep(0.02)
    assert tracker.metrics.updates >= n

    status, body = _http_get(tracker.metrics_port, "/metrics")
    assert status == 200
    assert "dmlc_worker_rows 300" in body  # cluster total: 100 + 200
    assert 'dmlc_worker_rows{rank="0"} 100' in body
    assert 'dmlc_worker_rows{rank="1"} 200' in body
    # merged histogram: bucket counts added across ranks
    assert 'dmlc_worker_lat_bucket{le="1",rank="0"} 1' in body
    assert 'dmlc_worker_lat_count 3' in body
    # scrape body is one valid exposition (no duplicate TYPE lines)
    type_names = [
        ln.split()[2] for ln in body.splitlines() if ln.startswith("# TYPE")
    ]
    assert len(type_names) == len(set(type_names)), type_names

    status, body = _http_get(tracker.metrics_port, "/metrics.json")
    assert status == 200
    report = json.loads(body)
    assert report["n_ranks"] == n
    assert report["cluster"]["counters"]["worker.rows"] == 300
    assert report["cluster"]["histograms"]["worker.lat"]["count"] == 3

    status, _ = _http_get(tracker.metrics_port, "/nope")
    assert status == 404

    for t in threads:
        t.join(timeout=30)
    assert not errors, errors
    assert tracker.join(timeout=JOIN_S), "the tracker never saw every shutdown"
    # end-of-job report is kept on the tracker after completion
    assert tracker.metrics_report is not None
    assert tracker.metrics_report["cluster"]["counters"]["worker.rows"] == 300
    tracker.close()


def test_tracker_end_of_job_report_file(tmp_path, monkeypatch):
    from dmlc_core_tpu_torch.tracker.client import RabitWorker
    from dmlc_core_tpu_torch.tracker.tracker import RabitTracker

    path = tmp_path / "job_metrics.json"
    monkeypatch.setenv("DMLC_METRICS_REPORT", str(path))
    tracker = RabitTracker("127.0.0.1", 1)
    tracker.start(1)
    w = RabitWorker("127.0.0.1", tracker.port, jobid="0")
    w.start(world_size=1)
    w.heartbeat({"counters": {"job.done": 1}})
    deadline = time.perf_counter() + 10
    while tracker.metrics.updates < 1 and time.perf_counter() < deadline:
        time.sleep(0.02)
    w.shutdown()
    assert tracker.join(timeout=JOIN_S), "the tracker never saw every shutdown"
    tracker.close()
    report = json.loads(path.read_text())
    assert report["cluster"]["counters"]["job.done"] == 1
    assert report["n_ranks"] == 1


def test_heartbeat_defaults_to_process_registry():
    """heartbeat() with no args ships the default registry snapshot."""
    from dmlc_core_tpu_torch.tracker.client import RabitWorker
    from dmlc_core_tpu_torch.tracker.tracker import RabitTracker

    marker = default_registry().counter("test.heartbeat.marker")
    marker.inc(7)
    tracker = RabitTracker("127.0.0.1", 1)
    tracker.start(1)
    w = RabitWorker("127.0.0.1", tracker.port, jobid="0")
    w.start(world_size=1)
    w.heartbeat()
    deadline = time.perf_counter() + 10
    while tracker.metrics.updates < 1 and time.perf_counter() < deadline:
        time.sleep(0.02)
    snap = tracker.metrics.per_rank()[0]
    assert snap["counters"]["test.heartbeat.marker"] >= 7
    w.shutdown()
    assert tracker.join(timeout=JOIN_S), "the tracker never saw every shutdown"
    tracker.close()


# -- migrated io_stats(): bit-compatible view over the registry ---------------

def test_retry_stats_view_matches_registry_counters():
    from dmlc_core_tpu_torch.io import retry

    retry.reset_stats()
    assert retry.stats() == {
        "retries": 0,
        "backoff_secs": 0.0,
        "faults_injected": 0,
    }
    before_reg = default_registry().snapshot()["counters"]
    policy = retry.RetryPolicy(
        max_attempts=5, base_secs=0.01, cap_secs=0.01, sleep=lambda s: None
    )
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise ConnectionResetError("boom")
        return "ok"

    assert policy.run(flaky) == "ok"
    retry.count_fault_injected(2)
    s = retry.stats()
    # the io_stats() golden shape: int counts, rounded float backoff
    assert s["retries"] == 3 and isinstance(s["retries"], int)
    assert s["faults_injected"] == 2 and isinstance(s["faults_injected"], int)
    assert isinstance(s["backoff_secs"], float) and s["backoff_secs"] > 0
    # the registry carries the same increments (monotonic, never reset)
    after_reg = default_registry().snapshot()["counters"]
    assert after_reg["io.retry.retries"] - before_reg.get(
        "io.retry.retries", 0
    ) == 3
    assert after_reg["io.faults.injected"] - before_reg.get(
        "io.faults.injected", 0
    ) == 2
    # delta view composes exactly as before the migration
    snap = retry.stats()
    retry.count_fault_injected(1)
    assert retry.stats_delta(snap) == {
        "retries": 0,
        "backoff_secs": 0.0,
        "faults_injected": 1,
    }
    retry.reset_stats()
    assert retry.stats()["faults_injected"] == 0


def test_split_io_stats_golden_keys(tmp_path):
    """InputSplitBase.io_stats() on a clean local read: mode, the three
    retry-delta keys and ``reopens``, zero, as in the JAX package (the
    retry layer is ported since slice 12)."""
    from dmlc_core_tpu_torch.io import split as io_split

    p = tmp_path / "x.txt"
    p.write_text("a\nb\nc\n")
    s = io_split.create(str(p), type="text", threaded=False)
    while s.next_record() is not None:
        pass
    stats = s.io_stats()
    s.close()
    assert stats == {"mode": "sequential", "reopens": 0, "retries": 0,
                     "backoff_secs": 0.0, "faults_injected": 0}


def test_wrapper_splits_io_stats_always_dict(tmp_path):
    """Threaded/cached/shuffle wrappers return a (possibly empty) dict
    even over a base without io_stats (the port has no abstract
    InputSplit: the base is duck-typed)."""
    from dmlc_core_tpu_torch.io import split as io_split

    class Bare:
        """Minimal base with no io_stats attribute."""

        def __init__(self):
            self.chunks = [b"a\n", b"b\n"]
            self.i = 0

        def next_chunk(self):
            if self.i >= len(self.chunks):
                return None
            c = self.chunks[self.i]
            self.i += 1
            return c

        def next_record(self):
            return self.next_chunk()

        def before_first(self):
            self.i = 0

        def reset_partition(self, part_index, num_parts):
            self.i = 0

        def extract_records(self, chunk):
            return iter([chunk])

        def close(self):
            pass

    t = io_split.ThreadedInputSplit(Bare())
    assert t.io_stats() == {}
    t.close()
    c = io_split.CachedInputSplit(Bare(), str(tmp_path / "cache.bin"))
    assert c.io_stats() == {}
    c.close()
    sh = io_split.InputSplitShuffle(Bare(), 0, 1, 2)
    assert sh.io_stats() == {}
    sh.close()
    # the real splits keep their full stats through the wrappers
    p = tmp_path / "y.txt"
    p.write_text("a\nb\n")
    t2 = io_split.create(str(p), type="text", threaded=True)
    stats = t2.io_stats()
    assert isinstance(stats, dict) and stats["mode"] == "sequential"
    t2.close()


def test_split_registry_mirrors_tick(tmp_path):
    """The indexed split's per-instance I/O-shape counters also feed the
    process-global io.split.* registry series."""
    import numpy as np

    from dmlc_core_tpu_torch.io import split as io_split
    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io.stream import FileStream

    rec = tmp_path / "d.rec"
    idx = tmp_path / "d.rec.idx"
    with FileStream(str(rec), "w") as f, FileStream(str(idx), "w") as fi:
        w = IndexedRecordIOWriter(f, fi)
        for i in range(32):
            w.write_record(np.int32(i).tobytes() * 3, key=i)
    before = default_registry().snapshot()["counters"]
    s = io_split.create(
        f"{rec}?index={idx}", type="recordio", shuffle="record",
        threaded=False, seed=3,
    )
    while s.next_batch_ex(8) is not None:
        pass
    stats = s.io_stats()
    s.close()
    after = default_registry().snapshot()["counters"]
    assert stats["records"] == 32
    assert after["io.split.records"] - before.get("io.split.records", 0) == 32
    assert (
        after["io.split.spans"] - before.get("io.split.spans", 0)
        == stats["spans"]
    )
    assert (
        after["io.split.bytes_read"] - before.get("io.split.bytes_read", 0)
        == stats["bytes_read"]
    )


def test_staging_stage_histograms_fed(tmp_path):
    """A staged epoch leaves duration samples in the
    staging.stage_seconds{stage=...} histograms and ticks the staging
    counters; the stage sums are distributions too."""
    import numpy as np

    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import dense_batches
    from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

    p = tmp_path / "d.libsvm"
    lines = []
    rng = np.random.default_rng(0)
    for i in range(64):
        feats = " ".join(f"{j}:{rng.normal():.4f}" for j in range(4))
        lines.append(f"{i % 2} {feats}")
    p.write_text("\n".join(lines) + "\n")
    before = default_registry().snapshot()
    spec = BatchSpec(batch_size=16, layout="dense", num_features=5)
    stream = dense_batches(str(p), spec)
    pipe = StagingPipeline(stream, device="cpu")
    n = sum(1 for _ in pipe)
    drain_close(pipe, stream)
    assert n == 4
    after = default_registry().snapshot()
    key = 'staging.stage_seconds{stage="host_pull"}'
    grew = (
        after["histograms"][key]["count"]
        - before["histograms"].get(key, {}).get("count", 0)
    )
    assert grew >= n
    assert (
        after["counters"]["staging.rows"]
        - before["counters"].get("staging.rows", 0)
    ) == 64
    # the pipeline's own counters agree with the registry's
    assert pipe.staging_stats()["packed_batches"] == n


# -- endpoints and heartbeats under load -----------------------------------------


def test_serve_metrics_http_concurrent_scrapes_and_idempotent_close():
    """serve_metrics_http under 8 concurrent scrapers answers every
    request with a parseable body, and BOTH halves of teardown are
    idempotent — shutdown() + a double server_close() must be safe
    (teardown paths race: atexit vs explicit close vs SIGTERM)."""
    import urllib.request

    from dmlc_core_tpu_torch.telemetry import serve_metrics_http

    reg = MetricRegistry()
    reg.counter("io.split.records").inc(42)
    server = serve_metrics_http(
        0, registry=reg, json_provider=lambda: {"ok": True}
    )
    port = server.server_address[1]
    results, errors = [], []

    def scrape(path):
        try:
            for _ in range(5):
                with urllib.request.urlopen(  # noqa: L006 (loopback test scrape, not remote IO)
                    f"http://127.0.0.1:{port}{path}", timeout=5
                ) as resp:
                    results.append(resp.read())
        except Exception as e:  # collected, asserted below
            errors.append(e)

    threads = [
        threading.Thread(target=scrape, args=(p,))
        for p in ("/metrics", "/metrics.json", "/metrics", "/stats")
        for _ in range(2)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(results) == 40
    assert any(b"dmlc_io_split_records 42" in r for r in results)
    server.shutdown()
    server.server_close()
    server.server_close()  # second close: no-op, no EBADF/double-free
    server.shutdown()      # and shutdown after close stays safe


def test_cluster_aggregator_skips_mismatched_histogram_edges():
    """The satellite's aggregator coverage: two ranks whose histogram
    EDGES disagree (version skew) — the merge keeps the first and
    skips the rest; every other series still merges."""
    agg = ClusterAggregator()
    agg.update(0, {
        "counters": {"c": 1}, "gauges": {},
        "histograms": {"h": {"le": [1.0, 2.0], "n": [1, 2, 0],
                             "count": 3, "sum": 3.0}},
    })
    agg.update(1, {
        "counters": {"c": 2}, "gauges": {},
        "histograms": {"h": {"le": [1.0, 4.0], "n": [5, 5, 0],
                             "count": 10, "sum": 9.0}},
    })
    cluster = agg.cluster()
    assert cluster["counters"]["c"] == 3  # counters still merged
    # the mismatched histogram kept the FIRST rank's buckets only
    assert cluster["histograms"]["h"]["count"] == 3
    assert cluster["histograms"]["h"]["le"] == [1.0, 2.0]
    # and the scrape keeps working end to end
    assert "dmlc_h_bucket" in agg.prometheus()


def test_cluster_aggregator_accepts_restart_timeseries():
    """Heartbeat time-series samples from a rank that restarts mid-job:
    the stale replayed tail is dropped (sample clock never goes
    backwards), the fresh post-relaunch samples extend the SAME rank's
    series, and windowed rates stay non-negative across the counter
    reset."""
    agg = ClusterAggregator()
    snap = {"counters": {}, "gauges": {}, "histograms": {}}
    agg.update(3, {**snap, "timeseries": [
        {"t": 50.0, "seq": 1, "counters": {"io.split.records": 900.0},
         "gauges": {}, "histograms": {}},
        {"t": 52.0, "seq": 2, "counters": {"io.split.records": 1800.0},
         "gauges": {}, "histograms": {}},
    ]})
    # relaunch: seq and counters restart; first sample replays t=51
    agg.update(3, {**snap, "timeseries": [
        {"t": 51.0, "seq": 1, "counters": {"io.split.records": 100.0},
         "gauges": {}, "histograms": {}},
        {"t": 55.0, "seq": 2, "counters": {"io.split.records": 400.0},
         "gauges": {}, "histograms": {}},
    ]})
    assert agg.timeseries.dropped_stale == 1
    view = agg.windowed(60.0)["per_rank"]["3"]
    assert view["samples"] == 3
    assert view["counters"]["io.split.records"]["delta"] >= 0
    ts_times = [
        s["t"]
        for s in agg.report()["timeseries"]["per_rank"]["3"]
    ]
    assert ts_times == sorted(ts_times)  # monotone after the relaunch


def test_gauge_set_max_and_registry_peak_reset():
    """The peak-gauge story (satellite): set_max keeps the high-water
    mark, reset_peak_gauges rewinds ONLY set_max-style gauges at a
    measurement-scope boundary — live inc/dec gauges are untouched."""
    reg = MetricRegistry()
    peak = reg.gauge("io.fetch.concurrency_peak")
    live = reg.gauge("dsserve.queue_depth")
    live.inc(4)
    peak.set_max(8)
    peak.set_max(3)       # lower reading never clobbers the peak
    assert peak.value() == 8
    assert reg.peak_gauge_values() == {"io.fetch.concurrency_peak": 8.0}
    assert reg.reset_peak_gauges() == 1
    assert peak.value() == 0.0
    assert live.value() == 4.0  # live accounting survived the rewind
    peak.set_max(5)       # the next scope records ITS peak
    assert peak.value() == 5.0


# -- both packages on the same inputs -------------------------------------------


def _registry_ops(pkg, seed):
    """The same seeded operations on a fresh registry of ``pkg``'s
    telemetry: labelled counters and gauges, histograms (default and
    custom bounds, values across and outside the buckets), a family
    past its label cap."""
    rng = np.random.default_rng(seed)
    reg = pkg.MetricRegistry()
    for i in range(8):
        reg.counter("io.split.records", labels={"part": str(i % 3)}).inc(
            int(rng.integers(0, 1000)))
    reg.counter("staging.rows").inc(float(rng.uniform(0, 1e6)))
    reg.gauge("tracker.shards.queue_depth").set(float(rng.uniform(0, 50)))
    h = reg.histogram("staging.stage_seconds", labels={"stage": "host_pull"})
    for v in rng.exponential(1e-3, 200):
        h.observe(float(v))
    h.observe(0.0)
    h.observe(1e6)
    hb = reg.histogram("io.codec.decode_seconds", bounds=pkg.log_bounds(1e-6, 4.0, 10.0))
    for v in rng.uniform(0, 2, 50):
        hb.observe(float(v))
    for i in range(7):  # past the cap of 4: collapses into overflow
        reg.counter("dsserve.slots_served", labels={"worker": f"w{i}"}).inc(i + 1)
    return reg


@pytest.fixture
def label_cap_4(monkeypatch):
    monkeypatch.setenv("DMLC_METRIC_LABEL_CAP", "4")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exporters_are_byte_equal_to_jax(seed, label_cap_4):
    reg = _registry_ops(port_telemetry, seed)
    jreg = _registry_ops(jax_telemetry, seed)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert to_prometheus(snap) == jax_telemetry.to_prometheus(jsnap)
    assert to_json(snap) == jax_telemetry.to_json(jsnap)
    # the histogram bucket edges are the JAX package's, so snapshots merge
    from dmlc_core_tpu.telemetry import registry as jax_registry
    from dmlc_core_tpu_torch.telemetry import registry as port_registry

    assert port_registry.DEFAULT_DURATION_BOUNDS == jax_registry.DEFAULT_DURATION_BOUNDS
    assert log_bounds(1e-6, 4.0, 10.0) == jax_telemetry.log_bounds(1e-6, 4.0, 10.0)


@pytest.mark.parametrize("direction", ["jax_into_port", "port_into_jax"])
def test_aggregators_accept_the_other_packages_heartbeats(direction, label_cap_4):
    snaps = [_registry_ops(port_telemetry, s).snapshot() for s in (3, 4)]
    jsnaps = [_registry_ops(jax_telemetry, s).snapshot() for s in (3, 4)]
    sender, agg_cls, merge = (
        (jsnaps, ClusterAggregator, merge_snapshots)
        if direction == "jax_into_port"
        else (snaps, jax_telemetry.ClusterAggregator, jax_telemetry.merge_snapshots)
    )
    agg = agg_cls()
    for rank, snap in enumerate(sender):
        agg.update(rank, json.dumps(snap))
    # either package's merge of either package's snapshots is the same
    assert merge(sender) == merge_snapshots(snaps) == jax_telemetry.merge_snapshots(jsnaps)
    rep = agg.report()
    assert rep["n_ranks"] == 2
    assert rep["cluster"] == merge_snapshots(snaps)
    assert agg.prometheus() == jax_telemetry.ClusterAggregator.prometheus(agg)


def _write_criteo(path, rows, codec=None, index=False):
    from dmlc_core_tpu_torch.data.row_block import RowBlock
    from dmlc_core_tpu_torch.data.rowrec import write_rowrec
    from dmlc_core_tpu_torch.io.stream import FileStream

    K = 39
    rng = np.random.default_rng(7)
    idx = rng.integers(0, 4096, (rows, K)).astype(np.uint32)
    val = rng.uniform(0, 1, (rows, K)).astype(np.float32)
    blk = RowBlock(offset=np.arange(rows + 1) * K,
                   label=rng.integers(0, 2, rows).astype(np.float32),
                   index=idx.reshape(-1), value=val.reshape(-1))
    with FileStream(path, "w") as f:
        if index:
            with FileStream(path + ".idx", "w") as fi:
                write_rowrec(f, [blk], index_stream=fi, codec=codec)
        else:
            write_rowrec(f, [blk], codec=codec)


_FAMILIES = ("staging.", "io.split.", "io.codec.")


def _telemetry_delta(registry, before, view):
    """(counter deltas under the families, histogram count deltas)."""
    counters = {k: v for k, v in view.delta().items() if v}
    hist_now = registry.snapshot()["histograms"]
    hists = {}
    for key, h in hist_now.items():
        if key.startswith(_FAMILIES):
            d = h["count"] - before.get(key, {}).get("count", 0)
            if d:
                hists[key] = d
    return counters, hists


class _Delta:
    def __init__(self, registry):
        self.registry = registry
        self.before = registry.snapshot()["histograms"]
        self.views = [registry.scoped(prefix=p) for p in _FAMILIES]

    def read(self):
        counters, hists = {}, {}
        for view in self.views:
            c, h = _telemetry_delta(self.registry, self.before, view)
            counters.update(c)
            hists.update(h)
        return counters, hists


@pytest.mark.parametrize("case", [
    "raw", "zlib", "raw&shuffle=batch", "zlib&shuffle=window", "zlib&shuffle=record",
])
def test_drain_registry_deltas_equal_jax(tmp_path, case):
    """One CPU drain of the same rowrec file through both staging
    pipelines moves the staging.*, io.split.* and io.codec.* series by
    the same amounts (counters exactly; histograms by sample count,
    since their values are times)."""
    import jax

    from dmlc_core_tpu.io import codec as jax_codec
    from dmlc_core_tpu.staging import BatchSpec as JaxSpec
    from dmlc_core_tpu.staging import StagingPipeline as JaxPipeline
    from dmlc_core_tpu.staging import drain_close as jax_drain_close
    from dmlc_core_tpu.staging import ell_batches as jax_ell_batches
    from dmlc_core_tpu_torch.io import codec
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches
    from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

    codec_name, _, shuffle = case.partition("&")
    path = str(tmp_path / "d.rec")
    rows = 5 * 64 + 17
    _write_criteo(path, rows, codec=None if codec_name == "raw" else codec_name,
                  index=bool(shuffle))
    uri = path if not shuffle else (
        f"{path}?index={path}.idx&{shuffle}&batch_size=64&seed=3&epoch=0")
    # a cold decoded-block cache in each package, so hits/misses agree
    codec.default_decode_cache().clear()
    jax_codec.default_decode_cache().clear()

    port_delta = _Delta(default_registry())
    src = ell_batches(uri, BatchSpec(batch_size=64, max_nnz=39))
    pipe = StagingPipeline(src, device="cpu")
    n = sum(1 for _ in pipe)
    assert drain_close(pipe, src)
    port = port_delta.read()

    jax_delta = _Delta(jax_telemetry.default_registry())
    jsrc = jax_ell_batches(uri, JaxSpec(batch_size=64, layout="ell", max_nnz=39))
    jpipe = JaxPipeline(jsrc, device=jax.devices("cpu")[0])
    jn = sum(1 for _ in jpipe)
    jax_drain_close(jpipe, jsrc)
    jax_side = jax_delta.read()

    assert n == jn == 6
    assert port[0]["staging.rows"] == rows
    assert port == jax_side
