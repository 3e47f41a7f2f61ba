"""The port's live streams (dmlc_core_tpu_torch/stream/) against the JAX
package's: the cases of tests/test_stream.py on the port (the 2-worker
submit drill is in test_torch_launch.py), then both packages on the same
inputs:

- the files of a stream (manifest, shards, indexes) written by the two
  packages for the same appends are byte-equal (on one clock);
- a stream written by one package and followed live by the other gives
  the records of a drain of the sealed stream, unshuffled and under
  ``shuffle=window``, both ways;
- ``_window_perm`` is equal over a grid of (seed, epoch, gen, widx, n);
- ``ell_batches`` over a sealed stream gives the JAX ``ell_batches``'s
  batches bit for bit, and the FM trained on them stays within
  ``test_torch_models.py``'s tolerance of the JAX FM;
- a leased (``&dynamic_shards=1``) follow under a tracker of either
  package drains each generation once;
- the port's online example against the JAX example: the same rows, the
  same batches, the params within tolerance after the same steps.

Every writer thread is joined with a timeout and every follow has a
``max_idle_secs``.
"""

import importlib.util
import json
import os
import threading
import time
import zlib  # noqa: L009 (crc32 as an order-free fold, not compression)
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu.stream import StreamSource as JaxSource
from dmlc_core_tpu.stream import StreamWriter as JaxWriter
from dmlc_core_tpu.stream import manifest as jax_sm
from dmlc_core_tpu.stream import source as jax_source
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter, RecordIOWriter
from dmlc_core_tpu_torch.io.stream import FileStream
from dmlc_core_tpu_torch.stream import StreamSource, StreamWriter
from dmlc_core_tpu_torch.stream import manifest as sm
from dmlc_core_tpu_torch.stream import source as port_source
from dmlc_core_tpu_torch.utils.logging import Error

REPO = Path(__file__).resolve().parent.parent
JOIN_S = 60
WRITERS = {"port": StreamWriter, "jax": JaxWriter}
SOURCES = {"port": StreamSource, "jax": JaxSource}


@pytest.fixture(autouse=True)
def _stream_env(monkeypatch):
    """No DMLC_STREAM_* knob leaks in from the environment, and retries
    run at test speed."""
    for k in ("DMLC_STREAM_POLL", "DMLC_STREAM_MAX_LAG", "DMLC_STREAM_LAG_POLICY"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DMLC_RETRY_BASE_SECS", "0.001")
    monkeypatch.setenv("DMLC_RETRY_CAP_SECS", "0.01")


def _payload(i: int) -> bytes:
    # variable sizes, so codec blocks and windows cut at odd offsets
    return (b"rec-%08d|" % i) * (1 + i % 4)


def _drain(src) -> list:
    out = []
    while True:
        r = src.next_record()
        if r is None:
            return out
        out.append(r)


def _posthoc(d: str, pkg: str = "port", **kw) -> list:
    src = SOURCES[pkg](d, **kw)
    try:
        return _drain(src)
    finally:
        src.close()


def _join(t: threading.Thread) -> None:
    t.join(JOIN_S)
    assert not t.is_alive(), "the writer thread did not end"


# -- the durable-commit contract on the RecordIO writers -----------------------


def test_commit_returns_frame_aligned_watermark(tmp_path):
    p = str(tmp_path / "w.rec")
    with FileStream(p, "w") as f:
        w = RecordIOWriter(f, codec="zlib", block_bytes=1 << 20)
        for i in range(10):
            w.write_record(_payload(i))
        b, r = w.commit()
    assert r == 10 and b == os.path.getsize(p)
    scan = sm.scan_committed_prefix(p)
    assert scan["committed_bytes"] == b and scan["tail_bytes"] == 0
    sp = io_split.create(p, 0, 1, type="recordio", shuffle=None)
    got = _drain(sp)
    sp.close()
    assert got == [_payload(i) for i in range(10)]


def test_flush_never_exposes_partial_block(tmp_path):
    """A raw flush mid-block leaves only whole frames on disk: the pending
    block stays in the writer until commit() seals it."""
    p = str(tmp_path / "partial.rec")
    f = FileStream(p, "w")
    w = RecordIOWriter(f, codec="zlib", block_bytes=256)
    for i in range(40):  # several sealed blocks and a pending one
        w.write_record(_payload(i))
    f.flush()
    scan = sm.scan_committed_prefix(p)
    assert scan["tail_bytes"] == 0, "flush exposed a torn frame"
    assert scan["committed_bytes"] == os.path.getsize(p)
    b, r = w.commit()
    f.close()
    assert r == 40
    scan = sm.scan_committed_prefix(p)
    assert scan["committed_bytes"] == b == os.path.getsize(p)
    assert scan["tail_bytes"] == 0


def test_indexed_writer_commit_and_fsync_knob(tmp_path):
    p = str(tmp_path / "idx.rec")
    ip = p + ".idx"
    with FileStream(p, "w") as f, FileStream(ip, "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec="zlib", block_bytes=512, fsync=True)
        for i in range(30):
            w.write_record(_payload(i))
        b1, r1 = w.commit()  # None: the constructor's policy
        for i in range(30, 50):
            w.write_record(_payload(i))
        b2, r2 = w.commit(fsync=False)
    assert (r1, r2) == (30, 50) and b2 > b1
    assert os.path.getsize(ip) > 0
    assert sm.scan_committed_prefix(p)["tail_bytes"] == 0


@pytest.mark.parametrize("codec", [None, "zlib"])
def test_commit_watermarks_and_files_equal_jax(tmp_path, codec):
    """The same records and commits through both packages' indexed
    writers: the same watermarks, data bytes and index bytes."""
    from dmlc_core_tpu.io.recordio import IndexedRecordIOWriter as JaxIndexed
    from dmlc_core_tpu.io.stream import FileStream as JaxFileStream

    marks = {}
    for pkg, (fs, writer) in {"port": (FileStream, IndexedRecordIOWriter),
                              "jax": (JaxFileStream, JaxIndexed)}.items():
        p = str(tmp_path / f"{pkg}.rec")
        with fs(p, "w") as f, fs(p + ".idx", "w") as fi:
            w = writer(f, fi, codec=codec, block_bytes=300)
            marks[pkg] = []
            for i in range(45):
                w.write_record(_payload(i), key=1000 + i)
                if i % 11 == 10:
                    marks[pkg].append(w.commit())
            marks[pkg].append(w.commit())
    assert marks["port"] == marks["jax"]
    for ext in (".rec", ".rec.idx"):
        assert ((tmp_path / f"port{ext}").read_bytes()
                == (tmp_path / f"jax{ext}").read_bytes())


# -- the manifest commit point -------------------------------------------------


def test_manifest_roundtrip_seq_and_missing(tmp_path):
    d = str(tmp_path)
    assert sm.read_manifest(d) is None
    m = sm.new_manifest()
    m["live"] = {"gen": 0, "data": "shard-00000.rec", "index": "shard-00000.rec.idx",
                 "bytes": 0, "records": 0, "committed_unix": 0.0}
    sm.write_manifest(d, m)
    sm.write_manifest(d, m)
    got = sm.read_manifest(d)
    assert got["seq"] == 2 and got["live"]["gen"] == 0
    assert got["sealed"] == [] and got["eos"] is False
    assert [n for n in os.listdir(d) if ".tmp" in n] == []
    # each package reads the other's manifest
    assert jax_sm.read_manifest(d) == got


def test_manifest_garbage_fails_loudly(tmp_path):
    (tmp_path / sm.MANIFEST_NAME).write_text("{not json")
    with pytest.raises(Error, match="corrupt stream manifest"):
        sm.read_manifest(str(tmp_path))


@pytest.mark.parametrize("codec", [None, "zlib"])
def test_stream_files_equal_jax(tmp_path, monkeypatch, codec):
    """The same appends, commits, rotations and close through both
    packages' writers, on one fixed clock: every file of the two
    directories is byte-equal, manifest.json included."""
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    dirs = {}
    for pkg, cls in WRITERS.items():
        d = tmp_path / pkg
        d.mkdir()
        with cls(str(d), codec=codec, block_bytes=512, rotate_bytes=2048,
                 commit_records=25, fsync="never") as w:
            for i in range(300):
                w.append(_payload(i), key=7 * i)
                if i == 150:
                    w.rotate()
        dirs[pkg] = d
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"]))
    assert sm.MANIFEST_NAME in names and len(names) >= 5
    for n in names:
        assert (dirs["port"] / n).read_bytes() == (dirs["jax"] / n).read_bytes(), n


# -- the writer: rotation, EOS, sealed shards ----------------------------------


def test_writer_rotates_and_seals_readable_shards(tmp_path):
    d = str(tmp_path)
    with StreamWriter(d, codec="zlib", block_bytes=512, rotate_bytes=2048,
                      commit_records=25) as w:
        for i in range(300):
            w.append(_payload(i))
    m = sm.read_manifest(d)
    assert m["eos"] is True and m["live"] is None
    assert len(m["sealed"]) >= 2, "rotate_bytes=2048 never rotated"
    assert sum(e["records"] for e in m["sealed"]) == 300
    nxt = 0
    for ent in m["sealed"]:
        shard = os.path.join(d, ent["data"])
        scan = sm.scan_committed_prefix(shard)
        assert scan["tail_bytes"] == 0
        assert scan["committed_bytes"] == ent["bytes"] == os.path.getsize(shard)
        sp = io_split.create(shard, 0, 1, type="recordio",
                             index_uri=os.path.join(d, ent["index"]))
        got = _drain(sp)
        sp.close()
        assert got == [_payload(i) for i in range(nxt, nxt + ent["records"])]
        nxt += ent["records"]
    assert nxt == 300


def test_writer_empty_rotation_and_empty_close(tmp_path):
    d = str(tmp_path)
    w = StreamWriter(d, codec=None)
    w.rotate()  # nothing appended: no empty generation is sealed
    w.close(eos=True)
    m = sm.read_manifest(d)
    assert m["sealed"] == [] and m["live"] is None and m["eos"] is True
    assert [n for n in os.listdir(d) if n.endswith(".rec")] == []


def test_writer_metrics_and_stats(tmp_path):
    """``stream.commits`` counts each publish; the watermark gauge is the
    committed records; ``stats()`` has the JAX writer's keys."""
    from dmlc_core_tpu_torch.telemetry import default_registry

    reg = default_registry()
    c0 = reg.counter("stream.commits").value()
    for sub in ("p", "j"):
        (tmp_path / sub).mkdir()
    with StreamWriter(str(tmp_path / "p"), codec=None, commit_records=10) as w:
        for i in range(35):
            w.append(_payload(i))
        assert reg.gauge("stream.watermark_records").value() == 30.0
        st = w.stats()
    assert reg.counter("stream.commits").value() == c0 + 3
    assert st["commits"] == 3 and st["records_appended"] == 35
    with JaxWriter(str(tmp_path / "j"), codec=None) as jw:
        assert set(jw.stats()) == set(st)


# -- a live follow equals a drain of the sealed stream -------------------------


def test_live_follow_sequential_matches_posthoc(tmp_path):
    d = str(tmp_path)
    expect = [_payload(i) for i in range(400)]

    def produce():
        with StreamWriter(d, codec="zlib", block_bytes=512, rotate_bytes=4096,
                          commit_records=20) as w:
            for i, rec in enumerate(expect):
                w.append(rec)
                if i % 50 == 49:
                    time.sleep(0.01)  # let the follower catch the tail

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    src = StreamSource(d, poll_secs=0.005, max_idle_secs=30.0)
    try:
        live = _drain(src)
        stats = src.io_stats()
    finally:
        src.close()
        _join(t)
    assert live == expect
    assert _posthoc(d) == expect
    assert stats["commits_seen"] >= 2 and stats["rotations_seen"] >= 1


def test_live_follow_shuffled_rotation_race_matches_posthoc(tmp_path):
    """A reader parked mid-window when the writer seals the live shard
    flushes the partial window at the boundary and emits exactly the
    order of a drain of the sealed directory."""
    d = str(tmp_path)
    kw = dict(shuffle="window", seed=11, window=64)
    w = StreamWriter(d, codec="zlib", block_bytes=512, rotate_bytes=1 << 30,
                     commit_records=0)
    src = StreamSource(d, poll_secs=0.005, max_idle_secs=30.0, **kw)
    for i in range(100):
        w.append(_payload(i))
    w.commit()
    live = [src.next_record() for _ in range(64)]  # 36 left mid-window
    w.rotate()
    for i in range(100, 150):
        w.append(_payload(i))
    w.close(eos=True)
    live += _drain(src)
    src.close()
    assert sorted(live) == sorted(_payload(i) for i in range(150))
    assert live == _posthoc(d, **kw) == _posthoc(d, "jax", **kw)
    m = sm.read_manifest(d)
    assert [e["records"] for e in m["sealed"]] == [100, 50]
    assert sorted(live[:100]) == sorted(_payload(i) for i in range(100))


def test_live_follow_chaos_faults_heal(tmp_path):
    """Transient open errors and resets on the manifest and the shards
    heal through the retry layer without reordering or losing a record."""
    from dmlc_core_tpu_torch.io import retry

    d = str(tmp_path)
    expect = [_payload(i) for i in range(200)]
    with StreamWriter(d, codec="zlib", block_bytes=512, rotate_bytes=4096,
                      commit_records=40) as w:
        for rec in expect:
            w.append(rec)
    before = retry.stats()
    got = _posthoc(f"fault://errors=2,resets=1,seed=7{d}", poll_secs=0.005,
                   max_idle_secs=30.0)
    assert got == expect
    assert retry.stats_delta(before)["retries"] > 0


@pytest.mark.parametrize("shuffle", ["0", "window"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cross_package_live_follow_matches_sealed_drain(tmp_path, writer, shuffle):
    """One package writes while the other follows live: the follower
    emits the records of the sealed drain, in its order, both ways."""
    reader = "port" if writer == "jax" else "jax"
    d = str(tmp_path)
    kw = dict(shuffle=shuffle, seed=5, window=48)

    def produce():
        with WRITERS[writer](d, codec="zlib", block_bytes=400, rotate_bytes=3000,
                             commit_records=17) as w:
            for i in range(360):
                w.append(_payload(i))
                if i % 40 == 39:
                    time.sleep(0.005)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    src = SOURCES[reader](d, poll_secs=0.003, max_idle_secs=30.0, **kw)
    try:
        live = _drain(src)
    finally:
        src.close()
        _join(t)
    assert sorted(live) == sorted(_payload(i) for i in range(360))
    assert live == _posthoc(d, "port", **kw) == _posthoc(d, "jax", **kw)
    assert len(sm.read_manifest(d)["sealed"]) >= 2


def test_window_perm_equals_jax():
    grid = [(seed, epoch, gen, widx, n)
            for seed in (0, 7, 2**40 + 3) for epoch in (0, 1, 5) for gen in (0, 3)
            for widx in (0, 1, 99) for n in (1, 2, 64, 1000)]
    for args in grid:
        assert port_source._window_perm(*args) == jax_source._window_perm(*args), args


def test_io_stats_of_a_sealed_drain_equal_jax(tmp_path):
    d = str(tmp_path)
    with JaxWriter(d, codec="zlib", block_bytes=512, rotate_bytes=4096,
                   commit_records=30) as w:
        for i in range(250):
            w.append(_payload(i))
    stats = {}
    for pkg in SOURCES:
        src = SOURCES[pkg](d, shuffle="window", seed=2, window=40, max_extent=1 << 16)
        _drain(src)
        stats[pkg] = src.io_stats()
        src.close()
    same = ("mode", "extents", "bytes_read", "windows", "records", "lag_records")
    assert {k: stats["port"][k] for k in same} == {k: stats["jax"][k] for k in same}
    assert set(stats["jax"]) == set(stats["port"])


# -- bounded staleness (DMLC_STREAM_MAX_LAG) -----------------------------------


def test_writer_blocks_on_reader_lag_then_resumes(tmp_path):
    d = str(tmp_path)
    w = StreamWriter(d, codec=None, commit_records=10, max_lag=30, lag_policy="block",
                     lag_poll_secs=0.005)
    src = StreamSource(d, poll_secs=0.005, ack_id="r0", max_idle_secs=30.0)
    done = threading.Event()

    def produce():
        for i in range(120):
            w.append(_payload(i))
        done.set()

    sm.write_ack(d, "r0", 0)  # the writer sees the lag at once
    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        time.sleep(0.3)
        assert not done.is_set(), "writer never blocked at max_lag=30"
        assert w.backpressure_waits >= 1
        assert w.records_appended < 120
        got = []
        while len(got) < 120:  # the acks release the writer
            r = src.next_record()
            assert r is not None
            got.append(r)
    finally:
        _join(t)
    assert done.is_set()
    w.close(eos=True)
    src.close()
    assert got == [_payload(i) for i in range(120)]
    assert w.stats()["backpressure_secs"] > 0


def test_writer_lag_policy_warn_never_blocks(tmp_path):
    d = str(tmp_path)
    sm.write_ack(d, "r0", 0)
    with StreamWriter(d, codec=None, max_lag=5, lag_policy="warn") as w:
        for i in range(50):
            w.append(_payload(i))
        assert w.backpressure_waits == 0


def test_lag_env_knobs_are_read(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_STREAM_MAX_LAG", "17")
    monkeypatch.setenv("DMLC_STREAM_LAG_POLICY", "warn")
    monkeypatch.setenv("DMLC_STREAM_POLL", "0.125")
    w = StreamWriter(str(tmp_path), codec=None)
    src = StreamSource(str(tmp_path))
    assert (w.max_lag, w.lag_policy, src._poll) == (17, "warn", 0.125)
    w.close()
    src.close()
    monkeypatch.setenv("DMLC_STREAM_LAG_POLICY", "drop")
    with pytest.raises(Error, match="lag_policy"):
        StreamWriter(str(tmp_path / "x"), codec=None)


# -- tools info on a growing shard ---------------------------------------------


def test_tools_info_growing_shard_reports_uncommitted_tail(tmp_path, capsys):
    from dmlc_core_tpu_torch.tools import main as tools_main

    d = str(tmp_path)
    w = StreamWriter(d, codec="zlib", block_bytes=512, commit_records=0)
    for i in range(60):
        w.append(_payload(i))
    w.commit()
    live = sm.read_manifest(d)["live"]
    shard = os.path.join(d, live["data"])
    with open(shard, "ab") as f:  # half a frame header past the watermark
        f.write(b"\x0a\x23\xd7\xce\x40")
    assert tools_main(["info", shard]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["shard"]["status"] == "growing (tail_bytes=5 uncommitted)"
    assert report["shard"]["committed_bytes"] == live["bytes"]
    assert report["shard"]["blocks"] > 0
    assert report["shard"] == {**jax_sm.scan_committed_prefix(shard),
                               "status": report["shard"]["status"]}
    w.close(eos=False)


# -- telemetry: the windows, the merge and the lag column ----------------------


def test_timeseries_derives_stream_lag():
    from dmlc_core_tpu_torch.telemetry import timeseries as ts

    def sample(t, seq, lag_r, lag_s, wm):
        return {"t": t, "seq": seq, "counters": {}, "histograms": {},
                "gauges": {"stream.lag_records": lag_r, "stream.lag_seconds": lag_s,
                           "stream.watermark_records": wm}}

    win = ts.windowed([sample(100.0, 1, 40.0, 0.5, 200.0),
                       sample(110.0, 2, 10.0, 1.25, 400.0)], 60.0)
    assert win["derived"]["stream_lag_records"] == 10.0
    assert win["derived"]["stream_lag_seconds"] == 1.25
    assert win["derived"]["stream_watermark_records"] == 400.0
    views = {
        str(i): {"samples": 2, "counters": {}, "gauges": {},
                 "derived": {"rows_per_sec": 1.0, "stream_lag_seconds": s,
                             "stream_lag_records": r, "stream_watermark_records": 400.0}}
        for i, (s, r) in enumerate(((0.2, 5.0), (3.5, 90.0)))
    }
    merged = ts.merge_windows(views)
    assert merged["derived"]["stream_lag_seconds"] == 3.5
    assert merged["derived"]["stream_lag_records"] == 90.0


def test_top_model_and_render_show_lag_column():
    from dmlc_core_tpu_torch.tools import _render_top, _top_model

    def rank(lag_s, lag_r):
        return {"samples": 3, "counters": {}, "gauges": {},
                "derived": {"rows_per_sec": 10.0, "stall_fraction": {},
                            "stream_lag_seconds": lag_s, "stream_lag_records": lag_r,
                            "stream_watermark_records": 500.0}}

    report = {"windowed": {
        "per_rank": {"0": rank(0.25, 3.0), "1": rank(2.5, 80.0)},
        "cluster": {"n_ranks": 2, "derived": {"rows_per_sec": 20.0, "stall_fraction": {},
                                              "stream_lag_seconds": 2.5,
                                              "stream_lag_records": 80.0}}}}
    model = _top_model(report, 30.0)
    assert model["ranks"]["1"]["stream_lag_seconds"] == 2.5
    txt = _render_top(model, "127.0.0.1:9999")
    assert "lag" in txt, txt
    assert "0.25s" in txt and "2.50s" in txt
    assert "stream lag 2.50s/80 recs" in txt
    for r in report["windowed"]["per_rank"].values():
        for k in list(r["derived"]):
            if k.startswith("stream_"):
                del r["derived"][k]
    report["windowed"]["cluster"]["derived"] = {"rows_per_sec": 20.0, "stall_fraction": {}}
    assert "lag" not in _render_top(_top_model(report, 30.0), "127.0.0.1:9999")


def test_stream_tail_wait_is_a_stall_stage(tmp_path):
    """``stream_tail_wait`` is a wait stage, and a follow parked on the
    writer records it on the flight recorder; the lag gauges are set."""
    from dmlc_core_tpu_torch.telemetry import default_registry, tracing
    from dmlc_core_tpu_torch.telemetry.tracing import _WAIT_STAGES

    assert "stream_tail_wait" in _WAIT_STAGES
    d = str(tmp_path)
    w = StreamWriter(d, codec=None, commit_records=5)
    tracing.reset()
    tracing.set_enabled(True)
    try:
        src = StreamSource(d, poll_secs=0.01, max_idle_secs=30.0)
        t = threading.Timer(0.1, lambda: [w.append(_payload(i)) for i in range(5)])
        t.start()
        assert src.next_record() == _payload(0)
        t.join(JOIN_S)
        evs = tracing.to_chrome_trace()["traceEvents"]
    finally:
        tracing.set_enabled(None)
        tracing.reset()
    assert any(e.get("name") == "dmlc:stream_tail_wait" and e.get("ph") == "X"
               for e in evs)
    assert src.io_stats()["tail_wait_secs"] > 0
    assert default_registry().gauge("stream.lag_records").value() == 4.0
    w.close()
    assert _drain(src) == [_payload(i) for i in range(1, 5)]
    src.close()


# -- the factories: create, the gather contract, ell_batches -------------------


def test_create_routes_manifest_uri_and_gathers(tmp_path):
    d = str(tmp_path)
    with StreamWriter(d, codec="zlib", block_bytes=512, rotate_bytes=4096,
                      commit_records=50) as w:
        for i in range(300):
            w.append(_payload(i))
    sp = io_split.create(d + "/manifest.json?shuffle=window&window=32&seed=3", 0, 1)
    assert isinstance(sp, StreamSource) and sp.supports_gather()
    seen = []
    while True:
        g = sp.next_gather_batch(48)
        if g is None:
            break
        buf, starts, sizes = g
        assert len(starts) == len(sizes) and len(starts) <= 48
        for s, z in zip(starts.tolist(), sizes.tolist()):
            seen.extend(sp.extract_records(bytes(buf[s:s + z])))
    sp.close()
    assert sorted(seen) == sorted(_payload(i) for i in range(300))
    assert seen == _posthoc(d, shuffle="window", seed=3, window=32)


@pytest.mark.parametrize("form", ["manifest", "stream=1", "type"])
def test_create_stream_forms_equal_jax(tmp_path, form):
    """``…/manifest.json?…``, ``dir?stream=1&…`` and ``type="stream"``
    follow the stream in both packages, with the same records."""
    d = str(tmp_path)
    with JaxWriter(d, codec=None, rotate_bytes=1500, commit_records=9) as w:
        for i in range(120):
            w.append(_payload(i))
    q = "shuffle=window&window=20&seed=4"
    uri, kind = {"manifest": (f"{d}/manifest.json?{q}", "recordio"),
                 "stream=1": (f"{d}?stream=1&{q}", "recordio"),
                 "type": (f"{d}?{q}", "stream")}[form]
    got = io_split.create(uri, type=kind)
    want = jax_split.create(uri, type=kind)
    assert isinstance(got, StreamSource)
    assert _drain(got) == _drain(want)
    got.close()
    want.close()


def test_stream_source_is_single_reader_unless_dynamic(tmp_path):
    d = str(tmp_path)
    with StreamWriter(d, codec=None) as w:
        w.append(b"x")
    with pytest.raises(Error, match="dynamic_shards"):
        io_split.create(d + "/manifest.json", 1, 2)
    with pytest.raises(Error, match="cachefile"):
        io_split.create(d + "/manifest.json#cache.rec", 0, 1)
    with pytest.raises(Error, match="do not apply to a stream"):
        io_split.create(d + "/manifest.json?index=x.idx", 0, 1)


def _criteo_stream(d, writer="jax", rows=600, seed=3, k=6, dim=97):
    """Rowrec rows appended to a stream by ``writer``; returns them."""
    from dmlc_core_tpu.data.rowrec import encode_row

    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(seed)
    recs = [encode_row(float(i % 2), rng.integers(0, dim, k, dtype=np.int64),
                       rng.normal(size=k).astype(np.float32)) for i in range(rows)]
    with WRITERS[writer](d, codec="zlib", block_bytes=2048, rotate_bytes=8192,
                         commit_records=50) as w:
        for r in recs:
            w.append(r)
    return recs


def test_ell_batches_over_a_stream_equal_jax_and_fm_within_tolerance(tmp_path):
    """``ell_batches`` over a sealed stream's manifest URI takes the
    gather route and gives the JAX ``ell_batches``'s batches bit for bit;
    the FM trained on them stays within 1e-4 of max |param| of the JAX FM
    (weights carried over with ``convert``)."""
    from dmlc_core_tpu.models import FactorizationMachine as JaxFM
    from dmlc_core_tpu.staging import BatchSpec as JaxSpec
    from dmlc_core_tpu.staging import ell_batches as jax_ell_batches
    from dmlc_core_tpu_torch.convert import params_from_jax, params_to_numpy
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    k, d, e, b = 6, 97, 4, 32
    sdir = str(tmp_path / "s")
    _criteo_stream(sdir, k=k, dim=d)
    query = "shuffle=window&window=64&seed=7"
    keys = ("indices", "values", "nnz", "labels", "weights")
    # the JAX producer follows the directory's ?stream=1 form only (it maps
    # a manifest path as a RecordIO file, whatever the query)
    jsrc = jax_ell_batches(f"{sdir}?stream=1&{query}",
                           JaxSpec(batch_size=b, layout="ell", max_nnz=k))
    want = [{key: np.array(getattr(x, key)) for key in keys} for x in jsrc]
    jsrc.close()
    runs = []
    for uri in (f"{sdir}/manifest.json?{query}", f"{sdir}?stream=1&{query}"):
        src = ell_batches(uri, BatchSpec(batch_size=b, layout="ell", max_nnz=k))
        runs.append([{key: np.array(getattr(x, key)) for key in keys} for x in src])
        stats = src.io_stats()
        src.close()
        assert stats["mode"] == "stream" and stats["records"] == 600
    got = runs[0]
    for run in runs:
        assert len(run) == len(want) > 10
        for g, w in zip(run, want):
            for key in keys:
                np.testing.assert_array_equal(g[key], w[key])
    prng = np.random.default_rng(4)
    params = {"w": prng.normal(size=d).astype(np.float32) * 0.3, "b": np.float32(0.1),
              "v": prng.normal(size=(d, e)).astype(np.float32) * 0.3}
    jmodel = JaxFM(d, embed_dim=e)
    jparams = params
    for batch in want:
        jparams, _ = jmodel.sgd_step(jparams, batch)
    model = FactorizationMachine(d, e, device="cpu")
    model.load_state_dict(params_from_jax(params, "cpu"))
    for batch in got:
        model.sgd_step({key: torch.from_numpy(v) for key, v in batch.items()})
    out = params_to_numpy(model.state_dict())
    for key in out:
        w = np.asarray(jparams[key], np.float32)
        assert float(np.abs(out[key] - w).max()) <= 1e-4 * float(np.abs(w).max()), key


def test_ell_batches_refuses_a_bare_manifest_path(tmp_path):
    """A bare ``…/manifest.json`` (no query) names the manifest file: the
    JAX producer maps the JSON as RecordIO and fails on its first frame
    (with a query too); the port refuses it by name and trains on no JSON
    byte (with a query it follows the stream, above)."""
    from dmlc_core_tpu.staging import BatchSpec as JaxSpec
    from dmlc_core_tpu.staging import ell_batches as jax_ell_batches
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches, plain_batches

    d = str(tmp_path)
    _criteo_stream(d, rows=50)
    with pytest.raises(Error, match="names a live stream's manifest"):
        ell_batches(d + "/manifest.json", BatchSpec(batch_size=8, max_nnz=6))
    for q in ("", "?shuffle=window&window=8"):
        with pytest.raises(Exception, match="bad magic"):
            list(jax_ell_batches(d + "/manifest.json" + q, JaxSpec(batch_size=8, max_nnz=6)))
    with pytest.raises(Error, match="not a live stream"):
        plain_batches(d + "/manifest.json?stream=1", BatchSpec(batch_size=8, max_nnz=6))


# -- several workers: tracker-leased generations -------------------------------


@pytest.mark.parametrize("tracker_pkg", ["port", "jax"])
def test_dynamic_follow_drains_each_generation_once(tmp_path, monkeypatch, tracker_pkg):
    """One leased follower under a tracker of either package: each
    generation's micro-shards are recorded once and the records are the
    sealed shards', generation by generation; a second pass is refused."""
    from test_torch_shardsvc import close_tracker, start_tracker

    d = str(tmp_path)
    m = None
    t = start_tracker(tracker_pkg, 1, monkeypatch, oversplit="3")
    try:
        writer = threading.Thread(target=_criteo_stream, args=(d, "jax", 400), daemon=True)
        writer.start()
        src = io_split.create(d + "/manifest.json?dynamic_shards=1&shuffle=window"
                              "&window=32&seed=9", threaded=False)
        src._max_idle = 60.0  # the factory sets no idle limit
        done, by_gen = [], {}
        src.on_shard_done = lambda gen, shard, status: done.append((gen, shard, status))
        while True:
            rec = src.next_record()
            if rec is None:
                break
            by_gen.setdefault(src.generation, []).append(zlib.crc32(rec))
        _join(writer)
        assert src.io_stats()["mode"] == "stream-dynamic"
        with pytest.raises(Error, match="single-pass"):
            src.before_first()
        src.close()
        m = sm.read_manifest(d)
    finally:
        close_tracker(t)
    assert len(m["sealed"]) >= 2
    recorded = [(g, s) for g, s, st in done if st == "recorded"]
    assert len(recorded) == len(set(recorded)) == 3 * len(m["sealed"])
    for ent in m["sealed"]:
        sp = jax_split.create(os.path.join(d, ent["data"]), type="recordio",
                              index_uri=os.path.join(d, ent["index"]), threaded=False)
        want = sorted(zlib.crc32(bytes(r)) for r in iter(sp.next_record, None))
        sp.close()
        assert sorted(by_gen[ent["gen"]]) == want


# -- the online example against the JAX example --------------------------------


def jax_online_example():
    spec = importlib.util.spec_from_file_location(
        "jax_example_train_online_fm", REPO / "examples" / "train_online_fm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_online_example_matches_the_jax_example(tmp_path):
    """The same generator rows (shard bytes equal), the same batches, and
    after the same steps the params within 1e-4 of max |param| of the
    JAX example's, the JAX init carried over with ``convert``."""
    from dmlc_core_tpu.models import FactorizationMachine as JaxFM
    from dmlc_core_tpu_torch.convert import params_from_jax, params_to_numpy
    from dmlc_core_tpu_torch.examples import train_online_fm as port_ex
    from dmlc_core_tpu_torch.models import FactorizationMachine

    jex = jax_online_example()
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    for d in dirs.values():
        os.makedirs(d)
    jex.produce(dirs["jax"], rows=1500, rows_per_sec=1e9)
    port_ex.produce(dirs["port"], rows=1500, rows_per_sec=1e9)
    for name in sorted(os.listdir(dirs["jax"])):
        if name.startswith("shard-"):
            assert (Path(dirs["jax"]) / name).read_bytes() == \
                (Path(dirs["port"]) / name).read_bytes(), name
    uri = "/manifest.json?shuffle=window&window=1024&seed=7"
    jmodel = JaxFM(jex.N_FEATURES, embed_dim=8)
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    jsrc = jax_split.create(dirs["jax"] + uri, threaded=False)
    jparams, jlosses, first = params, [], None
    while True:
        chunk = jsrc.next_batch(jex.B)
        if chunk is None:
            break
        rows = list(jsrc.extract_records(chunk))
        batch = jex.to_batch(rows)
        if first is None:
            first = (rows, {k: np.asarray(v) for k, v in batch.items()})
        jparams, loss = jmodel.sgd_step(jparams, batch, lr=0.1)
        jlosses.append(float(loss))
    jsrc.close()
    got = port_ex.to_batch(first[0], torch.device("cpu"))
    for key, want in first[1].items():
        np.testing.assert_array_equal(got[key].numpy(), want)
    model = FactorizationMachine(port_ex.N_FEATURES, embed_dim=port_ex.EMBED, device="cpu")
    model.load_state_dict(params_from_jax(params, "cpu"))
    src = io_split.create(dirs["port"] + uri, threaded=False)
    res = port_ex.train(src, model, torch.device("cpu"))
    src.close()
    assert res["rows"] == 1500 and len(res["losses"]) == len(jlosses) >= 6
    np.testing.assert_allclose(res["losses"], jlosses, rtol=1e-5)
    out = params_to_numpy(model.state_dict())
    for key in out:
        w = np.asarray(jparams[key], np.float32)
        assert float(np.abs(out[key] - w).max()) <= 1e-4 * float(np.abs(w).max()), key


def test_online_example_demo_mode_trains_while_the_generator_writes(tmp_path,
                                                                    monkeypatch):
    """The demo: the generator on a thread, the trainer following it live
    to EOS, every row trained once, finite losses."""
    from dmlc_core_tpu_torch.examples import train_online_fm as port_ex

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(port_ex.tempfile, "tempdir", str(tmp_path))
    for k in ("DMLC_TRACKER_URI", "DMLC_TASK_ID", "DMLC_NUM_WORKER"):
        monkeypatch.delenv(k, raising=False)
    orig = port_ex.produce
    monkeypatch.setattr(port_ex, "produce",
                        lambda d: orig(d, rows=2000, rows_per_sec=20000.0))
    res = port_ex.main([], device="cpu")
    assert res["rows"] == 2000 and res["steps"] >= 8
    assert all(np.isfinite(res["losses"]))
    assert res["io_stats"]["mode"] == "stream"
    assert os.path.exists(tmp_path / "fm_stream_demo" / "manifest.json")
