"""The port's indexed and shuffled splits against the JAX package's, on
the CPU.

Both packages read the same files, written from the same seeded numpy
records: every record's bytes, in order, must be identical (a bit-for-bit
comparison, no tolerance) for each shuffle mode over 3 epochs, 1 and 3
parts, ``skip_records`` resumes and ``shuffle_parts``; the span planner
must give the same spans, the counters the same values, and a bad option
the same error. Cases copied from tests/test_split_window.py,
test_split_gather.py and test_resume_position.py run on both packages.
"""

import os
import threading

import numpy as np
import pytest

from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu.utils.logging import Error as JaxError
from dmlc_core_tpu_torch.io import split
from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
from dmlc_core_tpu_torch.io.stream import FileStream
from dmlc_core_tpu_torch.utils.logging import Error

MODES = ["0", "record", "batch", "window", "legacy"]


def records_of(n, seed=0, magic_every=7):
    """Ragged payloads; every ``magic_every``-th holds the RecordIO magic
    word at an aligned offset, so those records are multipart chains."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        body = rng.integers(0, 256, 4 * int(rng.integers(1, 12)), dtype=np.uint8)
        if i % magic_every == 0:
            body[:4] = np.frombuffer(np.uint32(0xCED7230A).tobytes(), np.uint8)
        out.append(body.tobytes())
    return out


def write_indexed(tmp, records, name="data"):
    p, idx = os.path.join(tmp, f"{name}.rec"), os.path.join(tmp, f"{name}.idx")
    with FileStream(p, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi)
        for r in records:
            w.write_record(r)
    return p, idx


@pytest.fixture
def indexed(tmp_path):
    records = records_of(101)
    return (*write_indexed(str(tmp_path), records), records)


def query(mode, extra=""):
    q = {"0": "", "legacy": "&shuffle=record&legacy_shuffle=1"}.get(
        mode, f"&shuffle={mode}")
    return q + extra


def drain(s, epochs=1):
    """Every record of ``epochs`` epochs (``before_first`` between), then
    ``close()``, whatever happens."""
    out = []
    try:
        for e in range(epochs):
            if e:
                s.before_first()
            while True:
                rec = s.next_record()
                if rec is None:
                    break
                out.append(bytes(rec))
    finally:
        s.close()
    return out


def both(uri, part=0, parts=1, epochs=1, **kw):
    """(port records, JAX records, port split, JAX split) of ``uri``."""
    p = split.create(uri, part, parts, type="recordio", **kw)
    j = jax_split.create(uri, part, parts, type="recordio", threaded=False, **kw)
    return drain(p, epochs), drain(j, epochs), p, j


@pytest.mark.parametrize("parts", [1, 3])
@pytest.mark.parametrize("mode", MODES)
def test_record_order_matches_jax_over_three_epochs(indexed, mode, parts):
    p, idx, records = indexed
    uri = f"{p}?index={idx}{query(mode, '&batch_size=8&window=16&merge_gap=64&seed=4')}"
    seen = []
    for part in range(parts):
        got, want, ps, js = both(uri, part, parts, epochs=3)
        assert got == want
        stats, jstats = ps.io_stats(), js.io_stats()
        assert stats == {k: jstats[k] for k in stats}
        seen += got
    assert sorted(seen) == sorted(records * 3)


@pytest.mark.parametrize("mode,step,bad", [
    ("batch", 8, 12), ("window", 16, 20), ("record", 1, None), ("0", 1, None),
    ("legacy", 1, None),
])
def test_skip_records_resumes_like_jax(indexed, mode, step, bad):
    p, idx, records = indexed
    base = f"{p}?index={idx}{query(mode, '&batch_size=8&window=16&seed=9&epoch=2')}"
    full, _, _, _ = both(base)
    for skip in (step, 3 * step, 96, len(records)):
        if skip % step:
            continue
        got, want, _, _ = both(f"{base}&skip_records={skip}")
        assert got == want == full[skip:]
    if bad is not None:
        with pytest.raises(Error) as e:
            split.create(f"{base}&skip_records={bad}", type="recordio")
        with pytest.raises(JaxError) as je:
            jax_split.create(f"{base}&skip_records={bad}", type="recordio")
        assert str(e.value) == str(je.value)
    with pytest.raises(Error, match="outside this shard"):
        split.create(f"{base}&skip_records={len(records) + 1}", type="recordio")


def test_batch_mode_remainder_span_reads_last(indexed):
    """101 records in spans of 8: the 5-record remainder comes last in
    every epoch, so every multiple of 8 is a resumable position."""
    p, idx, records = indexed
    for epoch in range(3):
        got, want, _, _ = both(f"{p}?index={idx}&shuffle=batch&batch_size=8&epoch={epoch}")
        assert got == want
        assert got[-5:] == records[-5:]


def test_window_order_equals_record_mode(indexed):
    """Windows change how the bytes are read, never the order."""
    p, idx, _ = indexed
    ref, _, _, _ = both(f"{p}?index={idx}&shuffle=record&seed=5")
    for window, gap in ((16, 0), (64, 1 << 20), (7, 8), (1000, 64)):
        got, want, _, _ = both(
            f"{p}?index={idx}&shuffle=window&seed=5&window={window}&merge_gap={gap}")
        assert got == want == ref


def test_epoch_permutations_are_distinct_and_rebuildable(indexed):
    p, idx, _ = indexed
    s = split.IndexedRecordIOSplitter(p, idx, shuffle="window", window=16, seed=3)
    e0 = drain(s)
    s = split.IndexedRecordIOSplitter(p, idx, shuffle="window", window=16, seed=3)
    e01 = drain(s, epochs=2)
    assert e01[:len(e0)] == e0 and e01[len(e0):] != e0
    again = split.IndexedRecordIOSplitter(p, idx, shuffle="window", window=16,
                                          seed=3, epoch=1)
    assert drain(again) == e01[len(e0):]


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_plan_coalesced_spans_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    entries = [(int(o), int(sz), i) for i, (o, sz) in enumerate(
        zip(rng.integers(0, 5000, n), rng.integers(1, 90, n)))]
    for gap in (0, 5, 64, 1 << 20):
        assert split.plan_coalesced_spans(entries, gap) == \
            jax_split.plan_coalesced_spans(entries, gap)


def test_planner_merges_adjacent_and_respects_gap():
    entries = [(25, 10, 2), (0, 10, 0), (200, 10, 3), (10, 10, 1)]
    spans = split.plan_coalesced_spans(entries, 0)
    assert [(b, e) for b, e, _m in spans] == [(0, 20), (25, 35), (200, 210)]
    assert spans[0][2] == [(0, 10, 0), (10, 10, 1)]
    assert [(b, e) for b, e, _m in split.plan_coalesced_spans(entries, 5)] == \
        [(0, 35), (200, 210)]
    two = [(0, 10, 0), (14, 10, 1)]
    assert len(split.plan_coalesced_spans(two, 4)) == 1
    assert len(split.plan_coalesced_spans(two, 3)) == 2
    assert split.plan_coalesced_spans([], 64) == []
    # an entry inside its predecessor neither ends the span early nor
    # goes missing
    inner = [(0, 100, 0), (10, 5, 1), (120, 10, 2)]
    assert [(b, e, [m[2] for m in ms])
            for b, e, ms in split.plan_coalesced_spans(inner, 30)] == [(0, 130, [0, 1, 2])]


@pytest.mark.parametrize("source", ["recordio", "indexed", "window", "text"])
@pytest.mark.parametrize("parts", [1, 2])
def test_input_split_shuffle_matches_jax(tmp_path, indexed, source, parts):
    p, idx, _ = indexed
    if source == "text":
        p = str(tmp_path / "lines.txt")
        with open(p, "w") as f:
            f.writelines(f"line {i} {'x' * (i % 13)}\n" for i in range(300))
        uri, kind = f"{p}?shuffle_parts=4&seed=3", "text"
    else:
        q = {"recordio": "", "indexed": f"&index={idx}",
             "window": f"&index={idx}&shuffle=window&window=8"}[source]
        uri, kind = f"{p}?shuffle_parts=3&seed=2{q}", "recordio"
    for part in range(parts):
        s = split.create(uri, part, parts, type=kind)
        # the macro-shuffle reads ahead on a thread, as the JAX package's
        # does; over a windowed split, whose windows load on their own
        # read-ahead thread, it stays bare and keeps the gather views
        inner = s if source == "window" else s._base
        assert isinstance(s, split.InputSplitShuffle if source == "window"
                          else split.ThreadedInputSplit)
        assert isinstance(inner, split.InputSplitShuffle)
        j = jax_split.create(uri, part, parts, type=kind, threaded=False)
        assert drain(s, epochs=2) == drain(j, epochs=2)


@pytest.mark.parametrize("value", ["windo", "2x", "4", "yes"])
def test_invalid_shuffle_raises_like_normalize_shuffle(indexed, value):
    p, idx, _ = indexed
    with pytest.raises(Error) as e:
        split.create(f"{p}?index={idx}&shuffle={value}", type="recordio")
    with pytest.raises(JaxError) as je:
        jax_split.normalize_shuffle(value)
    assert str(e.value) == str(je.value)
    for v in (None, 0, "0", "", 1, True, "record", 2, "batch", 3, "window"):
        assert split.normalize_shuffle(v) == jax_split.normalize_shuffle(v)


def test_io_stats_show_coalescing(indexed):
    p, idx, records = indexed
    s = split.IndexedRecordIOSplitter(p, idx, batch_size=9, shuffle="window",
                                      seed=4, window=1 << 20, merge_gap=1 << 20)
    assert sorted(drain(s)) == sorted(records)
    stats = s.io_stats()
    assert stats["mode"] == "window" and stats["records"] == len(records)
    assert stats["spans"] == 1 and stats["seeks"] == 0
    assert stats["bytes_read"] == os.path.getsize(p)
    # next_record copies records out: every emission counts as copied
    assert stats["gather_fallback_batches"] > 0 and stats["gather_batches"] == 0
    legacy = split.IndexedRecordIOSplitter(p, idx, shuffle="record", legacy_shuffle=True)
    drain(legacy)
    assert legacy.io_stats()["spans"] == legacy.io_stats()["seeks"] == len(records)


def test_gather_views_frame_the_records_in_order(indexed):
    """``next_gather_batch`` views hold exactly the records
    ``next_batch_ex`` copies out, and never cross a window."""
    p, idx, _ = indexed
    want = drain(split.IndexedRecordIOSplitter(p, idx, shuffle="batch", batch_size=8,
                                               window=24, seed=1))
    s = split.IndexedRecordIOSplitter(p, idx, shuffle="batch", batch_size=8,
                                      window=24, seed=1)
    got = []
    try:
        while True:
            g = s.next_gather_batch(10)
            if g is None:
                break
            buf, starts, sizes = g
            assert len(starts) <= 10
            got += [bytes(buf[a:a + n]) for a, n in zip(starts, sizes)]
    finally:
        s.close()
    frames = b"".join(got)
    from dmlc_core_tpu_torch.io.recordio import RecordIOChunkReader

    assert [bytes(r) for r in RecordIOChunkReader(frames)] == want
    assert s.io_stats()["gather_batches"] > 0
    assert s.io_stats()["gather_fallback_batches"] == 0
    seq = split.IndexedRecordIOSplitter(p, idx)
    with pytest.raises(Error, match="windowed"):
        seq.next_gather_batch(4)
    seq.close()


def test_empty_part_and_reset_partition(indexed):
    p, idx, records = indexed
    for mod in (split, jax_split):
        s = mod.IndexedRecordIOSplitter(p, idx, 0, 1, batch_size=3,
                                        shuffle="window", seed=1, window=4)
        try:
            assert s.next_record() is not None
            s.reset_partition(99, 100)  # 99 * ceil(101 / 100) >= 101: empty
            assert s.next_record() is None
            s.reset_partition(0, 1)
            assert len(drain(s)) == len(records)
        finally:
            s.close()


def test_readahead_threads_end_on_close_and_before_first(indexed):
    p, idx, _ = indexed

    def readahead():
        return [t for t in threading.enumerate() if t.name == "split-window-readahead"]

    s = split.IndexedRecordIOSplitter(p, idx, batch_size=2, shuffle="window",
                                      window=8, seed=1)
    try:
        s.next_record()  # 13 windows, 2 queued: the thread is still busy
        assert readahead()
        s.before_first()
        assert not readahead()
        s.next_record()
    finally:
        s.close()
    assert not readahead()


def test_index_parse_is_shared_and_rereads_a_rewritten_file(tmp_path):
    p, idx = write_indexed(str(tmp_path), records_of(20))
    a = split.IndexedRecordIOSplitter(p, idx, 0, 2)
    b = split.IndexedRecordIOSplitter(p, idx, 1, 2)
    assert a._index_offs is b._index_offs
    p2, idx2 = write_indexed(str(tmp_path), records_of(30, seed=1), "other")
    os.replace(p2, p)
    os.replace(idx2, idx)
    c = split.IndexedRecordIOSplitter(p, idx)
    assert len(c._index_offs) == 30
    for s in (a, b, c):
        s.close()


@pytest.mark.parametrize("uri,match", [
    ("{p}?index={i}#cache", "cachefile"),
    ("{p}?index={i}&dynamic_shards=1", "ROADMAP.md §1 item 4"),
    ("{p}?index={i}&format=rowrec", "not supported"),
    ("{p}?shuffle=record", "indexed recordio"),
    ("{p}?skip_records=4", "indexed recordio"),
    ("{p}?index={i}&window=0&shuffle=window", ">= 1"),
    ("{p};{p}?index={i}", "multi-file"),
    ("s3://b/k?index={i}", "remote"),
])
def test_create_refuses_what_the_port_lacks(indexed, tmp_path, uri, match):
    """What the port lacks raises. A ``#cachefile`` and a file set, once
    refused, read since slice 7: the records equal the JAX package's, and
    so do the cache files the two write."""
    p, idx, _ = indexed
    uri = uri.format(p=p, i=idx)
    if match in ("cachefile", "multi-file"):
        port_uri = uri.replace("#cache", f"#{tmp_path / 'port.cache'}")
        jax_uri = uri.replace("#cache", f"#{tmp_path / 'jax.cache'}")
        got = drain(split.create(port_uri, type="recordio"), epochs=2)
        want = drain(jax_split.create(jax_uri, type="recordio", threaded=False), epochs=2)
        assert got == want and got
        if match == "cachefile":
            assert ((tmp_path / "port.cache").read_bytes()
                    == (tmp_path / "jax.cache").read_bytes())
        return
    with pytest.raises(Error, match=match):
        split.create(uri, type="recordio")


def test_compressed_index_raises(indexed, tmp_path):
    """A block index over v1 frames raises when its block is read (the
    frame there is no compressed block), and an index that mixes v1 and
    block offsets raises when it is opened: both with the JAX package's
    reasons."""
    p, _, _ = indexed
    idx = tmp_path / "z.idx"
    idx.write_text("0 0:0\n1 0:40\n")
    for mod, err in ((split, Error), (jax_split, JaxError)):
        s = mod.create(f"{p}?index={idx}", type="recordio", threaded=False)
        with pytest.raises(err, match="corrupt compressed chain"):
            s.next_record()
        s.close()
    idx.write_text("0 0:0\n1 40\n")
    for mod, err in ((split, Error), (jax_split, JaxError)):
        with pytest.raises(err, match="mixes v1 and compressed-block offsets"):
            mod.create(f"{p}?index={idx}", type="recordio")
