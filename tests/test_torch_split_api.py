"""The port's split interface against the JAX package's, on the CPU: every
split derives from ``io.split.InputSplit``; ``next_batch(n)`` on every
split type (line, RecordIO, indexed in each shuffle mode, single file,
threaded, cached, macro-shuffled, leased and live-stream splits) gives the
JAX split's records, and only the indexed splits and the leased source
honour the count; ``hint_chunk_size`` reaches the base through the
wrappers; iterating a split gives its records; the indexed split's
counters after a ``next_batch`` drain are the JAX test's."""

import numpy as np
import pytest

from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu.stream import StreamSource as JaxSource
from dmlc_core_tpu.stream import StreamWriter as JaxWriter
from dmlc_core_tpu_torch.io import split
from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter, RecordIOWriter
from dmlc_core_tpu_torch.io.stream import FileStream
from dmlc_core_tpu_torch.staging import fused
from dmlc_core_tpu_torch.stream import StreamSource
from dmlc_core_tpu_torch.telemetry import default_registry

from test_torch_shardsvc import close_tracker, start_tracker

N_RECORDS = 700


def record(rng, i: int) -> bytes:
    return b"%05d|" % i + rng.integers(0, 256, int(rng.integers(1, 90)),
                                       dtype=np.uint8).tobytes()


@pytest.fixture
def files(tmp_path):
    """A text file, a RecordIO file and an indexed RecordIO file with its
    index, the same seeded records in each."""
    rng = np.random.default_rng(11)
    recs = [record(rng, i) for i in range(N_RECORDS)]
    text = tmp_path / "lines.txt"
    text.write_bytes(b"".join(b"%d %s\n" % (i, r.hex().encode()) for i, r in enumerate(recs)))
    rec = str(tmp_path / "plain.rec")
    with FileStream(rec, "w") as f:
        w = RecordIOWriter(f)
        for r in recs:
            w.write_record(r)
    irec = str(tmp_path / "indexed.rec")
    with FileStream(irec, "w") as f, FileStream(irec + ".idx", "w") as fi:
        w = IndexedRecordIOWriter(f, fi)
        for i, r in enumerate(recs):
            w.write_record(r, i)
        w.flush_block()
    return {"text": str(text), "rec": rec, "irec": irec, "tmp": tmp_path}


def make(pkg, kind, files):
    """Split ``kind`` of package ``pkg`` over the fixture's files."""
    mod = split if pkg == "port" else jax_split
    text, rec, irec = files["text"], files["rec"], files["irec"]
    if kind == "line":
        return mod.LineSplitter(text, 0, 1)
    if kind == "line_part":
        return mod.LineSplitter(text, 1, 3)
    if kind == "recordio":
        return mod.RecordIOSplitter(rec, 0, 1)
    if kind == "recordio_part":
        return mod.RecordIOSplitter(rec, 2, 3)
    if kind == "single_file":
        return mod.SingleFileSplit(text)
    if kind == "threaded":
        return mod.create(text, type="text")
    if kind == "cached":
        return mod.create(text + "#" + str(files["tmp"] / f"{pkg}.cache"), type="text")
    if kind == "macro_shuffle":
        return mod.create(text + "?shuffle_parts=3&seed=2", type="text", threaded=False)
    if kind.startswith("indexed"):
        mode = kind.split("_", 1)[1] if "_" in kind else ""
        q = f"?index={irec}.idx&seed=4" + (f"&shuffle={mode}" if mode else "")
        return mod.create(irec + q, type="recordio", threaded=False)
    raise AssertionError(kind)


STATIC_KINDS = ["line", "line_part", "recordio", "recordio_part", "single_file",
                "threaded", "cached", "macro_shuffle"]
INDEXED_KINDS = ["indexed", "indexed_record", "indexed_batch", "indexed_window"]


def batches(sp, n):
    """The split's ``next_batch(n)`` drain, each chunk cut into records."""
    out = []
    while True:
        chunk = sp.next_batch(n)
        if chunk is None:
            return out
        out.append(list(sp.extract_records(chunk)))


@pytest.mark.parametrize("kind", STATIC_KINDS + INDEXED_KINDS)
@pytest.mark.parametrize("n", [1, 37])
def test_next_batch_gives_the_jax_records(files, kind, n):
    got, want = make("port", kind, files), make("jax", kind, files)
    assert isinstance(got, split.InputSplit)
    port, jax = batches(got, n), batches(want, n)
    got.close()
    want.close()
    flat = [r for b in port for r in b]
    assert flat == [r for b in jax for r in b]
    assert len(flat) > 0
    if kind.startswith("indexed"):
        # the count is honoured: n records a batch, the last one short
        assert [len(b) for b in port] == [len(b) for b in jax]
        assert all(len(b) == n for b in port[:-1])


@pytest.mark.parametrize("kind", STATIC_KINDS)
def test_next_batch_forwards_to_next_chunk(files, kind):
    a, b = make("port", kind, files), make("port", kind, files)
    assert list(iter(lambda: a.next_batch(5), None)) == list(iter(b.next_chunk, None))
    a.close()
    b.close()


@pytest.mark.parametrize("mode", ["", "record", "batch", "window"])
@pytest.mark.parametrize("n", [1, 64, 1000])
def test_indexed_next_batch_equals_next_batch_ex(files, mode, n):
    kind = "indexed_" + mode if mode else "indexed"
    a, b, j = make("port", kind, files), make("port", kind, files), make("jax", kind, files)
    got = list(iter(lambda: a.next_batch(n), None))
    assert got == list(iter(lambda: b.next_batch_ex(n), None))
    assert got == list(iter(lambda: j.next_batch(n), None))
    for sp in (a, b, j):
        sp.close()


@pytest.mark.parametrize("kind", STATIC_KINDS + INDEXED_KINDS)
def test_iterating_a_split_gives_the_jax_records(files, kind):
    got, want = make("port", kind, files), make("jax", kind, files)
    assert list(got) == list(want)
    got.close()
    want.close()


def test_every_split_class_is_an_input_split():
    for cls in (split.InputSplitBase, split.LineSplitter, split.RecordIOSplitter,
                split.IndexedRecordIOSplitter, split.SingleFileSplit,
                split.ThreadedInputSplit, split.CachedInputSplit, split.InputSplitShuffle,
                split.DynamicShardSource, StreamSource, fused.LegacyIndexedSplit,
                fused.PlainBlockSplit):
        assert issubclass(cls, split.InputSplit), cls
    base = split.InputSplit()
    for call in (base.next_chunk, base.next_record, base.before_first, base.total_size,
                 lambda: base.reset_partition(0, 1), lambda: base.extract_records(b"")):
        with pytest.raises(NotImplementedError):
            call()
    base.hint_chunk_size(4096)
    base.close()


@pytest.mark.parametrize("kind", ["threaded", "cached", "macro_shuffle"])
def test_wrappers_forward_hint_chunk_size(files, kind):
    sp = make("port", kind, files)
    inner = sp._base
    inner = getattr(inner, "_base", inner)
    sp.hint_chunk_size(2048)
    assert inner.buffer_size == 2048
    sp.hint_chunk_size(10)  # the base's floor
    assert inner.buffer_size == 1024
    sp.close()


def test_single_file_hint_is_a_no_op_as_jax(files):
    for mod in (split, jax_split):
        sp = mod.SingleFileSplit(files["text"])
        sp.hint_chunk_size(16)
        assert sum(len(list(sp.extract_records(c)))
                   for c in iter(sp.next_chunk, None)) == N_RECORDS
        sp.close()


def test_indexed_next_batch_counters_as_jax(files):
    """The JAX telemetry test's drain: 32 records by ``next_batch(8)``
    under ``shuffle=record``; the split's counters and the registry's
    deltas agree, and equal the JAX split's."""
    stats = {}
    for name, mod in (("port", split), ("jax", jax_split)):
        w_rec = str(files["tmp"] / f"small_{name}.rec")
        with FileStream(w_rec, "w") as f, FileStream(w_rec + ".idx", "w") as fi:
            w = IndexedRecordIOWriter(f, fi)
            for i in range(32):
                w.write_record(np.int32(i).tobytes() * 3, key=i)
        before = default_registry().snapshot()["counters"]
        s = mod.create(f"{w_rec}?index={w_rec}.idx", type="recordio", shuffle="record",
                       threaded=False, seed=3)
        while s.next_batch(8) is not None:
            pass
        stats[name] = s.io_stats()
        s.close()
        if name == "port":
            after = default_registry().snapshot()["counters"]
            for key, counter in (("records", "io.split.records"), ("spans", "io.split.spans"),
                                 ("bytes_read", "io.split.bytes_read")):
                assert after[counter] - before.get(counter, 0) == stats[name][key]
    assert stats["port"]["records"] == 32
    for key in ("mode", "records", "bytes_read"):
        assert stats["port"][key] == stats["jax"][key], key


@pytest.mark.parametrize("n", [1, 50])
def test_leased_next_batch_pulls_under_the_lease_as_jax(files, monkeypatch, n):
    """``DynamicShardSource.next_batch`` under a tracker of each package:
    the records of a whole epoch equal the JAX source's, every batch at
    most ``n`` records, every micro-shard leased and recorded once."""
    irec = files["irec"]
    uri = f"{irec}?index={irec}.idx&seed=5&dynamic_shards=1"
    drains, stats = {}, {}
    for pkg, mod in (("jax", jax_split), ("port", split)):
        t = start_tracker(pkg, 1, monkeypatch)
        try:
            src = mod.create(uri, type="recordio", threaded=False)
            assert isinstance(src, mod.InputSplit)
            drains[pkg] = batches(src, n)
            stats[pkg] = src.io_stats()
            src.close()
        finally:
            close_tracker(t)
    flat = [r for b in drains["port"] for r in b]
    assert flat == [r for b in drains["jax"] for r in b] and len(flat) == N_RECORDS
    assert max(len(b) for b in drains["port"]) <= n
    assert stats["port"]["leases"] == stats["port"]["shards_recorded"] == 4
    assert stats["port"]["shards_duplicate"] == 0


@pytest.mark.parametrize("n", [1, 33])
def test_stream_source_next_batch_as_jax(tmp_path, n):
    d = str(tmp_path)
    rng = np.random.default_rng(8)
    recs = [record(rng, i) for i in range(300)]
    with JaxWriter(d, codec="zlib", block_bytes=512, rotate_bytes=4096,
                   commit_records=30) as w:
        for r in recs:
            w.append(r)
    got = {}
    for name, cls in (("port", StreamSource), ("jax", JaxSource)):
        src = cls(d, shuffle="window", seed=2, window=40)
        assert name == "jax" or isinstance(src, split.InputSplit)
        got[name] = batches(src, n)
        src.close()
    assert got["port"] == got["jax"]
    assert sorted(r for b in got["port"] for r in b) == sorted(recs)


# -- split → producer → pipeline: the io_stats plumbing and staging helpers ----


def test_pipeline_io_stats_carry_the_split_counters(files):
    """A plain producer over an indexed, shuffled split staged on the CPU:
    ``StagingPipeline.io_stats()`` is the producer's split counters (the
    JAX generic stream's, over the same split) with ``"staging"`` beside."""
    from dmlc_core_tpu.staging import BatchSpec as JaxSpec
    from dmlc_core_tpu.staging import FixedShapeBatcher as JaxBatcher
    from dmlc_core_tpu.staging.fused import _GenericBatchStream as JaxStream
    from dmlc_core_tpu.data import RowRecParser as JaxRowRec
    from dmlc_core_tpu_torch.data import RowRecParser
    from dmlc_core_tpu_torch.staging import BatchSpec, FixedShapeBatcher, StagingPipeline

    rec = str(files["tmp"] / "rows.rec")
    rng = np.random.default_rng(12)
    with FileStream(rec, "w") as f, FileStream(rec + ".idx", "w") as fi:
        from dmlc_core_tpu_torch.data.rowrec import encode_row

        w = IndexedRecordIOWriter(f, fi)
        for i in range(500):
            k = int(rng.integers(1, 6))
            w.write_record(encode_row(float(i % 2), rng.integers(0, 100, k),
                                      rng.normal(size=k).astype(np.float32)), i)
        w.flush_block()
    uri = f"{rec}?index={rec}.idx&shuffle=record&seed=3"
    src = fused.GenericBatchStream(
        RowRecParser(split.create(uri, type="recordio", threaded=False)),
        FixedShapeBatcher(BatchSpec(batch_size=64, max_nnz=8)))
    pipe = StagingPipeline(src, device="cpu")
    n = sum(int(b["weights"].gt(0).sum()) for b in pipe)
    stats = pipe.io_stats()
    pipe.close()
    src_stats = src.io_stats()
    src.close()
    jax_src = JaxStream(JaxRowRec(jax_split.create(uri, type="recordio", threaded=False)),
                        JaxBatcher(JaxSpec(batch_size=64, max_nnz=8)))
    assert sum(b.n_valid for b in jax_src) == n == 500
    jax_stats = jax_src.io_stats()
    jax_src.close()
    staging = stats.pop("staging")
    assert staging["packed_batches"] + staging["per_array_batches"] == 8
    assert stats == src_stats
    for key in ("mode", "records", "bytes_read"):
        assert stats[key] == jax_stats[key], key


def test_gather_slices_and_batch_size_equal_jax():
    from dmlc_core_tpu.staging.batcher import gather_slices as jax_gather
    from dmlc_core_tpu_torch.staging import Batch, gather_slices

    rng = np.random.default_rng(13)
    buf = rng.integers(0, 256, 10000, dtype=np.uint8)
    for n in (0, 1, 17, 300):
        sizes = rng.integers(0, 40, n)
        starts = rng.integers(0, len(buf) - 40, n)
        got = gather_slices(buf, starts, sizes)
        assert got.dtype == np.uint8 and got.tobytes() == jax_gather(buf, starts,
                                                                      sizes).tobytes()
        assert got.tobytes() == b"".join(buf[s:s + z].tobytes()
                                         for s, z in zip(starts, sizes))
    b = Batch(labels=np.zeros(96, np.float32), weights=np.ones(96, np.float32), n_valid=90)
    assert b.batch_size == 96


def test_device_put_places_a_tree_with_no_fallback(monkeypatch):
    import torch

    from dmlc_core_tpu_torch.staging import device_put
    from dmlc_core_tpu_torch.utils.logging import Error

    rng = np.random.default_rng(14)
    tree = {"w": rng.normal(size=5).astype(np.float32),
            "v": [torch.arange(6).reshape(2, 3), (np.int64(3), 2.5)],
            "t": np.arange(12, dtype=np.int32).reshape(3, 4)[:, ::2]}
    got = device_put(tree, "cpu")
    assert isinstance(got["w"], torch.Tensor) and got["w"].dtype == torch.float32
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])
    assert torch.equal(got["v"][0], tree["v"][0])
    assert isinstance(got["v"][1], tuple) and got["v"][1][0].item() == 3
    np.testing.assert_array_equal(got["t"].numpy(), tree["t"])
    with pytest.raises(Error, match="cannot place"):
        device_put({"x": "text"}, "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Error, match="torch.cuda.is_available"):
        device_put(tree)
