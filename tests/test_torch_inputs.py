"""The port's file sets, read-ahead and cached splits, and its producers
over compressed, multi-file and ``#cachefile`` inputs, against the JAX
package's on the CPU.

The multi-file, directory, regex, threaded and cached cases of
tests/test_split.py run on both packages (records and chunks equal, bit
for bit); ``ell_batches``/``dense_batches`` over a compressed rowrec file
(1 and 3 parts, 4 threads, every shuffle mode), over a file set and over
a ``#cachefile`` give the JAX fused producers' batches byte for byte; a
cache file written by either package replays in the other; and every
thread these splits start ends on ``close()``.
"""

import os
import threading
import types

import numpy as np
import pytest

from dmlc_core_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_core_tpu.data.rowrec import write_rowrec as jax_write_rowrec
from dmlc_core_tpu.io import codec as jax_codec
from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu.io.stream import FileStream as JaxFileStream
from dmlc_core_tpu.staging import BatchSpec as JaxSpec
from dmlc_core_tpu.staging import dense_batches as jax_dense_batches
from dmlc_core_tpu.staging import ell_batches as jax_ell_batches
from dmlc_core_tpu.utils.logging import Error as JaxError
from dmlc_core_tpu_torch.io import codec
from dmlc_core_tpu_torch.io import split
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import dense_batches, ell_batches, plain_batches
from dmlc_core_tpu_torch.utils.logging import Error

from test_torch_fused import assert_same_stream, snapshot, text_rows

THREADS = ("codec-decode", "split-prefetch", "split-cache", "split-window-readahead",
           "fused-shard")
B, K, D = 32, 7, 24


# telemetry's threads (metrics endpoints, the reporter, the time-series
# sampler) start lazily; one that a test starts must end with it
TELEMETRY_THREADS = ("metrics-http", "telemetry-reporter", "telemetry-timeseries")


@pytest.fixture(autouse=True)
def no_thread_left_behind():
    before = set(threading.enumerate())
    yield
    started = [t for t in threading.enumerate()
               if t.name.startswith(TELEMETRY_THREADS) and t not in before]
    for t in started:
        t.join(timeout=5.0)
    assert not [t.name for t in started if t.is_alive()]
    codec.shutdown_decode_pool()
    if jax_codec._POOL is not None:  # the reference's pool shares the name
        jax_codec._POOL.shutdown(wait=True)
        jax_codec._POOL = None
    left = [t for t in threading.enumerate() if t.name.startswith(THREADS)]
    for t in left:
        t.join(timeout=5.0)
    assert not [t.name for t in left if t.is_alive()]


def write_files(root, files):
    out = []
    for name, body in files.items():
        p = os.path.join(str(root), name)
        with open(p, "wb") as f:
            f.write(body)
        out.append(p)
    return out


def records(s):
    out = []
    try:
        while (r := s.next_record()) is not None:
            out.append(bytes(r))
    finally:
        s.close()
    return out


def chunks(s):
    out = []
    try:
        while (c := s.next_chunk()) is not None:
            out.append(bytes(c))
    finally:
        s.close()
    return out


# -- file sets ------------------------------------------------------------------
def test_line_split_noeol_multifile_join(tmp_path):
    write_files(tmp_path, {"a.txt": b"a1\na2", "b.txt": b"b1\nb2\n"})
    uri = f"{tmp_path}/a.txt;{tmp_path}/b.txt"
    assert records(split.LineSplitter(uri, 0, 1)) == [b"a1", b"a2", b"b1", b"b2"]
    assert chunks(split.LineSplitter(uri)) == chunks(jax_split.LineSplitter(uri, 0, 1))


@pytest.mark.parametrize("nsplit", [1, 2, 3, 5, 8])
def test_line_split_distributed_matches_jax(tmp_path, nsplit):
    """Five files, EOL and NOEOL mixed, read as ``nsplit`` parts: every
    part's chunks and bounds equal the JAX package's, and each line
    lands in one part."""
    lines = [f"line-{i:03d}".encode() for i in range(37)]
    files, k = {}, 0
    for fi, cnt in enumerate([7, 9, 3, 11, 7]):
        body = b"\n".join(lines[k:k + cnt]) + (b"\n" if fi % 2 == 0 else b"")
        files[f"part{fi}.txt"] = body
        k += cnt
    uri = ";".join(write_files(tmp_path, files))
    got = []
    for rank in range(nsplit):
        port = split.LineSplitter(uri, rank, nsplit)
        jax = jax_split.LineSplitter(uri, rank, nsplit)
        port.buffer_size = jax.buffer_size = 32
        assert (port.offset_begin, port.offset_end) == (jax.offset_begin, jax.offset_end)
        got_chunks = chunks(port)
        assert got_chunks == chunks(jax)
        got += [r for c in got_chunks for r in port.extract_records(c)]
    assert sorted(got) == sorted(lines)


def test_line_split_directory_and_regex_uris(tmp_path):
    write_files(tmp_path, {"d0.txt": b"a\n", "d1.txt": b"b\n", "other.csv": b"c\n",
                           "empty.txt": b""})
    os.mkdir(tmp_path / "sub")
    write_files(tmp_path / "sub", {"z.txt": b"z\n"})
    for uri in (str(tmp_path), os.path.join(str(tmp_path), r"d.\.txt")):
        got = records(split.create(uri, type="text"))
        assert got == records(jax_split.create(uri, type="text"))
        assert sorted(got) == ([b"a", b"b", b"c"] if uri == str(tmp_path) else [b"a", b"b"])
    deep = records(split.create(str(tmp_path), type="text", recurse_directories=True))
    assert deep == records(jax_split.create(str(tmp_path), type="text",
                                            recurse_directories=True))
    assert b"z" in deep
    with pytest.raises(Error, match="Cannot find any files"):
        split.LineSplitter(str(tmp_path / "nothing-here.txt"))


def test_recordio_split_multifile(tmp_path):
    from dmlc_core_tpu_torch.io.recordio import RecordIOWriter

    paths = []
    for name in "ab":
        p = tmp_path / f"{name}.rec"
        with open(p, "wb") as f:
            w = RecordIOWriter(f)
            for i in range(10):
                w.write_record(f"{name}{i}".encode() * (i + 1))
        paths.append(str(p))
    uri = ";".join(paths)
    got = []
    for rank in range(2):
        port = records(split.RecordIOSplitter(uri, rank, 2))
        assert port == records(jax_split.RecordIOSplitter(uri, rank, 2))
        got += port
    assert got == [f"{n}{i}".encode() * (i + 1) for n in "ab" for i in range(10)]


# -- wrappers -------------------------------------------------------------------
def test_threaded_input_split_prefetch(tmp_path):
    lines = [f"t{i}".encode() for i in range(100)]
    (p,) = write_files(tmp_path, {"a.txt": b"\n".join(lines) + b"\n"})
    s = split.ThreadedInputSplit(split.LineSplitter(p, 0, 1))
    try:
        assert [s.next_record() for _ in lines] == lines
        assert s.next_record() is None
        s.before_first()
        assert s.next_record() == lines[0]  # a consumer that stops mid-epoch
    finally:
        s.close()


def test_threaded_split_keeps_capacity_across_reset(tmp_path):
    (p,) = write_files(tmp_path, {"a.txt": b"a\nb\nc\n"})
    s = split.ThreadedInputSplit(split.LineSplitter(p, 0, 1), max_capacity=8)
    s.reset_partition(0, 1)
    assert s.max_capacity == 8
    assert records(s) == [b"a", b"b", b"c"]


def test_threaded_chunks_equal_the_bare_splits(tmp_path):
    body = text_rows("libsvm", 300, seed=4)
    (p,) = write_files(tmp_path, {"a.svm": body})
    for parts in (1, 3):
        for i in range(parts):
            bare = split.create(p, i, parts, type="text", threaded=False)
            threaded = split.create(p, i, parts, type="text")
            assert isinstance(threaded, split.ThreadedInputSplit)
            bare.hint_chunk_size(1024)
            threaded.hint_chunk_size(1024)
            assert chunks(threaded) == chunks(bare)


def replay_with_jax(cache):
    """The chunks the JAX package's CachedInputSplit replays from
    ``cache`` (its replay generator; its constructor would start a new
    build at once)."""
    return list(jax_split.CachedInputSplit._produce_cached(
        types.SimpleNamespace(_cache_file=cache)))


def test_cached_input_split_replays_and_crosses_packages(tmp_path):
    lines = [f"c{i}".encode() for i in range(50)]
    (p,) = write_files(tmp_path, {"a.txt": b"\n".join(lines) + b"\n"})
    for Cached, Line, name in ((split.CachedInputSplit, split.LineSplitter, "port"),
                               (jax_split.CachedInputSplit, jax_split.LineSplitter, "jax")):
        s = Cached(Line(p, 0, 1), str(tmp_path / f"{name}.cache"))
        assert [s.next_record() for _ in lines] == lines and s.next_record() is None
        s.close()
    assert (tmp_path / "port.cache").read_bytes() == (tmp_path / "jax.cache").read_bytes()
    assert b"".join(replay_with_jax(str(tmp_path / "port.cache"))) == open(p, "rb").read()
    # the port's split replays the JAX package's cache once it is complete
    o = split.CachedInputSplit(split.LineSplitter(p, 0, 1), str(tmp_path / "jax.cache"))
    o._cache_complete = True
    assert records(o) == lines and o.epochs_replayed == 1
    s = split.CachedInputSplit(split.ThreadedInputSplit(split.LineSplitter(p, 0, 1)),
                               str(tmp_path / "c2"))
    try:
        assert [s.next_record() for _ in lines] == lines and s.next_record() is None
        os.unlink(p)  # the second epoch reads the cache, not the source
        s.before_first()
        assert [s.next_record() for _ in lines] == lines
        assert s.io_stats()["cache_epochs_replayed"] == 1
    finally:
        s.close()


def test_create_factory_with_cache_sugar(tmp_path):
    lines = [f"f{i}".encode() for i in range(20)]
    (p,) = write_files(tmp_path, {"a.txt": b"\n".join(lines) + b"\n"})
    cache = str(tmp_path / "cc")
    s = split.create(f"{p}#{cache}", 0, 1, "text")
    assert isinstance(s, split.CachedInputSplit)
    assert records(s) == lines and os.path.exists(cache)
    s2 = split.create(p, 0, 1, "text")
    assert isinstance(s2, split.ThreadedInputSplit)
    assert records(s2) == lines
    sharded = split.create(f"{p}#{cache}", 1, 2, "text")
    assert records(sharded) == records(jax_split.create(f"{p}#{cache}j", 1, 2, "text"))
    assert os.path.exists(f"{cache}.split2.part1")
    for bad, match in (("parquet", "unknown InputSplit type"),
                       ("indexed_recordio", "index_uri")):
        with pytest.raises(Error, match=match) as e:
            split.create(p, 0, 1, bad)
        with pytest.raises(JaxError) as je:
            jax_split.create(p, 0, 1, bad)
        assert str(e.value) == str(je.value)


def test_create_shuffle_with_cache_rejected(tmp_path):
    (p,) = write_files(tmp_path, {"a.txt": b"a\nb\n"})
    for uri, kw in ((f"{p}#cache", {"num_shuffle_parts": 2}),
                    (f"{p}?shuffle_parts=2#cache", {})):
        with pytest.raises(Error, match="freeze") as e:
            split.create(uri, 0, 1, "text", **kw)
        with pytest.raises(JaxError) as je:
            jax_split.create(uri, 0, 1, "text", **kw)
        assert str(e.value) == str(je.value)
    rec = tmp_path / "r.rec"
    idx = tmp_path / "r.idx"
    with JaxFileStream(str(rec), "w") as f, JaxFileStream(str(idx), "w") as fi:
        jax_write_rowrec(f, [JaxRowBlock(offset=np.array([0, 1]), label=np.zeros(1, np.float32),
                                         index=np.zeros(1, np.uint32))], index_stream=fi)
    uri = f"{rec}?index={idx}&shuffle=batch#{tmp_path / 'c'}"
    with pytest.raises(Error, match="freeze") as e:
        split.create(uri, type="recordio")
    with pytest.raises(JaxError) as je:
        jax_split.create(uri, type="recordio")
    assert str(e.value) == str(je.value)


def test_reset_partition_to_empty_clears_state(tmp_path):
    (p,) = write_files(tmp_path, {"a.txt": b"l1\nl2\nl3\nl4\n"})
    s = split.LineSplitter(p, 0, 1)
    assert s.next_record() == b"l1"
    s.reset_partition(5, 6)  # an empty byte range
    assert s.next_record() is None
    s.close()


def test_single_file_split_reads_a_file_and_stdin(tmp_path, monkeypatch):
    import io
    import sys

    (p,) = write_files(tmp_path, {"a.txt": b"x\r\ny\n\nz"})
    assert records(split.SingleFileSplit(p)) == records(jax_split.SingleFileSplit(p))
    assert records(split.SingleFileSplit(p)) == [b"x", b"y", b"z"]

    class Stdin:
        buffer = io.BytesIO(b"s1\ns2")

    monkeypatch.setattr(sys, "stdin", Stdin)
    s = split.create("-", type="text")
    assert isinstance(s, split.SingleFileSplit)
    try:
        assert [s.next_record(), s.next_record(), s.next_record()] == [b"s1", b"s2", None]
        with pytest.raises(Error, match="cannot rewind stdin"):
            s.before_first()
    finally:
        s.close()


def test_close_ends_threads_of_a_consumer_that_stops_mid_epoch(tmp_path):
    body = text_rows("libsvm", 2000, seed=9)
    (p,) = write_files(tmp_path, {"a.svm": body})
    s = split.create(p, type="text")
    s.hint_chunk_size(1024)  # many chunks: the queue fills and the thread waits
    assert s.next_chunk() is not None
    c = split.create(f"{p}#{tmp_path / 'cache'}", type="text")
    assert c.next_record() is not None
    s.close()
    c.close()
    assert not [t for t in threading.enumerate() if t.name.startswith("split-")]


# -- producers over compressed rowrec -----------------------------------------------
def write_rowrec_file(path, n, seed, codec_name=None, block_bytes=None, index=True):
    """Rowrec rows (0..K+3 features, magic-valued floats, ids past int32)
    written by the JAX package, compressed with ``codec_name``."""
    from dmlc_core_tpu.io.recordio import IndexedRecordIOWriter, RecordIOWriter

    from test_torch_fused import MAGIC_F32

    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, K + 4, n)
    offset = np.r_[0, np.cumsum(nnz)].astype(np.int64)
    value = rng.normal(size=int(offset[-1])).astype(np.float32)
    value[::29] = MAGIC_F32
    index_ = rng.integers(0, 5000, int(offset[-1])).astype(np.uint64)
    index_[::31] = 1 << 33
    blk = JaxRowBlock(offset=offset, label=rng.integers(0, 2, n).astype(np.float32),
                      index=index_, value=value,
                      weight=rng.uniform(0.5, 2, n).astype(np.float32))
    from dmlc_core_tpu.data.rowrec import encode_rows

    kw = {"codec": codec_name} if codec_name else {}
    if block_bytes:
        kw["block_bytes"] = block_bytes
    with JaxFileStream(str(path), "w") as f, JaxFileStream(f"{path}.idx", "w") as fi:
        w = IndexedRecordIOWriter(f, fi, **kw) if index else RecordIOWriter(f, **kw)
        for payload in encode_rows(blk):
            w.write_record(payload)
        w.flush()
    return str(path)


def assert_same_plain(got, plain):
    """The batches of a plain version (which counts no ``rows_out``)."""
    batches, counters = snapshot(plain)
    assert_same_stream((got[0], got[1][:1]), (batches, counters[:1]))


@pytest.fixture(scope="module")
def rowrec_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("rowrec")
    return {name: write_rowrec_file(root / f"{name}.rec", 700, seed=3, codec_name=name,
                                    block_bytes=2048)
            for name in (None, "zlib", "gzip")}


@pytest.mark.parametrize("name", ["zlib", "gzip"])
@pytest.mark.parametrize("parts,nthread", [(1, None), (3, None), (1, 4)])
def test_sequential_compressed_rowrec_matches_jax(rowrec_files, name, parts, nthread):
    """A compressed rowrec file takes the split route: its batches equal
    the JAX fused producer's on the same file, and, for one part on one
    thread, the uncompressed file's; the plain version decodes each
    block with ``decode_block``."""
    rec = rowrec_files[name]
    for vdt in (np.float32, np.float16):
        spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=vdt)
        jspec = JaxSpec(batch_size=B, max_nnz=K, value_dtype=vdt)
        for part in range(parts):
            got = snapshot(ell_batches(rec, spec, part, parts, nthread=nthread))
            assert_same_stream(got, snapshot(jax_ell_batches(rec, jspec, part, parts,
                                                             nthread=nthread)))
            if nthread is None:
                assert_same_plain(got, plain_batches(rec, spec, part, parts))
            if parts == 1 and nthread is None:
                assert_same_stream(got, snapshot(ell_batches(rowrec_files[None], spec)))


@pytest.mark.parametrize("mode", ["0", "record", "batch", "window", "legacy", "parts"])
@pytest.mark.parametrize("parts,nthread", [(1, None), (3, None), (1, 4)])
def test_indexed_compressed_rowrec_matches_jax_and_uncompressed(rowrec_files, mode, parts,
                                                                nthread):
    q = {"0": "", "legacy": "&shuffle=record&legacy_shuffle=1",
         "parts": "&shuffle=window&window=50&shuffle_parts=2"}.get(mode, f"&shuffle={mode}")
    q += "&seed=3&batch_size=32&window=96"
    spec = BatchSpec(batch_size=B, max_nnz=K)
    jspec = JaxSpec(batch_size=B, max_nnz=K)
    for part in range(parts):
        uri = f"{rowrec_files['zlib']}?index={rowrec_files['zlib']}.idx{q}"
        v1 = f"{rowrec_files[None]}?index={rowrec_files[None]}.idx{q}"
        src = ell_batches(uri, spec, part, parts, nthread=nthread)
        got = snapshot(src)
        assert_same_stream(got, snapshot(jax_ell_batches(uri, jspec, part, parts,
                                                         nthread=nthread)))
        assert_same_stream(got, snapshot(ell_batches(v1, spec, part, parts, nthread=nthread)))
        if nthread is None and mode != "parts":
            assert_same_plain(got, plain_batches(uri, spec, part, parts))
        stats = src.io_stats()
        if mode not in ("0", "legacy"):
            assert stats["gather_fallback_batches"] == 0 and stats["gather_batches"] > 0
        assert stats["decode_cache_hits"] + stats["decode_cache_misses"] > 0


def test_compressed_block_mid_v1_file_raises_with_the_cause(tmp_path, rowrec_files):
    """Past the 4 MiB head that picks the route, a compressed block in a
    v1 file stops the mmap route with the JAX package's reason."""
    v1 = open(rowrec_files[None], "rb").read()
    zipped = open(rowrec_files["zlib"], "rb").read()
    pad = (5 << 20) // len(v1) + 1
    mixed = tmp_path / "mixed.rec"
    mixed.write_bytes(v1 * pad + zipped)
    spec = BatchSpec(batch_size=B, max_nnz=K)
    with pytest.raises(Error, match="compressed RecordIO block mid-file; the mmap fast path"):
        list(ell_batches(str(mixed), spec))
    with pytest.raises(Exception, match="compressed RecordIO block mid-file; the mmap fast path"):
        list(jax_ell_batches(str(mixed), JaxSpec(batch_size=B, max_nnz=K)))


# -- producers over file sets and a #cachefile ----------------------------------------------
@pytest.fixture(scope="module")
def text_sets(tmp_path_factory):
    """libsvm and csv rows, whole and cut into four files at line ends."""
    root = tmp_path_factory.mktemp("text")
    out = {}
    for fmt in ("libsvm", "csv"):
        body = text_rows(fmt, 400, seed=5)[3:]  # no BOM: a file set has no one head
        whole = root / f"whole.{fmt}"
        whole.write_bytes(body)
        lines = body.splitlines(keepends=True)
        cut = [0, 90, 200, 310, len(lines)]
        d = root / f"set_{fmt}"
        d.mkdir()
        for i in range(4):
            (d / f"part-{i}").write_bytes(b"".join(lines[cut[i]:cut[i + 1]]))
        out[fmt] = (str(whole), str(d))
    return out


def make(fmt, uri, spec_kind, parts=1, part=0, nthread=None, port=True, cache=""):
    q = "?format=csv&label_column=0" if fmt == "csv" else "?format=libsvm"
    q += f"#{cache}" if cache else ""
    if spec_kind == "ell":
        spec = (BatchSpec if port else JaxSpec)(batch_size=B, max_nnz=K)
        return (ell_batches if port else jax_ell_batches)(uri + q, spec, part, parts,
                                                          nthread=nthread)
    spec = (BatchSpec if port else JaxSpec)(batch_size=B, layout="dense", num_features=D)
    return (dense_batches if port else jax_dense_batches)(uri + q, spec, part, parts,
                                                          nthread=nthread)


@pytest.mark.parametrize("fmt,kind", [("libsvm", "ell"), ("libsvm", "dense"), ("csv", "dense")])
@pytest.mark.parametrize("form", ["dir", "regex", "list"])
def test_file_set_batches_match_jax_and_the_one_file(text_sets, fmt, kind, form):
    whole, d = text_sets[fmt]
    uri = {"dir": d, "regex": f"{d}/part-.*",
           "list": ";".join(f"{d}/part-{i}" for i in range(4))}[form]
    got = snapshot(make(fmt, uri, kind))
    assert_same_stream(got, snapshot(make(fmt, uri, kind, port=False)))
    assert_same_stream(got, snapshot(make(fmt, whole, kind)))
    for parts, nthread in ((3, None), (1, 3)):
        for part in range(parts):
            assert_same_stream(snapshot(make(fmt, uri, kind, parts, part, nthread)),
                               snapshot(make(fmt, uri, kind, parts, part, nthread, False)))


@pytest.mark.parametrize("kind", ["ell", "dense"])
def test_cachefile_batches_replay_in_the_second_epoch(text_sets, tmp_path, kind):
    whole, _ = text_sets["libsvm"]
    cache = tmp_path / "svm.cache"
    src = make("libsvm", whole, kind, cache=cache)
    epoch1 = [(b.n_valid, b.packed.copy()) for b in src]
    assert cache.exists() and src.io_stats()["cache_epochs_replayed"] == 0
    epoch2 = [(b.n_valid, b.packed.copy()) for b in src]
    assert src.io_stats()["cache_epochs_replayed"] == 1
    src.close()
    want = snapshot(make("libsvm", whole, kind, port=False))[0]
    for got in (epoch1, epoch2):
        assert [n for n, _ in got] == [n for n, _k, _p in want]
        assert all(np.array_equal(g, w) for (_n, g), (_wn, _wk, w) in zip(got, want))
    # the producer's cache replays in the JAX package
    assert b"".join(replay_with_jax(str(cache))) == open(whole, "rb").read()
