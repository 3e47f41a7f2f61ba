"""The port's native producers against the JAX package's fused producers,
on the CPU: every batch of ``ell_batches`` (rowrec, libsvm, libfm; rowrec
also over indexed URIs in every shuffle mode) and ``dense_batches``
(libsvm, csv), f16 and f32, one part and three, one thread and three,
equal byte for byte with ``truncated_nnz``, ``rows_out``
and the padded tails; the plain versions where the JAX tests compare the
generic path; chunk edges, corrupt input and refusals; and two whole
paths through ``StagingPipeline(device="cpu")`` against the JAX models:
HIGGS csv → dense → LogisticRegression (loss and parameters after 3 steps
within 1e-5 relative) and Criteo libsvm → ELL → FactorizationMachine
(tolerance of test_torch_slice.py: losses 1e-5 relative, parameters 1e-4
of max |param|)."""

import os

import jax
import numpy as np
import pytest

from dmlc_core_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_core_tpu.data.rowrec import write_rowrec as jax_write_rowrec
from dmlc_core_tpu.io.stream import FileStream
from dmlc_core_tpu.models import FactorizationMachine as JaxFM
from dmlc_core_tpu.models import LogisticRegression as JaxLogReg
from dmlc_core_tpu.staging import BatchSpec as JaxSpec
from dmlc_core_tpu.staging import dense_batches as jax_dense_batches
from dmlc_core_tpu.staging import ell_batches as jax_ell_batches
from dmlc_core_tpu_torch.convert import params_from_jax, params_to_numpy
from dmlc_core_tpu_torch.data import native
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.models import FactorizationMachine, LogisticRegression
from dmlc_core_tpu_torch.staging import fused
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import (
    EllRowRecBatches,
    GenericBatchStream,
    ShardedFusedBatches,
    dense_batches,
    ell_batches,
    plain_batches,
)
from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close
from dmlc_core_tpu_torch.utils.logging import Error

B, K, D = 64, 7, 24
MAGIC_F32 = np.frombuffer(np.uint32(0xCED7230A).tobytes(), np.float32)[0]


def write_rec(path, n, seed, k=K, with_index=False):
    """Rowrec rows of 0..k+3 features (some wider than K), values with
    the RecordIO magic's bits (multipart chains) and ids past int32;
    with ``with_index``, also its ``.idx`` index."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, k + 4, n)
    offset = np.r_[0, np.cumsum(nnz)].astype(np.int64)
    value = rng.normal(size=int(offset[-1])).astype(np.float32)
    value[::29] = MAGIC_F32
    index = rng.integers(0, 5000, int(offset[-1])).astype(np.uint64)
    index[::31] = 1 << 33
    blk = JaxRowBlock(offset=offset, label=rng.integers(0, 2, n).astype(np.float32),
                      index=index, value=value,
                      weight=rng.uniform(0.5, 2, n).astype(np.float32))
    with FileStream(str(path), "w") as f:
        if with_index:
            with FileStream(f"{path}.idx", "w") as fi:
                jax_write_rowrec(f, [blk], index_stream=fi)
        else:
            jax_write_rowrec(f, [blk])
    return str(path)


def text_rows(fmt, n, seed, one_based=False):
    """Text rows with the cases the producers must agree on: a BOM, CRLF,
    comments, blank lines, qid, junk tokens, wide rows, ids >= D."""
    rng = np.random.default_rng(seed)
    lo = 1 if one_based else 0
    lines = []
    for i in range(n):
        label = f"{int(rng.integers(0, 2))}"
        if fmt == "csv":
            cells = [label] + [f"{rng.normal():.6g}" for _ in range(D + (i % 7 == 0))]
            if i % 9 == 0:
                cells[4] = "3.5junk"
            lines.append(",".join(cells) + ("\r\n" if i % 5 == 0 else "\n"))
            continue
        if i % 6 == 0:
            label += f":{rng.uniform(0.5, 2):.4g}"
        toks = [label]
        if fmt == "libsvm" and i % 7 == 0:
            toks.append(f"qid:{i}")
        for _ in range(int(rng.integers(0, K + 4))):
            j = int(rng.integers(lo, D + 3))
            v = f"{rng.normal():.5g}"
            if fmt == "libfm":
                toks.append(f"{int(rng.integers(lo, 4))}:{j}" + ("" if i % 4 == 0 else f":{v}"))
            else:
                toks.append(f"{j}" if i % 4 == 0 else f"{j}:{v}")
        if i % 10 == 0:
            toks.append("bad:tok:x")
        line = " ".join(toks)
        if fmt == "libsvm" and i % 8 == 0:
            line += " # comment"
        lines.append(line + ("\r\n" if i % 5 == 0 else "\n"))
        if i % 13 == 0:
            lines.append("\n")
    return b"\xef\xbb\xbf" + "".join(lines).encode()


def snapshot(stream):
    """Copies of a producer's batches as they are yielded (ring slots are
    recycled), then its counters; the stream is closed."""
    out = [(b.n_valid, tuple(b.as_dict()), b.packed.copy()) for b in stream]
    counters = (stream.truncated_nnz, getattr(stream, "rows_out", None))
    stream.close()
    return out, counters


def assert_same_stream(got, want):
    (gb, gc), (wb, wc) = got, want
    assert len(gb) == len(wb) > 0
    for (gn, gk, gp), (wn, wk, wp) in zip(gb, wb):
        assert (gn, gk) == (wn, wk)
        np.testing.assert_array_equal(gp, wp)
    assert gc == wc


def make_source(tmp_path, fmt, layout):
    """(uri, n_rows) of a file for ``fmt`` feeding ``layout``."""
    if fmt == "rowrec":
        return write_rec(tmp_path / "d.rec", 700, seed=1), 700
    ext = {"libsvm": "svm", "libfm": "fm", "csv": "csv"}[fmt]
    path = tmp_path / f"d.{ext}"
    path.write_bytes(text_rows(fmt, 700, seed=2))
    query = "?format=csv&label_column=0" if fmt == "csv" else f"?format={fmt}"
    return str(path) + query, 700


def specs(layout, vdtype):
    if layout == "ell":
        return (BatchSpec(batch_size=B, max_nnz=K, value_dtype=vdtype),
                JaxSpec(batch_size=B, layout="ell", max_nnz=K, value_dtype=np.dtype(vdtype)))
    return (BatchSpec(batch_size=B, layout="dense", num_features=D, value_dtype=vdtype),
            JaxSpec(batch_size=B, layout="dense", num_features=D, value_dtype=np.dtype(vdtype)))


@pytest.mark.parametrize("nthread", [None, 3])
@pytest.mark.parametrize("num_parts", [1, 3])
@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
@pytest.mark.parametrize("fmt,layout", [
    ("rowrec", "ell"), ("libsvm", "ell"), ("libfm", "ell"),
    ("libsvm", "dense"), ("csv", "dense"),
])
def test_producers_match_jax(tmp_path, fmt, layout, vdtype, num_parts, nthread):
    uri, _ = make_source(tmp_path, fmt, layout)
    spec, jspec = specs(layout, vdtype)
    port_fn, jax_fn = ((ell_batches, jax_ell_batches) if layout == "ell"
                       else (dense_batches, jax_dense_batches))
    for part in range(num_parts):
        got = port_fn(uri, spec, part, num_parts, nthread=nthread, ring=12)
        want = jax_fn(uri, jspec, part, num_parts, nthread=nthread, ring=12)
        assert got.ring_slots == want.ring_slots
        assert_same_stream(snapshot(got), snapshot(want))


@pytest.mark.parametrize("one_based", [True, False])
@pytest.mark.parametrize("num_parts", [1, 3])
@pytest.mark.parametrize("mode", [-1, 0, 1])
@pytest.mark.parametrize("fmt,layout", [("libsvm", "ell"), ("libfm", "ell"),
                                        ("libsvm", "dense")])
def test_indexing_modes_match_jax(tmp_path, fmt, layout, mode, num_parts, one_based):
    path = tmp_path / f"one.{fmt}"
    path.write_bytes(text_rows(fmt, 400, seed=3, one_based=one_based))
    spec, jspec = specs(layout, np.float32)
    port_fn, jax_fn = ((ell_batches, jax_ell_batches) if layout == "ell"
                       else (dense_batches, jax_dense_batches))
    for uri, kw in ((f"{path}?format={fmt}", {"indexing_mode": mode}),
                    (f"{path}?format={fmt}&indexing_mode={mode}", {})):
        for part in range(num_parts):
            assert_same_stream(snapshot(port_fn(uri, spec, part, num_parts, **kw)),
                               snapshot(jax_fn(uri, jspec, part, num_parts, **kw)))


EDGE_CASES = b"""\
1 0:1.5 3:-2.25 7:0.125
0 1:3 2:4.75
# full comment line
1:0.5 2:1.25 4:-1
-1 qid:7 0:2.5 5:1.75

1 0:0.0000001 7:123456.75
0 3:1e2 5:-1E-2
1 2:inf 4:-inf
1 0:99 1:1.23456789012345678
binarylabel 0:1 1:2
1 3 5 7
0 2:1.5 2:2.5 2:-0.5
1 0:1.5 junk 3:2.5 4:bad:1 5:x
1 100:5.0 3:1.0
0 0:+1.5 1:-0.0
"""


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
@pytest.mark.parametrize("layout", ["ell", "dense"])
def test_native_matches_plain_on_the_jax_edge_cases(tmp_path, layout, vdtype):
    """As the JAX package's tests hold its fused producers to the generic
    path: equal values (a -0.0 feature stages as +0.0 on the native dense
    path, which adds a row's features into a zeroed row)."""
    p = tmp_path / "edge.libsvm"
    p.write_bytes(EDGE_CASES)
    spec = (BatchSpec(batch_size=4, max_nnz=4, value_dtype=vdtype) if layout == "ell"
            else BatchSpec(batch_size=4, layout="dense", num_features=8, value_dtype=vdtype))
    src = ell_batches if layout == "ell" else dense_batches
    native_out = [{k: v.copy() for k, v in b.as_dict().items()}
                  for b in src(str(p), spec, format="libsvm")]
    plain_out = [b.as_dict() for b in plain_batches(str(p), spec, format="libsvm")]
    assert len(native_out) == len(plain_out) == 4
    for n, q in zip(native_out, plain_out):
        for k in n:
            np.testing.assert_array_equal(n[k], q[k], err_msg=k)


@pytest.mark.parametrize("num_parts", [1, 3])
@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
def test_rowrec_native_matches_its_plain_version(tmp_path, vdtype, num_parts):
    path = write_rec(tmp_path / "p.rec", 500, seed=4)
    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=vdtype)
    for part in range(num_parts):
        plain = plain_batches(path, spec, part, num_parts)
        assert isinstance(plain, EllRowRecBatches)
        got = snapshot(ell_batches(path, spec, part, num_parts))
        want = snapshot(plain)
        assert [g[2].tobytes() for g in got[0]] == [w[2].tobytes() for w in want[0]]
        assert got[1][0] == want[1][0]


def test_text_plain_version_is_the_parser_path(tmp_path):
    p = tmp_path / "a.csv"
    p.write_bytes(b"1,2,3\n4,5,6\n")
    spec = BatchSpec(batch_size=4, layout="dense", num_features=2)
    plain = plain_batches(f"{p}?format=csv&label_column=0", spec)
    assert isinstance(plain, GenericBatchStream)
    got = next(iter(plain))
    plain.close()
    np.testing.assert_array_equal(got.x[:2], [[2, 3], [5, 6]])
    np.testing.assert_array_equal(got.labels, [1, 4, 0, 0])


@pytest.mark.parametrize("num_parts", [1, 3])
def test_rowrec_records_across_window_and_chunk_edges(tmp_path, num_parts):
    """A record wider than the mmap window widens it, and windows stop at
    the part's end: every part gives the JAX package's rows."""
    path = write_rec(tmp_path / "w.rec", 300, seed=5, k=40)
    spec, jspec = specs("ell", np.float32)
    for part in range(num_parts):
        got = ell_batches(path, spec, part, num_parts)
        whole = got._split
        got._split = fused._MmapRawChunks(path, whole.begin, whole.end, chunk_bytes=64)
        whole.close()
        assert_same_stream(snapshot(got),
                           snapshot(jax_ell_batches(path, jspec, part, num_parts)))


@pytest.mark.parametrize("num_parts", [1, 3])
@pytest.mark.parametrize("fmt,layout", [
    ("libsvm", "ell"), ("libfm", "ell"), ("libsvm", "dense"), ("csv", "dense"),
])
def test_text_chunks_across_window_edges(tmp_path, fmt, layout, num_parts):
    """Line-aligned chunks of a small mmap window, which a line longer
    than the window widens, stop at the part's end; a last line without a
    newline still parses: every part gives the JAX package's rows."""
    uri, _ = make_source(tmp_path, fmt, layout)
    path = uri.split("?")[0]
    with open(path, "r+b") as f:
        f.truncate(f.seek(0, 2) - 1)  # drop the last newline
    spec, jspec = specs(layout, np.float32)
    port_fn, jax_fn = ((ell_batches, jax_ell_batches) if layout == "ell"
                       else (dense_batches, jax_dense_batches))
    for part in range(num_parts):
        got = port_fn(uri, spec, part, num_parts)
        begin, end = io_split.part_range(path, part, num_parts, "text")
        got._split = fused._MmapChunks(path, begin, end, chunk_bytes=100)
        assert_same_stream(snapshot(got), snapshot(jax_fn(uri, jspec, part, num_parts)))


@pytest.mark.parametrize("num_parts", [1, 3])
def test_rowrec_corrupt_and_truncated_files_raise(tmp_path, num_parts):
    good = open(write_rec(tmp_path / "g.rec", 200, seed=6), "rb").read()
    spec = BatchSpec(batch_size=B, max_nnz=K)
    bad = bytearray(good)
    frame = len(good) // 2 // 4 * 4
    while bad[frame:frame + 4] != b"\x0a\x23\xd7\xce":
        frame += 4
    bad[frame:frame + 4] = b"\xde\xad\xbe\xef"
    (tmp_path / "bad.rec").write_bytes(bytes(bad))
    with pytest.raises(Error, match="bad magic"):
        for part in range(num_parts):
            list(ell_batches(str(tmp_path / "bad.rec"), spec, part, num_parts))
    (tmp_path / "cut.rec").write_bytes(good[:-12])
    with pytest.raises(Error, match="truncated"):
        for part in range(num_parts):
            list(ell_batches(str(tmp_path / "cut.rec"), spec, part, num_parts))


def test_compressed_recordio_is_refused(tmp_path):
    """A compressed block too short for its header is refused when it is
    read, never decoded to rows: the file takes the split route, whose
    decode raises the JAX package's reason."""
    p = tmp_path / "c.rec"
    p.write_bytes(b"\x0a\x23\xd7\xce" + np.uint32((4 << 29) | 8).tobytes() + bytes(8))
    spec = BatchSpec(batch_size=4, max_nnz=2)
    with pytest.raises(Error, match="compressed block shorter than its 16-byte header"):
        list(ell_batches(str(p), spec))
    with pytest.raises(Exception, match="compressed block shorter than its 16-byte header"):
        list(jax_ell_batches(str(p), JaxSpec(batch_size=4, max_nnz=2)))


def test_csv_line_without_a_delimiter_raises(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_bytes(b"1,2,3\n7\n")
    spec = BatchSpec(batch_size=4, layout="dense", num_features=2)
    src = dense_batches(f"{p}?format=csv&label_column=0", spec)
    with pytest.raises(Error, match="Delimiter"):
        list(src)
    assert src.bad_lines == 1


@pytest.mark.parametrize("layout", ["ell", "dense"])
def test_overflow_error_policy_raises(tmp_path, layout):
    p = tmp_path / "o.svm"
    p.write_bytes(b"1 0:1 1:1 2:1 3:1 99:2\n")
    spec = (BatchSpec(batch_size=2, max_nnz=2, overflow="error") if layout == "ell" else
            BatchSpec(batch_size=2, layout="dense", num_features=4, overflow="error"))
    src = (ell_batches(f"{p}?format=libsvm", spec) if layout == "ell"
           else dense_batches(str(p), spec))
    with pytest.raises(Error, match="overflow='error'"):
        list(src)
    assert src.truncated_nnz == (3 if layout == "ell" else 1)


@pytest.mark.parametrize("call,match", [
    (lambda p, s, d: ell_batches(p + "#cache", s), "cachefile"),
    (lambda p, s, d: ell_batches(p + "?format=libsvm&shuffle_parts=2", s), "not supported"),
    (lambda p, s, d: ell_batches(p + "?format=libsvm&dynamic_shards=1", s), "not supported"),
    (lambda p, s, d: ell_batches(p + "?shuffle=batch", s), "indexed recordio source"),
    (lambda p, s, d: ell_batches(p + ";" + p, s), "multi-file"),
    (lambda p, s, d: plain_batches("dsserve://127.0.0.1:1/x", s), "remote"),
    (lambda p, s, d: ell_batches(p, s, format="csv"), "rowrec/libsvm/libfm"),
    (lambda p, s, d: ell_batches(p, d), "layout"),
    (lambda p, s, d: dense_batches(p, s), "dense"),
    (lambda p, s, d: dense_batches(p + "?format=csv&delimiter=é", d), "ASCII"),
    (lambda p, s, d: dense_batches(p + "?format=csv&dtype=int32", d), "float32"),
    (lambda p, s, d: ell_batches(os.path.dirname(p) + "/s?stream=1&shuffle=window&window=4",
                                 s), "stream"),
    (lambda p, s, d: ell_batches(os.path.dirname(p) + "/s/manifest.json", s),
     "names a live stream"),
])
def test_factories_refuse_what_the_port_lacks(tmp_path, call, match):
    """What the port lacks raises (a rowrec ``#cachefile`` as in the JAX
    package). A file set, once refused, reads since slice 7: its batches
    equal the JAX fused producer's. A live stream, refused until slice
    14, is followed with a query: its batches equal the JAX producer's; a
    bare manifest path (whose JSON the JAX producer maps as RecordIO)
    raises by name."""
    p = tmp_path / "x.rec"
    write_rec(p, 10, seed=7)
    spec = BatchSpec(batch_size=4, max_nnz=2)
    dspec = BatchSpec(batch_size=4, layout="dense", num_features=3)
    if match in ("stream", "names a live stream"):
        from dmlc_core_tpu.stream import StreamWriter as JaxWriter
        from dmlc_core_tpu_torch.io.recordio import RecordIOReader
        from dmlc_core_tpu_torch.io.stream import FileStream

        (tmp_path / "s").mkdir()
        with FileStream(str(p), "r") as f, JaxWriter(str(tmp_path / "s"), codec=None,
                                                     rotate_bytes=64) as w:
            for rec in iter(RecordIOReader(f).next_record, None):
                w.append(bytes(rec))
    if match == "stream":
        uri = f"{tmp_path}/s?stream=1&shuffle=window&window=4"
        want = snapshot(jax_ell_batches(uri, JaxSpec(batch_size=4, max_nnz=2)))
        assert_same_stream(snapshot(call(str(p), spec, dspec)), want)
        return
    if match == "multi-file":
        want = snapshot(jax_ell_batches(f"{p};{p}", JaxSpec(batch_size=4, max_nnz=2)))
        assert_same_stream(snapshot(call(str(p), spec, dspec)), want)
        return
    with pytest.raises(Error, match=match):
        call(str(p), spec, dspec)


SHUFFLES = {
    "index": "", "record": "&shuffle=record", "batch": "&shuffle=batch&batch_size=48",
    "window": "&shuffle=window&window=100&merge_gap=256",
    "legacy": "&shuffle=record&legacy_shuffle=1",
    "skip": "&shuffle=batch&batch_size=32&epoch=3&skip_records=96",
    "parts": "&shuffle=window&window=50&shuffle_parts=3",
}


@pytest.mark.parametrize("nthread", [None, 3])
@pytest.mark.parametrize("num_parts", [1, 3])
@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
@pytest.mark.parametrize("mode", list(SHUFFLES))
def test_indexed_producers_match_jax(tmp_path, mode, vdtype, num_parts, nthread):
    """Every batch of ``ell_batches`` over an indexed URI equals the JAX
    package's byte for byte, and, with one thread, the plain version's
    (one seek per record, no native code); no batch is copied out of the
    gather path."""
    rec = write_rec(tmp_path / "d.rec", 700, seed=3, with_index=True)
    uri = f"{rec}?index={rec}.idx&seed=5{SHUFFLES[mode]}"
    spec, jspec = specs("ell", vdtype)
    if mode == "skip" and nthread:
        return  # 96 records lie past a sub-shard: both raise alike (below)
    for part in range(num_parts):
        got = ell_batches(uri, spec, part, num_parts, nthread=nthread, ring=12)
        want = jax_ell_batches(uri, jspec, part, num_parts, nthread=nthread, ring=12)
        assert got.ring_slots == want.ring_slots
        port = snapshot(got)
        assert_same_stream(port, snapshot(want))
        stats = got.io_stats()
        assert stats.get("gather_fallback_batches", 0) == 0
        windowed = mode not in ("index", "legacy")
        assert (stats.get("gather_batches", 0) > 0) == windowed
        if nthread is None:  # the plain stream counts no rows_out
            plain, counters = snapshot(plain_batches(uri, spec, part, num_parts))
            assert_same_stream((port[0], port[1][:1]), (plain, counters[:1]))


def test_indexed_skip_outside_a_part_raises_like_jax(tmp_path):
    rec = write_rec(tmp_path / "d.rec", 700, seed=3, with_index=True)
    uri = f"{rec}?index={rec}.idx{SHUFFLES['skip']}"
    spec, jspec = specs("ell", np.float32)
    with pytest.raises(Error, match="outside this shard") as e:
        ell_batches(uri, spec, 2, 3, nthread=3)
    with pytest.raises(Exception) as je:
        jax_ell_batches(uri, jspec, 2, 3, nthread=3)
    assert str(e.value) == str(je.value)


@pytest.mark.parametrize("damage", ["shifted", "short"])
def test_gather_raises_when_the_index_and_data_disagree(tmp_path, damage):
    rec = write_rec(tmp_path / "d.rec", 200, seed=4, with_index=True)
    lines = open(f"{rec}.idx").read().split("\n")
    # a shifted offset points past a frame head; moving the next offset
    # back cuts a record short
    at = 50 if damage == "shifted" else 51
    key, off = lines[at].split("\t")
    lines[at] = f"{key}\t{int(off) + (4 if damage == 'shifted' else -4)}"
    open(f"{rec}.idx", "w").write("\n".join(lines))
    uri = f"{rec}?index={rec}.idx&shuffle=record"
    spec, jspec = specs("ell", np.float32)
    for make, err in ((lambda: ell_batches(uri, spec), Error),
                      (lambda: jax_ell_batches(uri, jspec), Exception)):
        src = make()
        try:
            with pytest.raises(err, match="index and the data disagree"):
                list(src)
        finally:
            src.close()


def test_plain_indexed_stream_runs_no_native_code(tmp_path, monkeypatch):
    rec = write_rec(tmp_path / "d.rec", 300, seed=6, with_index=True)
    uri = f"{rec}?index={rec}.idx&shuffle=window&window=40&seed=2"
    spec, _ = specs("ell", np.float32)
    want = snapshot(ell_batches(uri, spec))

    def refuse(*a, **k):
        raise AssertionError("the plain version called the native core")

    for name in ("parse_rowrec_ell", "parse_rowrec_gather_ell", "shuffle_mt19937"):
        monkeypatch.setattr(native, name, refuse)
    plain = plain_batches(uri, spec)
    assert isinstance(plain, GenericBatchStream)
    batches, counters = snapshot(plain)
    assert_same_stream((batches, counters[:1]), (want[0], want[1][:1]))


def test_factories_raise_when_the_library_cannot_be_built(tmp_path, monkeypatch):
    p = tmp_path / "x.svm"
    p.write_bytes(b"1 0:1\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", "false")
    spec = BatchSpec(batch_size=4, max_nnz=2)
    dspec = BatchSpec(batch_size=4, layout="dense", num_features=3)
    for call in (lambda: ell_batches(f"{p}?format=libsvm", spec),
                 lambda: dense_batches(str(p), dspec),
                 lambda: ell_batches(str(tmp_path / "y.rec"), spec)):
        (tmp_path / "y.rec").write_bytes(b"")
        with pytest.raises(Error, match="g\\+\\+ failed"):
            call()


@pytest.mark.parametrize("nthread", [None, 2])
def test_factories_return_native_producers(tmp_path, nthread):
    rec = write_rec(tmp_path / "n.rec", 50, seed=8)
    svm = tmp_path / "n.svm"
    svm.write_bytes(text_rows("libsvm", 50, seed=8))
    spec = BatchSpec(batch_size=8, max_nnz=K)
    dspec = BatchSpec(batch_size=8, layout="dense", num_features=D)
    streams = [ell_batches(rec, spec, nthread=nthread),
               ell_batches(f"{svm}?format=libsvm", spec, nthread=nthread),
               dense_batches(str(svm), dspec, nthread=nthread)]
    want = (ShardedFusedBatches,) if nthread else (
        fused.FusedEllRowRecBatches, fused.FusedEllLibSVMBatches,
        fused.FusedDenseLibSVMBatches)
    for s, cls in zip(streams, want * 3 if nthread else want):
        assert isinstance(s, cls)
        s.close()


def test_sharded_producer_ring_fits_the_pipeline(tmp_path):
    """ShardedFusedBatches promises ring - (prefetch + 1) slots, which the
    pipeline checks; every row lands once through the pipeline."""
    rec = write_rec(tmp_path / "s.rec", 1000, seed=9)
    spec = BatchSpec(batch_size=32, max_nnz=K)
    src = ell_batches(rec, spec, nthread=3, ring=10)
    assert src.ring_slots == 7
    pipe = StagingPipeline(src, device="cpu")
    labels = [b["labels"][b["weights"] > 0].numpy().copy() for b in pipe]
    assert drain_close(pipe, src)
    assert sum(len(x) for x in labels) == 1000 == src.rows_out
    short = ell_batches(rec, spec, nthread=3, ring=9)
    with pytest.raises(Error, match="ring"):
        StagingPipeline(short, device="cpu")
    short.close()


def run_both(jmodel, jparams, jsrc, model, src, lr):
    jstep = jax.jit(lambda p, b: jmodel.sgd_step(p, b, lr=lr))
    jlosses = []
    for batch in jsrc:
        jparams, loss = jstep(jparams, batch.as_dict())
        jlosses.append(float(loss))
    jsrc.close()
    pipe = StagingPipeline(src, device="cpu")
    losses = [float(model.sgd_step(batch, lr=lr)) for batch in pipe]
    assert drain_close(pipe, src)
    return losses, jlosses, jparams


def test_csv_dense_logistic_regression_matches_jax(tmp_path):
    rng = np.random.default_rng(10)
    n, d = 3 * 128, 28
    x = rng.normal(size=(n, d))
    y = (x @ rng.normal(size=d) > 0).astype(int)
    path = tmp_path / "higgs.csv"
    path.write_text("".join(f"{y[i]}," + ",".join(f"{v:.6f}" for v in x[i]) + "\n"
                            for i in range(n)))
    uri = f"{path}?format=csv&label_column=0"
    params = {"w": rng.normal(size=d).astype(np.float32) * 0.05, "b": np.float32(0.0)}
    model = LogisticRegression(d, device="cpu")
    model.load_state_dict(params_from_jax(params, "cpu"))
    spec = BatchSpec(batch_size=128, layout="dense", num_features=d)
    jspec = JaxSpec(batch_size=128, layout="dense", num_features=d)
    losses, jlosses, jparams = run_both(JaxLogReg(d), dict(params),
                                        jax_dense_batches(uri, jspec), model,
                                        dense_batches(uri, spec), lr=0.5)
    assert len(losses) == len(jlosses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = params_to_numpy(model.state_dict())
    for k, want in jparams.items():
        np.testing.assert_allclose(got[k], np.asarray(want), rtol=1e-5)


def test_criteo_libsvm_fm_matches_jax(tmp_path):
    rng = np.random.default_rng(11)
    n, k, d, e = 4 * 64 + 20, 39, 4096, 8
    dense = rng.uniform(0, 1, (n, 13))
    cats = rng.integers(13, d, (n, k - 13))
    labels = rng.integers(0, 2, n)
    path = tmp_path / "criteo.svm"
    path.write_text("".join(
        f"{labels[i]} " + " ".join(f"{j}:{dense[i, j]:.6f}" for j in range(13)) + " "
        + " ".join(str(c) for c in cats[i]) + "\n" for i in range(n)))
    uri = f"{path}?format=libsvm"
    params = {"w": rng.normal(size=d).astype(np.float32) * 0.05,
              "v": rng.normal(size=(d, e)).astype(np.float32) * 0.05,
              "b": np.float32(0.0)}
    model = FactorizationMachine(d, e, device="cpu")
    model.load_state_dict(params_from_jax(params, "cpu"))
    spec = BatchSpec(batch_size=64, max_nnz=k)
    jspec = JaxSpec(batch_size=64, layout="ell", max_nnz=k)
    losses, jlosses, jparams = run_both(JaxFM(d, embed_dim=e), dict(params),
                                        jax_ell_batches(uri, jspec), model,
                                        ell_batches(uri, spec), lr=0.5)
    assert len(losses) == len(jlosses) == 5
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = params_to_numpy(model.state_dict())
    for key, want in jparams.items():
        want = np.asarray(want)
        assert float(np.abs(got[key] - want).max()) <= 1e-4 * float(np.abs(want).max()), key
