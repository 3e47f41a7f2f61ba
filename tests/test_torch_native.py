"""The port's native parse core against the JAX package's, on the CPU.

Every ctypes binding of ``dmlc_core_tpu_torch/data/native.py`` (built
from the port's own copy of fastparse.cc under .build/native/) is run on
the same bytes as the JAX package's binding (native/libdmlc_tpu_native.so,
which tests/conftest.py builds): returns and every output byte must be
identical; the MT19937 shuffle also equals ``random.Random.shuffle``.
Also: the build stamp, f16 rounding at halfway points against
numpy, the GIL released during a call, and a failed build raising."""

import ctypes
import hashlib
import random
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from dmlc_core_tpu.data import native as jax_native
from dmlc_core_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_core_tpu.data.rowrec import write_rowrec as jax_write_rowrec
from dmlc_core_tpu.io.recordio import IndexedRecordIOWriter, RecordIOReader
from dmlc_core_tpu.io.stream import MemoryStream
from dmlc_core_tpu_torch.data import native
from dmlc_core_tpu_torch.utils.logging import Error

REPO = Path(__file__).resolve().parent.parent

LIBSVM_CASES = [
    b"",
    b"1 0:1.5 3:2.5\n-1 1:0.5\n",
    b"1 0:1.5 3:2.5 # comment\n# full comment\n\n0.5:2.0 qid:7 2:1.0\n",
    b"1 3 5 9\n0 2 4\n",
    b"1 1:0.5 3:2\n0 2:1\n",
    b"1 qid:abc 1:0.5\n",
    b"1 qid: 1:0.5\n",
    b"abc 1:0.5\n1 0:2.0\n",
    b"1 x:0.5 2:bad 3:1.0\n",
    b"1 0:1e-3 2:1E4 3:-2.5e+2\n",
    b"1:0.25 0:1\n",
    b"1 0:inf 1:nan\n",
    b"NA 1:1\n2 2:2",
    b"1 0:1.5\r\n2 1:2.5\r0 2:0.5\n",
    b"1 0:1\x0b2:3\n1\x0c0:1\n",
    b"1 99999999999999999999:1 1:2\n",
    b"1 0:1_0 2:3\n1_0 0:1\n",
    b"1 0:1e999 1:1e-999\n",
    b"1 qid:99999999999999999999 0:1\n",
]

CSV_CASES = [
    b"",
    b"1.0,2.0,3.0\n4.0,5.0,6.0\n",
    b"1.0,,3.0\n",
    b"1,abc,3\n",
    b"7.0,1.0,0.25\n",
    b"1.5e3,2E-2\n",
    b"-1.0,+2.0\n",
    b"9,8,7",
    b"1_0,2\n",
    b"1e999,2\n",
    b"1,2\r\n3,4\r\n",
]

LIBFM_CASES = [
    b"",
    b"1 0:3:1.5 2:7:0.5\n-1:0.5 1:4:2.0\n",
    b"1 1:1:0.5 2:3:0.5\n",
    b"1 0:3 2:7\n",
    b"1 junk 0:3:1.5 5\n",
    b"x 0:3:1.5\n1 1:1:1\n",
    b"1 -1:3:1.5 2:-7:0.5\n",
]


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


@pytest.mark.parametrize("mode", [0, 1, -1])
@pytest.mark.parametrize("case", range(len(LIBSVM_CASES)))
def test_parse_libsvm_matches_jax(case, mode):
    data = LIBSVM_CASES[case]
    assert_same(native.parse_libsvm(data, mode), jax_native.parse_libsvm(data, mode))


@pytest.mark.parametrize("args", [(-1, -1), (0, -1), (0, 2), (2, 0)])
@pytest.mark.parametrize("case", range(len(CSV_CASES)))
def test_parse_csv_matches_jax(case, args):
    data = CSV_CASES[case]
    assert_same(native.parse_csv(data, ord(","), *args),
                jax_native.parse_csv(data, ord(","), *args))


def test_parse_csv_error_matches_jax():
    with pytest.raises(Error, match="Delimiter") as got:
        native.parse_csv(b"1\n", ord(","), 0, -1)
    with pytest.raises(Exception, match="Delimiter") as want:
        jax_native.parse_csv(b"1\n", ord(","), 0, -1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", [0, 1, -1])
@pytest.mark.parametrize("case", range(len(LIBFM_CASES)))
def test_parse_libfm_matches_jax(case, mode):
    data = LIBFM_CASES[case]
    assert_same(native.parse_libfm(data, mode), jax_native.parse_libfm(data, mode))


def libsvm_chunk(rng, n, d=12, k=9):
    lines = []
    for i in range(n):
        toks = [f"{int(rng.integers(0, 2))}"]
        if i % 5 == 0:
            toks[0] += f":{rng.uniform(0.5, 2):.3f}"
        if i % 7 == 0:
            toks.append(f"qid:{i}")
        for _ in range(int(rng.integers(0, k + 3))):
            j = int(rng.integers(0, d + 3))
            toks.append(f"{j}" if rng.random() < 0.2 else f"{j}:{rng.normal():.6g}")
        if i % 11 == 0:
            toks.append("junk 4:bad")
        lines.append(" ".join(toks) + ("\r\n" if i % 13 == 0 else "\n"))
        if i % 17 == 0:
            lines.append("# comment\n\n")
    return "".join(lines).encode()


def libfm_chunk(rng, n, d=12, k=9):
    lines = []
    for i in range(n):
        toks = [f"{int(rng.integers(0, 2))}"]
        for _ in range(int(rng.integers(0, k + 3))):
            f, j = int(rng.integers(0, 4)), int(rng.integers(0, d + 3))
            toks.append(f"{f}:{j}" if rng.random() < 0.2 else f"{f}:{j}:{rng.normal():.6g}")
        if i % 11 == 0:
            toks.append("junk 1:x:2")
        lines.append(" ".join(toks) + "\n")
    return "".join(lines).encode()


def csv_chunk(rng, n, cols=6):
    lines = []
    for i in range(n):
        cells = [f"{rng.normal():.6g}" for _ in range(cols)]
        if i % 9 == 0:
            cells[2] = ""
        if i % 10 == 0:
            cells[3] = "1.5abc"
        lines.append(",".join(cells) + ("\r\n" if i % 4 == 0 else "\n"))
    return "".join(lines).encode()


def rowrec_chunk(rng, n, k=9):
    nnz = rng.integers(0, k + 4, n)
    offset = np.r_[0, np.cumsum(nnz)].astype(np.int64)
    value = rng.normal(size=int(offset[-1])).astype(np.float32)
    value[::23] = np.frombuffer(np.uint32(0xCED7230A).tobytes(), np.float32)[0]
    blk = JaxRowBlock(offset=offset, label=rng.normal(size=n).astype(np.float32),
                      index=rng.integers(0, 1 << 33, int(offset[-1])).astype(np.uint64),
                      value=value, weight=rng.uniform(0.5, 2, n).astype(np.float32))
    ms = MemoryStream()
    jax_write_rowrec(ms, [blk])
    return ms.getvalue()


def ell_buffers(capacity, k, vdtype):
    return (np.full((capacity, k), -7, np.int32), np.full((capacity, k), 3, vdtype),
            np.full(capacity, -7, np.int32), np.full(capacity, 3, np.float32),
            np.full(capacity, 3, np.float32))


def dense_buffers(capacity, d, vdtype):
    return (np.full((capacity, d), 3, vdtype), np.full(capacity, 3, np.float32),
            np.full(capacity, 3, np.float32))


def drive(fn, chunk, make_buffers, args, cr=True):
    """Resumable calls over a chunk into small reused buffers, as the
    producers make them; every return and every buffer byte after each
    call."""
    bufs = make_buffers()
    trace, off, fill, cr_hint = [], 0, 0, -1
    while off < len(chunk):
        extra = (cr_hint,) if cr else ()
        ret = fn(chunk, off, *args(bufs), fill, *extra)
        trace.append((tuple(ret), [b.tobytes() for b in bufs]))
        rows, consumed = ret[0], ret[1]
        if cr:
            cr_hint = ret[3]
        if rows == 0 and consumed == 0:
            break
        off += consumed
        fill = (fill + rows) % len(bufs[-1])
    return trace


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
@pytest.mark.parametrize("kind,base", [
    ("libsvm_dense", 0), ("libsvm_dense", 1), ("csv_dense", 0),
    ("libsvm_ell", 0), ("libsvm_ell", 1), ("libfm_ell", 0), ("libfm_ell", 1),
    ("rowrec_ell", 0),
])
def test_fused_bindings_match_jax(kind, vdtype, base):
    rng = np.random.default_rng(3)
    cap, k, d = 7, 5, 10
    if kind == "libsvm_dense":
        chunk = libsvm_chunk(rng, 300)
        make = lambda: dense_buffers(cap, d, vdtype)  # noqa: E731
        args = lambda b: (base, *b)  # noqa: E731
        fns = native.parse_libsvm_dense, jax_native.parse_libsvm_dense
    elif kind == "csv_dense":
        chunk = csv_chunk(rng, 300)
        make = lambda: dense_buffers(cap, 4, vdtype)  # noqa: E731
        args = lambda b: (ord(","), 0, 5, *b)  # noqa: E731
        fns = native.parse_csv_dense, jax_native.parse_csv_dense
    elif kind == "rowrec_ell":
        chunk = rowrec_chunk(rng, 300)
        make = lambda: ell_buffers(cap, k, vdtype)  # noqa: E731
        args = lambda b: b  # noqa: E731
        fns = native.parse_rowrec_ell, jax_native.parse_rowrec_ell
    else:
        chunk = (libsvm_chunk if kind == "libsvm_ell" else libfm_chunk)(rng, 300)
        make = lambda: ell_buffers(cap, k, vdtype)  # noqa: E731
        args = lambda b: (base, *b)  # noqa: E731
        fns = ((native.parse_libsvm_ell, jax_native.parse_libsvm_ell)
               if kind == "libsvm_ell" else
               (native.parse_libfm_ell, jax_native.parse_libfm_ell))
    cr = kind != "rowrec_ell"
    got = drive(fns[0], chunk, make, args, cr)
    want = drive(fns[1], chunk, make, args, cr)
    assert len(got) == len(want) > 10
    assert got == want


def test_rowrec_binding_stops_at_a_partial_record_and_flags_corruption():
    chunk = rowrec_chunk(np.random.default_rng(4), 20)
    for cut in (len(chunk) - 5, 6, len(chunk) // 2):
        bufs = ell_buffers(64, 5, np.float32)
        assert native.parse_rowrec_ell(chunk[:cut], 0, *bufs, 0) == \
            jax_native.parse_rowrec_ell(chunk[:cut], 0, *ell_buffers(64, 5, np.float32), 0)
    bad = b"\xde\xad\xbe\xef" + chunk[4:]
    got = native.parse_rowrec_ell(bad, 0, *ell_buffers(64, 5, np.float32), 0)
    assert got[4] == 1 and got[:2] == (0, 0)


# values at and beside the halfway points of f16, subnormals, the
# largest finite f16 and the first value that rounds to inf
_HALFWAY = np.array([
    1 + 2.0 ** -11, 1 + 3 * 2.0 ** -11, 1 + 2.0 ** -11 + 2.0 ** -20,
    1 + 2.0 ** -11 - 2.0 ** -20, 2 + 2.0 ** -10, 1024 + 0.5, 1024 + 1.5,
    2.0 ** -25, 3 * 2.0 ** -25, 2.0 ** -24 * 1.5, 65504, 65519.996, 65520,
    -(1 + 2.0 ** -11), -(1 + 3 * 2.0 ** -11), 0.1, 1 / 3, 1e-8, -0.0,
], dtype=np.float32)


@pytest.mark.parametrize("kind", ["libsvm_ell", "libsvm_dense", "rowrec_ell"])
def test_f16_rounding_matches_numpy_at_halfway_points(kind):
    vals = _HALFWAY
    n = len(vals)
    if kind == "rowrec_ell":
        blk = JaxRowBlock(offset=np.arange(n + 1), label=np.zeros(n, np.float32),
                          index=np.zeros(n, np.uint32), value=vals)
        ms = MemoryStream()
        jax_write_rowrec(ms, [blk])
        bufs = ell_buffers(n, 1, np.float16)
        native.parse_rowrec_ell(ms.getvalue(), 0, *bufs, 0)
        got = bufs[1][:, 0]
    else:
        text = "".join(f"0 0:{v!r}\n" for v in vals.tolist()).encode()
        if kind == "libsvm_ell":
            bufs = ell_buffers(n, 1, np.float16)
            native.parse_libsvm_ell(text, 0, 0, *bufs, 0)
            got = bufs[1][:, 0]
        else:
            bufs = dense_buffers(n, 1, np.float16)
            native.parse_libsvm_dense(text, 0, 0, *bufs, 0)
            got = bufs[0][:, 0]
    if kind == "libsvm_dense":
        # the dense kernel adds a row's features into a zeroed f32 row, so
        # -0.0 stages as +0.0 (as in the JAX package's fused producer)
        vals = vals + np.float32(0)
    with np.errstate(over="ignore"):
        want = vals.astype(np.float16)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_library_is_the_ports_own_build():
    path = native.library_path()
    assert path.parent == REPO / ".build" / "native"
    src = REPO / "dmlc_core_tpu_torch" / "native" / "fastparse.cc"
    assert native.source_hash() == hashlib.sha256(src.read_bytes()).hexdigest()
    assert native.source_sha256() == native.source_hash()


def test_bindings_check_their_buffers():
    x = np.zeros((4, 6), np.float32)[:, ::2]
    with pytest.raises(Error, match="C-contiguous"):
        native.parse_libsvm_dense(b"1 0:1\n", 0, 0, x, np.zeros(4, np.float32),
                                  np.zeros(4, np.float32), 0)
    idx, val, nnz, lab, wt = ell_buffers(4, 3, np.float32)
    with pytest.raises(Error, match="shorter than capacity"):
        native.parse_rowrec_ell(b"", 0, idx, val, nnz[:2], lab, wt, 0)
    with pytest.raises(Error, match="indices"):
        native.parse_libsvm_ell(b"", 0, 0, idx.astype(np.int64), val, nnz, lab, wt, 0)
    with pytest.raises(Error, match="outside"):
        native.parse_libsvm_ell(b"1 0:1\n", 99, 0, idx, val, nnz, lab, wt, 0)


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(Error, match="g\\+\\+ failed on fastparse.cc"):
        native.build()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(Error, match="not found"):
        native.build()
    assert not list(tmp_path.glob("*.so"))


def test_calls_release_the_gil():
    """A thread in a long native call leaves the interpreter to others:
    the main thread keeps running all through the call, with no gap
    near the call's length (a library that held the GIL would stop it
    for the whole call)."""
    native.load()
    data = b"1 0:1.5 3:2.5 7:0.25 9:1e-3 11:4\n" * 600_000
    span = {}

    def parse():
        span["start"] = time.perf_counter()
        native.parse_libsvm(data, 0)
        span["end"] = time.perf_counter()

    ticks = []
    t = threading.Thread(target=parse)
    t.start()
    while t.is_alive():
        ticks.append(time.perf_counter())
    t.join(timeout=60)
    assert not t.is_alive()
    window = span["end"] - span["start"]
    inside = [span["start"]] + [x for x in ticks if span["start"] < x < span["end"]]
    gaps = np.diff(inside + [span["end"]])
    assert window > 0.05
    assert gaps.max() < 0.5 * window


def test_loaded_with_cdll_not_pydll():
    lib = native.load()
    assert type(lib) is ctypes.CDLL


# -- the shuffled-read entry points -------------------------------------------
def indexed_rowrec(rng, n):
    """A rowrec chunk (magic-word values, so multipart chains occur) and
    each record's (start, size) from the JAX package's index writer."""
    chunk = rowrec_chunk(rng, n)
    ms, idx = MemoryStream(), MemoryStream()
    writer = IndexedRecordIOWriter(ms, idx)
    for rec in RecordIOReader(MemoryStream(chunk)):
        writer.write_record(rec)
    assert ms.getvalue() == chunk
    starts = np.array(idx.getvalue().split()[1::2], dtype=np.int64)
    sizes = np.diff(np.r_[starts, len(chunk)]).astype(np.int64)
    return np.frombuffer(chunk, np.uint8), starts, sizes


def gather_trace(fn, buf, starts, sizes, vdtype):
    """Resumable gather calls into small reused buffers: every return
    and every buffer byte after each call."""
    bufs = ell_buffers(7, 5, vdtype)
    trace, lo, fill = [], 0, 0
    while lo < len(starts):
        ret = tuple(fn(buf, starts, sizes, lo, len(starts) - lo, *bufs, fill))
        trace.append((ret, [b.tobytes() for b in bufs]))
        rows, consumed, corrupt = ret[0], ret[1], ret[4]
        if corrupt or not (rows or consumed):
            break
        lo += consumed
        fill = (fill + rows) % 7
    return trace


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
@pytest.mark.parametrize("damage", ["none", "short", "shifted"])
def test_gather_ell_matches_jax(vdtype, damage):
    rng = np.random.default_rng(5)
    buf, starts, sizes = indexed_rowrec(rng, 200)
    perm = rng.permutation(len(starts))
    starts, sizes = starts[perm].copy(), sizes[perm].copy()
    if damage == "short":  # a record the index cuts short
        sizes[150] -= 4
    elif damage == "shifted":  # a slice that starts past a frame head
        starts[150] += 4
        sizes[150] -= 4
    got = gather_trace(native.parse_rowrec_gather_ell, buf, starts, sizes, vdtype)
    want = gather_trace(jax_native.parse_rowrec_gather_ell, buf, starts, sizes, vdtype)
    assert len(got) > 10
    assert got == want
    assert (got[-1][0][4] == 1) == (damage != "none")


def test_walk_record_spans_matches_jax():
    rng = np.random.default_rng(6)
    buf, starts, sizes = indexed_rowrec(rng, 300)
    starts[7] += 4  # no head there
    sizes[9] = 3    # shorter than a header
    got = native.walk_record_spans(buf, starts, sizes)
    want = jax_native.walk_record_spans(buf, starts, sizes)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2:] == want[2:]
    assert got[2] > 0 and got[3] == 2  # multipart chains and the two corrupt


@pytest.mark.parametrize("n", [0, 1, 2, 3, 17, 1000, 65537])
@pytest.mark.parametrize("seed", [0, 111, 1_000_114])
def test_shuffle_mt19937_matches_random_shuffle(n, seed):
    perm = np.arange(n, dtype=np.int64)
    rnd = random.Random(seed)
    state = rnd.getstate()
    assert native.shuffle_mt19937(rnd, perm)
    assert rnd.getstate() == state  # the generator is left untouched
    ref = list(range(n))
    random.Random(seed).shuffle(ref)
    assert perm.tolist() == ref
    jax_perm = np.arange(n, dtype=np.int64)
    assert jax_native.shuffle_mt19937(random.Random(seed), jax_perm)
    np.testing.assert_array_equal(perm, jax_perm)


def test_shuffle_mt19937_declines_past_single_word_draws():
    class Huge:
        def __len__(self):
            return 1 << 31

    assert native.shuffle_mt19937(random.Random(0), Huge()) is False
    with pytest.raises(Error, match="int64"):
        native.shuffle_mt19937(random.Random(0), np.arange(4, dtype=np.int32))


def test_gather_bindings_check_their_arguments():
    buf, starts, sizes = indexed_rowrec(np.random.default_rng(7), 10)
    bufs = ell_buffers(4, 3, np.float32)
    with pytest.raises(Error, match="outside"):
        native.parse_rowrec_gather_ell(buf, starts, sizes, 5, 6, *bufs, 0)
    with pytest.raises(Error, match="int64"):
        native.parse_rowrec_gather_ell(buf, starts.astype(np.int32), sizes, 0, 1,
                                       *bufs, 0)
    with pytest.raises(Error, match="uint8"):
        native.walk_record_spans(buf.view(np.int8), starts, sizes)
