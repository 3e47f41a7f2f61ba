"""Build, load and call the port's native parse core (``native/fastparse.cc``).

The source is compiled at first use with ``g++`` into a shared library
cached under ``.build/native/`` at the checkout root, named by a hash of
the source, the flags, the compiler's version and the host CPU (the flags
hold ``-march=native``), and loaded with ``ctypes.CDLL``, so every call
releases the GIL. Nothing runs at import time. There is no fallback: a
failed build or load raises ``Error`` with the compiler's output.

Calling convention: the CSR parsers copy the library's growable buffers
into fresh numpy arrays and free them; the fused parsers write straight
into caller-owned ring-slot arrays, resuming at an offset into a chunk.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..utils.logging import Error, check

__all__ = [
    "build",
    "library_path",
    "load",
    "parse_csv",
    "parse_csv_dense",
    "parse_csv_dense_split",
    "parse_libfm",
    "parse_libfm_ell",
    "parse_libsvm",
    "parse_libsvm_dense",
    "parse_libsvm_ell",
    "parse_rowrec_ell",
    "parse_rowrec_gather_ell",
    "shuffle_mt19937",
    "source_hash",
    "source_sha256",
    "walk_record_spans",
]

_SRC = Path(__file__).resolve().parents[1] / "native" / "fastparse.cc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / ".build" / "native"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fvisibility=hidden",
          "-march=native", "-pthread"]
# the fewest rows a worker of ``parse_csv_dense_split`` takes (~1.5 MB of
# ``%.18e`` HIGGS rows): a call with fewer parses on the calling thread.
# On an 8-CPU H100 host the split beats one thread from 128 HIGGS rows a
# worker; the floor keeps room for narrow rows, which parse far faster.
SPLIT_MIN_ROWS = 2048


class _ParseResult(ctypes.Structure):
    """Mirrors fastparse.cc struct ParseResult."""

    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_elems", ctypes.c_int64),
        ("offset", ctypes.POINTER(ctypes.c_int64)),
        ("label", ctypes.POINTER(ctypes.c_float)),
        ("weight", ctypes.POINTER(ctypes.c_float)),
        ("qid", ctypes.POINTER(ctypes.c_int64)),
        ("field", ctypes.POINTER(ctypes.c_int64)),
        ("index", ctypes.POINTER(ctypes.c_uint64)),
        ("value", ctypes.POINTER(ctypes.c_float)),
        ("has_weight", ctypes.c_int32),
        ("has_qid", ctypes.c_int32),
        ("has_field", ctypes.c_int32),
        ("has_value", ctypes.c_int32),
        ("error", ctypes.c_char_p),
    ]


class _DenseResult(ctypes.Structure):
    """Mirrors fastparse.cc struct DenseResult."""

    _fields_ = [
        ("rows_written", ctypes.c_int64),
        ("bytes_consumed", ctypes.c_int64),
        ("truncated", ctypes.c_int64),
        ("has_cr", ctypes.c_int64),
    ]


class _EllResult(ctypes.Structure):
    """Mirrors fastparse.cc struct EllResult."""

    _fields_ = [
        ("rows_written", ctypes.c_int64),
        ("bytes_consumed", ctypes.c_int64),
        ("truncated", ctypes.c_int64),
        ("bad_records", ctypes.c_int64),
        ("corrupt", ctypes.c_int64),
    ]


class _CsvDenseResult(ctypes.Structure):
    """Mirrors fastparse.cc struct CsvDenseResult."""

    _fields_ = [
        ("rows_written", ctypes.c_int64),
        ("bytes_consumed", ctypes.c_int64),
        ("truncated", ctypes.c_int64),
        ("has_cr", ctypes.c_int64),
        ("bad_lines", ctypes.c_int64),
    ]


class _CsvSplitResult(ctypes.Structure):
    """Mirrors fastparse.cc struct CsvSplitResult."""

    _fields_ = [("csv", _CsvDenseResult), ("workers", ctypes.c_int64)]


_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_TEXT_ELL = [_P, _I64, _I32, _I64, _I32, _P, _P, _P, _P, _P, _I64, _I64, _I32,
             ctypes.POINTER(_DenseResult)]
# (restype, argtypes) of each entry point, in fastparse.cc's order
_SIGNATURES = {
    "dmlc_parse_libsvm": (ctypes.POINTER(_ParseResult), [ctypes.c_char_p, _I64, _I32]),
    "dmlc_parse_csv": (ctypes.POINTER(_ParseResult),
                       [ctypes.c_char_p, _I64, _I32, _I32, _I32]),
    "dmlc_parse_libfm": (ctypes.POINTER(_ParseResult), [ctypes.c_char_p, _I64, _I32]),
    "dmlc_free_result": (None, [ctypes.POINTER(_ParseResult)]),
    "dmlc_parse_libsvm_dense": (None, [_P, _I64, _I32, _I64, _I32, _P, _P, _P,
                                       _I64, _I64, _I32,
                                       ctypes.POINTER(_DenseResult)]),
    "dmlc_parse_csv_dense": (None, [_P, _I64, _I32, _I32, _I32, _I64, _I32, _P,
                                    _P, _P, _I64, _I64, _I32,
                                    ctypes.POINTER(_CsvDenseResult)]),
    "dmlc_parse_csv_dense_split": (None, [_P, _I64, _I32, _I32, _I32, _I64, _I32,
                                          _P, _P, _P, _I64, _I64, _I32, _I32, _I64,
                                          ctypes.POINTER(_CsvSplitResult)]),
    "dmlc_parse_rowrec_ell": (None, [_P, _I64, _I64, _I32, _P, _P, _P, _P, _P,
                                     _I64, _I64, ctypes.POINTER(_EllResult)]),
    "dmlc_parse_rowrec_gather_ell": (None, [_P, _P, _P, _I64, _I64, _I32, _P, _P,
                                            _P, _P, _P, _I64, _I64,
                                            ctypes.POINTER(_EllResult)]),
    "dmlc_walk_record_spans": (None, [_P, _P, _P, _I64, _P, _P,
                                      ctypes.POINTER(_I64),
                                      ctypes.POINTER(_I64)]),
    "dmlc_parse_libfm_ell": (None, _TEXT_ELL),
    "dmlc_parse_libsvm_ell": (None, _TEXT_ELL),
    "dmlc_shuffle_mt19937": (None, [_P, _I32, _I64, _P]),
    "dmlc_source_hash": (ctypes.c_char_p, []),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_path: Optional[Path] = None


def source_sha256() -> str:
    """sha256 of the port's ``fastparse.cc`` in this checkout."""
    return hashlib.sha256(_SRC.read_bytes()).hexdigest()


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise Error("g++ not found on PATH (set CXX to another C++17 compiler)")
    return cxx


def _cpu_model() -> str:
    """The CPU's model name and feature flags, which ``-march=native``
    compiles for."""
    keep = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":", 1)[0].strip()
                if key in ("model name", "flags") and key not in dict(keep):
                    keep.append((key, line.strip()))
    except OSError:
        pass
    return "\n".join(line for _, line in keep)


def build() -> Path:
    """Compile ``fastparse.cc`` unless a library for this source, flags,
    compiler and CPU exists; returns its path. Parallel builders (test
    workers) serialise on a lock file; each writes a pid-suffixed file
    and moves it into place."""
    cxx = _cxx()
    version = subprocess.run([cxx, "--version"], capture_output=True,
                             text=True).stdout
    src_hash = source_sha256()
    flags = [*_FLAGS, f'-DDMLC_SRC_HASH="{src_hash}"']
    key = hashlib.sha256("\n".join(
        [src_hash, " ".join(flags), version, _cpu_model()]).encode())
    out = _BUILD_DIR / f"fastparse-{key.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise Error(f"g++ failed on {_SRC.name}:\n"
                        f"{(proc.stdout + proc.stderr)[-4000:]}")
        os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (idempotent)."""
    global _lib, _path
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise Error(f"cannot load {path}: {e}") from e
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib, _path = lib, path
    return _lib


def library_path() -> Path:
    """Path of the loaded library (loading it first)."""
    load()
    return _path


def source_hash() -> str:
    """The sha256 stamped into the loaded library at build time."""
    return load().dmlc_source_hash().decode()


# -- CSR parsers -------------------------------------------------------------
def _memmove_out(ptr, n: int, dtype) -> np.ndarray:
    """Copy ``n`` elements from a native pointer into a fresh array."""
    arr = np.empty(n, dtype=dtype)
    if n:
        ctypes.memmove(arr.ctypes.data, ctypes.cast(ptr, ctypes.c_void_p),
                       n * arr.itemsize)
    return arr


def _copy_out(lib, res_ptr):
    """ParseResult → numpy arrays (copies), then free the native buffers."""
    res = res_ptr.contents
    try:
        if res.error:
            raise Error(res.error.decode())
        n, m = res.n_rows, res.n_elems
        offset = _memmove_out(res.offset, n + 1, np.int64)
        label = _memmove_out(res.label, n, np.float32)
        weight = _memmove_out(res.weight, n, np.float32) if res.has_weight else None
        qid = _memmove_out(res.qid, n, np.int64) if res.has_qid else None
        field = _memmove_out(res.field, m, np.int64) if res.has_field else None
        index = _memmove_out(res.index, m, np.uint64)
        value = _memmove_out(res.value, m, np.float32) if res.has_value else None
        return offset, label, weight, qid, field, index, value
    finally:
        lib.dmlc_free_result(res_ptr)


def parse_libsvm(data: bytes, indexing_mode: int):
    """Whole lines of libsvm → (offset, label, weight, qid, index, value)."""
    lib = load()
    offset, label, weight, qid, _field, index, value = _copy_out(
        lib, lib.dmlc_parse_libsvm(data, len(data), indexing_mode))
    return offset, label, weight, qid, index, value


def parse_csv(data: bytes, delimiter: int, label_column: int, weight_column: int):
    """Whole lines of csv → (offset, label, weight, index, value)."""
    lib = load()
    offset, label, weight, _qid, _field, index, value = _copy_out(
        lib, lib.dmlc_parse_csv(data, len(data), delimiter, label_column,
                                weight_column))
    return offset, label, weight, index, value


def parse_libfm(data: bytes, indexing_mode: int):
    """Whole lines of libfm → (offset, label, weight, field, index, value)."""
    lib = load()
    offset, label, weight, _qid, field, index, value = _copy_out(
        lib, lib.dmlc_parse_libfm(data, len(data), indexing_mode))
    return offset, label, weight, field, index, value


# -- fused parsers into caller-owned batch rows -------------------------------
def _check_dense_buffers(x, labels, weights):
    """Memory-safety preconditions of the dense kernels (never asserts,
    which ``-O`` strips): they write through raw pointers."""
    check(x.flags.c_contiguous and x.dtype in (np.float32, np.float16),
          "x must be C-contiguous float32/float16")
    check(labels.flags.c_contiguous and labels.dtype == np.float32
          and weights.flags.c_contiguous and weights.dtype == np.float32,
          "labels/weights must be C-contiguous float32")
    capacity, d = x.shape
    check(len(labels) >= capacity and len(weights) >= capacity,
          "labels/weights shorter than x capacity")
    return capacity, d


def _check_ell_buffers(indices, values, nnz, labels, weights):
    """Memory-safety preconditions of the ELL kernels."""
    check(indices.flags.c_contiguous and indices.dtype == np.int32,
          "indices must be C-contiguous int32")
    check(values.flags.c_contiguous
          and values.dtype in (np.float32, np.float16),
          "values must be C-contiguous float32/float16")
    check(nnz.flags.c_contiguous and nnz.dtype == np.int32,
          "nnz must be C-contiguous int32")
    check(labels.flags.c_contiguous and labels.dtype == np.float32
          and weights.flags.c_contiguous and weights.dtype == np.float32,
          "labels/weights must be C-contiguous float32")
    capacity, k = indices.shape
    check(values.shape == (capacity, k), "values shape != indices shape")
    check(len(nnz) >= capacity and len(labels) >= capacity
          and len(weights) >= capacity, "1-D buffers shorter than capacity")
    return capacity, k


def _chunk_at(chunk, offset: int):
    """(pointer to ``chunk[offset]``, bytes left) without a copy."""
    mem = np.frombuffer(chunk, dtype=np.uint8)
    check(0 <= offset <= mem.size, f"offset {offset} outside a {mem.size}-byte chunk")
    return ctypes.c_void_p(mem.ctypes.data + offset), mem.size - offset


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return ctypes.c_void_p(a.ctypes.data)


def parse_libsvm_dense(chunk, offset: int, base: int, x, labels, weights,
                       row_start: int, cr_hint: int = -1) -> Tuple[int, int, int, int]:
    """libsvm ``chunk[offset:]`` → rows ``row_start..`` of ``x`` [capacity,
    D] (f32/f16), ``labels`` and ``weights``. ``base`` (0 or 1) is
    subtracted from every id; ``cr_hint`` is -1 on a chunk's first call,
    then the returned ``has_cr``. Stops at buffer-full or chunk-end.
    Returns (rows_written, bytes_consumed, truncated, has_cr)."""
    lib = load()
    ptr, n = _chunk_at(chunk, offset)
    capacity, d = _check_dense_buffers(x, labels, weights)
    res = _DenseResult()
    lib.dmlc_parse_libsvm_dense(
        ptr, n, base, d, int(x.dtype == np.float16), _ptr(x), _ptr(labels),
        _ptr(weights), row_start, capacity, cr_hint, ctypes.byref(res))
    return res.rows_written, res.bytes_consumed, res.truncated, res.has_cr


def parse_csv_dense(chunk, offset: int, delimiter: int, label_column: int,
                    weight_column: int, x, labels, weights, row_start: int,
                    cr_hint: int = -1) -> Tuple[int, int, int, int, int]:
    """csv ``chunk[offset:]`` → dense rows (contract of
    ``parse_libsvm_dense``); ``weight_column`` -1 is none. Returns
    (rows_written, bytes_consumed, truncated, has_cr, bad_lines): a
    non-empty line without a delimiter counts in ``bad_lines``."""
    lib = load()
    ptr, n = _chunk_at(chunk, offset)
    capacity, d = _check_dense_buffers(x, labels, weights)
    res = _CsvDenseResult()
    lib.dmlc_parse_csv_dense(
        ptr, n, delimiter, label_column, weight_column, d,
        int(x.dtype == np.float16), _ptr(x), _ptr(labels), _ptr(weights),
        row_start, capacity, cr_hint, ctypes.byref(res))
    return (res.rows_written, res.bytes_consumed, res.truncated, res.has_cr,
            res.bad_lines)


def parse_csv_dense_split(chunk, offset: int, delimiter: int, label_column: int,
                          weight_column: int, x, labels, weights, row_start: int,
                          cr_hint: int = -1, workers: int = 1,
                          min_rows: int = SPLIT_MIN_ROWS) -> Tuple[int, int, int, int, int, int]:
    """``parse_csv_dense`` with the rows of the call split over up to
    ``workers`` threads, at least ``min_rows`` rows each (the producer
    keeps the default; tests lower it to split small inputs), every row
    in the place the one-thread call gives it: the same returns and
    output rows (after a line that gives no row, only the rows written
    are the same). Returns them with the number of threads that parsed
    the rows (1 when the call was not split)."""
    lib = load()
    ptr, n = _chunk_at(chunk, offset)
    capacity, d = _check_dense_buffers(x, labels, weights)
    res = _CsvSplitResult()
    lib.dmlc_parse_csv_dense_split(
        ptr, n, delimiter, label_column, weight_column, d,
        int(x.dtype == np.float16), _ptr(x), _ptr(labels), _ptr(weights),
        row_start, capacity, cr_hint, workers, min_rows, ctypes.byref(res))
    csv = res.csv
    return (csv.rows_written, csv.bytes_consumed, csv.truncated, csv.has_cr,
            csv.bad_lines, res.workers)


def parse_rowrec_ell(chunk, offset: int, indices, values, nnz, labels, weights,
                     row_start: int) -> Tuple[int, int, int, int, int]:
    """Whole RecordIO rowrec records of ``chunk[offset:]`` → ELL rows
    ``row_start..`` of ``indices`` [capacity, K] int32, ``values`` (f32/f16),
    ``nnz``, ``labels``, ``weights``. Stops at buffer-full or at a trailing
    partial record. Returns (rows_written, bytes_consumed, truncated,
    bad_records, corrupt); ``corrupt`` is set when a full frame header
    carries no magic."""
    lib = load()
    ptr, n = _chunk_at(chunk, offset)
    capacity, k = _check_ell_buffers(indices, values, nnz, labels, weights)
    res = _EllResult()
    lib.dmlc_parse_rowrec_ell(
        ptr, n, k, int(values.dtype == np.float16), _ptr(indices), _ptr(values),
        _ptr(nnz), _ptr(labels), _ptr(weights), row_start, capacity,
        ctypes.byref(res))
    return (res.rows_written, res.bytes_consumed, res.truncated,
            res.bad_records, res.corrupt)


def _check_spans(starts, sizes) -> None:
    check(starts.flags.c_contiguous and starts.dtype == np.int64
          and sizes.flags.c_contiguous and sizes.dtype == np.int64,
          "starts/sizes must be C-contiguous int64")


def parse_rowrec_gather_ell(buf, starts, sizes, lo: int, n_recs: int, indices,
                            values, nnz, labels, weights,
                            row_start: int) -> Tuple[int, int, int, int, int]:
    """The shuffled-read gather: the framed rowrec records at the byte
    slices ``(starts[lo + i], sizes[lo + i])`` of ``buf`` (uint8), in that
    order → ELL rows ``row_start..`` (buffers of ``parse_rowrec_ell``).
    One call per batch; resumed calls pass a new ``lo``. Stops at
    buffer-full. Returns (rows_written, recs_consumed, truncated,
    bad_records, corrupt); ``corrupt`` is set when a slice holds no
    complete record (the index and the data disagree)."""
    lib = load()
    check(buf.flags.c_contiguous and buf.dtype == np.uint8,
          "gather buf must be C-contiguous uint8")
    _check_spans(starts, sizes)
    check(0 <= lo and n_recs >= 0 and lo + n_recs <= len(starts)
          and len(sizes) >= len(starts), "gather range outside starts/sizes")
    capacity, k = _check_ell_buffers(indices, values, nnz, labels, weights)
    res = _EllResult()
    lib.dmlc_parse_rowrec_gather_ell(
        _ptr(buf), ctypes.c_void_p(starts.ctypes.data + lo * 8),
        ctypes.c_void_p(sizes.ctypes.data + lo * 8), n_recs, k,
        int(values.dtype == np.float16), _ptr(indices), _ptr(values),
        _ptr(nnz), _ptr(labels), _ptr(weights), row_start, capacity,
        ctypes.byref(res))
    return (res.rows_written, res.bytes_consumed, res.truncated,
            res.bad_records, res.corrupt)


def walk_record_spans(buf, starts, sizes) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """The batched point-read frame walk: each ``(starts[i], sizes[i])``
    slice of ``buf`` must begin at a RecordIO frame head. Returns
    ``(payload_offs, payload_lens, n_multipart, n_corrupt)``:
    ``payload_offs[i]`` is the payload's offset into ``buf`` for a
    single-frame record, -2 for a multi-part chain (the caller joins its
    parts) and -1 for a slice with no valid head."""
    lib = load()
    check(buf.flags.c_contiguous and buf.dtype == np.uint8,
          "walk buf must be C-contiguous uint8")
    _check_spans(starts, sizes)
    check(len(sizes) == len(starts), "starts/sizes lengths differ")
    n = len(starts)
    out_off = np.empty(n, dtype=np.int64)
    out_len = np.empty(n, dtype=np.int64)
    nm, nc = ctypes.c_int64(), ctypes.c_int64()
    lib.dmlc_walk_record_spans(_ptr(buf), _ptr(starts), _ptr(sizes), n,
                               _ptr(out_off), _ptr(out_len), ctypes.byref(nm),
                               ctypes.byref(nc))
    return out_off, out_len, int(nm.value), int(nc.value)


def shuffle_mt19937(rnd, perm: np.ndarray) -> bool:
    """Fisher-Yates ``perm`` (C-contiguous int64) in place, bit-identical
    to ``rnd.shuffle(perm)`` for a CPython ``random.Random``: the same
    Mersenne-Twister draws, rejection sampling and swaps. ``rnd`` is left
    untouched. Returns False, leaving ``perm`` as it was, when
    ``len(perm) >= 2**31``: ``getrandbits`` there draws several words per
    call, which the kernel does not mirror, and the caller runs
    ``rnd.shuffle`` itself, with the same swaps."""
    if len(perm) >= (1 << 31):
        return False
    lib = load()
    check(perm.flags.c_contiguous and perm.dtype == np.int64,
          "shuffle perm must be C-contiguous int64")
    state = rnd.getstate()
    check(state[0] == 3 and len(state[1]) == 625,
          "unsupported random.Random state version")
    key = np.asarray(state[1][:624], dtype=np.uint32)
    lib.dmlc_shuffle_mt19937(_ptr(key), state[1][624], len(perm), _ptr(perm))
    return True


def _text_ell(fn, chunk, offset, base, indices, values, nnz, labels, weights,
              row_start, cr_hint):
    ptr, n = _chunk_at(chunk, offset)
    capacity, k = _check_ell_buffers(indices, values, nnz, labels, weights)
    res = _DenseResult()
    fn(ptr, n, base, k, int(values.dtype == np.float16), _ptr(indices),
       _ptr(values), _ptr(nnz), _ptr(labels), _ptr(weights), row_start,
       capacity, cr_hint, ctypes.byref(res))
    return res.rows_written, res.bytes_consumed, res.truncated, res.has_cr


def parse_libfm_ell(chunk, offset: int, base: int, indices, values, nnz,
                    labels, weights, row_start: int,
                    cr_hint: int = -1) -> Tuple[int, int, int, int]:
    """libfm ``chunk[offset:]`` → ELL rows (buffers of ``parse_rowrec_ell``,
    resumable chunk of ``parse_libsvm_dense``); fields are checked, then
    dropped. Returns (rows_written, bytes_consumed, truncated, has_cr)."""
    return _text_ell(load().dmlc_parse_libfm_ell, chunk, offset, base, indices,
                     values, nnz, labels, weights, row_start, cr_hint)


def parse_libsvm_ell(chunk, offset: int, base: int, indices, values, nnz,
                     labels, weights, row_start: int,
                     cr_hint: int = -1) -> Tuple[int, int, int, int]:
    """libsvm ``chunk[offset:]`` → ELL rows (contract of
    ``parse_libfm_ell``). Returns (rows_written, bytes_consumed,
    truncated, has_cr)."""
    return _text_ell(load().dmlc_parse_libsvm_ell, chunk, offset, base,
                     indices, values, nnz, labels, weights, row_start, cr_hint)
