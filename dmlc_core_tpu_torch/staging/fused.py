"""Batch producers: rowrec, libsvm, libfm and csv files → ring slots of
fixed-shape batches (the port of ``dmlc_core_tpu/staging/fused.py``).

The native producers hand each chunk of the file straight to a fused
kernel of the native parse core (``data/native.py``), which writes the
rows into the current ring slot: no CSR arrays, no per-row Python.

- ``FusedEllRowRecBatches``: rowrec RecordIO → ELL [B,K], over raw mmap
  windows (the kernel stops at a trailing partial record; a record wider
  than the window widens it), or with ``?index=`` through an indexed,
  optionally shuffled split whose batches of records the gather kernel
  parses in permutation order.
- ``FusedEllLibSVMBatches`` / ``FusedEllLibFMBatches``: libsvm / libfm
  text → ELL [B,K]; libfm fields are checked, then dropped.
- ``FusedDenseLibSVMBatches`` / ``FusedDenseCSVBatches``: libsvm / csv
  text → dense [B,D].

A producer of one local file maps its part's byte range, ``[begin,
end)`` as ``io.split.part_range`` snaps it to record starts, and hands
the kernels views of the page cache; text is read in line-aligned
chunks of that range. What cannot be mapped takes the chunks of
``io.split.create`` instead, chosen from the input's kind: a file set
(a ``;`` list, a directory or a regex), a text ``#cachefile``, and a
rowrec file whose first 4 MiB hold a compressed block (its chunks come
back decoded). A UTF-8 BOM at the start of a part is skipped.
The native producers keep the JAX package's fused semantics, which
differ from the parser path in three places: libsvm/libfm
``indexing_mode=-1`` is resolved ONCE from the head of the file (the
parsers detect it per block), libsvm ``qid`` is dropped, and with
``nthread`` > 1 (``ShardedFusedBatches``) each sub-shard pads its own
tail batch and batches interleave round-robin.

``ell_batches`` and ``dense_batches`` always return a native producer.
The plain versions the tests and ``chip_smoke.py`` hold them to are
``EllRowRecBatches`` (rowrec decoded record by record in numpy),
``GenericBatchStream`` (a parser running its Python grammar,
``parse_block_plain`` → ``FixedShapeBatcher``) and, for indexed URIs,
``LegacyIndexedSplit`` (one seek per record) → numpy decode →
``FixedShapeBatcher``, all from ``plain_batches``; none runs the native
parse core.

A yielded batch views a ring slot and stays valid until ``ring_slots - 1``
further batches have been produced. A producer allocates its ring at its
first iteration, on the thread that drains it (``batcher.alloc_ring``):
drained by a staging pipeline that copies ring slots to the card in
place, the slots are page-locked.
"""

from __future__ import annotations

import mmap
import os
import random
import struct
from functools import partial
from typing import Iterator, List, Optional

import numpy as np

from ..data import create_parser, native, parser_options
from ..data.rowrec import RowRecParser
from ..data.strtonum import parse_triple
from ..io import split as io_split
from ..io import codec
from ..io.recordio import (
    CFLAG_COMPRESSED,
    KMAGIC,
    chunk_has_compressed,
    decode_flag,
    decode_length,
    scan_compressed_blob,
)
from ..io.stream import Stream
from ..io.uri import URISpec, rejoin_query, uri_int
from ..telemetry import default_registry as _default_registry
from ..utils.cpus import available_cpus, parse_threads
from ..utils.logging import Error, check
from ..utils.prefetch import Prefetcher
from .batcher import (
    Batch,
    BatchSpec,
    FixedShapeBatcher,
    alloc_dense_slot,
    alloc_ell_slot,
    alloc_ring,
    ell_batch,
    fill_ell_rows,
    pad_tail,
)

__all__ = [
    "EllRowRecBatches",
    "FusedDenseCSVBatches",
    "FusedDenseLibSVMBatches",
    "FusedEllLibFMBatches",
    "FusedEllLibSVMBatches",
    "FusedEllRowRecBatches",
    "GenericBatchStream",
    "ShardedFusedBatches",
    "dense_batches",
    "ell_batches",
    "plain_batches",
]

_BOM = b"\xef\xbb\xbf"
_MMAP_CHUNK = 32 << 20
_PROBE_BYTES = 262144
# the head of a rowrec file that decides its route (writers write uniform
# files; a compressed block past it raises where the mmap route meets it)
_REC_SNIFF_BYTES = 4 << 20

# registry mirrors of the fused producers' counters (the per-instance
# attributes stay authoritative for io_stats(); these give the fleet
# view over heartbeats and scrapes), under the JAX package's names
_REG = _default_registry()
_ROWS_OUT = _REG.counter(
    "staging.rows_out", help="rows emitted in fixed-shape batches"
)
_TRUNCATED = _REG.counter(
    "staging.truncated_nnz", help="features dropped by fixed-shape overflow"
)
_BAD_RECORDS = _REG.counter(
    "staging.bad_records", help="malformed records skipped by fused parsers"
)
_PARSE_SPLIT_ROWS = _REG.counter(
    "staging.parse_split_rows",
    help="rows parsed by native calls split over more than one thread",
)


class EllRowRecBatches:
    """The plain rowrec producer: ELL Batches over part ``part_index`` of
    ``num_parts`` of a local rowrec file, decoded record by record in
    numpy and written into a ring of ``ring`` packed slots (allocated at
    the first iteration)."""

    def __init__(
        self,
        path: str,
        spec: BatchSpec,
        part_index: int = 0,
        num_parts: int = 1,
        ring: int = 10,
    ) -> None:
        _check_ell_spec(spec)
        self.spec = spec
        self._parser = RowRecParser(path, part_index, num_parts)
        self.ring_slots = max(2, ring)
        self._ring = None
        self._slot = 0
        self.truncated_nnz = 0

    def _emit(self, n_valid: int) -> Batch:
        packed, views = self._ring[self._slot]
        self._slot = (self._slot + 1) % len(self._ring)
        return ell_batch(packed, views, n_valid)

    def __iter__(self) -> Iterator[Batch]:
        if self._ring is None:
            self._ring = alloc_ring(alloc_ell_slot, self.spec, self.ring_slots)
        B = self.spec.batch_size
        fill = 0
        for blk in self._parser:
            start = 0
            while start < blk.size:
                take = min(B - fill, blk.size - start)
                views = self._ring[self._slot][1]
                self.truncated_nnz += fill_ell_rows(
                    views, fill, blk.slice(start, start + take), self.spec
                )
                fill += take
                start += take
                if fill == B:
                    yield self._emit(B)
                    fill = 0
        if fill:
            pad_tail(self._ring[self._slot][1], fill)
            yield self._emit(fill)

    def close(self) -> None:
        self._parser.close()


class LegacyIndexedSplit(io_split.InputSplit):
    """The plain version of an indexed split (``?index=``): the
    (seed, epoch) permutation rule of ``IndexedRecordIOSplitter`` run by
    ``random.Random.shuffle`` on a Python list, then one seek and one
    read per record, ``batch_size`` records a chunk; over a
    compressed-block index, each record sliced out of its block, which is
    read and decoded with ``decode_block`` (the last block kept). No
    window, no span planning, no native code. Each ``reset_partition``
    starts the next epoch, as the indexed split's does."""

    def __init__(self, path: str, index_path: str, part_index: int,
                 num_parts: int, shuffle, batch_size: int, seed: int,
                 epoch: int, skip_records: int) -> None:
        with open(index_path) as f:
            vals = f.read().split()[1::2]
        self._end = os.path.getsize(path)
        if vals and ":" in vals[0]:
            # (block offset, offset in the decoded block), file order
            self._recs = sorted(tuple(int(x) for x in v.split(":")) for v in vals)
            self._blocks = sorted({b for b, _o in self._recs}) + [self._end]
            self._offs = None
        else:
            self._offs = sorted(int(t) for t in vals)
        self._block = (None, b"")
        self._fp = open(path, "rb")
        self._mode = io_split.normalize_shuffle(shuffle)
        self._bs, self._seed = batch_size, seed
        self._epoch, self._skip = epoch - 1, skip_records
        self._order: List[int] = []
        self._pos = 0
        self.reset_partition(part_index, num_parts)

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        n = len(self._offs if self._offs is not None else self._recs)
        step = -(-n // num_parts)
        self._lo, self._hi = min(part_index * step, n), min((part_index + 1) * step, n)
        self._order, self._pos = [], 0
        self.before_first()

    def before_first(self) -> None:
        lo, hi, bs = self._lo, self._hi, self._bs
        if hi <= lo:
            return
        self._epoch += 1
        rnd = random.Random(111 + self._seed + 1_000_003 * self._epoch)
        order = list(range(lo, hi))
        if self._mode == "batch":
            full = lo + (hi - lo) // bs * bs
            spans = list(range(lo, full, bs))
            rnd.shuffle(spans)
            spans += [full] if full < hi else []
            order = [i for s in spans for i in range(s, min(s + bs, hi))]
        elif self._mode:
            rnd.shuffle(order)
        self._order, self._pos = order[self._skip:], 0
        self._skip = 0

    def _read(self, begin: int, end: int) -> bytes:
        self._fp.seek(begin)
        return self._fp.read(end - begin)

    def _record(self, i: int) -> bytes:
        if self._offs is not None:
            end = self._offs[i + 1] if i + 1 < len(self._offs) else self._end
            return self._read(self._offs[i], end)
        b, o = self._recs[i]
        if self._block[0] != b:
            frame = self._read(b, self._blocks[self._blocks.index(b) + 1])
            self._block = (b, codec.decode_block(scan_compressed_blob(memoryview(frame), 0)[0])[0])
        raw = self._block[1]
        nxt = self._recs[i + 1] if i + 1 < len(self._recs) else None
        return raw[o:nxt[1]] if nxt is not None and nxt[0] == b else raw[o:]

    def next_chunk(self) -> Optional[bytes]:
        take = self._order[self._pos:self._pos + self._bs]
        if not take:
            return None
        self._pos += len(take)
        return b"".join(self._record(i) for i in take)

    def close(self) -> None:
        self._fp.close()


class PlainBlockSplit(io_split.InputSplit):
    """The plain version of a part of one RecordIO file that may hold
    compressed blocks: the part's bytes (``io.split.part_range``) walked
    frame by frame in Python, one chunk per compressed block, decoded
    here with ``decode_block``, or per run of v1 frames."""

    def __init__(self, path: str, part_index: int, num_parts: int) -> None:
        begin, end = io_split.part_range(path, part_index, num_parts, "recordio")
        with open(path, "rb") as f:
            f.seek(begin)
            self._data = memoryview(f.read(end - begin))
        self._pos = 0

    def next_chunk(self) -> Optional[bytes]:
        view, pos = self._data, self._pos
        start, n = pos, len(view)
        while pos < n:
            magic, lrec = struct.unpack_from("<II", view, pos)
            check(magic == KMAGIC, "RecordIO: bad magic")
            if decode_flag(lrec) & CFLAG_COMPRESSED:
                if pos > start:
                    break  # the v1 run before the block goes first
                blob, self._pos = scan_compressed_blob(view, pos)
                return codec.decode_block(blob)[0]
            pos += 8 + ((decode_length(lrec) + 3) & ~3)
        self._pos = pos
        return bytes(view[start:pos]) if pos > start else None

    def close(self) -> None:
        self._data = memoryview(b"")


def _legacy_split(path: str, args, part_index: int, num_parts: int):
    """The plain split of a routed rowrec URI's options: a
    ``LegacyIndexedSplit`` (or a RecordIOSplitter without an index),
    under ``InputSplitShuffle`` when ``shuffle_parts`` asks for it."""
    seed = uri_int(args, "seed", 0)
    if "index" in args:
        base = LegacyIndexedSplit(
            path, io_split.local_path(args["index"]), part_index, num_parts,
            args.get("shuffle", "0"), uri_int(args, "batch_size", 256), seed,
            uri_int(args, "epoch", 0), uri_int(args, "skip_records", 0))
    else:
        base = io_split.RecordIOSplitter(path, part_index, num_parts)
    nsp = uri_int(args, "shuffle_parts", 0)
    if nsp:
        return io_split.InputSplitShuffle(base, part_index, num_parts, nsp, seed)
    return base


def _check_ell_spec(spec: BatchSpec) -> None:
    check(spec.layout == "ell", f"ELL producer given layout {spec.layout!r}")
    check(spec.value_dtype in (np.dtype(np.float32), np.dtype(np.float16)),
          f"ELL staging takes f32/f16 values, not {spec.value_dtype}")
    check(spec.index_dtype == np.dtype(np.int32),
          "ELL staging stages int32 indices")


def _one_local_file(uri: str) -> Optional[str]:
    """The path when ``uri`` (options and fragment taken off) names one
    existing local file; None for a file set (a ``;`` list, a directory,
    a regex) or another filesystem's URI (``s3://``, ``fault://``,
    ``mem://``, ...), which ``io.split.create`` reads."""
    path = uri[len("file://"):] if uri.startswith("file://") else uri
    if ";" in path or "://" in path:
        return None
    return path if os.path.isfile(path) else None


def _uri_head(uri: str) -> bytes:
    """The head of the first file of ``uri``: every part of a file set
    resolves an auto setting from the same bytes."""
    with Stream.create(io_split.expand_files(uri)[0].path, "r") as f:
        return f.read(_PROBE_BYTES)


def _rec_file_compressed(path: str) -> bool:
    """Does the head of a rowrec file hold a compressed-block frame? The
    native kernels walk v1 frames only, so such a file takes the split
    route, whose chunks come back decoded."""
    with open(path, "rb") as f:
        return chunk_has_compressed(f.read(_REC_SNIFF_BYTES))


def _probe_base(chunk) -> int:
    """The libsvm auto indexing base from the head of a chunk (reference
    heuristic, libsvm_parser.h:159-168): 1-based iff no feature id 0
    appears in the first ~256 KB."""
    head = bytes(memoryview(chunk)[:_PROBE_BYTES])
    min_idx: Optional[int] = None
    for line in head.splitlines()[:2000]:
        toks = line.split(b"#", 1)[0].split()
        for tok in toks[1:]:
            if tok.startswith(b"qid:"):
                continue
            try:
                idx = int(tok.split(b":", 1)[0])
            except ValueError:
                continue
            if idx == 0:
                return 0
            if min_idx is None or idx < min_idx:
                min_idx = idx
    return 1 if (min_idx is not None and min_idx > 0) else 0


def _probe_libfm_base(chunk) -> int:
    """The libfm auto indexing base from the head of a chunk: 1-based iff
    every field id AND feature id seen is > 0 (libfm_parser.h:67-144),
    with tokens taken or skipped by the parsers' own ``parse_triple``."""
    head = bytes(memoryview(chunk)[:_PROBE_BYTES])
    seen = False
    for line in head.splitlines()[:2000]:
        for tok in line.split()[1:]:
            triple = parse_triple(tok)
            if triple is None:
                continue
            fid, feat, _v = triple
            if fid <= 0 or feat <= 0:
                return 0
            seen = True
    return 1 if seen else 0


class _MmapFile:
    """Bytes ``[begin, end)`` of a local file mapped read-only; the native
    kernels read the page cache directly, with no per-chunk copy."""

    def __init__(self, path: str, begin: int, end: int,
                 chunk_bytes: int = _MMAP_CHUNK) -> None:
        self._f = open(path, "rb")
        self.begin, self.end = begin, end
        self._mm = (mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
                    if end > begin else None)
        self._chunk = chunk_bytes
        self._pos = begin

    def before_first(self) -> None:
        self._pos = self.begin

    def close(self) -> None:
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass  # a chunk view is still alive; GC finishes the unmap
            self._mm = None
        self._f.close()


class _MmapChunks(_MmapFile):
    """Line-aligned chunks of the mapped range."""

    def next_chunk(self):
        if self._mm is None or self._pos >= self.end:
            return None
        begin = self._pos
        end = min(begin + self._chunk, self.end)
        if end < self.end:
            nl = self._mm.rfind(b"\n", begin, end)
            if nl < begin:
                nl = self._mm.find(b"\n", end, self.end)
                end = self.end if nl < 0 else nl + 1
            else:
                end = nl + 1
        self._pos = end
        return memoryview(self._mm)[begin:end]


class _MmapRawChunks(_MmapFile):
    """Raw windows of the mapped range, moved by the caller:
    ``advance(consumed)`` after a kernel call, ``grow()`` when not one
    whole record fits the window."""

    def __init__(self, path: str, begin: int, end: int,
                 chunk_bytes: int = _MMAP_CHUNK) -> None:
        super().__init__(path, begin, end, chunk_bytes)
        self._width = chunk_bytes

    def window(self):
        """The current window, or None at the end of the range."""
        if self._mm is None or self._pos >= self.end:
            return None
        end = min(self._pos + self._width, self.end)
        return memoryview(self._mm)[self._pos:end]

    def advance(self, consumed: int) -> None:
        self._pos += consumed
        if consumed:
            self._width = self._chunk

    def grow(self) -> bool:
        """Double the window; False when it already reaches the end of
        the range (the file is truncated)."""
        if self._pos + self._width >= self.end:
            return False
        self._width *= 2
        return True


class _RingBatches:
    """A ring of ``ring`` packed slots in the producer's layout, allocated
    at the first iteration (``_open_ring``), and the counters every
    native producer keeps."""

    _layout = "ell"

    def __init__(self, spec: BatchSpec, ring: int) -> None:
        check(spec.layout == self._layout,
              f"{type(self).__name__} needs layout={self._layout!r}")
        check(spec.value_dtype in (np.dtype(np.float32), np.dtype(np.float16)),
              f"native producers stage f32/f16 values, not {spec.value_dtype}")
        if spec.layout == "ell":
            _check_ell_spec(spec)
        self.spec = spec
        self.ring_slots = max(2, ring)
        self._ring = None
        self._slot = 0
        self.rows_in = 0
        self.rows_out = 0
        self.truncated_nnz = 0

    def _open_ring(self) -> None:
        """Allocate the ring on the draining thread, once."""
        if self._ring is None:
            alloc = alloc_ell_slot if self.spec.layout == "ell" else alloc_dense_slot
            self._ring = alloc_ring(alloc, self.spec, self.ring_slots)

    @property
    def _views(self):
        return self._ring[self._slot][1]

    def _emit(self, n_valid: int) -> Batch:
        """The current slot as a Batch; the ring moves on."""
        packed, v = self._ring[self._slot]
        self._slot = (self._slot + 1) % len(self._ring)
        self.rows_out += n_valid
        _ROWS_OUT.inc(n_valid)
        if self.spec.overflow == "error" and self.truncated_nnz:
            limit = (f"beyond max_nnz={self.spec.max_nnz}"
                     if self.spec.layout == "ell"
                     else f"outside [0, {self.spec.num_features})")
            raise Error(f"{self.truncated_nnz} features {limit} with "
                        "overflow='error'")
        if self.spec.layout == "dense":
            return Batch(labels=v["labels"], weights=v["weights"],
                         n_valid=n_valid, x=v["x"], packed=packed)
        return ell_batch(packed, v, n_valid)

    def _tail(self, fill: int) -> Batch:
        """The zero-padded last batch (padding rows carry weight 0)."""
        pad_tail(self._views, fill)
        return self._emit(fill)


class _FusedTextBatches(_RingBatches):
    """Shared loop of the text producers: line-aligned chunks, one
    resumable native call after another, into ring slots. One local file
    is mapped; a file set or a ``#cachefile`` is read through
    ``io.split.create`` (a ``CachedInputSplit`` replays the cache file
    from the second epoch). Iterating again starts the next epoch.
    Subclasses implement ``_parse``."""

    _format = ""

    def __init__(self, uri: str, spec: BatchSpec, part_index: int,
                 num_parts: int, ring: int) -> None:
        uspec = URISpec(uri, part_index, num_parts)
        self._options = parser_options(self._format, uspec.args)
        self.path = None if uspec.cache_file else _one_local_file(uspec.uri)
        # the split's URI: the files and the fragment, not the options
        fragment = uri.partition("#")[2]
        self._split_uri = uspec.uri + ("#" + fragment if fragment else "")
        if self.path is None:
            io_split.expand_files(uspec.uri)  # raises on what cannot be read
        self._head_uri = uspec.uri
        super().__init__(spec, ring)
        native.load()
        self._parts = (part_index, num_parts)
        self._split = None

    def io_stats(self) -> dict:
        """The split's counters (a ``#cachefile``'s
        ``cache_epochs_replayed``), or an empty dict on the mmap path."""
        return getattr(self._split, "io_stats", dict)()

    def _parse(self, chunk, off: int, fill: int, cr_hint: int):
        """One resumable native call → (rows, consumed, cr_hint)."""
        raise NotImplementedError

    def __iter__(self) -> Iterator[Batch]:
        self._open_ring()
        if self._split is not None:
            self._split.before_first()
        elif self.path is not None:  # opened here: a refused URI leaks no fd
            self._split = _MmapChunks(
                self.path, *io_split.part_range(self.path, *self._parts, "text"))
        else:
            self._split = io_split.create(self._split_uri, *self._parts, type="text")
        B = self.spec.batch_size
        fill = 0
        first = True
        while True:
            chunk = self._split.next_chunk()
            if chunk is None:
                break
            off = 0
            if first:  # a UTF-8 BOM opens the part (text_parser.h:81-95)
                off = 3 if bytes(chunk[:3]) == _BOM else 0
                first = False
            n = len(chunk)
            cr_hint = -1  # the kernel probes for '\r' once per chunk
            while off < n:
                rows, consumed, cr_hint = self._parse(chunk, off, fill, cr_hint)
                if consumed == 0 and rows == 0:
                    break
                off += consumed
                fill += rows
                self.rows_in += rows
                if fill == B:
                    yield self._emit(B)
                    fill = 0
        if fill:
            yield self._tail(fill)

    def close(self) -> None:
        if self._split is not None:
            self._split.close()


class _FusedBaseTextBatches(_FusedTextBatches):
    """A text producer whose ids take an indexing base (libsvm, libfm)."""

    _probe = staticmethod(_probe_base)

    def __init__(self, uri, spec, part_index=0, num_parts=1, indexing_mode=0,
                 ring=10) -> None:
        super().__init__(uri, spec, part_index, num_parts, ring)
        mode = int(self._options.get("indexing_mode", indexing_mode))
        # auto: every part must agree, so the file's head decides
        self._base = (1 if mode > 0 else 0) if mode >= 0 else self._probe(
            _uri_head(self._head_uri))


class FusedDenseLibSVMBatches(_FusedBaseTextBatches):
    """libsvm text → dense [B,D] (``dmlc_parse_libsvm_dense``)."""

    _format = "libsvm"
    _layout = "dense"

    def _parse(self, chunk, off, fill, cr_hint):
        v = self._views
        rows, consumed, trunc, cr_hint = native.parse_libsvm_dense(
            chunk, off, self._base, v["x"], v["labels"], v["weights"], fill,
            cr_hint)
        self.truncated_nnz += trunc
        if trunc:
            _TRUNCATED.inc(trunc)
        return rows, consumed, cr_hint


class FusedDenseCSVBatches(_FusedTextBatches):
    """csv text → dense [B,D] (``dmlc_parse_csv_dense_split``), with the
    cell rules of ``CSVParser``; ``label_column``, ``weight_column`` and
    ``delimiter`` (one ASCII byte) ride the URI or the constructor, and a
    non-empty line without a delimiter raises.

    Each native call splits its rows over ``parse_workers`` threads, each
    row in the place one thread gives it, so the batches are those of a
    one-thread parse: ``DMLC_PARSE_THREADS``, else half the CPUs the
    process may use (the loop, the staging thread and this producer's
    own thread keep the rest), shared by the ``_shares`` sub-producers
    of one ``nthread`` fan-out."""

    _format = "csv"
    _layout = "dense"

    def __init__(self, uri, spec, part_index=0, num_parts=1, label_column=-1,
                 weight_column=-1, delimiter=",", ring=10, *, _shares=1) -> None:
        super().__init__(uri, spec, part_index, num_parts, ring)
        opts = self._options
        check(opts.get("dtype", "float32") == "float32",
              "the native csv producer parses float32 cells")
        self._label_col = int(opts.get("label_column", label_column))
        self._weight_col = int(opts.get("weight_column", weight_column))
        check(self._label_col != self._weight_col or self._label_col < 0,
              "Must have distinct columns for labels and instance weights")
        delim = str(opts.get("delimiter", delimiter))
        check(len(delim) == 1 and ord(delim) < 128,
              f"the native csv producer takes a one-byte ASCII delimiter, "
              f"not {delim!r}")
        self._delim = ord(delim)
        self.bad_lines = 0
        self.parse_workers = max(
            1, parse_threads(max(1, available_cpus() // 2)) // _shares)

    def _parse(self, chunk, off, fill, cr_hint):
        v = self._views
        rows, consumed, trunc, cr_hint, bad, workers = native.parse_csv_dense_split(
            chunk, off, self._delim, self._label_col, self._weight_col,
            v["x"], v["labels"], v["weights"], fill, cr_hint, self.parse_workers)
        if workers > 1:
            _PARSE_SPLIT_ROWS.inc(rows)
        self.truncated_nnz += trunc
        if trunc:
            _TRUNCATED.inc(trunc)
        if bad:
            self.bad_lines += bad
            raise Error("Delimiter not found in the line. "
                        "Expected it to separate fields.")
        return rows, consumed, cr_hint


class FusedEllLibSVMBatches(_FusedBaseTextBatches):
    """libsvm text → ELL [B,K] (``dmlc_parse_libsvm_ell``): '#' comments
    and a ``qid:N`` second token are consumed."""

    _format = "libsvm"

    def _parse(self, chunk, off, fill, cr_hint):
        v = self._views
        rows, consumed, trunc, cr_hint = native.parse_libsvm_ell(
            chunk, off, self._base, v["indices"], v["values"], v["nnz"],
            v["labels"], v["weights"], fill, cr_hint)
        self.truncated_nnz += trunc
        if trunc:
            _TRUNCATED.inc(trunc)
        return rows, consumed, cr_hint


class FusedEllLibFMBatches(_FusedBaseTextBatches):
    """libfm text → ELL [B,K] (``dmlc_parse_libfm_ell``); fields are
    checked, then dropped (the ELL layout has no field axis)."""

    _format = "libfm"
    _probe = staticmethod(_probe_libfm_base)

    def _parse(self, chunk, off, fill, cr_hint):
        v = self._views
        rows, consumed, trunc, cr_hint = native.parse_libfm_ell(
            chunk, off, self._base, v["indices"], v["values"], v["nnz"],
            v["labels"], v["weights"], fill, cr_hint)
        self.truncated_nnz += trunc
        if trunc:
            _TRUNCATED.inc(trunc)
        return rows, consumed, cr_hint


def _compressed_head(buf, off: int) -> bool:
    """Does ``buf[off:]`` start with a compressed-block RecordIO frame
    (cflag bit 2), which the native kernel does not walk?"""
    head = bytes(memoryview(buf)[off:off + 8])
    if len(head) != 8:
        return False
    magic, lrec = struct.unpack("<II", head)
    return magic == KMAGIC and bool((lrec >> 29) & 4)


class FusedEllRowRecBatches(_RingBatches):
    """rowrec RecordIO → ELL [B,K] (``dmlc_parse_rowrec_ell``): frame
    scan, rowrec decode and ELL fill in one native pass.

    One local v1 file is read as raw mmap windows of the part's byte
    range. A URI with ``?index=``, ``?shuffle_parts=`` or
    ``&dynamic_shards=1`` (a ``DynamicShardSource`` leasing micro-shards
    from the tracker), a live stream's ``…/manifest.json?…`` or
    ``dir?stream=1`` (a ``StreamSource``; a bare manifest path without a
    query raises), a file set and a file whose head holds compressed
    blocks go through ``io.split.create``: a windowed shuffle
    (``shuffle=record|batch|window``) hands ``(buf, starts, sizes)`` views of each batch's
    records in permutation order to ``dmlc_parse_rowrec_gather_ell``,
    one native call per batch; other splits (file order, the legacy
    per-record loop, the macro-shuffle) hand whole-record chunks,
    decoded from their blocks, to the chunk kernel. There is no
    fallback: a gather that makes no progress, a record the index cuts
    short, a corrupt block and a compressed block met on the mmap route
    raise. A ``#cachefile`` raises, as in the JAX package.
    ``io_stats()`` gives the split's counters."""

    def __init__(self, uri: str, spec: BatchSpec, part_index: int = 0,
                 num_parts: int = 1, ring: int = 10) -> None:
        uspec = URISpec(uri, part_index, num_parts)
        check(not uspec.cache_file,
              "fused rowrec staging does not take a #cachefile (it already "
              "reads the binary shard at full speed); drop the fragment")
        split_args = parser_options("rowrec", uspec.args)
        # the split refuses options of an indexed read without an index;
        # a seed alone changes nothing of a plain read
        routed = bool(set(split_args) - {"seed"})
        if io_split.is_stream_uri(uri) and not routed:
            # the JAX producer maps the manifest's JSON as RecordIO and
            # fails on its first frame
            raise Error(f"{uspec.uri} names a live stream's manifest: follow it with "
                        "a query, e.g. '?stream=1' or '?shuffle=window&window=N'")
        self.path = _one_local_file(uspec.uri)
        self._mmap = not (routed or self.path is None or _rec_file_compressed(self.path))
        super().__init__(spec, ring)
        native.load()
        if self._mmap:
            self._split = _MmapRawChunks(
                self.path, *io_split.part_range(self.path, part_index,
                                                num_parts, "recordio"))
        else:
            self._split = io_split.create(
                uspec.uri + rejoin_query(split_args), part_index, num_parts,
                type="recordio")
        self._gather = bool(getattr(self._split, "supports_gather", bool)())
        self.bad_records = 0

    def io_stats(self) -> dict:
        """The split's I/O counters (``IndexedRecordIOSplitter.io_stats``),
        or an empty dict on the plain mmap path."""
        fn = getattr(self._split, "io_stats", None)
        return fn() if fn is not None else {}

    def _count(self, rows: int, trunc: int, bad: int) -> None:
        self.rows_in += rows
        self.truncated_nnz += trunc
        self.bad_records += bad
        if trunc:
            _TRUNCATED.inc(trunc)
        if bad:
            _BAD_RECORDS.inc(bad)

    def _feed(self, chunk, off: int, fill: int):
        """Parse ``chunk[off:]`` into the current slot → (off, fill,
        progressed)."""
        v = self._views
        rows, consumed, trunc, bad, corrupt = native.parse_rowrec_ell(
            chunk, off, v["indices"], v["values"], v["nnz"], v["labels"],
            v["weights"], fill)
        self._count(rows, trunc, bad)
        if corrupt:
            raise Error("rowrec: corrupt RecordIO frame (bad magic) at byte "
                        f"{off + consumed} of the current chunk")
        if not (rows or consumed) and _compressed_head(chunk, off):
            raise Error("rowrec: compressed RecordIO block mid-file; the mmap "
                        "fast path reads v1 frames only — read via a sharded/"
                        "indexed URI (the splitter path decodes blocks)")
        return off + consumed, fill + rows, bool(rows or consumed)

    def __iter__(self) -> Iterator[Batch]:
        self._open_ring()
        if self._gather:
            yield from self._iter_gather()
        elif self._mmap:
            yield from self._iter_mmap()
        else:
            yield from self._iter_chunks()

    def _iter_mmap(self) -> Iterator[Batch]:
        B = self.spec.batch_size
        fill = 0
        while True:
            chunk = self._split.window()
            if chunk is None:
                break
            off, n = 0, len(chunk)
            stalled = False
            while off < n:
                off, fill, progressed = self._feed(chunk, off, fill)
                if fill == B:
                    yield self._emit(B)
                    fill = 0
                elif not progressed:
                    stalled = True
                    break
            self._split.advance(off)
            if stalled and off == 0 and not self._split.grow():
                # not one whole record fits a window that reaches the end
                raise Error("rowrec: truncated RecordIO stream (record "
                            "extends past the end of the part)")
        if fill:
            yield self._tail(fill)

    def _iter_chunks(self) -> Iterator[Batch]:
        """Whole-record chunks of a split (file order, the legacy loop,
        the macro-shuffle); a record cut by a chunk's end carries over."""
        B = self.spec.batch_size
        fill = 0
        carry = b""
        while True:
            chunk = self._split.next_chunk()
            if chunk is None:
                break
            if carry:
                chunk = carry + bytes(chunk)
                carry = b""
            off, n = 0, len(chunk)
            while off < n:
                off, fill, progressed = self._feed(chunk, off, fill)
                if fill == B:
                    yield self._emit(B)
                    fill = 0
                elif not progressed:
                    carry = bytes(memoryview(chunk)[off:])
                    break
        if carry:
            raise Error("rowrec: truncated RecordIO stream "
                        f"({len(carry)} undecodable trailing bytes)")
        if fill:
            yield self._tail(fill)

    def _iter_gather(self) -> Iterator[Batch]:
        """The windowed shuffle: each ``next_gather_batch`` view goes to
        the native gather kernel, which parses the records in permutation
        order straight out of the window buffer into the ring slot."""
        B = self.spec.batch_size
        fill = 0
        while True:
            g = self._split.next_gather_batch(B - fill)
            if g is None:
                break
            buf, starts, sizes = g
            off, n = 0, len(starts)
            while off < n:
                v = self._views
                rows, consumed, trunc, bad, corrupt = native.parse_rowrec_gather_ell(
                    buf, starts, sizes, off, n - off, v["indices"], v["values"],
                    v["nnz"], v["labels"], v["weights"], fill)
                self._count(rows, trunc, bad)
                if corrupt:
                    raise Error("rowrec: corrupt RecordIO frame in shuffled "
                                f"gather slice {off + consumed} (the index "
                                "and the data disagree)")
                check(consumed > 0 or rows > 0, "gather made no progress")
                off += consumed
                fill += rows
                if fill == B:
                    yield self._emit(B)
                    fill = 0
        if fill:
            yield self._tail(fill)

    def close(self) -> None:
        self._split.close()


class ShardedFusedBatches:
    """A native producer fanned out over threads: the part is cut into
    ``subparts`` sub-shards, each with its own producer draining on a
    ``Prefetcher`` thread (the kernels release the GIL), and batches
    interleave round-robin. Each sub-shard pads its own tail batch.

    A sub-producer runs ahead of this stream by its queue and one blocked
    put, so the ring this stream can promise is ``prefetch + 1`` slots
    shorter than the sub-producers' rings."""

    def __init__(self, make_producer, subparts: int, prefetch: int = 2) -> None:
        self._producers = []
        self._iters: List[Prefetcher] = []
        self._prefetch = prefetch
        try:
            for t in range(subparts):
                self._producers.append(make_producer(t, subparts))
            min_ring = min(p.ring_slots for p in self._producers)
            self.ring_slots = min_ring - (prefetch + 1)
            check(self.ring_slots >= 2,
                  f"sub-producer rings ({min_ring}) must exceed the "
                  f"per-shard prefetch ({prefetch}) + 1 by at least 2")
        except BaseException:
            self.close()
            raise

    def _sum(self, name: str) -> int:
        return sum(getattr(p, name, 0) for p in self._producers)

    @property
    def truncated_nnz(self) -> int:
        return self._sum("truncated_nnz")

    @property
    def rows_in(self) -> int:
        return self._sum("rows_in")

    @property
    def rows_out(self) -> int:
        return self._sum("rows_out")

    @property
    def bad_records(self) -> int:
        return self._sum("bad_records")

    @property
    def bad_lines(self) -> int:
        return self._sum("bad_lines")

    def io_stats(self) -> dict:
        """The sub-producers' split counters, numbers summed (the mode
        carries over); empty when no sub-producer keeps any."""
        out: dict = {}
        for p in self._producers:
            for k, v in getattr(p, "io_stats", dict)().items():
                if isinstance(v, (int, float)):
                    out[k] = out.get(k, 0) + v
                else:
                    out.setdefault(k, v)
        return out

    def __iter__(self) -> Iterator[Batch]:
        # the threads start here: a stream built and never read starts none
        check(not self._iters, "ShardedFusedBatches is read once")
        self._iters = [Prefetcher(partial(iter, p), self._prefetch, f"fused-shard-{t}")
                       for t, p in enumerate(self._producers)]
        active = list(self._iters)
        while active:
            still = []
            for it in active:
                batch = it.next()
                if batch is None:
                    continue
                still.append(it)
                yield batch
            active = still

    def close(self) -> None:
        for it in self._iters:
            it.destroy(timeout=5.0)
        for p in self._producers:
            p.close()


def _fan_out(make, part_index: int, num_parts: int, nthread: Optional[int]):
    """``make(part, parts)``, or a ShardedFusedBatches of ``nthread``
    sub-shards of this part when ``nthread`` > 1."""
    if nthread is not None and nthread > 1:
        return ShardedFusedBatches(
            lambda t, n: make(part_index * n + t, num_parts * n), nthread)
    return make(part_index, num_parts)


def _format(uri: str, fmt: str, default: str) -> str:
    return str(URISpec(uri).args.get("format", default)) if fmt == "auto" else fmt


def _dsserve(uri: str, spec: BatchSpec, part_index: int, num_parts: int,
             format: str):
    """A ``dsserve://`` URI: the remote preprocessing tier's stream
    (``dsserve/client.py``). The servers run ``ell_batches`` /
    ``dense_batches`` for their shards; striping is per endpoint or per
    tracker lease, so the static shard arguments do not apply."""
    check(part_index == 0 and num_parts == 1,
          "dsserve:// sources stripe across servers (or tracker "
          "leases), not part_index/num_parts")
    from ..dsserve.client import DsServeBatches

    return DsServeBatches(uri, spec, format=format)


def ell_batches(
    uri: str,
    spec: BatchSpec,
    part_index: int = 0,
    num_parts: int = 1,
    ring: int = 10,
    nthread: Optional[int] = None,
    format: str = "auto",
    indexing_mode: int = 0,
):
    """Native ELL Batch stream of local rowrec, libsvm or libfm files (one
    file, a ``;`` list, a directory or a regex; rowrec may hold
    compressed blocks, text may name a ``#cachefile``).

    ``format``: 'rowrec' | 'libsvm' | 'libfm' | 'auto' (``?format=`` from
    the URI, defaulting to rowrec). ``indexing_mode`` applies to libsvm
    and libfm (``?indexing_mode=`` on the URI wins). ``nthread`` > 1 fans
    the parse out over threads (``ShardedFusedBatches``). Iterable, with
    ``ring_slots``, ``truncated_nnz`` and ``close()``. A
    ``dsserve://host:port,.../<dataset-uri>`` URI reads packed slots from
    the dsserve tier instead (``DsServeBatches``)."""
    if uri.startswith("dsserve://"):
        return _dsserve(uri, spec, part_index, num_parts, format)
    fmt = _format(uri, format, "rowrec")
    check(fmt in ("rowrec", "libsvm", "libfm"),
          f"ell_batches supports rowrec/libsvm/libfm, not {fmt!r}")
    _check_ell_spec(spec)
    if fmt == "rowrec":
        return _fan_out(lambda p, n: FusedEllRowRecBatches(uri, spec, p, n, ring),
                        part_index, num_parts, nthread)
    cls = FusedEllLibSVMBatches if fmt == "libsvm" else FusedEllLibFMBatches
    return _fan_out(lambda p, n: cls(uri, spec, p, n, indexing_mode=indexing_mode,
                                     ring=ring),
                    part_index, num_parts, nthread)


def dense_batches(
    uri: str,
    spec: BatchSpec,
    part_index: int = 0,
    num_parts: int = 1,
    nthread: Optional[int] = None,
    indexing_mode: int = 0,
    ring: int = 10,
    format: str = "auto",
):
    """Native dense Batch stream of local libsvm or csv files (as
    ``ell_batches`` takes them).

    ``format``: 'libsvm' | 'csv' | 'auto' (``?format=`` from the URI,
    defaulting to libsvm, reference data.cc:68-76); csv options ride the
    URI. Otherwise as ``ell_batches``, ``dsserve://`` included."""
    if uri.startswith("dsserve://"):
        return _dsserve(uri, spec, part_index, num_parts, format)
    fmt = _format(uri, format, "libsvm")
    check(fmt in ("libsvm", "csv"),
          f"dense_batches supports libsvm/csv, not {fmt!r}")
    check(spec.layout == "dense", "dense_batches needs layout='dense'")
    if fmt == "csv":
        return _fan_out(lambda p, n: FusedDenseCSVBatches(
                            uri, spec, p, n, ring=ring, _shares=max(1, nthread or 1)),
                        part_index, num_parts, nthread)
    return _fan_out(lambda p, n: FusedDenseLibSVMBatches(uri, spec, p, n,
                                                         indexing_mode, ring),
                    part_index, num_parts, nthread)


class GenericBatchStream:
    """The plain text producer: a parser → ``FixedShapeBatcher``, with the
    iterate/close surface of the native producers. Each batch owns its
    buffer."""

    def __init__(self, parser, batcher: FixedShapeBatcher) -> None:
        self._parser = parser
        self._batcher = batcher

    @property
    def truncated_nnz(self) -> int:
        return self._batcher.truncated_nnz

    def io_stats(self):
        """The counters of the parser's source split (an indexed read's
        spans and seeks, retries), or an empty dict, as the native
        producers report theirs."""
        parser = getattr(self._parser, "_base", self._parser)
        source = getattr(parser, "source", getattr(parser, "_source", None))
        fn = getattr(source, "io_stats", None)
        out = fn() if fn is not None else None
        return dict(out) if out else {}

    def __iter__(self) -> Iterator[Batch]:
        return self._batcher.batches(iter(self._parser))

    def close(self) -> None:
        self._parser.close()


def plain_batches(
    uri: str,
    spec: BatchSpec,
    part_index: int = 0,
    num_parts: int = 1,
    format: str = "auto",
    indexing_mode: int = 0,
):
    """The plain version of the native producer for ``uri``: rowrec →
    ``EllRowRecBatches``, or with ``?index=``/``?shuffle_parts=`` the
    records of ``LegacyIndexedSplit`` decoded by ``RowRecParser`` and
    packed by ``FixedShapeBatcher``; text → ``GenericBatchStream`` over a one-thread
    ``create_parser`` whose blocks go through the format's Python grammar
    (``parse_block_plain``) rather than the native parse
    (``indexing_mode`` joins the URI unless it carries one). ``format``
    'auto' defaults to rowrec for the ELL layout and to libsvm for the
    dense one. A ``dsserve://`` URI names the remote preprocessing tier,
    whose plain version is that of its inner URI: it raises."""
    check(not uri.startswith("dsserve://"),
          f"plain batches read files; {uri!r} names the remote preprocessing "
          "tier (its plain version is plain_batches of the inner URI)")
    fmt = _format(uri, format, "rowrec" if spec.layout == "ell" else "libsvm")
    if fmt == "rowrec":
        uspec = URISpec(uri, part_index, num_parts)
        check(not uspec.cache_file, "plain rowrec batches read no #cachefile")
        check(not io_split.is_stream_uri(uri),
              "plain rowrec batches read files, not a live stream; read the sealed "
              "stream's shards, or ell_batches over the stream")
        args = parser_options("rowrec", uspec.args)
        check("dynamic_shards" not in args,
              "plain rowrec batches read a static part; the static part "
              "(i, M) is micro-shard i of M's plain version")
        path = _one_local_file(uspec.uri)
        if set(args) - {"seed"}:
            split = _legacy_split(io_split.local_path(uspec.uri), args, part_index,
                                  num_parts)
        elif path is None:
            split = io_split.create(uspec.uri, part_index, num_parts, "recordio",
                                    threaded=False)
        elif _rec_file_compressed(path):
            split = PlainBlockSplit(path, part_index, num_parts)
        else:
            return EllRowRecBatches(path, spec, part_index, num_parts)
        return GenericBatchStream(RowRecParser(split), FixedShapeBatcher(spec))
    uspec = URISpec(uri, part_index, num_parts)
    if fmt in ("libsvm", "libfm") and indexing_mode and "indexing_mode" not in uspec.args:
        uri += ("&" if "?" in uri else "?") + f"indexing_mode={indexing_mode}"
    parser = create_parser(uri, part_index, num_parts, type=fmt, nthread=1,
                           threaded=False)
    parser.parse_block = parser.parse_block_plain
    return GenericBatchStream(parser, FixedShapeBatcher(spec))
