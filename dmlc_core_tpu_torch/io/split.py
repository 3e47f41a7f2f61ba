"""Splits of one local file: text lines or RecordIO records, by byte
range or through an index, in file order or shuffled.

The port of ``LineSplitter`` and ``RecordIOSplitter`` (src/io/
{line_split,recordio_split}.{h,cc} over src/io/input_split_base.cc) for a
single local file: part ``i`` of ``n`` owns the bytes
``[ceil(size/n)·i, ceil(size/n)·(i+1))`` (rounded up to the record
alignment), with both bounds snapped forward to the next record start,
so every record lands in exactly one part. Chunks hand out whole records
only. ``IndexedRecordIOSplitter`` shards by record count through an
index file and reads in file order or in a (seed, epoch) permutation;
``InputSplitShuffle`` visits sub-parts in a shuffled order. Multi-file
URIs, remote filesystems, compressed RecordIO and ``#cachefile`` are not
ported: ``create`` refuses them.
"""

from __future__ import annotations

import mmap
import os
import random
import threading
from collections import OrderedDict
from typing import BinaryIO, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.logging import Error, check, check_eq
from ..utils.prefetch import Prefetcher
from .recordio import RecordIOChunkReader, first_head_in_words, last_head_in_words
from .stream import Stream
from .uri import URISpec, uri_int

__all__ = [
    "IndexedRecordIOSplitter",
    "InputSplitShuffle",
    "LineSplitter",
    "RecordIOSplitter",
    "create",
    "local_path",
    "normalize_shuffle",
    "part_range",
    "plan_coalesced_spans",
]

DEFAULT_BUFFER_BYTES = (2 << 20) * 4


def local_path(uri: str) -> str:
    """The path of a URI naming one existing local file (``file://``
    optional); raises ``Error`` on what the port's splits do not read."""
    check("?" not in uri and "#" not in uri,
          f"{uri!r}: URI options and #cachefile are resolved before the split")
    path = uri[7:] if uri.startswith("file://") else uri
    if "://" in path or ";" in path:
        raise Error(f"{uri!r}: the port reads one local file; remote "
                    "filesystems and multi-file URIs are not ported")
    if not os.path.isfile(path):
        raise Error(f"Cannot find any files that match the URI pattern {uri!r}")
    return path


class _LocalSplit:
    """Part ``part_index`` of ``num_parts`` of one local file; subclasses
    say where records start."""

    _align = 1

    def __init__(self, path: str, part_index: int = 0, num_parts: int = 1) -> None:
        self.path = path
        self.buffer_size = DEFAULT_BUFFER_BYTES
        self._ntotal = os.path.getsize(path)
        if self._ntotal % self._align:
            raise Error(f"file {path} does not align by {self._align} bytes")
        self._fp: Optional[BinaryIO] = open(path, "rb")
        self.reset_partition(part_index, num_parts)

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        """Move to part ``part_index`` of ``num_parts`` and rewind
        (reference ResetPartition, input_split_base.cc:30-64)."""
        check(
            0 <= part_index < num_parts,
            f"part_index={part_index} outside num_parts={num_parts}",
        )
        ntotal = self._ntotal
        nstep = (ntotal + num_parts - 1) // num_parts
        nstep = (nstep + self._align - 1) // self._align * self._align
        begin = min(nstep * part_index, ntotal)
        end = min(nstep * (part_index + 1), ntotal)
        if begin < end:
            # a bound at a file edge is a record start already
            if 0 < end < ntotal:
                end += self._seek_record_begin(end)
            if 0 < begin < ntotal:
                begin += self._seek_record_begin(begin)
        self.offset_begin = begin
        self.offset_end = max(begin, end)
        self.before_first()

    def _seek_record_begin(self, offset: int) -> int:
        """Bytes from ``offset`` to the next record start."""
        raise NotImplementedError

    def before_first(self) -> None:
        """Rewind to the start of this part."""
        self._fp.seek(self.offset_begin)
        self._curr = self.offset_begin
        self._overflow = b""
        self._rec_iter: Optional[Iterator[bytes]] = None

    def _read(self, size: int) -> bytes:
        size = min(size, self.offset_end - self._curr)
        if size <= 0:
            return b""
        data = self._fp.read(size)
        self._curr += len(data)
        return data

    def next_chunk(self) -> Optional[bytes]:
        """The next run of whole records, or None at the end of the part."""
        raise NotImplementedError

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        """The records of a chunk from ``next_chunk``."""
        raise NotImplementedError

    def next_record(self) -> Optional[bytes]:
        """The next record, or None at the end of the part."""
        return _next_record(self)

    def io_stats(self) -> Dict[str, object]:
        return {}

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


class RecordIOSplitter(_LocalSplit):
    """record = RecordIO frame (reference src/io/recordio_split.{h,cc});
    records start at a magic word whose next word begins a chain."""

    _align = 4

    def _seek_record_begin(self, offset: int) -> int:
        """Bytes from ``offset`` to the next record head (recordio_split.cc
        :9-25); everything to EOF when there is none."""
        fp = self._fp
        fp.seek(offset)
        pos = 0  # offset of buf[0] from the scan start
        buf = b""
        while True:
            data = fp.read(1 << 16)
            buf += data
            usable = len(buf) & ~3
            if usable >= 8:
                hit = first_head_in_words(np.frombuffer(buf[:usable], dtype="<u4"))
                if hit >= 0:
                    return pos + hit * 4
            if not data:
                return pos + len(buf)
            # keep the last word: it may be a magic whose lrec comes next
            keep = max(usable - 4, 0)
            pos += keep
            buf = buf[keep:]

    def next_chunk(self) -> Optional[bytes]:
        """The next run of whole records, or None at the end of the part
        (input_split_base.cc:221-277: the buffer doubles until it holds
        at least one record; a partial tail carries to the next call)."""
        size = self.buffer_size
        while True:
            olen = len(self._overflow)
            if size <= olen:
                size *= 2
                continue
            data = self._overflow + self._read(size - olen)
            if not data:
                return None
            self._overflow = b""
            if len(data) != size:
                return data  # the part ends on a record boundary
            usable = len(data) & ~3
            cut = last_head_in_words(np.frombuffer(data[:usable], dtype="<u4"))
            cut = cut * 4 if cut > 0 else 0
            self._overflow = data[cut:]
            if cut:
                return data[:cut]
            size *= 2

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        for rec in RecordIOChunkReader(chunk):
            yield bytes(rec)


class LineSplitter(_LocalSplit):
    """record = text line (reference src/io/line_split.{h,cc}); a line
    starts after a run of ``\\n``/``\\r``."""

    def _seek_record_begin(self, offset: int) -> int:
        """Bytes from ``offset`` to just after the next newline run
        (line_split.cc:9-26), read in blocks."""
        fp = self._fp
        fp.seek(offset)
        nstep = 0
        seen_newline = False
        while True:
            buf = fp.read(1 << 16)
            if not buf:
                return nstep
            i = 0
            if not seen_newline:
                j = _find_newline(buf)
                if j < 0:
                    nstep += len(buf)
                    continue
                nstep += j + 1
                seen_newline = True
                i = j + 1
            while i < len(buf) and buf[i] in (0x0A, 0x0D):
                nstep += 1
                i += 1
            if i < len(buf):
                return nstep

    def next_chunk(self) -> Optional[bytes]:
        """The next run of whole lines, or None at the end of the part
        (input_split_base.cc:221-277). The buffer doubles until it holds
        a line end; a last line without one gets a ``\\n``."""
        size = self.buffer_size
        while True:
            olen = len(self._overflow)
            if size <= olen:
                size *= 2
                continue
            data = self._overflow + self._read(size - olen)
            if not data:
                return None
            self._overflow = b""
            if len(data) == olen:
                data += b"\n"  # no new bytes: the last line has no newline
            # line_split.cc:27-34
            cut = max(data.rfind(b"\n"), data.rfind(b"\r"))
            cut = cut + 1 if cut > 0 else 0
            self._overflow = data[cut:]
            if cut:
                return data[:cut]
            size *= 2

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        """Non-empty lines (line_split.cc:36-58)."""
        for line in chunk.replace(b"\r", b"\n").split(b"\n"):
            if line:
                yield line


def _next_record(split) -> Optional[bytes]:
    """``split``'s next record, pulled chunk by chunk."""
    while True:
        if split._rec_iter is not None:
            rec = next(split._rec_iter, None)
            if rec is not None:
                return rec
        chunk = split.next_chunk()
        if chunk is None:
            return None
        split._rec_iter = split.extract_records(chunk)


def _find_newline(buf: bytes) -> int:
    a, b = buf.find(b"\n"), buf.find(b"\r")
    if a < 0:
        return b
    if b < 0:
        return a
    return min(a, b)


def normalize_shuffle(v):
    """A shuffle option (keyword or URI string) in canonical form: None,
    0 or False → False (off); 'record', 1 or True → per-record
    permutation; 'batch' or 2 → permuted spans of ``batch_size``
    records; 'window' or 3 → per-record permutation read window by
    window. Anything else raises."""
    if v in (None, False, 0, "0", ""):
        return False
    if v in ("batch", 2, "2"):
        return "batch"
    if v in ("window", 3, "3"):
        return "window"
    if v in ("record", "1", 1, True):
        return "record"
    raise Error(f"invalid shuffle={v!r}: use 0/1/record/batch/window")


def _plan_span_bounds(
    offs: np.ndarray, sizes: np.ndarray, merge_gap: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort the records by offset and cut the sorted run wherever the gap
    from the running span end to the next record's start exceeds
    ``merge_gap``. Returns ``(order, starts, ends)``: ``order`` sorts the
    inputs by offset, and span j covers ``order[starts[j]:ends[j]]``."""
    order = np.argsort(offs, kind="stable")
    soffs = offs[order]
    # the running max covers entries that lie inside a predecessor
    run_end = np.maximum.accumulate(soffs + sizes[order])
    breaks = np.flatnonzero(soffs[1:] - run_end[:-1] > merge_gap) + 1
    starts = np.concatenate(([0], breaks))
    ends = np.concatenate((breaks, [len(offs)]))
    return order, starts, ends


def plan_coalesced_spans(
    entries: List[Tuple[int, int, int]], merge_gap: int
) -> List[Tuple[int, int, List[Tuple[int, int, int]]]]:
    """Coalesce ``[(offset, size, tag), ...]`` (any order) into spans:
    a record joins the span before it when the gap from that span's end
    to its start is at most ``merge_gap`` bytes. Returns
    ``[(span_begin, span_end, members)]``, members sorted by offset."""
    if not entries:
        return []
    offs = np.asarray([e[0] for e in entries], dtype=np.int64)
    sizes = np.asarray([e[1] for e in entries], dtype=np.int64)
    order, starts, ends = _plan_span_bounds(offs, sizes, merge_gap)
    out: List[Tuple[int, int, List[Tuple[int, int, int]]]] = []
    for s, e in zip(starts.tolist(), ends.tolist()):
        members = [entries[i] for i in order[s:e].tolist()]
        span_end = max(m[0] + m[1] for m in members)
        out.append((members[0][0], span_end, members))
    return out


def _native_shuffle(rnd: random.Random, perm: np.ndarray) -> bool:
    """Shuffle ``perm`` in place as ``rnd.shuffle`` would, with the
    native MT19937 kernel; False when the permutation is too large for
    the kernel's single-word draws (the caller then runs
    ``rnd.shuffle``, with the same swaps)."""
    from ..data import native  # data imports this module

    return native.shuffle_mt19937(rnd, perm)


# -- index files ------------------------------------------------------------
def _index_stat_key(index_uri: str, total: int):
    """Cache key of a local index file, ``(uri, mtime_ns, size, total)``,
    or None when it cannot be stat'ed."""
    path = index_uri[len("file://"):] if index_uri.startswith("file://") else index_uri
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (index_uri, st.st_mtime_ns, st.st_size, total)


def _load_index_uri(index_uri: str, total: int) -> Dict[str, np.ndarray]:
    with Stream.create(index_uri, "r") as stream:
        text = stream.read().decode()
    return _parse_index_text(text, total, index_uri)


# parsed indexes, least recently used first, bounded by their arrays'
# bytes (DMLC_INDEX_CACHE_MB, default 256): the sub-shard splitters of one
# file share one parse, and a rewritten file (new mtime) parses anew
_INDEX_CACHE: "OrderedDict[Tuple, Dict[str, np.ndarray]]" = OrderedDict()
_INDEX_CACHE_BYTES = 0
_INDEX_CACHE_LOCK = threading.Lock()


def _index_cache_budget() -> int:
    return max(0, int(os.environ.get("DMLC_INDEX_CACHE_MB", "256"))) << 20


def _load_index_cached(stat_key) -> Dict[str, np.ndarray]:
    """The parsed index of ``stat_key`` (``_index_stat_key``), shared
    read-only between splitters; a parse larger than the whole budget
    is not kept."""
    global _INDEX_CACHE_BYTES
    with _INDEX_CACHE_LOCK:
        data = _INDEX_CACHE.get(stat_key)
        if data is not None:
            _INDEX_CACHE.move_to_end(stat_key)
            return data
    data = _load_index_uri(stat_key[0], stat_key[3])
    nbytes = sum(v.nbytes for v in data.values())
    budget = _index_cache_budget()
    if nbytes <= budget:
        with _INDEX_CACHE_LOCK:
            if stat_key not in _INDEX_CACHE:
                _INDEX_CACHE[stat_key] = data
                _INDEX_CACHE_BYTES += nbytes
            _INDEX_CACHE.move_to_end(stat_key)
            while _INDEX_CACHE_BYTES > budget and len(_INDEX_CACHE) > 1:
                _k, old = _INDEX_CACHE.popitem(last=False)
                _INDEX_CACHE_BYTES -= sum(v.nbytes for v in old.values())
    return data


def _parse_index_keys(kvals: List[str], index_uri: str) -> np.ndarray:
    """The index's key column: int64 when every key is an integer, else
    the strings. A repeated key raises: a point read by key would
    return an arbitrary one of the records that share it."""
    try:
        keys = np.asarray(kvals, dtype=np.int64)
    except (ValueError, OverflowError):
        keys = np.asarray(kvals)
    ks = np.sort(keys)
    dup = np.nonzero(ks[1:] == ks[:-1])[0]
    if dup.size:
        raise Error(
            f"index file {index_uri!r}: duplicate key {ks[int(dup[0])]!r} "
            f"({dup.size + 1 if dup.size == 1 else 'several'} keys repeat) "
            f"— a point lookup would silently return an arbitrary one of "
            f"the records sharing it"
        )
    return keys


def _parse_index_text(text: str, total: int, index_uri: str) -> Dict[str, np.ndarray]:
    """``key offset`` pairs → read-only arrays ``offs`` (sorted),
    ``sizes`` (the gap to the next offset, the last to ``total``) and
    ``keys`` in the same order. A compressed-block index (``key
    block:in``) raises: compressed RecordIO is ``ROADMAP.md`` §1 item 2."""
    toks = text.split()
    vals = toks[1::2]
    if not vals:
        raise Error(f"empty index file {index_uri!r}")
    check(
        len(toks) % 2 == 0,
        f"index file {index_uri!r}: odd token count (truncated or "
        f"malformed key/offset pairs)",
    )
    keys = _parse_index_keys(toks[0::2], index_uri)
    if ":" in vals[0]:
        raise Error(f"index file {index_uri!r} indexes compressed-block "
                    "RecordIO, which is not ported (ROADMAP.md §1 item 2)")
    try:
        raw = np.asarray(vals, dtype=np.int64)
    except ValueError:
        raise Error(f"index file {index_uri!r} mixes v1 and compressed-block "
                    "offsets") from None
    order = np.argsort(raw, kind="stable")
    offs = raw[order]
    sizes = np.concatenate((np.diff(offs), [total - int(offs[-1])])).astype(np.int64)
    out = {"offs": offs, "sizes": sizes, "keys": keys[order]}
    for v in out.values():
        v.setflags(write=False)  # cached arrays are shared across splits
    return out


class _SpanReader:
    """Positioned reads of one local file: zero-copy ``mmap`` views (no
    seek, no shared cursor, so the window readahead thread and the
    consumer never race), or ``os.pread`` when the file does not map. Views stay valid until ``close()``, which leaves the
    unmap to the collector while a view is still exported."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._fd: Optional[int] = None
        self._mm: Optional[mmap.mmap] = None

    def _map(self):
        if self._mm is None and self._fd is None:
            fd = os.open(self._path, os.O_RDONLY)
            try:
                self._mm = mmap.mmap(fd, 0, access=mmap.ACCESS_READ)
            except (OSError, ValueError):
                self._fd = fd  # unmappable: pread
            else:
                os.close(fd)
        return self._mm

    def read(self, offset: int, size: int):
        """``size`` bytes at ``offset``: a memoryview of the mapping, or
        bytes read with ``os.pread``."""
        mm = self._map()
        if mm is not None:
            return memoryview(mm)[offset:offset + size]
        out: List[bytes] = []
        while size > 0:
            data = os.pread(self._fd, size, offset)
            if not data:
                break
            out.append(data)
            offset += len(data)
            size -= len(data)
        return out[0] if len(out) == 1 else b"".join(out)

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:
                pass  # a handed-out view is still alive; GC unmaps
            self._mm = None


class IndexedRecordIOSplitter:
    """One local, uncompressed RecordIO file sharded by RECORD COUNT
    through an index of ``key offset`` lines, with optional per-epoch
    shuffled reads (the port of the JAX package's
    ``IndexedRecordIOSplitter``; reference
    src/io/indexed_recordio_split.{h,cc}).

    Part ``i`` of ``n`` owns records ``[ceil(N/n)·i, ceil(N/n)·(i+1))``
    in file order. ``shuffle``:

    - off: the part in file order, ``batch_size`` records a chunk;
    - 'record': a per-record permutation of the part, served as one
      window: the part's bytes are one zero-copy mmap span and records
      leave it in permutation order. ``legacy_shuffle`` reads the same
      order with one seek and read per record instead (the reference's
      loop, kept to measure the window path against);
    - 'batch': spans of ``batch_size`` consecutive records in permuted
      order, records in file order inside a span; the remainder span
      (``N % batch_size`` records) always reads last;
    - 'window': the permutation of 'record', cut into windows of
      ``window`` records; each window's records are sorted by offset,
      merged into spans across gaps up to ``merge_gap`` bytes, read one
      span at a time, and emitted in permutation order.

    The permutation of epoch ``e`` comes from
    ``random.Random(111 + seed + 1_000_003·e)`` alone, so any epoch's
    order can be rebuilt without replaying the epochs before it (the
    reference carries its RNG from epoch to epoch instead). Windows load
    on a readahead thread (``Prefetcher``), closed on ``close()`` and on
    every ``before_first``. ``next_gather_batch`` hands ``(buf, starts,
    sizes)`` views for the native gather kernel; ``next_batch_ex``
    copies the same records out as framed bytes.
    """

    KRAND_MAGIC = 111  # reference indexed_recordio_split.h:82

    def __init__(
        self,
        path: str,
        index_uri: str,
        part_index: int = 0,
        num_parts: int = 1,
        batch_size: int = 256,
        shuffle=False,
        seed: int = 0,
        epoch: int = 0,
        skip_records: int = 0,
        window: int = 65536,
        merge_gap: int = 65536,
        legacy_shuffle: bool = False,
    ) -> None:
        """``epoch``/``skip_records`` start the read mid-run: epoch
        ``epoch``'s permutation, ``skip_records`` records in, skipped
        without reading them. With ``shuffle='batch'`` the skip must land
        on a span boundary (a multiple of ``batch_size``), with
        ``'window'`` on a window boundary, or at the end of the part."""
        mode = normalize_shuffle(shuffle)
        self.shuffle_mode: Optional[str] = mode if mode else None
        self._legacy_record = bool(legacy_shuffle) and mode == "record"
        self.batch_size = batch_size
        check(window >= 1, f"window={window} must be >= 1")
        check(merge_gap >= 0, f"merge_gap={merge_gap} must be >= 0")
        self.window = window
        self.merge_gap = merge_gap
        # a loaded window is (buf, rel, size): span bytes and each
        # record's start and length in permutation order (size None: a
        # uniform stride, buf 2-D and rel row numbers)
        self._win_iter: Optional[Prefetcher] = None
        self._win_buf = None
        self._win_pos = 0
        self._win_start = 0
        self._win_skip = 0
        self._span_reader = _SpanReader(path)
        self._fp: Optional[BinaryIO] = None
        self.path = path
        # I/O-shape counters, cumulative across epochs (io_stats)
        self.spans_read = 0
        self.seek_calls = 0
        self.bytes_read = 0
        self.records_emitted = 0
        self.gather_batches = 0
        self.gather_bytes = 0
        self.gather_fallback_batches = 0
        self._seed = seed
        self.epoch = epoch - 1  # before_first() steps into `epoch`
        self._skip_next = skip_records
        self._total = os.path.getsize(path)
        skey = _index_stat_key(index_uri, self._total)
        data = (_load_index_cached(skey) if skey is not None
                else _load_index_uri(index_uri, self._total))
        self._index_offs = data["offs"]
        self._index_sizes = data["sizes"]
        self.index_begin = self.index_end = 0
        self._current = 0
        self._n_overflow = 0
        self._permutation = []
        self._rec_iter: Optional[Iterator[bytes]] = None
        self.reset_partition(part_index, num_parts)

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        """Move to records ``[ceil(N/n)·i, ceil(N/n)·(i+1))`` and start
        the next epoch (reference indexed_recordio_split.cc:12-41)."""
        check(0 <= part_index < num_parts,
              f"part_index={part_index} outside num_parts={num_parts}")
        ntotal = len(self._index_offs)
        nstep = (ntotal + num_parts - 1) // num_parts
        if part_index * nstep >= ntotal:
            self.index_begin = self.index_end = 0
            self._permutation = []
            self._current = 0
            self._n_overflow = 0
            self._rec_iter = None
            self._teardown_window_pipeline()
            return
        self.index_begin = part_index * nstep
        self.index_end = min((part_index + 1) * nstep, ntotal)
        self._n_overflow = 0
        self.before_first()

    def before_first(self) -> None:
        """Start the next epoch: its permutation from (seed, epoch)."""
        if self.index_end <= self.index_begin:
            return
        self.epoch += 1
        rnd = random.Random(self.KRAND_MAGIC + self._seed + 1_000_003 * self.epoch)
        # the previous epoch's readahead goes first: it must not read
        # windows of a permutation that is about to change
        self._teardown_window_pipeline()
        if self.shuffle_mode == "batch":
            # only FULL spans are shuffled and the remainder span reads
            # last, so every multiple of batch_size is a span boundary
            # (a resumable position); the span order is expanded to a
            # per-record permutation for the window machinery
            total = self.index_end - self.index_begin
            full_end = self.index_begin + (total // self.batch_size) * self.batch_size
            span_starts = list(range(self.index_begin, full_end, self.batch_size))
            rnd.shuffle(span_starts)
            if full_end < self.index_end:
                span_starts.append(full_end)
            starts = np.asarray(span_starts, dtype=np.int64)
            counts = np.minimum(starts + self.batch_size, self.index_end) - starts
            pos = np.arange(int(counts.sum()), dtype=np.int64)
            self._permutation = np.repeat(starts, counts) + (
                pos - np.repeat(np.cumsum(counts) - counts, counts))
            self._current = 0
        elif self.shuffle_mode in ("record", "window"):
            if self._legacy_record:
                self._permutation = list(range(self.index_begin, self.index_end))
                rnd.shuffle(self._permutation)
            else:
                # the native kernel replays random.Random's draws and
                # swaps, so the order is the legacy loop's either way
                perm = np.arange(self.index_begin, self.index_end, dtype=np.int64)
                if not _native_shuffle(rnd, perm):
                    rnd.shuffle(perm)
                self._permutation = perm
            self._current = 0
        else:
            self._current = self.index_begin
        self._n_overflow = 0
        if self._skip_next:
            self._fast_forward(self._skip_next)
            self._skip_next = 0
        self._rec_iter = None

    def _fast_forward(self, n: int) -> None:
        """Skip ``n`` records of the current epoch without reading them."""
        total = self.index_end - self.index_begin
        check(0 <= n <= total, f"skip_records={n} outside this shard's {total} records")
        if self.windowed:
            if self.shuffle_mode == "batch":
                full = (total // self.batch_size) * self.batch_size
                check(
                    (n % self.batch_size == 0 and n <= full) or n == total,
                    f"skip_records={n} lands inside a shuffled span "
                    f"(checkpoint at span boundaries — batch_size="
                    f"{self.batch_size} multiples)",
                )
            elif self.shuffle_mode == "window":
                check(
                    n % self.window == 0 or n == total,
                    f"skip_records={n} lands inside a shuffled window of "
                    f"{self.window} (checkpoint at window boundaries — "
                    f"window={self.window} multiples)",
                )
            # record mode resumes anywhere: its first window is sliced
            W = self._eff_window()
            self._win_start = n // W
            self._win_skip = n - self._win_start * W
        elif self._legacy_record:
            self._current = n
        else:
            self._current = self.index_begin + n

    def _read_at(self, offset: int, size: int) -> bytes:
        """Seek and read (sequential chunks, the legacy per-record loop)."""
        if self._fp is None:
            self._fp = open(self.path, "rb")
        self._fp.seek(offset)
        data = self._fp.read(size)
        self.seek_calls += 1
        self.spans_read += 1
        self.bytes_read += len(data)
        return data

    # -- the window machinery -------------------------------------------------
    @property
    def windowed(self) -> bool:
        """True when the shuffle is served by the window machinery
        (record without ``legacy_shuffle``, batch, window): then
        ``next_gather_batch`` works and windows load on a readahead
        thread."""
        return (self.shuffle_mode in ("record", "batch", "window")
                and not self._legacy_record)

    def supports_gather(self) -> bool:
        """Whether ``next_gather_batch`` serves this configuration."""
        return self.windowed

    def _eff_window(self) -> int:
        """Records per window: record mode is one window over the whole
        part (a zero-copy mapping of the local file); batch and window
        modes use ``window``."""
        if self.shuffle_mode == "record":
            return max(1, len(self._permutation))
        return self.window

    def _n_windows(self) -> int:
        return -(-len(self._permutation) // self._eff_window())

    def _teardown_window_pipeline(self) -> None:
        if self._win_iter is not None:
            self._win_iter.destroy(timeout=5.0)
            self._win_iter = None
        self._win_buf = None
        self._win_pos = 0
        self._win_start = 0
        self._win_skip = 0

    def _read_spans(self, span_begin: np.ndarray, span_len: np.ndarray) -> np.ndarray:
        """A window's spans as one uint8 buffer, spans back to back: one
        span is a zero-copy view of the mapping, several are copied into
        one buffer."""
        spans = list(zip(span_begin.tolist(), span_len.tolist()))
        total = int(span_len.sum())
        self.spans_read += len(spans)
        self.bytes_read += total
        reader = self._span_reader
        if len(spans) == 1:
            begin, nbytes = spans[0]
            data = reader.read(begin, nbytes)
            check_eq(len(data), nbytes, "span read truncated")
            return np.frombuffer(data, dtype=np.uint8)
        buf = np.empty(total, dtype=np.uint8)
        base = 0
        for begin, nbytes in spans:
            data = reader.read(begin, nbytes)
            check_eq(len(data), nbytes, "span read truncated")
            buf[base:base + nbytes] = np.frombuffer(data, dtype=np.uint8)
            base += nbytes
        return buf

    def _load_window(self, lo: int, hi: int):
        """Read the records at permutation positions [lo, hi) through
        coalesced spans → ``(buf, rel, size)`` in permutation order.
        When the merged gaps more than double the buffer, it is
        compacted to the records' own bytes."""
        perm = np.asarray(self._permutation[lo:hi], dtype=np.int64)
        offs = self._index_offs[perm]
        sizes = self._index_sizes[perm]
        order, starts, ends = _plan_span_bounds(offs, sizes, self.merge_gap)
        soffs = offs[order]
        s_sorted = sizes[order]
        run_end = np.maximum.accumulate(soffs + s_sorted)
        span_begin = soffs[starts]
        span_len = run_end[ends - 1] - span_begin
        buf = self._read_spans(span_begin, span_len)
        # each sorted record's start in buf: its offset in its span plus
        # the span's base in the buffer
        counts = ends - starts
        span_base = np.concatenate(([0], np.cumsum(span_len)[:-1]))
        rel_sorted = soffs - np.repeat(span_begin, counts) + np.repeat(span_base, counts)
        idt = np.int32 if len(buf) < (1 << 31) else np.int64
        rec_bytes = int(s_sorted.sum())
        if len(buf) > 2 * rec_bytes:
            base = np.cumsum(s_sorted) - s_sorted
            gather = np.arange(rec_bytes, dtype=idt) + np.repeat(
                (rel_sorted - base).astype(idt), s_sorted)
            buf = buf[gather]
            rel_sorted = base
        rel = np.empty(len(rel_sorted), dtype=idt)
        rel[order] = rel_sorted.astype(idt)  # sorted → permutation order
        stride = int(sizes[0]) if len(sizes) else 0
        if (stride and int(sizes.min()) == stride == int(sizes.max())
                and len(buf) % stride == 0 and not (rel % stride).any()):
            # fixed-size records: a 2-D row gather, no per-byte indices
            return buf.reshape(-1, stride), rel // stride, None
        return buf, rel, sizes.astype(idt)

    def _window_stream(self) -> Iterator:
        # _win_start/_win_skip are fixed before the first pull starts
        # this generator; the skip applies to the first window only
        W = self._eff_window()
        n = len(self._permutation)
        skip = self._win_skip
        for k in range(self._win_start, self._n_windows()):
            lo = min(k * W + skip, n)
            hi = min((k + 1) * W, n)
            skip = 0
            if lo >= hi:
                continue
            yield self._load_window(lo, hi)

    def _refill_window(self) -> bool:
        """The next window, loaded by the readahead thread, into the
        emission buffer; False at the end of the epoch."""
        if self._win_iter is None:
            self._win_iter = Prefetcher(self._window_stream, 2,
                                        "split-window-readahead")
        nxt = self._win_iter.next()
        if nxt is None:
            return False
        self._win_buf = nxt
        self._win_pos = 0
        return True

    def _emit_from_window(self, n: int) -> Tuple[int, List[bytes]]:
        """Up to ``n`` framed records in permutation order, copied out
        with one fancy index per window touched."""
        got = 0
        chunks: List[bytes] = []
        while got < n:
            state = self._win_buf
            if state is None or self._win_pos >= len(state[1]):
                if not self._refill_window():
                    break
                state = self._win_buf
            buf, rel, size = state
            take = min(n - got, len(rel) - self._win_pos)
            r = rel[self._win_pos:self._win_pos + take]
            if size is None:
                chunks.append(buf[r].tobytes())
            else:
                s = size[self._win_pos:self._win_pos + take]
                total = int(s.sum())
                base = np.cumsum(s, dtype=r.dtype) - s
                gather = np.arange(total, dtype=r.dtype) + np.repeat(r - base, s)
                chunks.append(buf[gather].tobytes())
            self._win_pos += take
            got += take
        return got, chunks

    def next_gather_batch(self, n_records: int):
        """Up to ``n_records`` records in permutation order as views,
        ``(buf, starts, sizes)``: the current window's uint8 span bytes
        and each record's int64 offset and length in it, or None at the
        end of the epoch. Nothing is copied; the caller is done with the
        views before it pulls past the current window. A call never
        crosses a window, so short returns are normal."""
        check(self.windowed, "next_gather_batch needs a windowed shuffle")
        state = self._win_buf
        if state is None or self._win_pos >= len(state[1]):
            if not self._refill_window():
                return None
            state = self._win_buf
        buf, rel, size = state
        take = min(n_records, len(rel) - self._win_pos)
        r = rel[self._win_pos:self._win_pos + take]
        if size is None:
            stride = buf.shape[1]
            out = (buf.reshape(-1), r.astype(np.int64) * stride,
                   np.full(take, stride, dtype=np.int64))
        else:
            s = size[self._win_pos:self._win_pos + take]
            out = (buf, r.astype(np.int64), s.astype(np.int64))
        self._win_pos += take
        self.records_emitted += take
        self.gather_batches += 1
        self.gather_bytes += int(out[2].sum())
        return out

    def count_gather_fallback(self, n: int = 1) -> None:
        """A consumer that copied ``next_gather_batch`` views into framed
        bytes reports it here; the port's producers never do."""
        self.gather_fallback_batches += n

    def io_stats(self) -> Dict[str, object]:
        """I/O-shape counters since construction: ``spans`` positioned
        reads, ``seeks`` seek calls, ``bytes_read`` and ``records``
        emitted (skipped records excluded); on the window path also
        ``gather_batches``, ``gather_bytes`` and
        ``gather_fallback_batches`` (emissions copied into framed
        bytes)."""
        out: Dict[str, object] = {
            "mode": self.shuffle_mode or "sequential",
            "records": self.records_emitted,
            "spans": self.spans_read,
            "seeks": self.seek_calls,
            "bytes_read": self.bytes_read,
        }
        if self.windowed:
            out["gather_batches"] = self.gather_batches
            out["gather_bytes"] = self.gather_bytes
            out["gather_fallback_batches"] = self.gather_fallback_batches
        return out

    def next_batch_ex(self, n_records: int) -> Optional[bytes]:
        """The next ``n_records`` records as framed bytes (reference
        NextBatchEx, indexed_recordio_split.cc:159-212): copied out of
        the windows, one seek per record (legacy), or one read of the
        contiguous range (sequential)."""
        if self.windowed:
            n = self._n_overflow or n_records
            got, chunks = self._emit_from_window(n)
            if not got:
                return None
            self._n_overflow = n - got
            self.records_emitted += got
            self.gather_fallback_batches += 1
            return chunks[0] if len(chunks) == 1 else b"".join(chunks)
        if self._legacy_record:
            n = self._n_overflow or n_records
            parts: List[bytes] = []
            while len(parts) < n and self._current < len(self._permutation):
                idx = self._permutation[self._current]
                parts.append(self._read_at(int(self._index_offs[idx]),
                                           int(self._index_sizes[idx])))
                self._current += 1
            if not parts:
                return None
            self._n_overflow = n - len(parts)
            self.records_emitted += len(parts)
            return b"".join(parts)
        n = self._n_overflow or n_records
        last = min(self._current + n, self.index_end)
        self._n_overflow = self._current + n - last
        if last <= self._current:
            return None
        begin_off = int(self._index_offs[self._current])
        end_off = (int(self._index_offs[last]) if last < len(self._index_offs)
                   else self._total)
        chunk = self._read_at(begin_off, end_off - begin_off)
        if chunk:
            self.records_emitted += last - self._current
        self._current = last
        return chunk if chunk else None

    def next_chunk(self) -> Optional[bytes]:
        return self.next_batch_ex(self.batch_size)

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        for rec in RecordIOChunkReader(chunk):
            yield bytes(rec)

    def next_record(self) -> Optional[bytes]:
        return _next_record(self)

    def close(self) -> None:
        self._teardown_window_pipeline()
        self._span_reader.close()
        if self._fp is not None:
            self._fp.close()
            self._fp = None


class InputSplitShuffle:
    """Macro-shuffle: cut the file into ``num_parts · num_shuffle_parts``
    sub-parts and visit this part's ``num_shuffle_parts`` of them in an
    order drawn anew each epoch from ``random.Random(666 + seed)``
    (reference include/dmlc/input_split_shuffle.h:24-33, 100-119, 151).
    Over a windowed indexed split it passes ``next_gather_batch`` on."""

    KRAND_MAGIC = 666

    def __init__(self, base, part_index: int, num_parts: int,
                 num_shuffle_parts: int, seed: int = 0) -> None:
        check(num_shuffle_parts > 0, "num_shuffle_parts must be positive")
        self._base = base
        self._num_total = num_parts * num_shuffle_parts
        self._sub_parts = [part_index * num_shuffle_parts + i
                           for i in range(num_shuffle_parts)]
        self._rnd = random.Random(self.KRAND_MAGIC + seed)
        self._order: List[int] = []
        self._cursor = 0
        self.before_first()

    def before_first(self) -> None:
        self._order = list(self._sub_parts)
        self._rnd.shuffle(self._order)
        self._cursor = 0
        self._base.reset_partition(self._order[0], self._num_total)

    def _advance(self) -> bool:
        self._cursor += 1
        if self._cursor >= len(self._order):
            return False
        self._base.reset_partition(self._order[self._cursor], self._num_total)
        return True

    def next_record(self) -> Optional[bytes]:
        while True:
            rec = self._base.next_record()
            if rec is not None:
                return rec
            if not self._advance():
                return None

    def next_chunk(self) -> Optional[bytes]:
        while True:
            chunk = self._base.next_chunk()
            if chunk is not None:
                return chunk
            if not self._advance():
                return None

    def supports_gather(self) -> bool:
        return bool(getattr(self._base, "supports_gather", bool)())

    def next_gather_batch(self, n_records: int):
        """The base's ``next_gather_batch`` across the sub-parts, so a
        windowed shuffle under the macro-shuffle keeps the gather path
        (the JAX package copies these records into framed chunks)."""
        while True:
            out = self._base.next_gather_batch(n_records)
            if out is not None:
                return out
            if not self._advance():
                return None

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        nsp = len(self._sub_parts)
        self._sub_parts = [part_index * nsp + i for i in range(nsp)]
        self._num_total = num_parts * nsp
        self.before_first()

    def io_stats(self) -> Dict[str, object]:
        return self._base.io_stats()

    def close(self) -> None:
        self._base.close()


# URI options ``create`` reads: those of an indexed split, and
# ``shuffle_parts``/``seed`` of the macro-shuffle over any split
INDEXED_OPTIONS = ("index", "shuffle", "seed", "epoch", "skip_records",
                   "batch_size", "window", "merge_gap", "legacy_shuffle")
SPLIT_OPTIONS = INDEXED_OPTIONS + ("shuffle_parts",)


def create(
    uri: str,
    part_index: int = 0,
    num_parts: int = 1,
    type: str = "text",
    index_uri: Optional[str] = None,
    shuffle=None,
    seed: int = 0,
    batch_size: Optional[int] = None,
    num_shuffle_parts: int = 0,
    epoch: int = 0,
    skip_records: int = 0,
    window: Optional[int] = None,
    merge_gap: Optional[int] = None,
):
    """Split factory for one local file (reference InputSplit::Create,
    src/io.cc:81-130). ``type``: 'text' (LineSplitter), 'recordio'
    (RecordIOSplitter) or 'indexed_recordio' (IndexedRecordIOSplitter,
    which 'recordio' becomes when an index is given). Options ride the
    URI as well, a keyword argument winning over the URI:
    ``?index=<uri>&shuffle=0|record|batch|window&seed=S&epoch=E&
    skip_records=N&batch_size=B&window=W&merge_gap=G&legacy_shuffle=1``
    for an indexed split, and ``?shuffle_parts=N&seed=S`` for the
    macro-shuffle (``InputSplitShuffle``) over any split. Options of the
    indexed split without an index, ``#cachefile`` and any other option
    raise. Splits come back bare: there is no read-ahead wrapper."""
    check(num_parts >= 1 and 0 <= part_index < num_parts,
          f"invalid shard ({part_index}, {num_parts}): need "
          "0 <= part_index < num_parts")
    check(type in ("text", "recordio", "indexed_recordio"),
          f"split type {type!r}: only 'text', 'recordio' and "
          "'indexed_recordio' are ported")
    spec = URISpec(uri, part_index, num_parts)
    check(not spec.cache_file,
          "#cachefile is not ported (ROADMAP.md §1 item 2)")
    args = spec.args
    if "dynamic_shards" in args:
        raise Error("dynamic_shards needs the tracker (ROADMAP.md §1 item 4)")
    unknown = sorted(set(args) - set(SPLIT_OPTIONS))
    if unknown:
        raise Error(f"URI options {unknown} are not supported by the port's "
                    "splits")
    path = local_path(spec.uri)
    if num_shuffle_parts == 0:
        num_shuffle_parts = uri_int(args, "shuffle_parts", 0)
    if type == "recordio" and (index_uri is not None or "index" in args):
        type = "indexed_recordio"
    if seed == 0:
        seed = uri_int(args, "seed", 0)
    if type == "indexed_recordio":
        if index_uri is None:
            check("index" in args, "indexed_recordio requires index_uri")
            index_uri = str(args["index"])
        shuffle = normalize_shuffle(args.get("shuffle", "0") if shuffle is None
                                    else shuffle)
        if batch_size is None:
            batch_size = uri_int(args, "batch_size", 256)
        if window is None:
            window = uri_int(args, "window", 65536, minimum=1)
        if merge_gap is None:
            merge_gap = uri_int(args, "merge_gap", 65536, minimum=0)
        if epoch == 0:
            epoch = uri_int(args, "epoch", 0)
        if skip_records == 0:
            skip_records = uri_int(args, "skip_records", 0)
        base = IndexedRecordIOSplitter(
            path, index_uri, part_index, num_parts, batch_size=batch_size,
            shuffle=shuffle, seed=seed, epoch=epoch, skip_records=skip_records,
            window=window, merge_gap=merge_gap,
            legacy_shuffle=bool(uri_int(args, "legacy_shuffle", 0)))
    else:
        stray = sorted(set(args) & set(INDEXED_OPTIONS) - {"seed"})
        check(not (stray or shuffle or epoch or skip_records),
              f"{stray or 'shuffle/epoch/skip_records'} need an indexed "
              f"recordio source (?index=<uri>), not type={type!r}")
        cls = LineSplitter if type == "text" else RecordIOSplitter
        base = cls(path, part_index, num_parts)
    if num_shuffle_parts > 0:
        return InputSplitShuffle(base, part_index, num_parts,
                                 num_shuffle_parts, seed)
    return base


def part_range(uri: str, part_index: int = 0, num_parts: int = 1,
               type: str = "text") -> Tuple[int, int]:
    """The ``[begin, end)`` bytes that ``create`` gives part ``part_index``
    of ``num_parts`` of a plain split: both bounds at record starts (or
    the file's ends)."""
    check(type in ("text", "recordio"), f"part_range of a {type!r} split")
    split = create(uri, part_index, num_parts, type)
    split.close()
    return split.offset_begin, split.offset_end
