"""Record-aligned splits of a set of local files: text lines or RecordIO
records, by byte range or through an index, in file order or shuffled
(the port of ``dmlc_core_tpu/io/split.py`` for local files).

A URI names one file, a ``;``-separated list, a directory or a regex over
a directory's file names (reference ConvertToURIs,
src/io/input_split_base.cc:96-175); the files are read as one byte
stream. Part ``i`` of ``n`` owns the bytes ``[ceil(size/n)·i,
ceil(size/n)·(i+1))`` (rounded up to the record alignment), both bounds
snapped forward to the next record start, so every record lands in one
part; a file's start is a record start, no record spans two files, and a
last text line without a newline is ended at the file's end. Chunks hand
out whole records only. ``RecordIOSplitter`` decodes compressed blocks
(``io/recordio.decode_chunk``) before a chunk leaves it; a block is a
record head, so it is atomic to one part. ``IndexedRecordIOSplitter``
shards by record count through an index file, v1 or compressed-block,
and reads in file order or in a (seed, epoch) permutation;
``InputSplitShuffle`` visits sub-parts in a shuffled order;
``ThreadedInputSplit`` reads ahead on a thread and ``CachedInputSplit``
replays a ``#cachefile`` after the first epoch. Remote filesystems, the
stream sources and ``dynamic_shards`` are not ported: ``create`` refuses
them.
"""

from __future__ import annotations

import bisect
import hashlib
import mmap
import os
import random
import re
import sys
import threading
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..utils.logging import Error, check, check_eq
from ..utils.prefetch import Prefetcher
from . import codec as _codec
from . import serializer
from .filesystem import FileInfo, FileSystem
from .recordio import (
    RecordIOChunkReader,
    decode_chunk,
    first_head_in_words,
    last_head_in_words,
    scan_compressed_blob,
)
from .stream import SeekStream, Stream
from .uri import URISpec, uri_int

__all__ = [
    "CachedInputSplit",
    "IndexedRecordIOSplitter",
    "InputSplitBase",
    "InputSplitShuffle",
    "LineSplitter",
    "RecordIOSplitter",
    "SingleFileSplit",
    "ThreadedInputSplit",
    "create",
    "expand_files",
    "local_path",
    "normalize_shuffle",
    "part_range",
    "plan_coalesced_spans",
]

DEFAULT_BUFFER_BYTES = (2 << 20) * 4
# a split thread that does not stop within this many seconds raises
_JOIN_TIMEOUT = 30.0


def local_path(uri: str) -> str:
    """The path of a URI naming one existing local file (``file://``
    optional); raises ``Error`` on anything else."""
    check("?" not in uri and "#" not in uri,
          f"{uri!r}: URI options and #cachefile are resolved before the split")
    FileSystem.get_instance(uri)  # raises on a remote scheme
    path = uri[7:] if uri.startswith("file://") else uri
    if ";" in path or not os.path.isfile(path):
        raise Error(f"{uri!r} is not one local file")
    return path


def _expand_uris(filesys: FileSystem, uri: str) -> List[str]:
    """The ``;``-separated URI list with regex expansion over each
    entry's directory (reference ConvertToURIs,
    input_split_base.cc:96-147)."""
    out: List[str] = []
    for part in uri.split(";"):
        if not part:
            continue
        pos = part.rfind("/")
        if pos < 0 or pos + 1 == len(part):
            out.append(part)
            continue
        try:
            listing = filesys.list_directory(part[:pos])
        except (OSError, Error):
            out.append(part)  # parent unlistable: the stat reports it
            continue
        stripped = part.rstrip("/")
        exact = [f for f in listing if f.path.rstrip("/") == stripped]
        if exact:
            out.append(exact[0].path)
            continue
        try:
            pattern = re.compile(stripped)
        except re.error as e:
            raise Error(f"bad regex {stripped!r} in input URI: {e}") from e
        matched = False
        for f in listing:
            if f.type == "file" and f.size and pattern.fullmatch(f.path.rstrip("/")):
                out.append(f.path)
                matched = True
        if not matched:
            out.append(part)  # falls through to the missing-file error
    return out


def _list_recursive(filesys: FileSystem, uri: str) -> List[FileInfo]:
    out: List[FileInfo] = []
    for f in filesys.list_directory(uri):
        out.extend(_list_recursive(filesys, f.path) if f.type == "directory" else [f])
    return out


def expand_files(uri: str, recurse_directories: bool = False) -> List[FileInfo]:
    """The non-empty files a split of ``uri`` reads, in read order
    (reference InitInputFileInfo, input_split_base.cc:149-175): entries
    expanded, directories listed (recursively with
    ``recurse_directories``); raises when none is found."""
    filesys = FileSystem.get_instance(uri.split(";")[0])
    files: List[FileInfo] = []
    for path in _expand_uris(filesys, uri):
        try:
            info = filesys.get_path_info(path)
        except (OSError, Error):
            continue  # a missing candidate falls to the error below
        if info.type == "directory":
            listing = (_list_recursive(filesys, info.path) if recurse_directories
                       else filesys.list_directory(info.path))
            files.extend(f for f in listing if f.type == "file" and f.size)
        elif info.size:
            files.append(info)
    if not files:
        raise Error(f"Cannot find any files that match the URI pattern {uri!r}")
    return files


def _local(path: str) -> str:
    return path[len("file://"):] if path.startswith("file://") else path


class InputSplitBase:
    """Byte-range sharding of a file set (reference
    src/io/input_split_base.{h,cc}); subclasses say where records start
    (``seek_record_begin``, ``find_last_record_begin``) and how a chunk
    splits into records."""

    _align = 1
    _is_text = False

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 recurse_directories: bool = False) -> None:
        self.files = expand_files(uri, recurse_directories)
        offsets = [0]
        for f in self.files:
            if f.size % self._align:
                raise Error(f"file {f.path} does not align by {self._align} bytes")
            offsets.append(offsets[-1] + f.size)
        self.file_offset = offsets
        self.buffer_size = DEFAULT_BUFFER_BYTES
        self._fs: Optional[SeekStream] = None
        self._file_ptr = 0
        self.offset_begin = self.offset_end = self.offset_curr = 0
        self._overflow = b""
        self._rec_iter: Optional[Iterator[bytes]] = None
        self.reset_partition(part_index, num_parts)

    def total_size(self) -> int:
        return self.file_offset[-1]

    def hint_chunk_size(self, nbytes: int) -> None:
        self.buffer_size = max(nbytes, 1024)

    def seek_record_begin(self, stream: SeekStream) -> int:
        """Bytes from the stream's position to the next record start."""
        raise NotImplementedError

    def find_last_record_begin(self, data: bytes) -> int:
        """Offset of the last record start in ``data`` (0 if none)."""
        raise NotImplementedError

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        raise NotImplementedError

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        """Move to part ``part_index`` of ``num_parts`` and rewind
        (reference ResetPartition, input_split_base.cc:30-64)."""
        check(0 <= part_index < num_parts,
              f"part_index={part_index} outside num_parts={num_parts}")
        ntotal = self.file_offset[-1]
        nstep = (ntotal + num_parts - 1) // num_parts
        nstep = (nstep + self._align - 1) // self._align * self._align
        self.offset_begin = min(nstep * part_index, ntotal)
        self.offset_end = min(nstep * (part_index + 1), ntotal)
        self.offset_curr = self.offset_begin
        self._overflow = b""
        self._rec_iter = None
        if self.offset_begin == self.offset_end:
            self._close_fs()
            return
        fp = bisect.bisect_right(self.file_offset, self.offset_begin) - 1
        fp_end = bisect.bisect_right(self.file_offset, self.offset_end) - 1
        # a bound at a file start is a record start already
        if self.offset_end != self.file_offset[fp_end]:
            with self._open(fp_end) as fs:
                fs.seek(self.offset_end - self.file_offset[fp_end])
                self.offset_end += self.seek_record_begin(fs)
        if self.offset_begin != self.file_offset[fp]:
            with self._open(fp) as fs:
                fs.seek(self.offset_begin - self.file_offset[fp])
                self.offset_begin += self.seek_record_begin(fs)
        self.offset_curr = self.offset_begin
        self.before_first()

    def _open(self, file_ptr: int) -> SeekStream:
        return SeekStream.create_for_read(self.files[file_ptr].path)

    def _close_fs(self) -> None:
        if self._fs is not None:
            self._fs.close()
            self._fs = None

    def before_first(self) -> None:
        """Rewind to the start of this part (input_split_base.cc:66-82)."""
        if self.offset_begin >= self.offset_end:
            return
        fp = bisect.bisect_right(self.file_offset, self.offset_begin) - 1
        self._close_fs()
        self._file_ptr = fp
        self._fs = self._open(fp)
        self._fs.seek(self.offset_begin - self.file_offset[fp])
        self.offset_curr = self.offset_begin
        self._overflow = b""
        self._rec_iter = None

    def _read(self, size: int) -> bytes:
        """Up to ``size`` bytes of the part, across file ends; a text file
        ends with a newline added, so a last line without one is not
        joined to the next file's first (input_split_base.cc:177-219)."""
        if (self._fs is None or self.offset_begin >= self.offset_end
                or self.offset_curr >= self.offset_end):
            return b""
        size = min(size, self.offset_end - self.offset_curr)
        out: List[bytes] = []
        nleft = size
        while nleft > 0:
            data = self._fs.read(nleft)
            if data:
                out.append(data)
                nleft -= len(data)
                self.offset_curr += len(data)
                continue
            if self._is_text:
                out.append(b"\n")
                nleft -= 1
            check_eq(self.offset_curr, self.file_offset[self._file_ptr + 1],
                     "file offset not calculated correctly")
            if self._file_ptr + 1 >= len(self.files):
                break
            self._file_ptr += 1
            self._fs.close()
            self._fs = self._open(self._file_ptr)
        return b"".join(out)

    def _read_chunk(self, max_size: int) -> Optional[bytes]:
        """One buffer of whole records, the partial tail kept for the next
        call (ReadChunk, input_split_base.cc:221-258): None at the end of
        the part, b'' when not one record fits the buffer."""
        olen = len(self._overflow)
        if max_size <= olen:
            return b""
        data = self._overflow + self._read(max_size - olen)
        if not data:
            return None
        self._overflow = b""
        if self._is_text:
            if len(data) == olen:
                data += b"\n"  # no new bytes: the last line has no newline
        elif len(data) != max_size:
            return data  # the part ends on a record boundary
        cut = self.find_last_record_begin(data)
        self._overflow = data[cut:]
        return data[:cut]

    def _next_chunk_ex(self) -> Optional[bytes]:
        """The buffer doubles until it holds a record (Chunk::Load,
        input_split_base.cc:260-277)."""
        size = self.buffer_size
        while True:
            chunk = self._read_chunk(size)
            if chunk is None:
                return None
            if chunk:
                return chunk
            size *= 2

    def next_chunk(self) -> Optional[bytes]:
        """The next run of whole records, or None at the end of the part."""
        return self._next_chunk_ex()

    def next_record(self) -> Optional[bytes]:
        """The next record, or None at the end of the part."""
        return _next_record(self, self._next_chunk_ex)

    def io_stats(self) -> Dict[str, object]:
        return {"mode": "sequential"}

    def close(self) -> None:
        self._close_fs()


def _next_record(split, next_chunk) -> Optional[bytes]:
    """``split``'s next record, pulled chunk by chunk from ``next_chunk``."""
    while True:
        if split._rec_iter is not None:
            rec = next(split._rec_iter, None)
            if rec is not None:
                return rec
        chunk = next_chunk()
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


def _text_records(chunk: bytes) -> Iterator[bytes]:
    """Non-empty lines; newline runs collapse (line_split.cc:36-58)."""
    for line in chunk.replace(b"\r", b"\n").split(b"\n"):
        if line:
            yield line


class LineSplitter(InputSplitBase):
    """record = text line (reference src/io/line_split.{h,cc}); a line
    starts after a run of ``\\n``/``\\r``."""

    _is_text = True

    def seek_record_begin(self, stream: SeekStream) -> int:
        """Bytes to just after the next newline run (line_split.cc:9-26),
        read in blocks."""
        nstep = 0
        seen_newline = False
        while True:
            buf = stream.read(1 << 16)
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

    def find_last_record_begin(self, data: bytes) -> int:
        """line_split.cc:27-34."""
        cut = max(data.rfind(b"\n"), data.rfind(b"\r"))
        return cut + 1 if cut > 0 else 0

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        return _text_records(chunk)


class RecordIOSplitter(InputSplitBase):
    """record = RecordIO frame (reference src/io/recordio_split.{h,cc});
    records start at a magic word whose next word begins a chain. Chunks
    leave decoded (``decode_chunk`` on ``decode_ctx``, default the
    process-global ``io/codec.py`` context), so every consumer sees v1
    frames."""

    _align = 4

    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1,
                 recurse_directories: bool = False,
                 decode_ctx: Optional[_codec.DecodeContext] = None) -> None:
        # set first: reset_partition runs inside super().__init__
        self._decode_ctx = decode_ctx or _codec.default_decode_context()
        super().__init__(uri, part_index, num_parts, recurse_directories)

    def _next_chunk_ex(self) -> Optional[bytes]:
        chunk = super()._next_chunk_ex()
        return None if chunk is None else decode_chunk(chunk, self._decode_ctx)

    def seek_record_begin(self, stream: SeekStream) -> int:
        """Bytes to the next record head (recordio_split.cc:9-25);
        everything to EOF when there is none."""
        pos = 0  # offset of buf[0] from the scan start
        buf = b""
        while True:
            data = stream.read(1 << 16)
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

    def find_last_record_begin(self, data: bytes) -> int:
        """recordio_split.cc:26-42."""
        usable = len(data) & ~3
        hit = last_head_in_words(np.frombuffer(data[:usable], dtype="<u4"))
        return hit * 4 if hit >= 0 else 0

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        for rec in RecordIOChunkReader(chunk):
            yield bytes(rec)


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
    try:
        st = os.stat(_local(index_uri))
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
    ``keys`` in the same order; a compressed-block index (``key
    block:in``) → the record-to-block geometry
    (``_parse_compressed_index``). An index that mixes the two raises."""
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
    mixed = Error(f"index file {index_uri!r} mixes v1 and compressed-block offsets")
    if ":" in vals[0]:
        out = _parse_compressed_index(vals, keys, total, index_uri, mixed)
    else:
        try:
            raw = np.asarray(vals, dtype=np.int64)
        except ValueError:
            raise mixed from None
        order = np.argsort(raw, kind="stable")
        offs = raw[order]
        sizes = np.concatenate((np.diff(offs), [total - int(offs[-1])])).astype(np.int64)
        out = {"offs": offs, "sizes": sizes, "keys": keys[order]}
    for v in out.values():
        v.setflags(write=False)  # cached arrays are shared across splits
    return out


_COMPRESSED_INDEX_RE = re.compile(r"\d+:\d+(?: \d+:\d+)*")


def _parse_compressed_index(vals: List[str], keys: np.ndarray, total: int,
                            index_uri: str, mixed: Error) -> Dict[str, np.ndarray]:
    """The ``<block>:<in>`` column (the block frame's file offset, the
    record's frame start inside the decoded block) → per record its
    block id, in-block offset and the next record's in-block offset in
    the same block (-1 for a block's last), and per block its offset and
    framed size; records sort by (block, in), file order. Every entry
    must be exactly ``int:int``."""
    joined = " ".join(vals)
    if _COMPRESSED_INDEX_RE.fullmatch(joined) is None:
        raise mixed
    nums = np.asarray(joined.replace(":", " ").split(), dtype=np.int64)
    check_eq(nums.size, 2 * len(vals), "compressed index parse")
    boff, inoff = nums[0::2], nums[1::2]
    order = np.lexsort((inoff, boff))
    rec_boff, rec_inoff = boff[order], inoff[order]
    boffs, inv = np.unique(rec_boff, return_inverse=True)
    rec_block = inv.astype(np.int64).reshape(-1)
    block_sizes = np.concatenate((np.diff(boffs), [total - int(boffs[-1])])).astype(np.int64)
    check(bool((block_sizes > 0).all()) and int(boffs[0]) >= 0,
          f"index file {index_uri!r}: block offsets outside the {total}-byte dataset")
    nxt = np.full(len(rec_boff), -1, dtype=np.int64)
    same = rec_block[1:] == rec_block[:-1]
    nxt[:-1][same] = rec_inoff[1:][same]
    return {"rec_block": rec_block, "rec_inoff": rec_inoff, "rec_next": nxt,
            "block_offs": boffs, "block_sizes": block_sizes, "keys": keys[order]}


class _SpanReader:
    """Positioned reads of a file set by dataset offset (a span may
    cross file ends): zero-copy ``mmap`` views (no seek, no shared
    cursor, so the window read-ahead thread and the consumer never race),
    or ``os.pread`` for a file that does not map. Views stay valid until
    ``close()``, which leaves the unmap to the collector while a view is
    still exported."""

    def __init__(self, files: List[FileInfo], file_offset: List[int]) -> None:
        self._files = files
        self._file_offset = file_offset
        self._fds: Dict[int, int] = {}
        self._mmaps: Dict[int, mmap.mmap] = {}

    def _read_in_file(self, fp: int, rel: int, size: int):
        mm = self._mmaps.get(fp)
        if mm is None and fp not in self._fds:
            fd = os.open(_local(self._files[fp].path), os.O_RDONLY)
            try:
                mm = self._mmaps[fp] = mmap.mmap(fd, 0, access=mmap.ACCESS_READ)
            except (OSError, ValueError):
                self._fds[fp] = fd  # unmappable: pread
            else:
                os.close(fd)
        if mm is not None:
            return memoryview(mm)[rel:rel + size]
        out: List[bytes] = []
        while size > 0:
            data = os.pread(self._fds[fp], size, rel)
            if not data:
                break
            out.append(data)
            rel += len(data)
            size -= len(data)
        return out[0] if len(out) == 1 else b"".join(out)

    def _segments(self, offset: int, size: int):
        """``(file, offset in it, bytes, base in the span)`` of each file
        the span covers."""
        written = 0
        while written < size:
            fp = bisect.bisect_right(self._file_offset, offset) - 1
            if fp >= len(self._files):
                return
            take = min(size - written, self._file_offset[fp + 1] - offset)
            if take <= 0:
                return
            yield fp, offset - self._file_offset[fp], take, written
            written += take
            offset += take

    def read(self, offset: int, size: int):
        """``size`` bytes at dataset ``offset``: a memoryview of the
        mapping when one file covers them, else joined bytes."""
        out = []
        for fp, rel, take, _base in self._segments(offset, size):
            data = self._read_in_file(fp, rel, take)
            out.append(data)
            if len(data) < take:
                break
        if len(out) == 1:
            return out[0]
        return b"".join(out)

    def close(self) -> None:
        for fd in self._fds.values():
            try:
                os.close(fd)
            except OSError:
                pass
        self._fds.clear()
        for mm in self._mmaps.values():
            try:
                mm.close()
            except BufferError:
                pass  # a handed-out view is still alive; GC unmaps
        self._mmaps.clear()


class IndexedRecordIOSplitter(RecordIOSplitter):
    """A RecordIO file set sharded by RECORD COUNT through an index of
    ``key offset`` lines (or ``key block:in`` for compressed blocks),
    with optional per-epoch shuffled reads (the port of the JAX
    package's ``IndexedRecordIOSplitter``; reference
    src/io/indexed_recordio_split.{h,cc}).

    Part ``i`` of ``n`` owns records ``[ceil(N/n)·i, ceil(N/n)·(i+1))``
    in file order. ``shuffle``:

    - off: the part in file order, ``batch_size`` records a chunk;
    - 'record': a per-record permutation of the part. On an uncompressed
      file it is served as one window, the part's bytes one zero-copy
      mmap span that records leave in permutation order; on a compressed
      one as windows of ``window`` records (a whole-part window would
      hold the part decoded), in the same order. ``legacy_shuffle``
      reads the same order with one seek and read per record instead;
    - 'batch': spans of ``batch_size`` consecutive records in permuted
      order, records in file order inside a span; the remainder span
      (``N % batch_size`` records) always reads last;
    - 'window': the permutation of 'record', cut into windows of
      ``window`` records; each window's records are sorted by offset,
      merged into spans across gaps up to ``merge_gap`` bytes, read one
      span at a time, and emitted in permutation order.

    Over compressed blocks a window reads the blocks its records live
    in: cached decoded blocks come from the decoded-block cache, the
    others are read in spans coalesced at block granularity and decoded
    on the pool. The cache key holds each file's path, size and
    ``mtime_ns`` and a digest of the block layout, so a file rewritten in
    place is decoded anew.

    The permutation of epoch ``e`` comes from
    ``random.Random(111 + seed + 1_000_003·e)`` alone, so any epoch's
    order can be rebuilt without replaying the epochs before it (the
    reference carries its RNG from epoch to epoch instead). Windows load
    on a read-ahead thread (``Prefetcher``), closed on ``close()`` and on
    every ``before_first``. ``next_gather_batch`` hands ``(buf, starts,
    sizes)`` views for the native gather kernel; ``next_batch_ex``
    copies the same records out as framed bytes.
    """

    KRAND_MAGIC = 111  # reference indexed_recordio_split.h:82

    def __init__(
        self,
        uri: str,
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
        decode_ctx: Optional[_codec.DecodeContext] = None,
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
        self._span_reader: Optional[_SpanReader] = None
        # I/O-shape counters, cumulative across epochs (io_stats)
        self.spans_read = 0
        self.seek_calls = 0
        self.bytes_read = 0
        self.records_emitted = 0
        self.gather_batches = 0
        self.gather_bytes = 0
        self.gather_fallback_batches = 0
        self.decode_cache_hits = 0
        self.decode_cache_misses = 0
        self._seed = seed
        self.epoch = epoch - 1  # before_first() steps into `epoch`
        self._skip_next = skip_records
        self._index_uri = index_uri
        self._index_loaded = False
        self._compressed = False
        self._cache_key: object = None
        self.index_begin = self.index_end = 0
        self._current = 0
        self._n_overflow = 0
        self._permutation = []
        super().__init__(uri, part_index, num_parts, decode_ctx=decode_ctx)

    def _read_index_file(self) -> None:
        total = self.file_offset[-1]
        skey = _index_stat_key(self._index_uri, total)
        data = (_load_index_cached(skey) if skey is not None
                else _load_index_uri(self._index_uri, total))
        self._index_loaded = True
        if "offs" in data:
            self._index_offs = data["offs"]
            self._index_sizes = data["sizes"]
            return
        self._compressed = True
        self._rec_block = data["rec_block"]
        self._rec_inoff = data["rec_inoff"]
        self._rec_next = data["rec_next"]
        self._block_offs = data["block_offs"]
        self._block_sizes = data["block_sizes"]
        # the decoded-block identity: each file's path, size and mtime,
        # the dataset size and a digest of the block layout (plain
        # strings and ints: the same in every process)
        sig = []
        for f in self.files:
            try:
                mtime = os.stat(_local(f.path)).st_mtime_ns
            except OSError:
                mtime = 0
            sig.append((f.path, int(f.size), mtime, f.etag))
        self._cache_key = (tuple(sig), int(total),
                           hashlib.sha1(self._block_offs.tobytes()).hexdigest())
        # a record sits at its block's offset, which keeps the part's
        # byte bounds meaningful
        self._index_offs = self._block_offs[self._rec_block]
        self._index_sizes = np.zeros(len(self._rec_block), dtype=np.int64)

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        """Move to records ``[ceil(N/n)·i, ceil(N/n)·(i+1))`` and start
        the next epoch (reference indexed_recordio_split.cc:12-41)."""
        check(0 <= part_index < num_parts,
              f"part_index={part_index} outside num_parts={num_parts}")
        if not self._index_loaded:
            self._read_index_file()
        ntotal = len(self._index_offs)
        nstep = (ntotal + num_parts - 1) // num_parts
        if part_index * nstep >= ntotal:
            self.offset_begin = self.offset_end = self.offset_curr = 0
            self.index_begin = self.index_end = 0
            self._permutation = []
            self._current = 0
            self._n_overflow = 0
            self._rec_iter = None
            self._teardown_window_pipeline()
            return
        self.index_begin = part_index * nstep
        self.index_end = min((part_index + 1) * nstep, ntotal)
        self.offset_begin = int(self._index_offs[self.index_begin])
        self.offset_end = (int(self._index_offs[self.index_end]) if self.index_end < ntotal
                           else self.file_offset[-1])
        self._n_overflow = 0
        self.before_first()

    def before_first(self) -> None:
        """Start the next epoch: its permutation from (seed, epoch)."""
        if self.index_end <= self.index_begin:
            return
        self.epoch += 1
        rnd = random.Random(self.KRAND_MAGIC + self._seed + 1_000_003 * self.epoch)
        # the previous epoch's read-ahead goes first: it must not read
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
        """Seek to a dataset offset and read (sequential chunks, the
        legacy per-record loop), across file ends."""
        fp = bisect.bisect_right(self.file_offset, offset) - 1
        if fp != self._file_ptr or self._fs is None:
            self._close_fs()
            self._file_ptr = fp
            self._fs = self._open(fp)
        self._fs.seek(offset - self.file_offset[fp])
        out: List[bytes] = []
        nleft = size
        while nleft > 0:
            data = self._fs.read(nleft)
            if not data:
                if self._file_ptr + 1 >= len(self.files):
                    break
                self._file_ptr += 1
                self._fs.close()
                self._fs = self._open(self._file_ptr)
                continue
            out.append(data)
            nleft -= len(data)
        self.seek_calls += 1
        self.spans_read += 1
        self.bytes_read += size - nleft
        return b"".join(out)

    # -- compressed blocks ----------------------------------------------------
    def _block_key(self, bid: int) -> object:
        return (self._cache_key, int(self._block_offs[bid]))

    def _get_span_reader(self) -> _SpanReader:
        if self._span_reader is None:
            self._span_reader = _SpanReader(self.files, self.file_offset)
        return self._span_reader

    def _fetch_blocks(self, missing: List[int]) -> Dict[int, bytes]:
        """Read, decode and cache the blocks ``missing`` (ids): their file
        ranges coalesce into spans (``merge_gap``), each span's blocks go
        to the decode pool as the span is read."""
        ctx = self._decode_ctx
        marr = np.asarray(missing, dtype=np.int64)
        offs = self._block_offs[marr]
        sizes = self._block_sizes[marr]
        order, starts, ends = _plan_span_bounds(offs, sizes, self.merge_gap)
        span_begin = offs[order][starts]
        run_end = np.maximum.accumulate(offs[order] + sizes[order])
        span_len = run_end[ends - 1] - span_begin
        reader = self._get_span_reader()
        pending = []  # (block id, decode Future)
        for si, (begin, nbytes) in enumerate(zip(span_begin.tolist(), span_len.tolist())):
            data = reader.read(begin, nbytes)
            check_eq(len(data), nbytes, "span read truncated")
            self.spans_read += 1
            self.bytes_read += nbytes
            mv = memoryview(data)
            for k in order[starts[si]:ends[si]].tolist():
                rel = int(offs[k]) - begin
                blob, _end = scan_compressed_blob(mv[rel:rel + int(sizes[k])], 0)
                pending.append((int(marr[k]), ctx.submit_decode(blob)))
        out: Dict[int, bytes] = {}
        for bid, fut in pending:
            raw, _n = fut.result()
            out[bid] = raw
            ctx.put_block(self._block_key(bid), raw)
        return out

    def _blocks(self, bids) -> Dict[int, bytes]:
        """The decoded blocks ``bids`` (unique ids): cached ones from the
        decode context, the rest read and decoded; counts hits and
        misses."""
        found = self._decode_ctx.get_blocks([self._block_key(b) for b in bids])
        blocks: Dict[int, bytes] = {}
        for b in bids:
            raw = found.get(self._block_key(b))
            if raw is not None:
                blocks[b] = raw
        missing = sorted(b for b in bids if b not in blocks)
        self.decode_cache_hits += len(blocks)
        self.decode_cache_misses += len(missing)
        if missing:
            blocks.update(self._fetch_blocks(missing))
        return blocks

    def _emit_range(self, lo: int, hi: int) -> bytes:
        """Framed v1 bytes of records [lo, hi) of a compressed file: the
        covered blocks decoded and sliced at the index's in-block
        offsets; the bytes an uncompressed writer writes for them."""
        runs: List[Tuple[int, int, int]] = []  # (block, first, end) records
        i = lo
        while i < hi:
            b = int(self._rec_block[i])
            j = i + 1
            while j < hi and int(self._rec_block[j]) == b:
                j += 1
            runs.append((b, i, j))
            i = j
        blocks = self._blocks(list(dict.fromkeys(b for b, _i, _j in runs)))
        out: List[memoryview] = []
        for b, i, j in runs:
            mv = memoryview(blocks[b])
            start, end = int(self._rec_inoff[i]), int(self._rec_next[j - 1])
            out.append(mv[start:] if end < 0 else mv[start:end])
        return b"".join(out)

    def _load_window_compressed(self, perm: np.ndarray):
        """A window over compressed blocks: its unique blocks decoded (or
        cached) back to back in one buffer, each record's start and
        length in it from the index's in-block offsets, in permutation
        order."""
        bids = self._rec_block[perm]
        uniq = np.unique(bids)
        decoded = self._blocks(uniq.tolist())
        lens = np.asarray([len(decoded[b]) for b in uniq.tolist()], dtype=np.int64)
        base = np.concatenate(([0], np.cumsum(lens)[:-1]))
        buf = np.frombuffer(b"".join(decoded[b] for b in uniq.tolist()), dtype=np.uint8)
        pos = np.searchsorted(uniq, bids)
        rec_start = base[pos] + self._rec_inoff[perm]
        nxt = self._rec_next[perm]
        rec_end = base[pos] + np.where(nxt >= 0, nxt, lens[pos])
        idt = np.int32 if len(buf) < (1 << 31) else np.int64
        return buf, rec_start.astype(idt), (rec_end - rec_start).astype(idt)

    # -- the window machinery -------------------------------------------------
    @property
    def windowed(self) -> bool:
        """True when the shuffle is served by the window machinery
        (record without ``legacy_shuffle``, batch, window): then
        ``next_gather_batch`` works and windows load on a read-ahead
        thread."""
        return (self.shuffle_mode in ("record", "batch", "window")
                and not self._legacy_record)

    def supports_gather(self) -> bool:
        """Whether ``next_gather_batch`` serves this configuration."""
        return self.windowed

    def _eff_window(self) -> int:
        """Records per window: record mode over an uncompressed file is
        one window over the whole part (a zero-copy mapping); batch and
        window modes, and record mode over compressed blocks, use
        ``window``."""
        if self.shuffle_mode == "record" and not self._compressed:
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
        reader = self._get_span_reader()
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
        if self._compressed:
            return self._load_window_compressed(perm)
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
        """The next window, loaded by the read-ahead thread, into the
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
        bytes); over compressed blocks ``decode_cache_hits`` and
        ``decode_cache_misses`` (blocks found in the decoded-block cache,
        and blocks read and decoded)."""
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
        if self._compressed:
            out["decode_cache_hits"] = self.decode_cache_hits
            out["decode_cache_misses"] = self.decode_cache_misses
        return out

    def next_batch_ex(self, n_records: int) -> Optional[bytes]:
        """The next ``n_records`` records as framed bytes (reference
        NextBatchEx, indexed_recordio_split.cc:159-212): copied out of
        the windows, one read per record (legacy), or one read of the
        contiguous range (sequential); decoded from their blocks on a
        compressed file."""
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
                parts.append(self._emit_range(idx, idx + 1) if self._compressed
                             else self._read_at(int(self._index_offs[idx]),
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
        if self._compressed:
            chunk = self._emit_range(self._current, last)
        else:
            begin_off = int(self._index_offs[self._current])
            end_off = (int(self._index_offs[last]) if last < len(self._index_offs)
                       else self.file_offset[-1])
            chunk = self._read_at(begin_off, end_off - begin_off)
        if chunk:
            self.records_emitted += last - self._current
        self._current = last
        return chunk if chunk else None

    def next_chunk(self) -> Optional[bytes]:
        return self.next_batch_ex(self.batch_size)

    def next_record(self) -> Optional[bytes]:
        return _next_record(self, self.next_chunk)

    def close(self) -> None:
        self._teardown_window_pipeline()
        if self._span_reader is not None:
            self._span_reader.close()
            self._span_reader = None
        super().close()


class SingleFileSplit:
    """One text file, or standard input for the URI ``-``, read whole
    with no sharding (reference src/io/single_file_split.h)."""

    def __init__(self, path: str = "-") -> None:
        self._path = path
        self._stream = None
        self._eof = False
        self._rec_iter: Optional[Iterator[bytes]] = None
        self._overflow = b""
        self.before_first()

    def _open(self):
        return sys.stdin.buffer if self._path == "-" else open(self._path, "rb")

    def before_first(self) -> None:
        if self._path == "-" and self._stream is not None:
            raise Error("cannot rewind stdin")
        if self._stream is not None:
            self._stream.close()
        self._stream = self._open()
        self._eof = False
        self._rec_iter = None
        self._overflow = b""

    def total_size(self) -> int:
        return 0 if self._path == "-" else os.path.getsize(self._path)

    def next_chunk(self) -> Optional[bytes]:
        """The next run of whole lines; a last line without a newline
        gets one."""
        while not self._eof:
            data = self._stream.read(DEFAULT_BUFFER_BYTES)
            if not data:
                self._eof = True
                if self._overflow:
                    out, self._overflow = self._overflow + b"\n", b""
                    return out
                return None
            data = self._overflow + data
            cut = max(data.rfind(b"\n"), data.rfind(b"\r"))
            if cut <= 0:
                self._overflow = data
                continue
            self._overflow = data[cut + 1:]
            return data[:cut + 1]
        return None

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        return _text_records(chunk)

    def next_record(self) -> Optional[bytes]:
        return _next_record(self, self.next_chunk)

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        check_eq(num_parts, 1, "SingleFileSplit does not shard")

    def close(self) -> None:
        if self._stream is not None and self._path != "-":
            self._stream.close()
        self._stream = None


def _stop(it: Optional[Prefetcher], what: str) -> None:
    """End a split thread within ``_JOIN_TIMEOUT`` seconds, or raise:
    the split under it must not be touched while it runs."""
    if it is not None and not it.destroy(timeout=_JOIN_TIMEOUT):
        raise Error(f"{what} thread did not stop within {_JOIN_TIMEOUT:.0f} s")


class _Wrapper:
    """A split that serves its base's chunks from a thread: the thread
    starts at the first pull, and the base's records are cut from the
    chunks it hands over."""

    def __init__(self, base) -> None:
        self._base = base
        self._iter: Optional[Prefetcher] = None
        self._rec_iter: Optional[Iterator[bytes]] = None

    def _start(self) -> Prefetcher:
        raise NotImplementedError

    def next_chunk(self) -> Optional[bytes]:
        if self._iter is None:
            self._iter = self._start()
        return self._iter.next()

    def next_record(self) -> Optional[bytes]:
        return _next_record(self, self.next_chunk)

    def _halt(self) -> None:
        _stop(self._iter, type(self).__name__)
        self._iter = None
        self._rec_iter = None

    def total_size(self) -> int:
        return self._base.total_size()

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        return self._base.extract_records(chunk)

    def io_stats(self) -> Dict[str, object]:
        return self._base.io_stats()

    def close(self) -> None:
        self._halt()
        self._base.close()


class ThreadedInputSplit(_Wrapper):
    """Read-ahead: the base's chunks are pulled on a thread into a queue
    of ``max_capacity`` (reference src/io/threaded_input_split.h,
    capacity 2 at :33). The capacity holds across ``reset_partition``."""

    def __init__(self, base, max_capacity: int = 2) -> None:
        super().__init__(base)
        self.max_capacity = max_capacity

    def _start(self) -> Prefetcher:
        return Prefetcher(lambda: iter(self._base.next_chunk, None), self.max_capacity,
                          "split-prefetch")

    def hint_chunk_size(self, nbytes: int) -> None:
        self._base.hint_chunk_size(nbytes)

    def before_first(self) -> None:
        """Rewind: the thread stops, the base rewinds, the next pull
        starts a new thread."""
        self._halt()
        self._base.before_first()

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self._halt()
        self._base.reset_partition(part_index, num_parts)


class CachedInputSplit(_Wrapper):
    """The first epoch serves the base's chunks and writes each to
    ``cache_file`` (``serializer.write_bytes`` frames); once an epoch has
    run to its end, later epochs replay the file and never touch the
    base (reference src/io/cached_input_split.h: InitPreprocIter
    :148-164, InitCachedIter :166-189). An epoch cut short rebuilds the
    cache. ``io_stats`` adds ``cache_epochs_replayed``."""

    def __init__(self, base, cache_file: str) -> None:
        super().__init__(base)
        self._cache_file = cache_file
        self._cache_complete = False
        self.epochs_replayed = 0

    def _build(self) -> Iterator[bytes]:
        out = Stream.create(self._cache_file, "w")
        try:
            while True:
                chunk = self._base.next_chunk()
                if chunk is None:
                    break
                serializer.write_bytes(out, chunk)
                yield chunk
            self._cache_complete = True
        finally:
            out.close()

    def _replay(self) -> Iterator[bytes]:
        with Stream.create(self._cache_file, "r") as stream:
            while True:
                n = serializer.try_read_scalar(stream, "uint64")
                if n is None:
                    return
                yield stream.read_exact(n)

    def _start(self) -> Prefetcher:
        if self._cache_complete:
            self.epochs_replayed += 1
            return Prefetcher(self._replay, 2, "split-cache-replay")
        return Prefetcher(self._build, 2, "split-cache-build")

    def before_first(self) -> None:
        self._halt()
        if not self._cache_complete:
            self._base.before_first()  # the first pass did not finish: rebuild

    def reset_partition(self, part_index: int, num_parts: int) -> None:
        self._halt()
        self._cache_complete = False
        self._base.reset_partition(part_index, num_parts)

    def io_stats(self) -> Dict[str, object]:
        return {**self._base.io_stats(), "cache_epochs_replayed": self.epochs_replayed}


class InputSplitShuffle:
    """Macro-shuffle: cut the file set into ``num_parts ·
    num_shuffle_parts`` sub-parts and visit this part's
    ``num_shuffle_parts`` of them in an order drawn anew each epoch from
    ``random.Random(666 + seed)`` (reference
    include/dmlc/input_split_shuffle.h:24-33, 100-119, 151). Over a
    windowed indexed split it passes ``next_gather_batch`` on."""

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

    def total_size(self) -> int:
        return self._base.total_size()

    def extract_records(self, chunk: bytes) -> Iterator[bytes]:
        return self._base.extract_records(chunk)

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
    recurse_directories: bool = False,
    num_shuffle_parts: int = 0,
    threaded: bool = True,
    epoch: int = 0,
    skip_records: int = 0,
    window: Optional[int] = None,
    merge_gap: Optional[int] = None,
):
    """Split factory for local files (reference InputSplit::Create,
    src/io.cc:81-130). ``type``: 'text' (LineSplitter; the URI ``-`` is
    standard input, ``SingleFileSplit``), 'recordio' (RecordIOSplitter)
    or 'indexed_recordio' (IndexedRecordIOSplitter, which 'recordio'
    becomes when an index is given). Options ride the URI as well, a
    keyword argument winning over the URI:
    ``?index=<uri>&shuffle=0|record|batch|window&seed=S&epoch=E&
    skip_records=N&batch_size=B&window=W&merge_gap=G&legacy_shuffle=1``
    for an indexed split, and ``?shuffle_parts=N&seed=S`` for the
    macro-shuffle over any split. ``uri#cachefile`` gives a
    ``CachedInputSplit``. One wrapper reads ahead, never two: a cached
    split, a windowed shuffle (its own read-ahead thread), or with
    ``threaded`` a ``ThreadedInputSplit`` (over the macro-shuffle too).
    A shuffle or ``shuffle_parts`` with a ``#cachefile``, options of the
    indexed split without an index, and any other option raise."""
    check(num_parts >= 1 and 0 <= part_index < num_parts,
          f"invalid shard ({part_index}, {num_parts}): need "
          "0 <= part_index < num_parts")
    spec = URISpec(uri, part_index, num_parts)
    args = spec.args
    if "dynamic_shards" in args:
        raise Error("dynamic_shards needs the tracker (ROADMAP.md §1 item 4)")
    unknown = sorted(set(args) - set(SPLIT_OPTIONS))
    if unknown:
        raise Error(f"URI options {unknown} are not supported by the port's "
                    "splits")
    if num_shuffle_parts == 0:
        num_shuffle_parts = uri_int(args, "shuffle_parts", 0)
    if type == "recordio" and (index_uri is not None or "index" in args):
        type = "indexed_recordio"
    if seed == 0:
        seed = uri_int(args, "seed", 0)
    if type not in ("text", "recordio", "indexed_recordio"):
        raise Error(f"unknown InputSplit type {type!r}")
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
        check(not (shuffle and spec.cache_file),
              "indexed shuffle with a #cachefile would freeze the first "
              "epoch's shuffle order into the cache; pick one")
        base = IndexedRecordIOSplitter(
            spec.uri, index_uri, part_index, num_parts, batch_size=batch_size,
            shuffle=shuffle, seed=seed, epoch=epoch, skip_records=skip_records,
            window=window, merge_gap=merge_gap,
            legacy_shuffle=bool(uri_int(args, "legacy_shuffle", 0)))
    else:
        stray = sorted(set(args) & set(INDEXED_OPTIONS) - {"seed"})
        check(not (stray or shuffle or epoch or skip_records),
              f"{stray or 'shuffle/epoch/skip_records'} need an indexed "
              f"recordio source (?index=<uri>), not type={type!r}")
        if type == "text" and spec.uri == "-":
            return SingleFileSplit("-")
        cls = LineSplitter if type == "text" else RecordIOSplitter
        base = cls(spec.uri, part_index, num_parts, recurse_directories)
    windowed = isinstance(base, IndexedRecordIOSplitter) and base.windowed
    if num_shuffle_parts > 0:
        if spec.cache_file:
            base.close()
        check(not spec.cache_file,
              "num_shuffle_parts with a #cachefile would freeze the first "
              "epoch's shuffle order into the cache; pick one")
        shuffled = InputSplitShuffle(base, part_index, num_parts,
                                     num_shuffle_parts, seed)
        # a windowed base reads ahead already, and keeps its gather views
        return ThreadedInputSplit(shuffled) if threaded and not windowed else shuffled
    if spec.cache_file:
        return CachedInputSplit(base, spec.cache_file)
    if windowed or not threaded:
        return base
    return ThreadedInputSplit(base)


def part_range(uri: str, part_index: int = 0, num_parts: int = 1,
               type: str = "text") -> Tuple[int, int]:
    """The ``[begin, end)`` bytes that ``create`` gives part ``part_index``
    of ``num_parts`` of a plain split of one file: both bounds at record
    starts (or the file's ends)."""
    check(type in ("text", "recordio"), f"part_range of a {type!r} split")
    split = create(uri, part_index, num_parts, type, threaded=False)
    split.close()
    return split.offset_begin, split.offset_end
