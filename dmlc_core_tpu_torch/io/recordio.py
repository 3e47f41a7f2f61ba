"""RecordIO: the splittable binary record container, bit-compatible with
dmlc-core's format (include/dmlc/recordio.h:16-45, src/recordio.cc), and
its compressed blocks (the port of ``dmlc_core_tpu/io/recordio.py``).

Frame layout (little-endian uint32 words)::

    [kMagic = 0xced7230a] [lrec] [data ...] [zero pad to 4-byte boundary]
    lrec = (cflag << 29) | length        # length < 2**29

A payload holding the magic word at a 4-byte-aligned offset is split
there into a multipart chain (cflag 1 start, 2 middle, 3 end; 0 is a
whole record) and the reader re-inserts the elided magic.

Compressed blocks: a writer given a ``codec`` buffers framed records into
blocks of about ``block_bytes`` raw bytes and writes each block as one
frame whose cflag has bit 2 set (``CFLAG_COMPRESSED``): 4 is a whole
blob, 5/6/7 a magic-escaped blob chain. The blob is an ``io/codec.py``
block (a 16-byte header, then the compressed bytes), and the decoded
bytes are plain v1 frames. The chunk reader takes v1 frames only and
rejects a compressed frame; ``decode_chunk`` turns a chunk of mixed
frames into v1 frames first.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..utils.logging import Error, check
from . import codec as _codec

__all__ = [
    "CFLAG_COMPRESSED",
    "DEFAULT_BLOCK_BYTES",
    "KMAGIC",
    "IndexedRecordIOWriter",
    "RecordIOChunkReader",
    "RecordIOReader",
    "RecordIOWriter",
    "chunk_has_compressed",
    "decode_chunk",
    "decode_flag",
    "decode_length",
    "encode_lrec",
    "first_head_in_words",
    "last_head_in_words",
    "scan_compressed_blob",
]

KMAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", KMAGIC)
_MAX_LEN = 1 << 29
# cflag bit 2: the frame holds (part of) a compressed block. The magic
# word itself decodes to cflag 6, a compressed middle part, so it is
# never a record head
CFLAG_COMPRESSED = 4
# raw bytes a writer buffers per compressed block by default
DEFAULT_BLOCK_BYTES = 1 << 18
_SCAN_BLOCK_WORDS = 1 << 18  # 1 MB of uint32 words per head-scan block


def encode_lrec(cflag: int, length: int) -> int:
    """recordio.h:52-54."""
    return ((cflag & 7) << 29) | length


def decode_flag(lrec: int) -> int:
    """recordio.h:60-62."""
    return (lrec >> 29) & 7


def decode_length(lrec: int) -> int:
    """recordio.h:68-70."""
    return lrec & (_MAX_LEN - 1)


def _aligned_magic_positions(payload: bytes) -> np.ndarray:
    """4-byte-aligned offsets where the payload equals the magic word
    (the writer's escape scan, src/recordio.cc:20-28, in one compare)."""
    lower = len(payload) & ~3
    if lower == 0:
        return np.empty(0, dtype=np.int64)
    words = np.frombuffer(payload, dtype="<u4", count=lower // 4)
    return (np.nonzero(words == KMAGIC)[0] * 4).astype(np.int64)


class RecordIOWriter:
    """Frame writer (recordio.h:38-115) onto a binary stream. With a
    ``codec`` (a name or an ``io/codec.py`` Codec), records are buffered
    and written as compressed blocks of about ``block_bytes`` raw framed
    bytes; ``flush()`` (or ``close()``) writes the last partial block.
    Without one the output is plain v1 frames."""

    def __init__(self, stream, codec=None, level: Optional[int] = None,
                 block_bytes: int = DEFAULT_BLOCK_BYTES) -> None:
        self.stream = stream
        self.except_counter = 0  # magic collisions escaped
        self.bytes_written = 0
        self.records_written = 0  # records written out, not the buffered ones
        self.codec = None if codec in (None, "", "none") else _codec.get_codec(codec)
        self.level = level
        check(block_bytes >= 1, f"block_bytes={block_bytes} must be >= 1")
        self.block_bytes = block_bytes
        self.blocks_written = 0
        self._blk_parts: List[bytes] = []
        self._blk_len = 0
        self._blk_offs: List[int] = []  # frame starts inside the block
        self._blk_keys: List[Optional[int]] = []

    def _frame_payload(self, data: bytes, base_flag: int = 0) -> bytes:
        """One payload framed with the aligned-magic escape
        (src/recordio.cc:11-51); ``base_flag`` ORs into every part's
        cflag: 0 for records, ``CFLAG_COMPRESSED`` for block blobs."""
        check(len(data) < _MAX_LEN, "RecordIO only accepts records < 2^29 bytes")
        out: List[bytes] = []
        dptr = 0
        for pos in _aligned_magic_positions(data):
            pos = int(pos)
            cflag = (1 if dptr == 0 else 2) | base_flag
            out.append(_MAGIC_BYTES)
            out.append(struct.pack("<I", encode_lrec(cflag, pos - dptr)))
            out.append(data[dptr:pos])
            dptr = pos + 4
            self.except_counter += 1
        out.append(_MAGIC_BYTES)
        out.append(struct.pack("<I", encode_lrec((3 if dptr else 0) | base_flag,
                                                 len(data) - dptr)))
        out.append(data[dptr:])
        out.append(b"\x00" * ((4 - ((len(data) - dptr) & 3)) & 3))
        return b"".join(out)

    def write_record(self, data: bytes) -> None:
        framed = self._frame_payload(data)
        if self.codec is not None:
            self._buffer_block(framed, (0,), (None,))
            return
        self.stream.write(framed)
        self.bytes_written += len(framed)
        self.records_written += 1

    def write_framed_block(self, framed: bytes, offsets) -> None:
        """Write records framed already; ``offsets`` are their frame
        starts in ``framed``."""
        if self.codec is not None:
            self._buffer_block(framed, offsets, (None,) * len(offsets))
            return
        base = self.bytes_written
        self.stream.write(framed)
        self.bytes_written += len(framed)
        self.records_written += len(offsets)
        self._note_framed_records(base, offsets)

    def _note_framed_records(self, base: int, offsets) -> None:
        pass  # the plain writer keeps nothing per record

    def _buffer_block(self, framed: bytes, offsets, keys) -> None:
        """Add framed records (frames start at ``offsets``) to the
        pending block, cut at record boundaries so a block holds about
        ``block_bytes``; a block is written once it reaches that size,
        and a larger record goes alone."""
        n = len(offsets)
        if n == 0:
            return
        bounds = [int(o) for o in offsets]
        check(bounds[0] == 0,
              f"write_framed_block: first frame must start at byte 0 of the "
              f"buffer (got {bounds[0]}); leading bytes would be lost")
        bounds.append(len(framed))
        i = 0
        while i < n:
            j = i + 1
            while j < n and self._blk_len + (bounds[j] - bounds[i]) < self.block_bytes:
                j += 1
            seg = framed if i == 0 and j == n else framed[bounds[i]:bounds[j]]
            base = self._blk_len - bounds[i]
            for t in range(i, j):
                self._blk_offs.append(base + bounds[t])
                self._blk_keys.append(keys[t])
            self._blk_parts.append(seg)
            self._blk_len += len(seg)
            if self._blk_len >= self.block_bytes:
                self.flush_block()
            i = j

    def flush_block(self) -> None:
        """Write the buffered records as one compressed block frame."""
        if not self._blk_offs:
            return
        raw = b"".join(self._blk_parts)
        blob = _codec.encode_block(raw, len(self._blk_offs), self.codec, self.level)
        framed = self._frame_payload(blob, base_flag=CFLAG_COMPRESSED)
        base = self.bytes_written
        self.stream.write(framed)
        self.bytes_written += len(framed)
        self.blocks_written += 1
        self.records_written += len(self._blk_offs)
        self._note_block_records(base, self._blk_offs, self._blk_keys)
        self._blk_parts, self._blk_len = [], 0
        self._blk_offs, self._blk_keys = [], []

    def _note_block_records(self, base: int, offsets, keys) -> None:
        pass

    def flush(self) -> None:
        """Write the pending block and flush the stream; needed after the
        last record when writing with a codec."""
        self.flush_block()
        self.stream.flush()

    def close(self) -> None:
        """``flush()``; the stream stays the caller's."""
        self.flush()


class IndexedRecordIOWriter(RecordIOWriter):
    """A RecordIOWriter that also writes the index an indexed split
    shards by: one ``key<TAB>offset`` line per record (reference
    ReadIndexFile, src/io/indexed_recordio_split.cc:43-62), the key
    defaulting to the record's ordinal. With a ``codec`` the offset is
    ``<block>:<in>``: the block frame's file offset and the record's
    frame start inside the decoded block. Offsets count the writer's own
    bytes, so the data stream must start at byte 0 of its file."""

    def __init__(self, stream, index_stream, codec=None, level: Optional[int] = None,
                 block_bytes: int = DEFAULT_BLOCK_BYTES) -> None:
        super().__init__(stream, codec=codec, level=level, block_bytes=block_bytes)
        try:
            pos = stream.tell()
        except (OSError, AttributeError, Error):
            pos = 0  # a pipe: no position to hold it to
        check(pos == 0, "IndexedRecordIOWriter must start at byte 0 of the "
              f"destination (stream is at {pos}); offsets would be wrong")
        self.index_stream = index_stream
        self._count = 0

    def write_record(self, data: bytes, key: Optional[int] = None) -> None:
        if self.codec is not None:
            self._buffer_block(self._frame_payload(data), (0,), (key,))
            return
        offset = self.bytes_written
        super().write_record(data)
        k = self._count if key is None else key
        self.index_stream.write(f"{k}\t{offset}\n".encode())
        self._count += 1

    def _note_framed_records(self, base: int, offsets) -> None:
        if len(offsets) == 0:
            return
        lines = "".join(f"{self._count + i}\t{base + int(o)}\n"
                        for i, o in enumerate(offsets))
        self.index_stream.write(lines.encode())
        self._count += len(offsets)

    def _note_block_records(self, base: int, offsets, keys) -> None:
        lines: List[str] = []
        for o, k in zip(offsets, keys):
            lines.append(f"{self._count if k is None else k}\t{base}:{int(o)}\n")
            self._count += 1
        self.index_stream.write("".join(lines).encode())

    def flush(self) -> None:
        super().flush()
        self.index_stream.flush()


class RecordIOReader:
    """Record reader over a stream (recordio.h:118-158,
    recordio.cc:53-82). Compressed blocks are checked and decoded and
    their records served one at a time; ``allow_compressed=False``
    rejects them with a checked error."""

    def __init__(self, stream, allow_compressed: bool = True) -> None:
        self.stream = stream
        self._eof = False
        self._allow_compressed = allow_compressed
        self._pending: Optional[Iterator[memoryview]] = None

    def _read_head(self) -> Tuple[int, int]:
        head = self.stream.read(8)
        if len(head) != 8:
            raise Error("Invalid RecordIO file: truncated header")
        magic, lrec = struct.unpack("<II", head)
        if magic != KMAGIC:
            raise Error(f"Invalid RecordIO file: bad magic {magic:#x}")
        return decode_flag(lrec), decode_length(lrec)

    def _read_chain(self, cflag: int, length: int) -> bytes:
        """A frame chain from an already-read header: the parts joined
        with their elided magic words; bit 2 of the cflag is the same
        across the chain."""
        want_compressed = cflag & CFLAG_COMPRESSED
        parts: List[bytes] = []
        while True:
            data = self.stream.read_exact((length + 3) & ~3)
            parts.append(data[:length])
            if (cflag & 3) in (0, 3):
                return b"".join(parts)
            parts.append(_MAGIC_BYTES)
            cflag, length = self._read_head()
            if (cflag & CFLAG_COMPRESSED) != want_compressed or (cflag & 3) not in (2, 3):
                raise Error("Invalid RecordIO file: corrupt multipart chain "
                            f"(continuation cflag {cflag})")

    def next_record(self) -> Optional[bytes]:
        """The next record, or None at the end of the stream."""
        while True:
            if self._pending is not None:
                rec = next(self._pending, None)
                if rec is not None:
                    return bytes(rec)
                self._pending = None
            if self._eof:
                return None
            head = self.stream.read(8)
            if len(head) == 0:
                self._eof = True
                return None
            if len(head) != 8:
                raise Error("Invalid RecordIO file: truncated header")
            magic, lrec = struct.unpack("<II", head)
            if magic != KMAGIC:
                raise Error(f"Invalid RecordIO file: bad magic {magic:#x}")
            cflag, length = decode_flag(lrec), decode_length(lrec)
            if cflag & CFLAG_COMPRESSED:
                if not self._allow_compressed:
                    raise Error(
                        f"compressed RecordIO block (cflag {cflag}) in a "
                        f"v1-only reader; re-open with allow_compressed=True "
                        f"or convert with `tools recompress --codec none`")
                raw, _n = _codec.decode_block(self._read_chain(cflag, length))
                self._pending = iter(RecordIOChunkReader(raw))
                continue
            return self._read_chain(cflag, length)

    def __iter__(self) -> Iterator[bytes]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


def _head_hits(words: np.ndarray) -> np.ndarray:
    """Word indices of record-START headers: the magic followed by an
    lrec whose part flag is 0 or 1 (cflag 0/1 for records, 4/5 for
    compressed blocks; src/recordio.cc:85-100). The magic word itself
    decodes to a middle part, so [magic][magic] is no head."""
    if len(words) < 2:
        return np.empty(0, dtype=np.int64)
    return np.nonzero(
        (words[:-1] == KMAGIC) & (((words[1:] >> 29) & 3) <= 1)
    )[0]


def first_head_in_words(words: np.ndarray) -> int:
    """Word index of the first record head in a uint32 view, or -1."""
    hits = _head_hits(words)
    return int(hits[0]) if len(hits) else -1


def last_head_in_words(words: np.ndarray) -> int:
    """Word index of the last record head in a uint32 view, or -1
    (src/io/recordio_split.cc:26-42)."""
    hits = _head_hits(words)
    return int(hits[-1]) if len(hits) else -1


def _find_next_record_head(buf: memoryview, start: int) -> int:
    """First aligned offset >= start holding a record head, or len(buf);
    scans in 1 MB blocks with one word of overlap and an early exit."""
    n = len(buf) & ~3
    nwords = n // 4
    w0 = ((start + 3) & ~3) // 4
    while w0 + 1 < nwords:
        w1 = min(w0 + _SCAN_BLOCK_WORDS, nwords)
        words = np.frombuffer(buf[w0 * 4 : min(w1 * 4 + 4, n)], dtype="<u4")
        hit = first_head_in_words(words)
        if hit >= 0:
            return (w0 + hit) * 4
        w0 = w1
    return len(buf)


class RecordIOChunkReader:
    """Iterate the records of one chunk of whole v1 frames
    (recordio.h:160-196): the chunk is divided into ``num_parts``
    aligned byte ranges whose bounds snap forward to record heads, and
    multipart chains are reassembled with their elided magic words."""

    def __init__(self, chunk, part_index: int = 0, num_parts: int = 1) -> None:
        view = memoryview(chunk)
        size = len(view)
        nstep = (size + num_parts - 1) // num_parts
        nstep = (nstep + 3) & ~3
        begin = min(size, nstep * part_index)
        end = min(size, nstep * (part_index + 1))
        self._view = view
        self._pos = _find_next_record_head(view, begin)
        self._end = _find_next_record_head(view, end) if end < size else size

    def next_record(self) -> Optional[memoryview]:
        """The next record (zero-copy for a single-part frame), or None."""
        if self._pos >= self._end:
            return None
        view = self._view
        parts: List[bytes] = []
        while True:
            head = view[self._pos : self._pos + 8]
            if len(head) != 8:
                raise Error("RecordIO chunk: truncated header")
            magic, lrec = struct.unpack("<II", head)
            check(magic == KMAGIC, "RecordIO chunk: bad magic")
            cflag = decode_flag(lrec)
            check(cflag & CFLAG_COMPRESSED == 0,
                  "compressed RecordIO block in a v1 chunk reader "
                  "(run the chunk through decode_chunk first)")
            length = decode_length(lrec)
            start = self._pos + 8
            self._pos = start + ((length + 3) & ~3)
            if self._pos > len(view):
                raise Error("RecordIO chunk: truncated record payload")
            if cflag == 0:
                return view[start : start + length]
            parts.append(bytes(view[start : start + length]))
            if cflag == 3:
                return memoryview(b"".join(parts))
            parts.append(_MAGIC_BYTES)

    def __iter__(self) -> Iterator[memoryview]:
        while True:
            rec = self.next_record()
            if rec is None:
                return
            yield rec


# -- compressed chunks --------------------------------------------------------
def chunk_has_compressed(chunk) -> bool:
    """Does the chunk hold a compressed-block frame? In a well-formed
    file every aligned magic word is a frame header (the writer escapes
    the payloads'), so a magic followed by a word with cflag bit 2 set
    is a compressed frame: one vectorized compare, no frame walk."""
    usable = len(chunk) & ~3
    if usable < 8:
        return False
    words = np.frombuffer(chunk, dtype="<u4", count=usable // 4)
    return bool(np.any((words[:-1] == KMAGIC) & ((words[1:] >> np.uint32(29)) >= 4)))


def scan_compressed_blob(view: memoryview, pos: int) -> Tuple[bytes, int]:
    """The blob of the compressed frame chain that starts at ``pos`` (a
    cflag 4 or 5 head) → (blob bytes, the offset after the chain)."""
    parts: List[bytes] = []
    first = True
    while True:
        head = view[pos : pos + 8]
        check(len(head) == 8, "RecordIO chunk: truncated compressed header")
        magic, lrec = struct.unpack("<II", head)
        check(magic == KMAGIC, "RecordIO chunk: bad magic in compressed chain")
        cflag = decode_flag(lrec)
        check(cflag & CFLAG_COMPRESSED and (cflag & 3) in ((0, 1) if first else (2, 3)),
              f"RecordIO chunk: corrupt compressed chain (cflag {cflag})")
        length = decode_length(lrec)
        start = pos + 8
        pos = start + ((length + 3) & ~3)
        if not first:
            parts.append(_MAGIC_BYTES)
        parts.append(bytes(view[start : start + length]))
        check(len(parts[-1]) == length, "RecordIO chunk: truncated compressed block")
        if (cflag & 3) in (0, 3):
            return b"".join(parts), pos
        first = False


def decode_chunk(chunk, ctx=None):
    """A chunk of whole frames with every compressed block decoded and
    the v1 frames passed through: the bytes an uncompressed writer
    writes for the same records. A chunk without compressed frames comes
    back as the same object. Blocks decode on ``ctx`` (an
    ``io/codec.py`` DecodeContext; default the process-global one)."""
    if not chunk_has_compressed(chunk):
        return chunk
    view = memoryview(chunk)
    n = len(view)
    out: List[object] = []  # views of v1 runs, or the ordinal of a blob
    blobs: List[bytes] = []
    pos = run_start = 0
    while pos + 8 <= n:
        magic, lrec = struct.unpack("<II", view[pos : pos + 8])
        check(magic == KMAGIC, "RecordIO chunk: bad magic")
        if decode_flag(lrec) & CFLAG_COMPRESSED:
            if run_start < pos:
                out.append(view[run_start:pos])
            blob, pos = scan_compressed_blob(view, pos)
            out.append(len(blobs))
            blobs.append(blob)
            run_start = pos
        else:
            pos += 8 + ((decode_length(lrec) + 3) & ~3)
    check(pos == n, "RecordIO chunk: trailing partial frame")
    if run_start < n:
        out.append(view[run_start:n])
    decoded = (ctx or _codec.default_decode_context()).decode_blocks(blobs)
    return b"".join(decoded[p][0] if isinstance(p, int) else p for p in out)
