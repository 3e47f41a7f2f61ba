"""RecordIO: the splittable binary record container, bit-compatible with
dmlc-core's format (include/dmlc/recordio.h:16-45, src/recordio.cc).

Frame layout (little-endian uint32 words)::

    [kMagic = 0xced7230a] [lrec] [data ...] [zero pad to 4-byte boundary]
    lrec = (cflag << 29) | length        # length < 2**29

A payload holding the magic word at a 4-byte-aligned offset is split
there into a multipart chain (cflag 1 start, 2 middle, 3 end; 0 is a
whole record) and the reader re-inserts the elided magic.

This port keeps the raw v1 frames only: the writers have no block codecs
(compressed-block RecordIO is ``ROADMAP.md`` §1 item 2), and the chunk reader rejects compressed-block frames (cflag bit 2) with a
checked error instead of returning their bytes as records.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, List, Optional

import numpy as np

from ..utils.logging import Error, check

__all__ = [
    "KMAGIC",
    "IndexedRecordIOWriter",
    "RecordIOChunkReader",
    "RecordIOWriter",
    "decode_flag",
    "decode_length",
    "encode_lrec",
    "first_head_in_words",
    "last_head_in_words",
]

KMAGIC = 0xCED7230A
_MAGIC_BYTES = struct.pack("<I", KMAGIC)
_MAX_LEN = 1 << 29
# cflag bit 2 marks a compressed-block frame, which this port cannot read
_CFLAG_COMPRESSED = 4
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
    """Raw v1 frame writer (recordio.h:38-115) onto a binary file object."""

    def __init__(self, stream: BinaryIO) -> None:
        self.stream = stream
        self.except_counter = 0  # magic collisions escaped
        self.bytes_written = 0
        self.records_written = 0

    def write_record(self, data: bytes) -> None:
        """Frame one payload, escaping aligned magic words into a chain."""
        check(len(data) < _MAX_LEN, "RecordIO only accepts records < 2^29 bytes")
        out: List[bytes] = []
        dptr = 0
        for pos in _aligned_magic_positions(data):
            pos = int(pos)
            cflag = 1 if dptr == 0 else 2
            out.append(_MAGIC_BYTES)
            out.append(struct.pack("<I", encode_lrec(cflag, pos - dptr)))
            out.append(data[dptr:pos])
            dptr = pos + 4
            self.except_counter += 1
        out.append(_MAGIC_BYTES)
        out.append(
            struct.pack("<I", encode_lrec(3 if dptr else 0, len(data) - dptr))
        )
        out.append(data[dptr:])
        out.append(b"\x00" * ((4 - ((len(data) - dptr) & 3)) & 3))
        framed = b"".join(out)
        self.stream.write(framed)
        self.bytes_written += len(framed)
        self.records_written += 1


class IndexedRecordIOWriter(RecordIOWriter):
    """A RecordIOWriter that also writes the index an indexed split
    shards by: one ``key<TAB>offset`` line per record (reference
    ReadIndexFile, src/io/indexed_recordio_split.cc:43-62), the key
    defaulting to the record's ordinal. Offsets count the writer's own
    bytes, so the data stream must start at byte 0 of its file."""

    def __init__(self, stream: BinaryIO, index_stream: BinaryIO,
                 codec=None) -> None:
        if codec is not None:
            raise Error(f"codec={codec!r}: compressed-block RecordIO is not "
                        "ported (ROADMAP.md §1 item 2); the port writes v1 "
                        "frames")
        super().__init__(stream)
        try:
            pos = stream.tell()
        except (OSError, AttributeError, Error):
            pos = 0  # a pipe: no position to hold it to
        check(pos == 0, "IndexedRecordIOWriter must start at byte 0 of the "
              f"destination (stream is at {pos}); offsets would be wrong")
        self.index_stream = index_stream
        self._count = 0

    def write_record(self, data: bytes, key: Optional[int] = None) -> None:
        offset = self.bytes_written
        super().write_record(data)
        k = self._count if key is None else key
        self.index_stream.write(f"{k}\t{offset}\n".encode())
        self._count += 1


def _head_hits(words: np.ndarray) -> np.ndarray:
    """Word indices of record-START headers: the magic followed by an
    lrec whose part flag is 0 or 1 (src/recordio.cc:85-100). The magic
    word itself decodes to a middle part, so [magic][magic] is no head."""
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
    """Iterate the records of one chunk of whole frames
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
            check(
                cflag & _CFLAG_COMPRESSED == 0,
                "compressed RecordIO block: this reader takes raw v1 "
                "frames only",
            )
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
