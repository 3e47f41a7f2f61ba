"""Byte-range splits of one local file: text lines or RecordIO records.

The port of ``LineSplitter`` and ``RecordIOSplitter`` (src/io/
{line_split,recordio_split}.{h,cc} over src/io/input_split_base.cc) for a
single local file: part ``i`` of ``n`` owns the bytes
``[ceil(size/n)·i, ceil(size/n)·(i+1))`` (rounded up to the record
alignment), with both bounds snapped forward to the next record start,
so every record lands in exactly one part. Chunks hand out whole records
only. Multi-file URIs, remote filesystems, indexed and shuffled splits
are not ported yet: ``create`` refuses them.
"""

from __future__ import annotations

import os
from typing import BinaryIO, Optional, Tuple

import numpy as np

from ..utils.logging import Error, check
from .recordio import first_head_in_words, last_head_in_words

__all__ = ["LineSplitter", "RecordIOSplitter", "create", "local_path", "part_range"]

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
        check(
            0 <= part_index < num_parts,
            f"part_index={part_index} outside num_parts={num_parts}",
        )
        self.path = path
        self.buffer_size = DEFAULT_BUFFER_BYTES
        ntotal = os.path.getsize(path)
        if ntotal % self._align:
            raise Error(f"file {path} does not align by {self._align} bytes")
        nstep = (ntotal + num_parts - 1) // num_parts
        nstep = (nstep + self._align - 1) // self._align * self._align
        begin = min(nstep * part_index, ntotal)
        end = min(nstep * (part_index + 1), ntotal)
        self._fp: Optional[BinaryIO] = open(path, "rb")
        if begin < end:
            # a bound at a file edge is a record start already
            if 0 < end < ntotal:
                end += self._seek_record_begin(end)
            if 0 < begin < ntotal:
                begin += self._seek_record_begin(begin)
        self.offset_begin = begin
        self.offset_end = max(begin, end)
        self._overflow = b""
        self.before_first()

    def _seek_record_begin(self, offset: int) -> int:
        """Bytes from ``offset`` to the next record start."""
        raise NotImplementedError

    def before_first(self) -> None:
        """Rewind to the start of this part."""
        self._fp.seek(self.offset_begin)
        self._curr = self.offset_begin
        self._overflow = b""

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


def _find_newline(buf: bytes) -> int:
    a, b = buf.find(b"\n"), buf.find(b"\r")
    if a < 0:
        return b
    if b < 0:
        return a
    return min(a, b)


def create(uri: str, part_index: int = 0, num_parts: int = 1,
           type: str = "text") -> _LocalSplit:
    """Split factory (reference InputSplit::Create, src/io.cc:81-130) for
    one local file: ``type`` 'text' gives a LineSplitter, 'recordio' a
    RecordIOSplitter."""
    check(type in ("text", "recordio"),
          f"split type {type!r}: only 'text' and 'recordio' are ported")
    path = local_path(uri)
    cls = LineSplitter if type == "text" else RecordIOSplitter
    return cls(path, part_index, num_parts)


def part_range(uri: str, part_index: int = 0, num_parts: int = 1,
               type: str = "text") -> Tuple[int, int]:
    """The ``[begin, end)`` bytes that ``create`` gives part ``part_index``
    of ``num_parts``: both bounds at record starts (or the file's ends)."""
    split = create(uri, part_index, num_parts, type)
    split.close()
    return split.offset_begin, split.offset_end
