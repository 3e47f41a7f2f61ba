"""Byte streams over local files and memory (the port of
``dmlc_core_tpu/io/stream.py``; reference dmlc::Stream / dmlc::SeekStream,
include/dmlc/io.h:30-129, and the local FileStream of
src/io/local_filesys.cc:27-67).

``Stream.create(uri, mode)`` opens a URI through the filesystem its
protocol names (``io/filesystem.FS_REGISTRY``: local paths, ``file://``,
``mem://``, ``fault://`` and the remote schemes of ``io/cloudfs.py``).
``StreamIO`` and ``wrap_text`` give any Stream the standard file
protocol (the reference's ``dmlc::istream``/``ostream``, io.h:318-443).
"""

from __future__ import annotations

import io as _pyio
from typing import Optional, Union

from ..utils.logging import Error, check

__all__ = [
    "FileStream",
    "MemoryStream",
    "SeekStream",
    "Serializable",
    "Stream",
    "StreamIO",
    "wrap_text",
]


class Stream:
    """Sequential byte stream (reference io.h:30-106)."""

    def read(self, n: int = -1) -> bytes:
        raise NotImplementedError

    def write(self, data: bytes) -> int:
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def read_exact(self, n: int) -> bytes:
        """Exactly ``n`` bytes, or raise ``Error``."""
        buf = self.read(n)
        if len(buf) != n:
            raise Error(f"Stream: expected {n} bytes, got {len(buf)}")
        return buf

    def __enter__(self) -> "Stream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @staticmethod
    def create(uri: str, mode: str = "r", allow_null: bool = False) -> Optional["Stream"]:
        """Open ``uri`` for 'r', 'w' or 'a' (always binary); reference
        Stream::Create, src/io.cc:132-138. ``allow_null`` forgives only a
        failed open (a missing file → None); a bad mode or an unknown
        scheme always raises."""
        from .filesystem import FileSystem  # filesystem imports this module

        check(mode in ("r", "w", "a"), f"invalid stream mode {mode!r}")
        fs = FileSystem.get_instance(uri)
        try:
            return fs.open(uri, mode)
        except (OSError, Error):
            if allow_null:
                return None
            raise


class SeekStream(Stream):
    """Stream with random access (reference io.h:109-129)."""

    def seek(self, pos: int) -> None:
        raise NotImplementedError

    def tell(self) -> int:
        raise NotImplementedError

    @staticmethod
    def create_for_read(uri: str, allow_null: bool = False) -> Optional["SeekStream"]:
        """Reference SeekStream::CreateForRead (io.cc:140-145)."""
        s = Stream.create(uri, "r", allow_null=allow_null)
        if s is not None:
            check(isinstance(s, SeekStream), f"{uri} does not support seeking")
        return s  # type: ignore[return-value]


class _FileLike(SeekStream):
    """A SeekStream over a Python binary file object."""

    def __init__(self, fp) -> None:
        self._fp = fp

    def read(self, n: int = -1) -> bytes:
        return self._fp.read(n)

    def write(self, data: Union[bytes, bytearray, memoryview]) -> int:
        return self._fp.write(data)

    def seek(self, pos: int) -> None:
        self._fp.seek(pos)

    def tell(self) -> int:
        return self._fp.tell()

    def flush(self) -> None:
        self._fp.flush()

    def close(self) -> None:
        self._fp.close()


class FileStream(_FileLike):
    """Local-file stream (reference FileStream, local_filesys.cc:27-67)."""

    def __init__(self, path: str, mode: str = "r") -> None:
        check(mode in ("r", "w", "a"), f"invalid stream mode {mode!r}")
        super().__init__(open(path, mode + "b"))
        self.path = path


class MemoryStream(_FileLike):
    """In-memory seekable stream (reference MemoryStringStream,
    include/dmlc/memory_io.h:66-105)."""

    def __init__(self, data: bytes = b"") -> None:
        super().__init__(_pyio.BytesIO(data))

    def getvalue(self) -> bytes:
        return self._fp.getvalue()


class Serializable:
    """An object saved to and loaded from a Stream (reference
    io.h:132-146)."""

    def save(self, stream: Stream) -> None:
        raise NotImplementedError

    def load(self, stream: Stream) -> None:
        raise NotImplementedError


class StreamIO(_pyio.RawIOBase):
    """``io.RawIOBase`` over a Stream, so code that wants a file object
    (``io.BufferedReader``, ``io.TextIOWrapper``, csv, pickle, np.load)
    reads and writes any filesystem's streams. ``mode`` is 'r', 'w' or
    'rw', the directions the Stream was opened for; ``close_stream``
    says whether closing the adapter closes the Stream (by default the
    caller keeps it, as the reference's adapters do). Failures are the io
    protocol's: ``io.UnsupportedOperation`` for a direction or a seek the
    Stream lacks, ``OSError`` for SEEK_END."""

    def __init__(self, stream: Stream, mode: str = "r", close_stream: bool = False) -> None:
        super().__init__()
        check(mode in ("r", "w", "rw"), f"StreamIO mode {mode!r}")
        self._stream = stream
        self._mode = mode
        self._close_stream = close_stream

    def readable(self) -> bool:
        return "r" in self._mode

    def writable(self) -> bool:
        return "w" in self._mode

    def seekable(self) -> bool:
        return isinstance(self._stream, SeekStream)

    def readinto(self, b) -> int:
        if "r" not in self._mode:
            raise _pyio.UnsupportedOperation("not readable")
        data = self._stream.read(len(b))
        n = len(data)
        b[:n] = data
        return n

    def write(self, b) -> int:
        if "w" not in self._mode:
            raise _pyio.UnsupportedOperation("not writable")
        return self._stream.write(b)

    def seek(self, pos: int, whence: int = _pyio.SEEK_SET) -> int:
        if not isinstance(self._stream, SeekStream):
            raise _pyio.UnsupportedOperation("stream is not seekable")
        if whence == _pyio.SEEK_SET:
            target = pos
        elif whence == _pyio.SEEK_CUR:
            target = self._stream.tell() + pos
        else:
            raise OSError("StreamIO supports SEEK_SET and SEEK_CUR only")
        self._stream.seek(target)
        return target

    def tell(self) -> int:
        if not isinstance(self._stream, SeekStream):
            raise _pyio.UnsupportedOperation("stream is not seekable")
        return self._stream.tell()

    def flush(self) -> None:
        if not self.closed:
            self._stream.flush()

    def close(self) -> None:
        if not self.closed:
            try:
                super().close()  # flushes first
            finally:
                if self._close_stream:
                    self._stream.close()


def wrap_text(stream: Stream, mode: str = "r", **kwargs) -> _pyio.TextIOWrapper:
    """A text view of ``stream`` ('r', 'w' or 'rw'), buffered; keyword
    arguments go to ``io.TextIOWrapper`` (encoding, newline, ...).
    Closing the view closes the Stream."""
    raw = StreamIO(stream, mode=mode, close_stream=True)
    if mode == "rw":
        buf: _pyio.BufferedIOBase = _pyio.BufferedRandom(raw)
    elif mode == "w":
        buf = _pyio.BufferedWriter(raw)
    else:
        buf = _pyio.BufferedReader(raw)
    return _pyio.TextIOWrapper(buf, **kwargs)
