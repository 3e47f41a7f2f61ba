"""Byte streams over local files and memory (the port of
``dmlc_core_tpu/io/stream.py``; reference dmlc::Stream / dmlc::SeekStream,
include/dmlc/io.h:30-129, and the local FileStream of
src/io/local_filesys.cc:27-67).

``Stream.create(uri, mode)`` opens a URI through the filesystem its
protocol names (``io/filesystem.FS_REGISTRY``: local paths, ``file://``,
``mem://``, ``fault://`` and the remote schemes of ``io/cloudfs.py``).
"""

from __future__ import annotations

import io as _pyio
from typing import Optional, Union

from ..utils.logging import Error, check

__all__ = ["FileStream", "MemoryStream", "SeekStream", "Stream"]


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
