"""The local filesystem behind the port's streams and checkpoints (the
port of ``dmlc_core_tpu/io/filesystem.py``; reference dmlc::FileSystem,
include/dmlc/io.h:582-631, and src/io/local_filesys.cc).

``FileSystem.get_instance`` answers bare paths and ``file://`` URIs with
the one ``LocalFileSystem``; any other scheme raises (remote filesystems
are ``ROADMAP.md`` §1 item 8).
"""

from __future__ import annotations

import os
import shutil
from typing import List, NamedTuple

from ..utils.logging import Error
from .stream import FileStream, Stream

__all__ = ["FileInfo", "FileSystem", "LocalFileSystem"]


class FileInfo(NamedTuple):
    """Reference io.h:560-578: path, size and type ('file' or
    'directory'); ``etag`` is the backend's change token, "" locally."""

    path: str
    size: int
    type: str
    etag: str = ""


def _scheme(uri: str) -> str:
    pos = uri.find("://")
    return "" if pos < 0 else uri[: pos + 3]


class FileSystem:
    """Abstract filesystem (reference io.h:582-631)."""

    def open(self, uri: str, mode: str = "r") -> Stream:
        """Open for read, write or append; read streams seek."""
        raise NotImplementedError

    def get_path_info(self, uri: str) -> FileInfo:
        raise NotImplementedError

    def list_directory(self, uri: str) -> List[FileInfo]:
        raise NotImplementedError

    def exists(self, uri: str) -> bool:
        try:
            self.get_path_info(uri)
            return True
        except (OSError, Error):
            return False

    def delete(self, uri: str, recursive: bool = False) -> None:
        """Remove a file; with ``recursive``, a directory tree."""
        raise NotImplementedError

    def rename(self, src_uri: str, dst_uri: str) -> None:
        raise NotImplementedError

    def copy(self, src_uri: str, dst_uri: str) -> None:
        """Copy one file through this process."""
        with self.open(src_uri, "r") as src, self.open(dst_uri, "w") as dst:
            while True:
                chunk = src.read(1 << 20)
                if not chunk:
                    break
                dst.write(chunk)

    @staticmethod
    def get_instance(uri: str) -> "FileSystem":
        """The filesystem of ``uri`` (reference FileSystem::GetInstance,
        src/io.cc:30-71): local paths and ``file://`` only."""
        scheme = _scheme(uri)
        if scheme not in ("", "file://"):
            raise Error(
                f"unknown filesystem protocol {scheme!r} in {uri!r}: the "
                "port reads local files; remote filesystems are "
                "ROADMAP.md §1 item 8")
        return LocalFileSystem.instance()


class LocalFileSystem(FileSystem):
    """Reference src/io/local_filesys.cc; one instance per process."""

    _instance: "LocalFileSystem" = None  # type: ignore[assignment]

    @classmethod
    def instance(cls) -> "LocalFileSystem":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @staticmethod
    def _path(uri: str) -> str:
        return uri[len("file://"):] if uri.startswith("file://") else uri

    def open(self, uri: str, mode: str = "r") -> Stream:
        return FileStream(self._path(uri), mode)

    def get_path_info(self, uri: str) -> FileInfo:
        path = self._path(uri)
        st = os.stat(path)  # follows symlinks, like reference :69-97
        kind = "directory" if os.path.isdir(path) else "file"
        return FileInfo(path=uri, size=st.st_size, type=kind)

    def list_directory(self, uri: str) -> List[FileInfo]:
        path = self._path(uri)
        prefix = uri.rstrip("/")
        out = []
        for name in sorted(os.listdir(path)):
            full = os.path.join(path, name)
            try:
                st = os.stat(full)
            except OSError:
                continue  # dangling symlink, skipped like reference :99-145
            kind = "directory" if os.path.isdir(full) else "file"
            out.append(FileInfo(path=f"{prefix}/{name}", size=st.st_size, type=kind))
        return out

    def delete(self, uri: str, recursive: bool = False) -> None:
        path = self._path(uri)
        if recursive and os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)

    def rename(self, src_uri: str, dst_uri: str) -> None:
        """``os.replace``: atomic within one filesystem."""
        os.replace(self._path(src_uri), self._path(dst_uri))
