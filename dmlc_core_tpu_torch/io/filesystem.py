"""Filesystems by URI protocol (the port of
``dmlc_core_tpu/io/filesystem.py``; reference dmlc::FileSystem,
include/dmlc/io.h:582-631, FileSystem::GetInstance, src/io.cc:30-71, and
src/io/local_filesys.cc).

Backends register in ``FS_REGISTRY`` by protocol:

- ``file://`` and bare paths → ``LocalFileSystem``;
- ``mem://`` → ``MemoryFileSystem``, a process-global in-memory store
  (the hermetic stand-in for an object store);
- ``fault://`` → ``io.faults.FaultInjectingFileSystem``;
- ``http://``, ``https://``, ``s3://``, ``gs://``, ``hdfs://``,
  ``viewfs://`` and ``azure://`` → the remote filesystems of
  ``io/cloudfs.py``.

The last two modules register their protocols when they are imported;
``get_instance`` imports both on a miss. ``TemporaryDirectory`` is the
reference's (include/dmlc/filesystem.h:34-158).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Callable, Dict, List, NamedTuple

from ..utils.logging import Error
from .stream import FileStream, MemoryStream, Stream
from .uri import URI

__all__ = ["FS_REGISTRY", "FileInfo", "FileSystem", "LocalFileSystem",
           "MemoryFileSystem", "TemporaryDirectory"]


class FileInfo(NamedTuple):
    """Reference io.h:560-578: path, size and type ('file' or
    'directory'); ``etag`` is the backend's change token, "" locally."""

    path: str
    size: int
    type: str
    etag: str = ""


#: protocol → filesystem factory (the JAX package's ``Registry("filesystem")``)
FS_REGISTRY: Dict[str, Callable[[], "FileSystem"]] = {}


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
        raise Error(f"{type(self).__name__} does not support delete")

    def copy(self, src_uri: str, dst_uri: str) -> None:
        """Copy one file through this process."""
        with self.open(src_uri, "r") as src, self.open(dst_uri, "w") as dst:
            while True:
                chunk = src.read(1 << 20)
                if not chunk:
                    break
                dst.write(chunk)

    def rename(self, src_uri: str, dst_uri: str) -> None:
        """Move a file: copy, then delete. Not atomic, but a crash leaves
        no destination or a whole one, never a torn one; a backend with
        a real rename overrides this."""
        self.copy(src_uri, dst_uri)
        self.delete(src_uri)

    def list_directory_recursive(self, uri: str) -> List[FileInfo]:
        """Every file under ``uri``, breadth first (reference
        ListDirectoryRecursive, src/io/filesys.cc:9-25)."""
        out: List[FileInfo] = []
        queue = [uri]
        while queue:
            for info in self.list_directory(queue.pop(0)):
                if info.type == "directory":
                    queue.append(info.path)
                else:
                    out.append(info)
        return out

    @staticmethod
    def get_instance(uri: str) -> "FileSystem":
        """The filesystem of ``uri`` by its protocol (reference
        FileSystem::GetInstance, src/io.cc:30-71)."""
        proto = URI(uri).protocol or "file://"
        entry = FS_REGISTRY.get(proto)
        if entry is None:
            # a miss loads the remote backends and the fault:// wrapper
            # once, so cloudfs.py and faults.py stay the one place that
            # registers each of their protocols
            from . import cloudfs, faults  # noqa: F401

            entry = FS_REGISTRY.get(proto)
        if entry is None:
            raise Error(f"unknown filesystem protocol {proto!r} in {uri!r}; "
                        f"registered: {sorted(FS_REGISTRY)}")
        return entry()


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


class MemoryFileSystem(FileSystem):
    """Process-global in-memory store under ``mem://``: the hermetic
    stand-in for an object store (no reference analogue)."""

    _store: Dict[str, bytes] = {}

    class _WriteBack(MemoryStream):
        def __init__(self, store: Dict[str, bytes], key: str, init: bytes = b"") -> None:
            super().__init__()
            if init:
                self.write(init)
            self._store, self._key = store, key
            self._closed = False

        def flush(self) -> None:
            if not self._closed:
                self._store[self._key] = self.getvalue()

        def close(self) -> None:
            if self._closed:
                return
            self.flush()
            self._closed = True
            super().close()

    def open(self, uri: str, mode: str = "r") -> Stream:
        if mode == "r":
            if uri not in self._store:
                raise Error(f"mem:// key not found: {uri}")
            return MemoryStream(self._store[uri])
        if mode == "w":
            return self._WriteBack(self._store, uri)
        if mode == "a":
            return self._WriteBack(self._store, uri, self._store.get(uri, b""))
        raise Error(f"invalid mode {mode!r}")

    def get_path_info(self, uri: str) -> FileInfo:
        if uri in self._store:
            return FileInfo(path=uri, size=len(self._store[uri]), type="file")
        prefix = uri.rstrip("/") + "/"
        if any(k.startswith(prefix) for k in self._store):
            return FileInfo(path=uri, size=0, type="directory")
        raise Error(f"mem:// key not found: {uri}")

    def list_directory(self, uri: str) -> List[FileInfo]:
        prefix = uri.rstrip("/") + "/"
        seen: Dict[str, FileInfo] = {}
        for key, data in sorted(self._store.items()):
            if not key.startswith(prefix):
                continue
            rest = key[len(prefix):]
            full = prefix + rest.split("/", 1)[0]
            if "/" in rest:
                seen.setdefault(full, FileInfo(path=full, size=0, type="directory"))
            else:
                seen[full] = FileInfo(path=full, size=len(data), type="file")
        return list(seen.values())

    def delete(self, uri: str, recursive: bool = False) -> None:
        if uri in self._store:
            del self._store[uri]
            return
        prefix = uri.rstrip("/") + "/"
        keys = [k for k in self._store if k.startswith(prefix)]
        if not keys:
            raise Error(f"mem:// key not found: {uri}")
        if not recursive:
            raise Error(f"mem:// {uri} is a prefix; pass recursive=True")
        for k in keys:
            del self._store[k]

    @classmethod
    def reset(cls) -> None:
        cls._store.clear()


FS_REGISTRY["file://"] = LocalFileSystem.instance
FS_REGISTRY["mem://"] = MemoryFileSystem


class TemporaryDirectory:
    """A ``mkdtemp`` directory, deleted with everything in it by
    ``cleanup()``, on leaving a ``with`` block, or when collected (the
    reference's destructor)."""

    def __init__(self, prefix: str = "dmlctmp") -> None:
        self.path = tempfile.mkdtemp(prefix=prefix)

    def __enter__(self) -> "TemporaryDirectory":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()

    def cleanup(self) -> None:
        if self.path and os.path.isdir(self.path):
            shutil.rmtree(self.path, ignore_errors=True)
        self.path = ""

    def __del__(self) -> None:
        try:
            self.cleanup()
        except Exception:
            pass
