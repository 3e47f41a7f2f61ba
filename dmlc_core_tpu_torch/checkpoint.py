"""Checkpoints of parameter trees, in one process (the port of the
single-process half of ``dmlc_core_tpu/checkpoint.py``).

- ``save_pytree``/``load_pytree``: a nested dict/list/tuple of tensors,
  arrays and scalars as ``DMLCTPU1`` + the port's serializer, the same
  bytes as the JAX package writes for the same numpy tree. Tensors are
  saved as numpy arrays; loads return numpy trees (put them on the
  device with ``convert.params_from_jax``).
- ``Checkpointer``: step-numbered ``ckpt-<step>.bin`` files under a base
  on any registered filesystem (a local directory, ``s3://``, ``gs://``,
  ``hdfs://``, ``mem://``, ``fault://``, ...), each written to a
  ``.tmp`` name, its stored length checked, then renamed into place,
  with an optional ``meta`` dict (the data position of a mid-epoch save)
  in a ``.meta.bin`` sidecar, ``keep`` retention and a background
  ``save_async``. Steps are found by listing the base, and retention and
  debris removal go through ``FileSystem.delete``.

Under the launcher, ``Checkpointer(process_index=rank)`` writes the
``.bin`` layout from rank 0 alone, as the JAX ``_is_writer`` decides;
every rank restores. Sharded checkpoints (``ckpt-<step>.d``, one shard
file per process) wait for ``parallel/`` (``ROADMAP.md`` §1 item 5): the
port lists them, so a same-step save replaces one and retention removes
old ones, but it neither writes nor restores them, and ``sharded=True``
or a ``process_count`` raises.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .io import serializer
from .io.filesystem import FileInfo, FileSystem
from .io.stream import Stream
from .utils.logging import Error, check

__all__ = ["AsyncSave", "Checkpointer", "load_pytree", "save_pytree"]

logger = logging.getLogger("dmlc_core_tpu_torch.checkpoint")

_MAGIC = b"DMLCTPU1"
_MANIFEST = "MANIFEST.bin"
_SHARDED = ("a sharded checkpoint (ckpt-<step>.d) is not ported: it waits "
            "for parallel/ (ROADMAP.md §1 item 5)")


def _to_host(tree: Any, copy: bool = False) -> Any:
    """Tensors → numpy (``.detach().cpu()``); numpy and scalars pass.
    ``copy`` makes every array an owned copy: a CPU tensor's numpy view
    shares its storage, so a step that updates the parameters in place
    would otherwise change a tree that ``save_async`` is still writing."""

    def conv(x):
        if isinstance(x, torch.Tensor):
            arr = x.detach().cpu().numpy()
            return arr.copy() if copy else arr
        if isinstance(x, np.ndarray):
            return np.array(x, copy=True) if copy else x
        return x

    return _tree_map(conv, tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v) for v in tree)
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def save_pytree(uri_or_stream, tree: Any) -> None:
    """Serialize a nested dict/list/tuple of tensors, arrays and scalars
    to a URI on any registered filesystem or an open Stream."""
    if isinstance(uri_or_stream, Stream):
        stream, own = uri_or_stream, False
    else:
        stream, own = Stream.create(uri_or_stream, "w"), True
    try:
        stream.write(_MAGIC)
        serializer.save(stream, _to_host(tree))
    finally:
        if own:
            stream.close()


def load_pytree(uri_or_stream) -> Any:
    """The tree ``save_pytree`` wrote, with numpy leaves."""
    if isinstance(uri_or_stream, Stream):
        stream, own = uri_or_stream, False
    else:
        stream, own = Stream.create(uri_or_stream, "r"), True
    try:
        magic = stream.read_exact(len(_MAGIC))
        check(magic == _MAGIC, f"bad checkpoint magic {magic!r}")
        return serializer.load(stream)
    finally:
        if own:
            stream.close()


def _as_local(uri: str) -> Optional[str]:
    """The path of a local URI, or None for another filesystem's."""
    if uri.startswith("file://"):
        return uri[len("file://"):]
    return None if "://" in uri else uri


def _remove(uri: str, tree_ok: bool = False) -> None:
    """Best-effort removal on any filesystem (retention and debris:
    nothing depends on it)."""
    try:
        FileSystem.get_instance(uri).delete(uri, recursive=tree_ok)
    except (OSError, Error):
        pass


def _clear_manifest(dir_uri: str) -> None:
    """Remove a sharded checkpoint's manifest if it is there, so the
    directory is torn (invisible) before anything else changes; unlike
    ``_remove`` a failure raises, since a stale manifest left behind
    would shadow the new save."""
    uri = f"{dir_uri}/{_MANIFEST}"
    fs = FileSystem.get_instance(uri)
    if fs.exists(uri):
        fs.delete(uri)


class _CountingStream(Stream):
    """Pass-through write stream that counts bytes, so an atomic write
    over another filesystem can verify the stored length before it
    commits."""

    def __init__(self, inner: Stream) -> None:
        self._inner = inner
        self.nbytes = 0

    def read(self, n: int = -1) -> bytes:
        raise Error("_CountingStream is write-only")

    def write(self, data) -> int:
        out = self._inner.write(data)
        self.nbytes += len(data)
        return out

    def flush(self) -> None:
        self._inner.flush()

    def close(self) -> None:
        self._inner.close()


def _write_atomic(uri: str, tree: Any) -> None:
    """``save_pytree`` with a write-then-commit discipline: the final
    ``uri`` is absent or whole, never torn.

    - a local path: a ``.tmp`` file, then ``os.replace``;
    - another filesystem (``s3://``, ``hdfs://``, ``mem://``,
      ``fault://``, ...): the tree is written to ``uri + '.tmp'``, its
      stored length is checked against the bytes written (a truncated
      upload fails here), then ``FileSystem.rename`` commits it: a real
      rename where the backend has one (WebHDFS), else a server-side
      copy and a delete, which never expose a partial final object.
    """
    local = _as_local(uri)
    if local is not None:
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
        tmp = local + ".tmp"
        save_pytree(tmp, tree)
        os.replace(tmp, local)
        return
    fs = FileSystem.get_instance(uri)
    tmp = uri + ".tmp"
    counter = _CountingStream(fs.open(tmp, "w"))
    try:
        save_pytree(counter, tree)
    finally:
        counter.close()
    stored = fs.get_path_info(tmp).size
    check(stored == counter.nbytes,
          f"atomic write of {uri}: tmp key holds {stored} bytes, expected "
          f"{counter.nbytes}; refusing to commit a torn object")
    fs.rename(tmp, uri)


class AsyncSave:
    """Handle of a checkpoint being written in the background."""

    def __init__(self) -> None:
        self._done = threading.Event()
        self._exc: Optional[BaseException] = None
        self.uri: Optional[str] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> Optional[str]:
        """Wait for the write; returns the checkpoint's path and
        re-raises a failed write."""
        check(self._done.wait(timeout),
              f"checkpoint write still in flight after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self.uri


class Checkpointer:
    """Step-numbered checkpoints ``{base}/ckpt-{step:010d}.bin`` under a
    base on any registered filesystem, the newest ``keep`` of them kept
    (``keep`` <= 0 keeps all).

    A save with ``meta`` writes it to ``ckpt-{step:010d}.meta.bin``.
    The order of ``_write_single`` is: remove the step's old sidecar,
    land the tree, then write the new sidecar. So a visible sidecar
    always belongs to the visible tree, and a crash between the two
    leaves a tree without a sidecar: ``restore_meta`` then returns None,
    which a caller reads as "position unknown" (replay, never skip).
    """

    _PAT = re.compile(r"ckpt-(\d{10})(\.bin|\.d)$")

    def __init__(self, base_uri: str, keep: int = 3,
                 process_index: Optional[int] = None,
                 sharded: Optional[bool] = None,
                 process_count: Optional[int] = None) -> None:
        """``process_index``: this process's rank in a run launched by the
        tracker (``DMLC_TASK_ID``); only rank 0 (or None) writes."""
        check(not sharded, _SHARDED)
        check(process_count is None,
              f"{_SHARDED}; process_count is its rank plumbing")
        self.base = base_uri.rstrip("/")
        FileSystem.get_instance(self.base)  # an unknown scheme raises here
        self.keep = keep
        self._proc = process_index
        self._inflight: Optional[AsyncSave] = None

    def _is_writer(self) -> bool:
        return self._proc is None or self._proc == 0

    def _fs(self) -> FileSystem:
        return FileSystem.get_instance(self.base + "/x")

    def _path(self, step: int, sharded: bool = False) -> str:
        return f"{self.base}/ckpt-{step:010d}{'.d' if sharded else '.bin'}"

    def _meta_path(self, step: int) -> str:
        # the name does not match _PAT: sidecars are not steps
        return f"{self.base}/ckpt-{step:010d}.meta.bin"

    def _listing(self, uri: str) -> List[FileInfo]:
        try:
            return self._fs().list_directory(uri)
        except (OSError, Error):
            return []

    def _manifest_ok(self, dir_uri: str) -> bool:
        """A sharded checkpoint is complete once its manifest landed."""
        return any(info.path.rstrip("/").endswith(_MANIFEST)
                   for info in self._listing(dir_uri))

    def _scan_ex(self) -> Dict[int, Dict[str, Any]]:
        """{step: {sharded, bytes}} from one listing of the base (and one
        of each ``.d`` entry); a sharded directory without its manifest
        is not a step."""
        out: Dict[int, Dict[str, Any]] = {}
        for info in self._listing(self.base):
            m = self._PAT.search(info.path.rstrip("/"))
            if not m:
                continue
            step = int(m.group(1))
            if m.group(2) == ".bin":
                out.setdefault(step, {"sharded": False, "bytes": int(info.size)})
                continue
            entries = self._listing(self._path(step, sharded=True))
            if any(e.path.rstrip("/").endswith(_MANIFEST) for e in entries):
                out[step] = {"sharded": True,
                             "bytes": sum(int(e.size) for e in entries)}
        return out

    def steps(self) -> List[int]:
        return sorted(self._scan_ex())

    def steps_info(self) -> List[Dict[str, Any]]:
        """[{step, layout, uri, bytes}] by step."""
        return [{"step": step, "layout": "sharded" if v["sharded"] else "single",
                 "uri": self._path(step, v["sharded"]), "bytes": v["bytes"]}
                for step, v in sorted(self._scan_ex().items())]

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def prune(self, keep: Optional[int] = None) -> List[int]:
        """A retention pass (``keep`` overrides the configured count for
        this call); returns the steps removed."""
        old = self.keep
        if keep is not None:
            self.keep = keep
        try:
            before = self.steps()
            self._prune()
            after = set(self.steps())
        finally:
            self.keep = old
        return [s for s in before if s not in after]

    def wait(self, timeout: Optional[float] = None) -> None:
        """Wait for an in-flight ``save_async``, re-raising its failure.
        On a timeout the handle stays, so no later call races it."""
        handle = self._inflight
        if handle is None:
            return
        try:
            handle.result(timeout)
        finally:
            if handle.done():
                self._inflight = None

    def save_async(self, step: int, tree: Any,
                   meta: Optional[Dict[str, Any]] = None) -> AsyncSave:
        """``save`` with the file I/O on a background thread. The tree is
        copied to owned host arrays HERE, before the call returns, so the
        caller may update its parameters in place at once. Saves are
        serial: a second call first waits for the first. On a process
        that does not write, the handle's path is None."""
        self.wait()
        handle = AsyncSave()
        host_tree = _to_host(tree, copy=True)
        is_writer = self._is_writer()

        def run():
            try:
                if is_writer:
                    handle.uri = self._write_single(step, host_tree, "async ", meta)
            except BaseException as e:  # surfaced by result()
                handle._exc = e
            finally:
                handle._done.set()

        threading.Thread(target=run, daemon=True, name=f"ckpt-async-{step}").start()
        self._inflight = handle
        return handle

    def save(self, step: int, tree: Any,
             meta: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write step ``step``; returns its path (None on a process that
        does not write). ``meta`` is a small dict stored beside it and
        read back by ``restore_meta``, such as the data position
        ``{"epoch": e, "records": n}`` a resume skips to."""
        self.wait()
        if not self._is_writer():
            return None
        return self._write_single(step, tree, "", meta)

    def _write_single(self, step: int, tree: Any, tag: str,
                      meta: Optional[Dict[str, Any]]) -> str:
        """Write the tree, then the sidecar, then prune. A same-step
        sharded directory would shadow the new file: its manifest goes
        first (a failure raises), the rest after the new file landed."""
        sharded_path = self._path(step, sharded=True)
        had_shadow = self._manifest_ok(sharded_path)
        if had_shadow:
            _clear_manifest(sharded_path)
        path = self._path(step)
        _remove(self._meta_path(step))
        _write_atomic(path, tree)
        if meta is not None:
            _write_atomic(self._meta_path(step), meta)
        if had_shadow:
            _remove(sharded_path, tree_ok=True)
        self._prune()
        logger.info("%scheckpoint step %d -> %s", tag, step, path)
        return path

    def _resolve(self, step: Optional[int]) -> Tuple[int, bool]:
        """(step, sharded) of the given or newest step, after any
        in-flight write."""
        self.wait()
        scan = self._scan_ex()
        if step is None:
            check(bool(scan), f"no checkpoints under {self.base}")
            step = max(scan)
        step = int(step)
        return step, scan.get(step, {"sharded": False})["sharded"]

    def restore(self, step: Optional[int] = None) -> Tuple[int, Any]:
        """(step, tree) of the given or newest step, with numpy leaves."""
        step, sharded = self._resolve(step)
        check(not sharded, _SHARDED)
        return step, load_pytree(self._path(step))

    def restore_meta(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The ``meta`` saved with the given or newest step, or None when
        it carried none (position unknown: replay, never skip)."""
        step, sharded = self._resolve(step)
        check(not sharded, _SHARDED)
        meta = self._meta_path(step)
        return load_pytree(meta) if self._fs().exists(meta) else None

    def _prune(self) -> None:
        steps = self.steps()
        if steps:
            self._prune_torn(newest_complete=steps[-1])
        if self.keep <= 0 or len(steps) <= self.keep:
            return
        for s in steps[: -self.keep]:
            _remove(self._path(s))
            _remove(self._meta_path(s))
            _remove(self._path(s, sharded=True), tree_ok=True)

    def _prune_torn(self, newest_complete: int) -> None:
        """Remove debris older than the newest complete step: ``.tmp``
        files and sharded directories without a manifest. Newer debris
        may be another writer's save in flight and stays."""
        for info in self._listing(self.base):
            full = info.path.rstrip("/")
            name = full.rsplit("/", 1)[-1]
            if name.endswith(".tmp"):
                m = self._PAT.search(name[: -len(".tmp")])
                if m and int(m.group(1)) < newest_complete:
                    _remove(full)
                continue
            m = self._PAT.search(name)
            if (m and m.group(2) == ".d" and int(m.group(1)) < newest_complete
                    and not self._manifest_ok(full)):
                _remove(full, tree_ok=True)
