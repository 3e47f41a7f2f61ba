"""Checkpoints of parameter trees (the port of
``dmlc_core_tpu/checkpoint.py``).

- ``save_pytree``/``load_pytree``: a nested dict/list/tuple of tensors,
  arrays and scalars as ``DMLCTPU1`` + the port's serializer, the same
  bytes as the JAX package writes for the same numpy tree. Tensors are
  saved as numpy arrays; loads return numpy trees (put them on the
  device with ``convert.params_from_jax``).
- ``save_pytree_sharded``/``load_pytree_sharded``: a tree of placed
  blocks (``parallel.Placed``, one rank's block of a global array) across
  the ranks of a mesh. Every process writes its replica-0 chunks (global
  index range + data) into ``shard-{proc:05d}.bin``, process 0 writes the
  tree's skeleton (``MANIFEST.bin``) last, after a barrier, so a manifest
  means every shard landed; restore reassembles the global arrays and
  places them by a template's placement, on whatever mesh the template
  lives on. The files are the JAX package's: either package reads the
  other's.
- ``Checkpointer``: step-numbered ``ckpt-<step>.bin`` files, or
  ``ckpt-<step>.d`` directories for sharded trees, under a base on any
  registered filesystem (a local directory, ``s3://``, ``gs://``,
  ``hdfs://``, ``mem://``, ``fault://``, ...), each file written to a
  ``.tmp`` name, its stored length checked, then renamed into place, with
  an optional ``meta`` dict (the data position of a mid-epoch save) in a
  ``.meta.bin`` sidecar or the manifest, ``keep`` retention and a
  background ``save_async``. Steps are found by listing the base, and
  retention and debris removal go through ``FileSystem.delete``.

Under the launcher, ``Checkpointer(process_index=rank)`` writes the
``.bin`` layout from rank 0 alone, as the JAX ``_is_writer`` decides;
every rank restores. The sharded layout is collective: every rank of
the world calls ``save``. Its barriers go through the store the ranks met
on (``parallel.mesh.store_barrier``), never through a collective of the
training group: the async save runs them on its own thread while the
step's collectives run, and collectives issued from two threads would
interleave in different orders on different ranks and deadlock (the JAX
package's ``coordination_only`` rule).
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .io import serializer
from .io.filesystem import FileInfo, FileSystem
from .io.stream import Stream
from .parallel.mesh import process_shard, store_barrier
from .parallel.spmd import Placed, place
from .utils.logging import Error, check, log_info

__all__ = [
    "AsyncSave",
    "Checkpointer",
    "load_pytree",
    "load_pytree_sharded",
    "save_pytree",
    "save_pytree_sharded",
]


_MAGIC = b"DMLCTPU1"
_MANIFEST = "MANIFEST.bin"
# skeleton marker for a leaf whose data lives in the shard files
_LEAF_KEY = "__dmlc_sharded_leaf__"


def _to_host(tree: Any, copy: bool = False) -> Any:
    """Tensors → numpy (``.detach().cpu()``); numpy and scalars pass.
    ``copy`` makes every array an owned copy: a CPU tensor's numpy view
    shares its storage, so a step that updates the parameters in place
    would otherwise change a tree that ``save_async`` is still writing."""

    def conv(x):
        if isinstance(x, Placed):
            check(x.local.shape == torch.Size(x.shape),
                  "a block of a split array in a .bin checkpoint: save it sharded")
            x = x.local
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


# -- sharded checkpoints -------------------------------------------------------

def _tree_map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over parallel structures (``other`` may be
    None anywhere: no counterpart below that point)."""
    if isinstance(tree, dict) and _LEAF_KEY in tree:
        return fn(tree, other)  # a chunked leaf's marker is a leaf
    if isinstance(tree, dict):
        return {k: _tree_map2(fn, v, other.get(k) if isinstance(other, dict) else None)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        def pick(i):
            if isinstance(other, (list, tuple)) and i < len(other):
                return other[i]
            return None

        out = [_tree_map2(fn, v, pick(i)) for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, other)


def _sync_processes(name: str) -> None:
    """Barrier across the world's ranks through the store (no-op in a
    world of one); a name may be passed again by a later save."""
    store_barrier(name.replace("/", "_"))


def _norm_index(index, shape) -> Tuple[List[int], List[int]]:
    """A block's tuple of slices → (starts, stops)."""
    starts, stops = [], []
    for d, sl in enumerate(index):
        check(sl.step in (None, 1), "strided shard indexes unsupported")
        starts.append(int(sl.start or 0))
        stops.append(int(sl.stop if sl.stop is not None else shape[d]))
    return starts, stops


def save_pytree_sharded(dir_uri: str, tree: Any, process_index: Optional[int] = None,
                        process_count: Optional[int] = None,
                        meta: Optional[Dict[str, Any]] = None) -> None:
    """Write a tree of placed blocks as a sharded checkpoint.

    Layout under ``dir_uri``: one ``shard-{proc:05d}.bin`` per process
    holding its replica-0 chunks (global index range + data), and
    ``MANIFEST.bin``, the tree's skeleton with each tensor leaf replaced
    by ``{_LEAF_KEY: id, shape, dtype}`` and numpy leaves inline,
    written by process 0 after every shard landed.

    Collective: every process of the world calls it. Chunks are written
    once each, by the rank whose block has ``replica_id == 0``. A plain
    tensor leaf is the process's own copy: every process writes it whole,
    and restore keeps process 0's.
    """
    rank, world = process_shard()
    process_index = rank if process_index is None else process_index
    process_count = world if process_count is None else process_count
    skeleton, chunks = _snapshot_sharded(tree)
    _write_sharded(dir_uri, skeleton, chunks, process_index, process_count,
                   meta=meta)


def _snapshot_sharded(tree: Any, copy: bool = False):
    """Skeleton + this process's replica-0 chunks, on the host. Runs in
    the caller's thread: afterwards the checkpoint holds no device
    tensor, so the step may update the parameters in place while a
    thread writes (the async save passes ``copy=True``: a CPU tensor's
    numpy view shares its storage)."""
    leaves: List[Any] = []

    def skel(x):
        # every tensor becomes a chunked leaf, by structure alone, so the
        # leaf ids agree across processes
        if isinstance(x, (Placed, torch.Tensor)):
            leaf_id = len(leaves)
            leaves.append(x)
            t = x.local if isinstance(x, Placed) else x
            return {_LEAF_KEY: leaf_id, "shape": [int(d) for d in x.shape],
                    "dtype": str(torch.empty(0, dtype=t.dtype).numpy().dtype)}
        if copy and isinstance(x, np.ndarray):
            return np.array(x, copy=True)  # an inline host leaf: own it
        return x

    def walk(t):
        if isinstance(t, dict):
            check(_LEAF_KEY not in t, f"user tree may not contain {_LEAF_KEY!r}")
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            out = [walk(v) for v in t]
            return tuple(out) if isinstance(t, tuple) else out
        return skel(t)

    skeleton = walk(tree)
    chunks: Dict[int, List[Tuple[List[int], List[int], np.ndarray]]] = {}
    for leaf_id, x in enumerate(leaves):
        if isinstance(x, Placed):
            if x.replica_id != 0:
                continue
            starts, stops = _norm_index(x.index, x.shape)
            data = _host(x.local)
        else:
            starts, stops = [0] * x.dim(), [int(d) for d in x.shape]
            data = _host(x)
        chunks[leaf_id] = [(starts, stops, data.copy() if copy else data)]
    return skeleton, chunks


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _write_sharded(dir_uri: str, skeleton: Any, chunks, process_index: int,
                   process_count: int,
                   meta: Optional[Dict[str, Any]] = None) -> None:
    """The files and the completeness protocol of a sharded save
    (collective)."""
    base = dir_uri.rstrip("/")
    if process_index == 0:
        _clear_manifest(base)
    # after the manifest's removal and before any shard write: a re-save
    # into an existing .d must be torn (invisible) before a shard of it
    # changes, or a crash mid-rewrite would leave a manifest over mixed
    # old and new shards
    _sync_processes(f"dmlc_ckpt_clear:{base}")
    _write_atomic(f"{base}/shard-{process_index:05d}.bin",
                  {"proc": process_index, "chunks": chunks})
    _sync_processes(f"dmlc_ckpt_shards:{base}")
    if process_index == 0:
        manifest: Dict[str, Any] = {"tree": skeleton, "nprocs": process_count}
        if meta is not None:
            manifest["meta"] = meta  # the data position, under the same guarantee
        _write_atomic(f"{base}/{_MANIFEST}", manifest)
    _sync_processes(f"dmlc_ckpt_manifest:{base}")


def load_pytree_sharded(dir_uri: str, template: Any = None) -> Any:
    """Reassemble a sharded checkpoint and place it by ``template``.

    Reads the manifest and every shard file, rebuilds each global array
    on the host (checking that the chunks cover every element once), then
    places each leaf by its counterpart in ``template``: a ``Placed``
    leaf gives this rank's block on the template's mesh and spec (the
    mesh at restore may differ from the mesh at save), a tensor gives a
    tensor on its device; leaves without a counterpart come back as
    numpy arrays. Every process reads the whole tree (O(model) host
    memory), as in the JAX package.
    """
    base = dir_uri.rstrip("/")
    manifest = load_pytree(f"{base}/{_MANIFEST}")
    skeleton, nprocs = manifest["tree"], int(manifest["nprocs"])
    meta: Dict[int, Tuple[Tuple[int, ...], np.dtype]] = {}

    def collect_meta(t):
        if isinstance(t, dict) and _LEAF_KEY in t:
            meta[int(t[_LEAF_KEY])] = (tuple(int(d) for d in t["shape"]), np.dtype(t["dtype"]))
        elif isinstance(t, dict):
            for v in t.values():
                collect_meta(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                collect_meta(v)

    collect_meta(skeleton)
    assembled = {lid: np.empty(shape, dtype) for lid, (shape, dtype) in meta.items()}
    filled = dict.fromkeys(meta, 0)
    seen: Dict[int, List[Tuple[Tuple[int, ...], Tuple[int, ...]]]] = {lid: [] for lid in meta}
    # descending process order: the last write wins on an exact duplicate
    # range, so process 0's copy of a process-local leaf prevails
    for proc in range(nprocs - 1, -1, -1):
        shard = load_pytree(f"{base}/shard-{proc:05d}.bin")
        for leaf_id, parts in shard["chunks"].items():
            leaf_id = int(leaf_id)
            check(leaf_id in assembled, f"shard chunk for unknown leaf {leaf_id}")
            for starts, stops, data in parts:
                rng = (tuple(int(a) for a in starts), tuple(int(b) for b in stops))
                assembled[leaf_id][tuple(slice(a, b) for a, b in zip(*rng))] = data
                if rng in seen[leaf_id]:
                    continue  # a process-local duplicate: overwritten, counted once
                for o_starts, o_stops in seen[leaf_id]:
                    overlap = all(a < ob and oa < b for a, b, oa, ob in
                                  zip(*rng, o_starts, o_stops)) and len(rng[0]) > 0
                    check(not overlap,
                          f"checkpoint leaf {leaf_id}: partially overlapping shard "
                          f"chunks {rng} vs {(o_starts, o_stops)}: corrupt "
                          f"checkpoint under {base}")
                seen[leaf_id].append(rng)
                filled[leaf_id] += int(data.size)
    for leaf_id, (shape, _) in meta.items():
        want = int(np.prod(shape)) if shape else 1
        check(filled[leaf_id] == want,
              f"checkpoint leaf {leaf_id}: {filled[leaf_id]}/{want} elements "
              f"covered: missing shard files under {base}")

    def rebuild(skel_leaf, tmpl_leaf):
        if isinstance(skel_leaf, dict) and _LEAF_KEY in skel_leaf:
            return _place(assembled[int(skel_leaf[_LEAF_KEY])], tmpl_leaf)
        if isinstance(skel_leaf, np.ndarray) and tmpl_leaf is not None:
            return _place(skel_leaf, tmpl_leaf)  # an inline array: honour the template
        return skel_leaf

    return _tree_map2(rebuild, skeleton, template)


def _place(host: np.ndarray, template) -> Any:
    """A host array → this rank's block on the template's placement, a
    tensor on the template tensor's device, or the host array."""
    if not isinstance(template, (Placed, torch.Tensor)):
        return host
    check(tuple(template.shape) == tuple(host.shape),
          f"template shape {tuple(template.shape)} != checkpoint shape {tuple(host.shape)}")
    local = template.local if isinstance(template, Placed) else template
    t = torch.from_numpy(np.asarray(host, order="C")).to(local.dtype)
    if isinstance(template, Placed):
        return place(t, template.mesh, template.spec)
    return t.to(local.device)


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
    """Step-numbered checkpoints under a base on any registered
    filesystem, the newest ``keep`` of them kept (``keep`` <= 0 keeps
    all): ``{base}/ckpt-{step:010d}.bin`` for host trees (process 0
    writes), or ``{base}/ckpt-{step:010d}.d/`` for sharded trees (every
    process writes its shard; ``save_pytree_sharded``). The sharded
    layout is chosen when the tree holds a block of a split array, or a
    tensor in a world of more than one rank; ``sharded=True/False``
    forces the choice. ``restore`` loads the newest (or a given) step
    into every process, placed by ``template`` when given.

    A ``.bin`` save with ``meta`` writes it to
    ``ckpt-{step:010d}.meta.bin``; a ``.d`` save puts it in the manifest.
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
        """``process_index``/``process_count``: this process's rank and
        the rank count of a run launched by the tracker (``DMLC_TASK_ID``)
        outside ``parallel.init_process_group``; only rank 0 (or None)
        writes the ``.bin`` layout. Without a process group the sharded
        layout has no barrier: such a caller brackets ``save`` with its
        own (an allreduce, say), and ``save_async`` of a sharded tree
        over more than one process raises."""
        self.base = base_uri.rstrip("/")
        FileSystem.get_instance(self.base)  # an unknown scheme raises here
        self.keep = keep
        self._proc = process_index
        self._count = process_count
        self._sharded = sharded
        self._inflight: Optional[AsyncSave] = None

    def _is_writer(self) -> bool:
        if self._proc is not None:
            return self._proc == 0
        return process_shard()[0] == 0

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

    def _needs_sharded(self, tree: Any) -> bool:
        if self._sharded is not None:
            return self._sharded
        found = {"tensor": False, "split": False}

        def probe(x):
            if isinstance(x, Placed):
                found["tensor"] = True
                if tuple(x.local.shape) != x.shape:
                    found["split"] = True
            elif isinstance(x, torch.Tensor):
                found["tensor"] = True
            return x

        _tree_map(probe, tree)
        if found["split"]:
            return True
        if not found["tensor"]:
            return False
        count = self._count if self._count is not None else process_shard()[1]
        return count > 1

    def _rank_count(self) -> Tuple[int, int]:
        rank, world = process_shard()
        return (rank if self._proc is None else self._proc,
                world if self._count is None else self._count)

    def _after_sharded(self, step: int, tag: str) -> None:
        """On the writer, after a sharded save: the same step's ``.bin``
        and its sidecar are stale now (a surviving sidecar would hand a
        later restore_meta a position for the wrong tree); then prune."""
        if self._is_writer():
            _remove(self._path(step))
            _remove(self._meta_path(step))
            self._prune()
            log_info(f"{tag}sharded checkpoint step {step} -> "
                     f"{self._path(step, sharded=True)}")

    def save_async(self, step: int, tree: Any,
                   meta: Optional[Dict[str, Any]] = None) -> AsyncSave:
        """``save`` with the file I/O on a background thread. The tree is
        copied to owned host arrays HERE, before the call returns, so the
        caller may update its parameters in place at once. Saves are
        serial: a second call first waits for the first. A sharded save
        is collective (every rank calls it, in the same order) and its
        barriers go through the store, never a collective. On a process
        that writes no ``.bin``, the handle's path is None."""
        self.wait()
        handle = AsyncSave()
        if self._needs_sharded(tree):
            proc, count = self._rank_count()
            check(count <= 1 or process_shard()[1] > 1,
                  "save_async of a sharded tree over more than one process needs "
                  "parallel.init_process_group's store for its barriers; a "
                  "tracker-launched worker uses the synchronous save() with "
                  "a barrier of its own")
            path = self._path(step, sharded=True)
            skeleton, chunks = _snapshot_sharded(tree, copy=True)

            def work():
                _write_sharded(path, skeleton, chunks, proc, count, meta=meta)
                self._after_sharded(step, "async ")
                return path
        else:
            host_tree = _to_host(tree, copy=True)
            is_writer = self._is_writer()

            def work():
                if not is_writer:
                    return None
                return self._write_single(step, host_tree, "async ", meta)

        def run():
            try:
                handle.uri = work()
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
        does not write a ``.bin``; the sharded layout is collective and
        every process gets the path). ``meta`` is a small dict stored
        with it under the same completeness guarantee and read back by
        ``restore_meta``, such as the data position ``{"epoch": e,
        "records": n}`` a resume skips to."""
        self.wait()
        if self._needs_sharded(tree):
            proc, count = self._rank_count()
            path = self._path(step, sharded=True)
            skeleton, chunks = _snapshot_sharded(tree)
            _write_sharded(path, skeleton, chunks, proc, count, meta=meta)
            self._after_sharded(step, "")
            return path
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
        log_info(f"{tag}checkpoint step {step} -> {path}")
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

    def restore(self, step: Optional[int] = None,
                template: Any = None) -> Tuple[int, Any]:
        """(step, tree) of the given or newest step, with numpy leaves,
        or placed by ``template`` (a tree of ``Placed`` blocks or
        tensors, such as ``model.placed()``), whichever layout it was
        saved in and whatever mesh it was saved from."""
        step, sharded = self._resolve(step)
        if sharded:
            return step, load_pytree_sharded(self._path(step, sharded=True), template)
        tree = load_pytree(self._path(step))
        if template is not None:
            tree = _tree_map2(
                lambda leaf, tmpl: _place(leaf, tmpl) if isinstance(leaf, np.ndarray) else leaf,
                tree, template)
        return step, tree

    def restore_meta(self, step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """The ``meta`` saved with the given or newest step, or None when
        it carried none (position unknown: replay, never skip)."""
        step, sharded = self._resolve(step)
        if sharded:
            return load_pytree(f"{self._path(step, sharded=True)}/{_MANIFEST}").get("meta")
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
