"""Rank meshes over torch.distributed, one device per rank (the port of
``dmlc_core_tpu/parallel/mesh.py``).

JAX drives many devices from one process through a ``Mesh`` and lets
XLA insert the collectives. The port runs one process per rank, each
with one device, and its collectives are explicit ``torch.distributed``
calls on the process groups a ``Mesh`` makes over the world's ranks.

- ``init_process_group``: joins the world. Under the port's launcher the
  rank and world come from the tracker's rendezvous (ranks in connect
  order, as the collective engine has them), and rank 0's store address
  reaches the other ranks over the tracker's links, so a job needs no
  address of its own. It sets the rank's CUDA device before the init.
  NCCL (the default on the card) puts one rank on each card; ranks that
  share a card must ask for ``backend="gloo"``, and ``nccl`` with more
  local ranks than cards raises (the backend never changes on its own).
- ``make_mesh``: a row-major grid of the world's ranks with named axes,
  and one process group per line of every set of axes, all made once at
  construction (``new_group`` is collective: every rank makes every
  group, in the same order).
- ``process_shard``: ``(rank, world)``, as ``jax.process_index()`` and
  ``jax.process_count()`` give them; ``process_shard(mesh)`` is the part
  of the input this rank reads when each rank stages only its own rows:
  ``(data coordinate, data axis size)``, the same part for every rank of
  a model line.
"""

from __future__ import annotations

import datetime
import itertools
import os
import socket
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import Error, check

__all__ = [
    "Mesh",
    "destroy_process_group",
    "init_process_group",
    "make_mesh",
    "process_shard",
    "store_barrier",
]

# collectives and store waits give up after this many seconds
TIMEOUT_SECS = 300.0


class _World:
    """This process's membership: the store the ranks met through, the
    rank's device, the tracker worker that brokered the rendezvous and
    how often each barrier name was passed in this world
    (torch.distributed's own state is process-wide, and so is this)."""

    store = None
    device = None
    worker = None
    barrier_uses: Dict[str, int] = {}
    barrier_lock = threading.Lock()


_WORLD = _World()


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=TIMEOUT_SECS)


def _dist():
    import torch.distributed as dist

    return dist


def _route_ip(host: str, port: int) -> str:
    """This host's address on the route to ``host`` (a UDP connect sends
    nothing)."""
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.connect((host, port))
        return s.getsockname()[0]


def _tracker_store(timeout: datetime.timedelta):
    """(rank, world, store) from the port's tracker: the rendezvous gives
    the rank, rank 0 opens a TCPStore on a free port, and its address
    rides a broadcast over the tracker's links."""
    from torch.distributed import TCPStore

    from ..tracker.client import RabitWorker
    from ..tracker.collective import Collective

    worker = RabitWorker()
    rank = worker.start()
    world = worker.world_size
    coll = Collective(worker)
    try:
        addr = np.zeros(5, np.int64)
        store = None
        if rank == 0:
            ip = _route_ip(worker.tracker_uri, worker.tracker_port)
            store = TCPStore(ip, 0, world, True, timeout=timeout,
                             wait_for_workers=False)
            addr[:4] = [int(x) for x in ip.split(".")]
            addr[4] = store.port
        addr = coll.broadcast(addr, root=0)
        if rank != 0:
            ip = ".".join(str(int(x)) for x in addr[:4])
            store = TCPStore(ip, int(addr[4]), world, False, timeout=timeout)
    finally:
        coll.close()
    _WORLD.worker = worker
    return rank, world, store


def _local_ranks(store, rank: int, world: int) -> Tuple[int, int]:
    """(local rank, local world): this rank's place among the ranks on
    its host, through the store."""
    host = socket.gethostname()
    store.set(f"dmlc_host/{rank}", host)
    keys = [f"dmlc_host/{r}" for r in range(world)]
    store.wait(keys, _timeout())
    hosts = [store.get(k).decode() for k in keys]
    return (sum(h == host for h in hosts[:rank]), sum(h == host for h in hosts))


def init_process_group(backend: Optional[str] = None, rank: Optional[int] = None,
                       world: Optional[int] = None, device=None,
                       init_method: Optional[str] = None) -> Tuple[int, int]:
    """Join the world; returns ``(rank, world)``.

    - ``init_method`` ``file://<path>`` with ``rank`` and ``world``;
      without it, the tracker's rendezvous under
      the launcher (``DMLC_TRACKER_URI`` set), else a world of one.
    - ``device`` defaults to ``cuda``: local rank ``i`` takes card ``i``
      modulo the card count, set before the init. ``device="cpu"`` runs
      on the CPU.
    - ``backend`` defaults to ``nccl`` on the card and ``gloo`` on the
      CPU. ``nccl`` with more local ranks than cards raises: ranks that
      share a card pass ``backend="gloo"`` themselves.

    Every collective and store wait has a timeout of ``TIMEOUT_SECS``.
    """
    import torch

    from ..utils.device import resolve_device

    dist = _dist()
    check(not dist.is_initialized(), "init_process_group: already initialized")
    dev = resolve_device(device)
    timeout = _timeout()
    if init_method is not None:
        check(rank is not None and world is not None,
              f"init_method {init_method!r} needs rank and world")
        check(init_method.startswith("file://"),
              f"init_method {init_method!r}: expected file://<path>")
        store = dist.FileStore(init_method[len("file://"):], world)
    elif "DMLC_TRACKER_URI" in os.environ:
        rank, world, store = _tracker_store(timeout)
    else:
        check(rank in (None, 0) and world in (None, 1),
              "init_process_group: a world of more than one rank needs the "
              "launcher or an init_method")
        rank, world, store = 0, 1, dist.HashStore()
    check(0 <= rank < world, f"rank {rank} out of range for world {world}")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local, local_world = _local_ranks(store, rank, world)
        cards = torch.cuda.device_count()
        if backend == "nccl" and local_world > cards:
            raise Error(
                f"nccl puts one rank on each card, and {local_world} ranks "
                f"of this host would share {cards} card(s); pass "
                "backend='gloo' for ranks that share a card")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timeout)
    _WORLD.store = store
    _WORLD.device = dev
    _WORLD.barrier_uses = {}
    return rank, world


def destroy_process_group() -> None:
    """Leave the world: destroy the default group, then end the tracker
    worker's session (when the launcher brokered it)."""
    dist = _dist()
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.store = None
    _WORLD.device = None
    _WORLD.barrier_uses = {}
    worker, _WORLD.worker = _WORLD.worker, None
    if worker is not None:
        worker.shutdown()


def process_shard(mesh: Optional["Mesh"] = None,
                  data_axis: str = "data") -> Tuple[int, int]:
    """``(rank, world)`` of this process, ``(0, 1)`` outside a world.

    With a mesh: ``(mesh.coords[data_axis], mesh.shape[data_axis])``, the
    ``(part_index, num_parts)`` this rank reads when it stages only its
    own rows (``StagingPipeline(mesh=, local_rows=True)``). The ranks of
    a model line share a data coordinate, so they read the same part; a
    JAX process reads part ``jax.process_index()``, and holds every
    device of its line."""
    if mesh is not None:
        check(data_axis in mesh.shape,
              f"data axis {data_axis!r} is not an axis of the mesh {mesh.shape}")
        return mesh.coords[data_axis], mesh.shape[data_axis]
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def store_barrier(name: str) -> None:
    """Every rank reaches ``name`` before any passes it, through the
    store the ranks met on, never through a collective: a thread may
    call it while the main thread's step runs collectives on the same
    group, and two collectives issued in different orders on two ranks
    deadlock. A name may be passed again: each pass has keys of its own,
    numbered by how often this process passed the name in this world,
    which every rank counts alike as long as every rank passes the
    barriers of one name in the same order. No-op in a world of one."""
    rank, world = process_shard()
    if world <= 1:
        return
    store = _WORLD.store
    check(store is not None,
          "a barrier across ranks needs init_process_group's store")
    with _WORLD.barrier_lock:
        use = _WORLD.barrier_uses.get(name, 0)
        _WORLD.barrier_uses[name] = use + 1
    store.set(f"dmlc_barrier/{name}/{use}/{rank}", b"1")
    store.wait([f"dmlc_barrier/{name}/{use}/{r}" for r in range(world)],
               datetime.timedelta(seconds=2 * TIMEOUT_SECS))


class Mesh:
    """A grid of ranks with named axes, this rank's place in it, and the
    process groups of its lines.

    ``shape`` maps each axis name to its size (as a JAX mesh's does);
    ``ranks`` is the grid itself; ``coords`` this rank's index on each
    axis. ``group(axes)`` is the group of the ranks that share this
    rank's coordinates on every other axis (None when that line holds
    this rank alone, or when the mesh was built without groups: a mesh
    that only places and stages, as the tests build one per rank).
    """

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str], rank: int,
                 device=None, groups: Optional[Dict[Tuple[str, ...], object]] = None
                 ) -> None:
        import torch

        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        check(self.ranks.ndim == len(self.axis_names), "shape/axis_names length mismatch")
        self.rank = int(rank)
        hit = np.argwhere(self.ranks == self.rank)
        check(len(hit) == 1, f"rank {rank} is not on the mesh {self.ranks.tolist()}")
        self.coords = dict(zip(self.axis_names, (int(c) for c in hit[0])))
        self.shape = dict(zip(self.axis_names, (int(s) for s in self.ranks.shape)))
        self.device = torch.device("cpu" if device is None else device)
        self._groups = dict(groups or {})

    def group(self, axes: Sequence[str]):
        axes = tuple(a for a in self.axis_names if a in axes)
        return self._groups.get(axes)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, device={self.device})"


def _axis_sets(axis_names):
    for n in range(1, len(axis_names) + 1):
        yield from itertools.combinations(axis_names, n)


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), device=None) -> Mesh:
    """A ``Mesh`` over the world's ranks, row-major.

    - default: every rank on one ``data`` axis;
    - ``shape`` (d0, d1, ...) with matching ``axis_names`` for n-D meshes,
      e.g. ((2, 2), ('data', 'model')); -1 in at most one slot absorbs
      the remaining ranks.

    Collective: every rank calls it with the same arguments, since it
    makes the groups of every line. Its device is the one
    ``init_process_group`` gave the rank; outside a world it is a mesh of
    one rank and no groups on ``device`` (default ``cuda``).
    """
    from ..utils.device import resolve_device

    rank, n = process_shard()
    if shape is None:
        shape = (n,)
    shape = list(shape)
    check(len(shape) == len(axis_names), "shape/axis_names length mismatch")
    if -1 in shape:
        i = shape.index(-1)
        rest = int(np.prod([s for s in shape if s != -1]))
        check(n % rest == 0, f"{n} devices not divisible by {rest}")
        shape[i] = n // rest
    check(int(np.prod(shape)) == n, f"mesh shape {tuple(shape)} != {n} devices")
    ranks = np.arange(n, dtype=np.int64).reshape(shape)
    groups = {}
    dist = _dist()
    if n > 1:
        names = tuple(axis_names)
        for axes in _axis_sets(names):
            others = [a for a in names if a not in axes]
            other_sizes = [shape[names.index(a)] for a in others]
            for coord in itertools.product(*(range(s) for s in other_sizes)):
                fixed = dict(zip(others, coord))
                index = tuple(slice(None) if a in axes else fixed[a] for a in names)
                members = [int(r) for r in ranks[index].reshape(-1)]
                if len(members) == 1:
                    continue  # a line of one rank needs no collective
                g = dist.new_group(members, timeout=_timeout())
                if rank in members:
                    groups[axes] = g
    dev = _WORLD.device if dist.is_initialized() else resolve_device(device)
    return Mesh(ranks, axis_names, rank, dev, groups)
