"""Double-buffered staging of packed host batches onto the device.

    producer (ring-slot batches) → host queue (thread, depth ``prefetch``)
        → transfer thread: copy ``Batch.packed`` into a pinned host slot,
          one non-blocking host→device copy on a side stream, an event
        → device queue (``depth`` staged batches in flight)
        → consumer: its stream waits on the copy's event, then the batch
          is ``Tensor.view(dtype)`` slices of the one device u8 tensor

A pinned slot is rewritten only after the event of its previous copy has
completed, and the device u8 tensor (allocated on the copy stream) is
recorded on the consumer's stream, so the caching allocator does not
reuse it while the step still reads it. On the CPU ``torch.from_numpy``
would share the producer's ring slot, so the bytes are copied first (a
yielded batch must not change when the producer's ring wraps). Batches
without a usable packed layout take one transfer per array. The transfer
loop picks each batch's route (per array, mesh shard, direct or pack) and
hands its bytes to the device's copier (``_CudaCopier`` or
``_CpuCopier``), chosen once when the pipeline is built.

Direct copies (``pack_reason``, decided once per pipeline, never under
mesh shard staging): the host→device copy reads the producer's own
buffer, with no pack copy, when the producer either

- declares ``adopt_slots`` (the dsserve client), its promise that a
  delivered buffer stays stable until every view over it dies: a
  C-contiguous page-aligned buffer is copied directly on CUDA and shared
  with ``torch.from_numpy`` on the CPU (the tensor holds the array, so
  the producer's liveness tracking sees it); any other buffer is copied
  and counted in ``dsserve.slot_copies``;
- or, on CUDA, declares ``ring_slots`` of at least ``max(1, prefetch) +
  depth + 4``: a slot that is page-aligned and pinned goes directly, any
  other is packed. A slot is rewritten ``ring_slots`` batches after it
  was emitted; by then the batches after it fill at most 1 slot in the
  producer, ``prefetch`` in its queue, 1 on the transfer thread and
  ``depth + 2`` copies in flight (the oldest is waited for to make
  room), so its own copy has completed.

A direct copy's source is kept referenced until the copy's event has
completed (torch's caching host allocator tracks only the buffers it
allocated, so nothing else would keep a pooled bank from being recycled,
or an shm segment from being acked back to its server, under the DMA).
A CUDA pipeline that copies directly drains its producer under
``batcher.host_pinning``, so what the producer allocates on that thread,
through any wrapper that iterates it there, is page-locked: a ring
allocated at its first iteration takes its slots from torch's pinned
caching allocator, and the dsserve client installs the pinning in its
receive pool (pool banks from torch's pinned allocator, each mapped shm
segment registered once with ``cudaHostRegister``; a failed
registration raises).

Mesh staging (``mesh=``, one rank of a ``parallel`` mesh): every rank
reads the same global batch of B rows (the JAX package's single-process
layout), packs only its own data coordinate's rows, every array's at a
PACK_ALIGN offset of one ``stride``-byte block (``packed_shard_layout``),
into its pinned slot, makes one host→device copy and hands out views of
``B/n`` rows: rank ``d`` of the data axis gets rows ``[d·B/n,
(d+1)·B/n)``, and the ranks of a model line get the same rows. A batch
whose rows do not split over the data axis, or that is not packed, goes
array by array (``_stage_per_array_mesh``), and a batch of B rows that
do not divide by the axis raises there, as a JAX ``NamedSharding`` put
does.

Local rows (``mesh=`` with ``local_rows=True``, the JAX package's
multi-process branch, ``make_array_from_process_local_data``): the host
batch is this rank's own block, read from part ``process_shard(mesh)``
of the input with the per-rank batch size, and it takes the one-device
packed path on the mesh's device (pinned slot, one copy, event). The
global batch is the data coordinates' blocks in data order. Parts of a
byte-range split may end a batch apart, so once a step the ranks of a
data line exchange, on the consumer's thread before the step's own
collectives, whether each still has a batch: a rank whose part has ended
yields an all-padding batch of the same layout (every row weight 0, the
padding rows' zeros), counted in ``padding_batches``, and every rank
stops together once no part has a batch. Weight-0 rows leave the step's
global weighted mean as it was.

Telemetry (the JAX package's series and span names): the registry
counters ``staging.rows``/``bytes``/``device_puts``/``batches{path}``
and one ``staging.stage_seconds{stage}`` histogram per stage, resolved
once at import so the transfer thread pays one thread-local add per
write; each stage runs under ``annotate("dmlc:<stage>")``, which puts it
on the flight recorder's ring and, while a torch profiler records on
that thread, on the capture's timeline. The staging thread's pull of
each producer batch is a ``dmlc:produce`` span (the port's own: the JAX
pipeline has none there). ``stage_seconds`` and ``throughput()`` keep
their sums.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from ..telemetry import default_registry as _default_registry
from ..utils.device import DeviceLike, resolve_device
from ..utils.logging import Error, check
from ..utils.prefetch import Prefetcher
from ..utils.profiler import annotate
from .batcher import Batch, host_pinning, packed_layout, packed_shard_layout

__all__ = [
    "StagingPipeline",
    "StagingStats",
    "device_put",
    "drain_close",
    "pack_reason",
    "packed_layout",
    "stage_batch",
]

logger = logging.getLogger("dmlc_core_tpu_torch.staging")

_REG = _default_registry()
_ROWS_STAGED = _REG.counter("staging.rows", help="rows staged to device")
_BYTES_STAGED = _REG.counter("staging.bytes", help="bytes staged to device")
_DEVICE_PUTS = _REG.counter("staging.device_puts", help="device transfers")
_SLOTS_ADOPTED = _REG.counter(
    "staging.adopted_slots",
    help="packed slots device_put straight from the producer's buffer "
    "(dispatch_pack copy skipped)",
)
_SLOT_COPIES = _REG.counter(
    "dsserve.slot_copies",
    help="received dsserve slots that took the dispatch_pack memcpy "
    "anyway (0 on the zero-copy adopt path)",
)
# registered under the JAX name although its path (the jitted unpacker
# cache) is not ported: it stays 0
_REG.counter("staging.unpack_evictions", help="jitted-unpacker LRU evictions")
_BATCH_COUNTERS = {
    kind: _REG.counter(
        "staging.batches",
        help="staged batches by transfer path",
        labels={"path": kind},
    )
    for kind in ("packed", "packed_shard", "per_array")
}
_STAGES = ("host_pull", "dispatch_pack", "dispatch_put", "dispatch_slot_wait",
           "transfer_wait")
_STAGE_HISTS = {
    stage: _REG.histogram(
        "staging.stage_seconds",
        help="per-stage staging durations (secs)",
        labels={"stage": stage},
    )
    for stage in _STAGES
}
# the stages whose seconds also sum into ``stage_dispatch``
_DISPATCH = ("dispatch_pack", "dispatch_put")


_PAGE = 4096  # an adopted slot starts on a page, as a pinned ring slot does


def adoptable_slot(batch: Batch) -> bool:
    """True when this batch's packed buffer can be copied to the device
    directly, skipping the dispatch_pack copy. Callers first check the
    producer declared ``adopt_slots`` — the promise that a delivered
    buffer is stable until every view over it dies (dsserve's pooled
    recv banks and shm segments are liveness-tracked by finalizers). Per
    batch all that remains is shape: page-aligned and contiguous."""
    packed = batch.packed
    return (
        packed is not None
        and packed.flags.c_contiguous
        and packed.ctypes.data % _PAGE == 0
    )


class _InFlight:
    """Adopted host buffers that a host→device copy may still read, each
    kept referenced until its copy's event has completed; at most
    ``cap`` at once (the oldest is waited for to make room)."""

    def __init__(self, cap: int) -> None:
        self._cap = max(1, cap)
        self._q: list = []  # (event, buffer), oldest first

    def __len__(self) -> int:
        return len(self._q)

    def prune(self) -> None:
        """Drop the buffers whose copies have completed, oldest first."""
        n = 0
        while n < len(self._q) and self._q[n][0].query():
            n += 1
        del self._q[:n]

    def full(self) -> bool:
        return len(self._q) >= self._cap

    def wait_oldest(self) -> None:
        event, _buf = self._q.pop(0)
        event.synchronize()

    def add(self, event, buf) -> None:
        self._q.append((event, buf))

    def drain(self) -> None:
        while self._q:
            self.wait_oldest()


def _cuda_check(err, what: str) -> None:
    code = int(getattr(err, "value", err))
    if code != 0:
        raise Error(f"{what} failed: {err} ({code})")


class _CudaPinning:
    """Page-locking for the producer of a CUDA pipeline that copies
    directly (``batcher.host_pinning``): each ring slot and each dsserve
    pool bank comes from torch's pinned allocator, each mapped shm
    segment is registered with ``cudaHostRegister`` once and
    unregistered before it is unmapped (``dsserve.client.
    set_host_pinning``). Counts what it pinned."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.banks = 0
        self.segments = 0
        self.segments_unregistered = 0
        self.ring_slots = 0

    def bank(self, nbytes: int) -> np.ndarray:
        with self._lock:
            self.banks += 1
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()

    def ring_slot(self, nbytes: int) -> np.ndarray:
        """A zeroed page-locked ring slot (``batcher.alloc_ring``) that
        starts on a page, as ``adoptable_slot`` asks (the pinned
        allocator need not align a small block to one); the caching
        allocator hands a dropped ring's blocks to the next."""
        with self._lock:
            self.ring_slots += 1
        raw = torch.empty(nbytes + _PAGE, dtype=torch.uint8, pin_memory=True).numpy()
        start = -raw.ctypes.data % _PAGE
        buf = raw[start:start + nbytes]
        buf.fill(0)
        return buf

    def register(self, addr: int, nbytes: int) -> None:
        _cuda_check(torch.cuda.cudart().cudaHostRegister(addr, nbytes, 0),
                    f"cudaHostRegister of {nbytes} bytes")
        with self._lock:
            self.segments += 1

    def unregister(self, addr: int) -> None:
        _cuda_check(torch.cuda.cudart().cudaHostUnregister(addr),
                    "cudaHostUnregister")
        with self._lock:
            self.segments_unregistered += 1

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"banks_pinned": self.banks, "segments_pinned": self.segments,
                    "segments_unpinned": self.segments_unregistered,
                    "ring_slots_pinned": self.ring_slots}


_PINNING: Optional[_CudaPinning] = None
_PINNING_LOCK = threading.Lock()


def _cuda_pinning() -> _CudaPinning:
    global _PINNING
    with _PINNING_LOCK:
        if _PINNING is None:
            _PINNING = _CudaPinning()
        return _PINNING


def host_pinning_stats() -> Dict[str, int]:
    """What the producers of CUDA pipelines that copy directly
    page-locked so far in this process: pool banks, shm segments and
    ring slots (0s when none did)."""
    return _PINNING.stats() if _PINNING is not None else {
        "banks_pinned": 0, "segments_pinned": 0, "segments_unpinned": 0,
        "ring_slots_pinned": 0}


def device_put(tree, device: DeviceLike = None):
    """``tree`` (numpy arrays, tensors and numbers, nested in dicts, lists
    and tuples) with every leaf a tensor on ``device`` (default ``cuda``,
    raising when there is none): the port's one call site for placing
    what is not a batch, such as a model's parameters. Nothing falls
    back to another device; a leaf of another type raises."""
    dev = resolve_device(device)

    def put(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        if isinstance(x, (np.generic, int, float, bool)):
            return torch.as_tensor(np.asarray(x)).to(dev)
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(put(v) for v in x)
        raise Error(f"device_put: cannot place a {type(x).__name__}")

    return put(tree)


def _torch_dtype(dtype: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _unpack(u8: torch.Tensor, layout) -> Dict[str, torch.Tensor]:
    """Named typed views of one u8 tensor; offsets are PACK_ALIGN aligned,
    so every slice starts on its dtype's boundary."""
    return {
        name: u8[off : off + nb].view(_torch_dtype(dtype)).reshape(shape)
        for name, off, nb, shape, dtype in layout
    }


class StagingStats:
    """Thread-safe transfer-shape counters. ``packed_shard_dma`` latches
    True the first time a batch rides the mesh's packed-shard path."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.device_puts = 0
        self.puts_per_device: Dict[str, int] = {}
        self.packed_batches = 0
        self.packed_shard_batches = 0
        self.per_array_batches = 0
        self.packed_shard_dma = False

    def tick_batch(self, kind: str, puts: int, device) -> None:
        """One staged batch on path ``kind`` (packed, packed_shard or
        per_array) that took ``puts`` copies to ``device``."""
        with self._lock:
            self.device_puts += puts
            key = str(device)
            self.puts_per_device[key] = self.puts_per_device.get(key, 0) + puts
            if kind == "packed":
                self.packed_batches += 1
            elif kind == "packed_shard":
                self.packed_shard_batches += 1
                self.packed_shard_dma = True
            else:
                self.per_array_batches += 1
        _DEVICE_PUTS.inc(puts)
        _BATCH_COUNTERS[kind].inc()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "device_puts": self.device_puts,
                "puts_per_device": dict(self.puts_per_device),
                "packed_batches": self.packed_batches,
                "packed_shard_batches": self.packed_shard_batches,
                "per_array_batches": self.per_array_batches,
                "packed_shard_dma": self.packed_shard_dma,
            }


def _ring_bounds(prefetch: int, depth: int) -> Dict[str, Tuple[int, str]]:
    """The least ring a producer may have under a pipeline, each with the
    sum it stands for: ``alive`` keeps valid every batch the pipeline
    holds at once, ``in_place`` lets a slot's own copy complete before
    the producer rewrites it (the module docstring)."""
    p = max(1, prefetch)
    return {
        "alive": (prefetch + depth + 3,
                  f"1 in producer + prefetch={prefetch} + 1 staging + "
                  f"depth={depth} + 1 consumed"),
        "in_place": (p + depth + 4,
                     f"1 being filled + prefetch={p} + 1 staging + "
                     f"depth+2={depth + 2} copies in flight"),
    }


def pack_reason(source, device: torch.device, shard_staging: bool,
                prefetch: int, depth: int) -> Optional[str]:
    """Why a pipeline packs every batch of ``source``, or None when its
    host→device copy may read the source's own buffers (the module
    docstring): an adopting source's on either device, a long enough
    ring's on CUDA."""
    if shard_staging:
        return "mesh shard staging packs this rank's rows"
    if getattr(source, "adopt_slots", False):
        return None
    if device.type != "cuda":
        return "a CPU pipeline copies every batch"
    ring = getattr(source, "ring_slots", None)
    if ring is None:
        return "the producer declares no ring"
    need, parts = _ring_bounds(prefetch, depth)["in_place"]
    if ring < need:
        return (f"producer ring has {ring} slots but an in-place copy needs "
                f"{need} ({parts})")
    return None


def _produced(host_batches: Iterable[Batch], pinning=None) -> Iterator[Batch]:
    """The producer's batches, each pulled under a ``dmlc:produce`` span
    (the staging thread's work; its waits to hand a batch on are the
    gaps between spans), drained under ``host_pinning(pinning)``."""
    with host_pinning(pinning):
        it = iter(host_batches)
        while True:
            with annotate("dmlc:produce"):
                batch = next(it, None)
            if batch is None:
                return
            yield batch


def _per_array(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {
        k: torch.from_numpy(np.array(v, copy=True)).to(device)
        for k, v in batch.as_dict().items()
    }


def _shard_plan(batch: Batch, mesh, data_axis: str):
    """(shard_entries, stride, n_shards) when the packed-shard path
    applies, else None: the batch is packed, the data axis exists, every
    array is C-contiguous and every leading dim divides by the axis (the
    batcher emits a fixed batch_size, so this holds per config)."""
    if batch.packed is None:
        return None
    n_shards = mesh.shape.get(data_axis)
    if not n_shards:
        return None
    arrays = batch.as_dict()
    if any(not v.flags.c_contiguous for v in arrays.values()):
        return None
    plan = packed_shard_layout(
        [(k, v.shape, str(v.dtype)) for k, v in arrays.items()], n_shards)
    if plan is None:
        return None
    shard_entries, stride = plan
    return shard_entries, stride, n_shards


def _local_layout(shard_entries, n_shards: int):
    """The unpack layout of one shard's block: each array's rows."""
    return tuple((name, off, nb, (shape[0] // n_shards,) + tuple(shape[1:]), dtype)
                 for name, off, nb, shape, dtype in shard_entries)


def _pack_shard(batch: Batch, shard_entries, n_shards: int, coord: int,
                out: np.ndarray) -> np.ndarray:
    """Copy shard ``coord``'s rows of every array into ``out`` (one
    shard's block of ``stride`` bytes) at their offsets."""
    arrays = batch.as_dict()
    for name, off, nb, _shape, _dtype in shard_entries:
        src = arrays[name].view(np.uint8).reshape(n_shards, nb)
        out[off : off + nb] = src[coord]
    return out


def _stage_per_array_mesh(batch: Batch, mesh, data_axis: str,
                          device: torch.device) -> Dict[str, torch.Tensor]:
    """This rank's rows of every array, one copy per array."""
    check(data_axis in mesh.shape,
          f"data axis {data_axis!r} is not an axis of the mesh {mesh.shape}")
    n = mesh.shape[data_axis]
    d = mesh.coords[data_axis]
    out = {}
    for k, v in batch.as_dict().items():
        check(v.shape[0] % n == 0,
              f"array {k!r} of shape {tuple(v.shape)}: the global size of its "
              f"dimension 0 should be divisible by {n}, the size of the data "
              f"axis {data_axis!r}, but it is equal to {v.shape[0]}")
        rows = v.shape[0] // n
        out[k] = torch.from_numpy(np.array(v[d * rows:(d + 1) * rows], copy=True)).to(device)
    return out


def stage_batch(batch: Batch, device: DeviceLike = None, mesh=None,
                data_axis: str = "data",
                stats: Optional[StagingStats] = None,
                local_rows: bool = False) -> Dict[str, torch.Tensor]:
    """One host Batch → dict of device tensors, synchronously: one u8
    copy unpacked by views when the batch is packed, else one copy per
    array. With a mesh, this rank's rows (its data coordinate's) on the
    mesh's device, one copy of its shard's block when the rows split;
    with ``local_rows`` as well, ``batch`` is this rank's own block and
    goes whole to the mesh's device, as on one device. The result never
    aliases the host batch."""
    if local_rows:
        check(mesh is not None, "local_rows stages a rank's block: it needs mesh=")
        device = mesh.device
    elif mesh is not None:
        dev = mesh.device
        plan = _shard_plan(batch, mesh, data_axis)
        if plan is None:
            out = _stage_per_array_mesh(batch, mesh, data_axis, dev)
            if stats is not None:
                stats.tick_batch("per_array", len(out), dev)
            return out
        shard_entries, stride, n_shards = plan
        src = _pack_shard(batch, shard_entries, n_shards, mesh.coords[data_axis],
                          np.zeros(stride, dtype=np.uint8))
        if stats is not None:
            stats.tick_batch("packed_shard", 1, dev)
        return _unpack(torch.from_numpy(src).to(dev), _local_layout(shard_entries, n_shards))
    dev = resolve_device(device)
    layout = packed_layout(batch)
    if layout is None:
        out = _per_array(batch, dev)
        if stats is not None:
            stats.tick_batch("per_array", len(out), dev)
        return out
    if stats is not None:
        stats.tick_batch("packed", 1, dev)
    return _unpack(torch.from_numpy(np.array(batch.packed, copy=True)).to(dev), layout)


class _PinnedSlot:
    """A reusable page-locked host buffer and the event of the last
    host→device copy that read it."""

    def __init__(self) -> None:
        self.buf: Optional[torch.Tensor] = None
        self.event: Optional[torch.cuda.Event] = None

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()
            self.event = None

    def get(self, n: int) -> torch.Tensor:
        """The first ``n`` bytes of the slot's pinned buffer."""
        if self.buf is None or self.buf.numel() < n:
            self.buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        return self.buf[:n]


class _Staged:
    """A batch whose device bytes may still be in flight."""

    __slots__ = ("u8", "event", "layout", "arrays")

    def __init__(self, u8=None, event=None, layout=None, arrays=None) -> None:
        self.u8 = u8
        self.event = event
        self.layout = layout
        self.arrays = arrays

    def ready(self) -> Dict[str, torch.Tensor]:
        """The batch, usable on the caller's current stream."""
        if self.arrays is not None:
            return self.arrays
        if self.event is not None:
            stream = torch.cuda.current_stream(self.u8.device)
            stream.wait_event(self.event)
            self.u8.record_stream(stream)
        return _unpack(self.u8, self.layout)


class _CudaCopier:
    """Host→device copies to one card, each on the copy stream with its
    event: a packed batch through one of ``depth + 2`` pinned slots, a
    direct one from the producer's buffer, kept referenced until its
    copy's event has completed (at most ``depth + 2`` in flight)."""

    def __init__(self, device: torch.device, depth: int, stage) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.slots = [_PinnedSlot() for _ in range(depth + 2)]
        self._slot_i = 0
        self._inflight = _InFlight(depth + 2)
        self._stage = stage
        self.pinning = _cuda_pinning()
        self.direct_pinned = 0  # direct copies whose source was page-locked

    def context(self):
        return torch.cuda.device(self.device)

    def _copy(self, src: torch.Tensor):
        """(device u8 tensor, event) of one copy of ``src`` on the stream."""
        with torch.cuda.stream(self.stream):
            u8 = torch.empty(src.numel(), dtype=torch.uint8, device=self.device)
            u8.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return u8, event

    def pack(self, nbytes: int, fill, layout) -> _Staged:
        """``fill(dst)`` writes the batch's ``nbytes`` into a pinned slot,
        then one copy to the device."""
        slot = self.slots[self._slot_i]
        self._slot_i = (self._slot_i + 1) % len(self.slots)
        if slot.event is not None:
            with self._stage("dispatch_slot_wait"):
                slot.wait()
        with self._stage("dispatch_pack"):
            src = slot.get(nbytes)
            fill(src)
        with self._stage("dispatch_put"):
            u8, slot.event = self._copy(src)
        return _Staged(u8=u8, event=slot.event, layout=layout)

    def direct(self, packed: np.ndarray, layout) -> _Staged:
        """The copy straight from the producer's buffer."""
        self._inflight.prune()
        if self._inflight.full():
            with self._stage("dispatch_slot_wait"):
                self._inflight.wait_oldest()
        with self._stage("dispatch_put"):
            src = torch.from_numpy(packed)
            if src.is_pinned():
                self.direct_pinned += 1
            u8, event = self._copy(src)
            self._inflight.add(event, packed)
        return _Staged(u8=u8, event=event, layout=layout)

    def drain(self) -> None:
        """Wait for the direct copies still in flight."""
        self._inflight.drain()


class _CpuCopier:
    """Hand-overs on the CPU: a packed batch is copied into a fresh
    buffer, a direct one shares the producer's buffer. On the CPU the
    put is the hand-over of the bytes; it is a stage all the same, as in
    the JAX pipeline."""

    slots = ()
    pinning = None  # nothing is page-locked for the CPU
    direct_pinned = 0

    def __init__(self, stage) -> None:
        self._stage = stage

    def context(self):
        return contextlib.nullcontext()

    def pack(self, nbytes: int, fill, layout) -> _Staged:
        with self._stage("dispatch_pack"):
            u8 = torch.empty(nbytes, dtype=torch.uint8)
            fill(u8)
        with self._stage("dispatch_put"):
            return _Staged(u8=u8, layout=layout)

    def direct(self, packed: np.ndarray, layout) -> _Staged:
        # the tensor holds the array, so the producer cannot recycle it
        # under the consumer
        with self._stage("dispatch_put"):
            return _Staged(u8=torch.from_numpy(packed), layout=layout)

    def drain(self) -> None:
        pass


class StagingPipeline:
    """Iterator of device-resident batch dicts with double buffering.

    ``host_batches`` is any iterable of Batch, pulled on a background
    thread (``prefetch`` batches queued); a transfer thread keeps
    ``depth`` staged batches in flight. ``device`` defaults to ``cuda``,
    or with ``mesh`` (a ``parallel.Mesh``) to the mesh's device, and then
    each batch is this rank's rows of it over ``data_axis``. With
    ``local_rows`` each host batch is already this rank's block (its
    part ``process_shard(mesh)``), staged whole, and the ranks of a data
    line take the same number of steps (the module docstring).
    """

    def __init__(
        self,
        host_batches: Iterable[Batch],
        device: DeviceLike = None,
        mesh=None,
        data_axis: str = "data",
        depth: int = 2,
        prefetch: int = 2,
        local_rows: bool = False,
    ) -> None:
        check(mesh is not None or not local_rows,
              "local_rows stages a rank's block: it needs mesh=")
        self._local_rows = local_rows
        # the data line's group that the end-of-part exchange runs on
        # (None: a data axis of one rank, nothing to agree on)
        self._line = mesh.group((data_axis,)) if local_rows else None
        self._source = host_batches
        self._spec = getattr(host_batches, "spec", None)
        self._pad_layout = None
        self._part_ended = False
        self.padding_batches = 0
        self._mesh = None if local_rows else mesh
        self._data_axis = data_axis
        self._device = mesh.device if mesh is not None and device is None else (
            resolve_device(device))
        self._plan_memo: Dict[Any, Any] = {}
        self._depth = max(1, depth)
        # a ring producer recycles its host buffers: its ring must outlast
        # every batch this pipeline can hold at once
        ring = getattr(host_batches, "ring_slots", None)
        if ring is not None:
            need, parts = _ring_bounds(prefetch, self._depth)["alive"]
            check(ring >= need, f"producer ring has {ring} slots but the pipeline "
                                f"keeps up to {need} batches alive ({parts})")
        self.rows_staged = 0
        self.batches_staged = 0
        self.bytes_staged = 0
        self.close_timed_out = False
        why = pack_reason(host_batches, self._device, self._mesh is not None,
                          prefetch, self._depth)
        if why is not None and ring is not None:
            logger.debug("ring slots packed: %s", why)
        # which buffers go to the device as they are: none, an adopting
        # producer's ("adopted": its promise covers any page-aligned one)
        # or a ring's ("ring": a slot that is also pinned)
        self._direct = None if why is not None else (
            "adopted" if getattr(host_batches, "adopt_slots", False) else "ring")
        self.slots_adopted = 0
        # wall seconds per stage; the transfer thread's stages overlap
        # the consumer's, so the sum may exceed wall time
        self.stage_seconds: Dict[str, float] = {
            "host_pull": 0.0,
            "dispatch_pack": 0.0,
            "dispatch_put": 0.0,
            "dispatch_slot_wait": 0.0,
            "stage_dispatch": 0.0,
            "transfer_wait": 0.0,
        }
        self.staging = StagingStats()
        self._t_start: Optional[float] = None
        self._copier = (_CudaCopier(self._device, self._depth, self._stage)
                        if self._device.type == "cuda" else _CpuCopier(self._stage))
        pinning = self._copier.pinning if self._direct else None
        self._host_iter = Prefetcher(
            lambda: _produced(host_batches, pinning), prefetch, "staging"
        )
        self._xfer_iter = Prefetcher(self._staged, self._depth, "staging-xfer")

    def _observe(self, key: str, dt: float) -> None:
        self.stage_seconds[key] += dt
        if key in _DISPATCH:
            self.stage_seconds["stage_dispatch"] += dt
        _STAGE_HISTS[key].observe(dt)

    @contextlib.contextmanager
    def _stage(self, key: str, span: Optional[str] = None):
        """Time the block as stage ``key``, under ``dmlc:<span or key>``."""
        t0 = time.perf_counter()
        with annotate(f"dmlc:{span or key}"):
            yield
        self._observe(key, time.perf_counter() - t0)

    def _plan_for(self, host: Batch):
        """``_shard_plan`` for this pipeline's mesh, memoized by the
        arrays' shapes and dtypes (contiguity is checked per batch)."""
        if host.packed is None:
            return None
        arrays = host.as_dict()
        key = tuple((k, v.shape, str(v.dtype)) for k, v in arrays.items())
        if key not in self._plan_memo:
            self._plan_memo[key] = _shard_plan(host, self._mesh, self._data_axis)
        plan = self._plan_memo[key]
        if plan is not None and any(not v.flags.c_contiguous for v in arrays.values()):
            return None
        return plan

    def _goes_direct(self, host: Batch) -> bool:
        """Whether ``host.packed`` goes to the device as it is: a
        page-aligned buffer of an adopting producer, or a page-aligned
        pinned slot of a ring copied in place."""
        if self._direct is None or not adoptable_slot(host):
            return False
        return self._direct == "adopted" or torch.from_numpy(host.packed).is_pinned()

    def _put(self, host: Batch) -> _Staged:
        """Start one batch's copy on its route: mesh shard, per array,
        direct or pack."""
        dev = self._device
        layout = None
        if self._mesh is not None:
            plan = self._plan_for(host)
            if plan is not None:
                shard_entries, stride, n_shards = plan
                coord = self._mesh.coords[self._data_axis]
                item = self._copier.pack(
                    stride,
                    lambda dst: _pack_shard(host, shard_entries, n_shards, coord,
                                            dst.numpy()),
                    _local_layout(shard_entries, n_shards))
                self.staging.tick_batch("packed_shard", 1, dev)
                return item
        else:
            layout = packed_layout(host)
            if self._local_rows and layout is not None and self._pad_layout is None:
                self._pad_layout = (layout, host.packed.nbytes)
        if layout is None:
            with self._stage("dispatch_put", span="stage"):
                arrays = (_per_array(host, dev) if self._mesh is None else
                          _stage_per_array_mesh(host, self._mesh, self._data_axis, dev))
            self.staging.tick_batch("per_array", len(arrays), dev)
            return _Staged(arrays=arrays)
        packed = host.packed
        if self._goes_direct(host):
            item = self._copier.direct(packed, layout)
            self.slots_adopted += 1
            _SLOTS_ADOPTED.inc()
        else:
            if self._direct == "adopted":  # adopt-capable, but not page-aligned
                _SLOT_COPIES.inc()
            item = self._copier.pack(packed.nbytes,
                                     lambda dst: dst.copy_(torch.from_numpy(packed)),
                                     layout)
        self.staging.tick_batch("packed", 1, dev)
        return item

    def _staged(self) -> Iterator[_Staged]:
        """Transfer thread: pull host batches, start their copies."""
        with self._copier.context():
            while True:
                with self._stage("host_pull"):
                    host = self._host_iter.next()
                if host is None:
                    return
                item = self._put(host)
                nbytes = sum(v.nbytes for v in host.as_dict().values())
                self.rows_staged += host.n_valid
                self.batches_staged += 1
                self.bytes_staged += nbytes
                _ROWS_STAGED.inc(host.n_valid)
                _BYTES_STAGED.inc(nbytes)
                del host  # release the producer's slot before blocking downstream
                yield item

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        if self._t_start is None:
            self._t_start = time.perf_counter()
        # the finally also tears the threads down when the consumer
        # abandons the iterator
        try:
            while True:
                t0 = time.perf_counter()
                with annotate("dmlc:transfer_wait"):
                    item = None if self._part_ended else self._xfer_iter.next()
                    self._part_ended = item is None
                    more = (item is not None if self._line is None
                            else self._any_part_left(item is not None))
                    if not more:
                        return
                    dev = item.ready() if item is not None else self._padding()
                self._observe("transfer_wait", time.perf_counter() - t0)
                yield dev
        finally:
            self.close()

    def _any_part_left(self, have: bool) -> bool:
        """Whether any rank of this data line still has a batch of its
        part (one all_reduce on the line's group, on the consumer's
        thread: a tensor on the CPU for gloo, on the card for NCCL)."""
        import torch.distributed as dist

        on = "cpu" if dist.get_backend(self._line) == "gloo" else self._device
        flag = torch.tensor([int(have)], dtype=torch.int32, device=on)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._line)
        return bool(flag.item())

    def _padding(self) -> Dict[str, torch.Tensor]:
        """A batch of this part's layout whose every row is padding: the
        zeros a padded tail row holds, weight 0."""
        if self._pad_layout is None:
            check(self._spec is not None,
                  "this rank's part held no batch, and its source has no "
                  "BatchSpec (.spec) to lay out a padding batch")
            from .batcher import alloc_dense_slot, alloc_ell_slot

            alloc = alloc_dense_slot if self._spec.layout == "dense" else alloc_ell_slot
            buf, views = alloc(self._spec)
            self._pad_layout = (packed_layout(Batch(n_valid=0, packed=buf, **views)),
                                buf.nbytes)
        layout, nbytes = self._pad_layout
        self.padding_batches += 1
        return _unpack(torch.zeros(nbytes, dtype=torch.uint8, device=self._device), layout)

    def throughput(self) -> Dict[str, float]:
        """rows/s and MB/s since the first iteration, with stage seconds."""
        now = time.perf_counter()
        dt = max(now - (self._t_start or now), 1e-9)
        return {
            "rows_per_sec": self.rows_staged / dt,
            "mb_per_sec": self.bytes_staged / dt / 1e6,
            "seconds": dt,
            "rows": float(self.rows_staged),
            "batches": float(self.batches_staged),
            **{f"secs_{k}": v for k, v in self.stage_seconds.items()},
        }

    def staging_stats(self) -> Dict[str, Any]:
        """Transfer counts by path and the pinned ring's shape; with local
        rows, also the all-padding batches yielded after this part ended.
        A local-rows batch counts as one packed copy, where the JAX
        multi-process branch counts one put per array and local device
        under ``per_array``."""
        out = self.staging.snapshot()
        out["dispatch_ring_depth"] = self._depth
        out["dispatch_ring_slots"] = len(self._copier.slots)
        out["slots_adopted"] = self.slots_adopted
        out["slots_adopted_pinned"] = self._copier.direct_pinned
        if self._local_rows:
            out["padding_batches"] = self.padding_batches
        return out

    def io_stats(self) -> Dict[str, Any]:
        """The batch source's counters (its split's I/O shape, retries and
        faults) with ``staging_stats()`` under ``"staging"``: the last hop
        of split → producer → pipeline."""
        fn = getattr(self._source, "io_stats", None)
        src = fn() if fn is not None else None
        out: Dict[str, Any] = dict(src) if src else {}
        out["staging"] = self.staging_stats()
        return out

    def close(self) -> bool:
        """Stop both threads with bounded joins (host side first, so a
        transfer thread blocked on it wakes). Returns False — and latches
        ``close_timed_out`` — when a join timed out: the orphaned thread
        may still read the batch source."""
        host_joined = self._host_iter.destroy(timeout=1.0)
        xfer_joined = self._xfer_iter.destroy(timeout=1.0)
        if not (host_joined and xfer_joined):
            self.close_timed_out = True
        else:
            self._copier.drain()  # the direct copies' sources are released
        return host_joined and xfer_joined


def drain_close(pipe: StagingPipeline, *sources) -> bool:
    """Close a StagingPipeline, then its batch sources — unless the
    teardown join timed out: an orphaned producer thread may still read
    the sources' buffers, so they are left to process teardown. Returns
    True when everything closed cleanly."""
    if not pipe.close():
        logger.warning(
            "staging teardown join timed out; deferring close of %d "
            "batch source(s) to process teardown", len(sources),
        )
        return False
    for s in sources:
        close = getattr(s, "close", None)
        if close is not None:
            close()
    return True
