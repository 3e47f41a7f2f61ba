"""Fixed-shape batching of ragged RowBlocks, in two layouts.

- ``ell``: ``indices i32[B,K]``, ``values f32|f16[B,K]`` (zero padded) and
  per-row ``nnz i32[B]``. Rows wider than K keep their first K features
  ('truncate', counted) or raise ('error'); ids that do not fit the index
  dtype leave their slot zero and are counted the same way.
- ``dense``: ``x f32|f16[B,D]`` (HIGGS-style tabular rows). Ids >= D
  (wrapped negatives included) are dropped and counted, or raise;
  duplicate ids in a row add up.

Both carry ``labels f32[B]`` and ``weights f32[B]``, and every array is a
view into ONE contiguous uint8 buffer (``Batch.packed``) whose sections
start on ``PACK_ALIGN`` boundaries, so the staging pipeline moves a batch
in a single host→device copy. A partial final batch is zero padded to B
rows with weight 0, so models use ``weights`` as the validity mask.

A ring producer allocates its ring (``alloc_ring``) on the thread that
first drains it: numpy buffers, or the page-locked slots of the
pinning that thread runs under (``host_pinning``: that of a CUDA
staging pipeline that copies directly).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..data.row_block import RowBlock
from ..utils.logging import Error, check

__all__ = [
    "PACK_ALIGN",
    "Batch",
    "BatchSpec",
    "FixedShapeBatcher",
    "alloc_dense_slot",
    "alloc_ell_slot",
    "alloc_packed_slot",
    "alloc_ring",
    "current_host_pinning",
    "gather_slices",
    "host_pinning",
    "packed_layout",
    "packed_shard_layout",
]

# every section starts on an 8-byte boundary (the widest staged dtype),
# so host views and the on-device ``Tensor.view(dtype)`` slices are aligned
PACK_ALIGN = 8


def _aligned(nbytes: int) -> int:
    return (nbytes + PACK_ALIGN - 1) & ~(PACK_ALIGN - 1)


def alloc_packed_slot(sections, host=None):
    """One zeroed contiguous uint8 buffer + named views into it.

    ``sections`` is [(name, shape, dtype)]; each section's offset is
    PACK_ALIGN aligned. ``host(nbytes)``, when given, makes the buffer
    (zeroed uint8 of ``nbytes``). Returns (buf, views)."""
    offs = []
    off = 0
    for _name, shape, dtype in sections:
        nb = int(np.prod(shape)) * np.dtype(dtype).itemsize
        offs.append((off, nb))
        off += _aligned(nb)
    buf = np.zeros(off, dtype=np.uint8) if host is None else host(off)
    views = {}
    for (o, nb), (name, shape, dtype) in zip(offs, sections):
        views[name] = buf[o : o + nb].view(dtype).reshape(shape)
    return buf, views


def gather_slices(buf: np.ndarray, starts: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """``buf[starts[i] : starts[i] + sizes[i]]`` back to back in one uint8
    array, gathered through one index array (``np.repeat``) with no
    per-slice loop: the numpy form of the shuffled reads' gather."""
    starts = np.asarray(starts, dtype=np.int64)
    sizes = np.asarray(sizes, dtype=np.int64)
    total = int(sizes.sum())
    if not total:
        return np.empty(0, dtype=np.uint8)
    base = np.cumsum(sizes) - sizes
    return buf[np.arange(total, dtype=np.int64) + np.repeat(starts - base, sizes)]


@dataclass(frozen=True)
class Batch:
    """One fixed-shape host batch; ``n_valid`` rows are real, the rest are
    zero padding with weight 0. 'ell' sets indices/values/nnz, 'dense'
    sets x. ``packed`` is the buffer the other arrays view into."""

    labels: np.ndarray
    weights: np.ndarray
    n_valid: int
    indices: Optional[np.ndarray] = None
    values: Optional[np.ndarray] = None
    nnz: Optional[np.ndarray] = None
    x: Optional[np.ndarray] = None
    packed: Optional[np.ndarray] = None

    @property
    def batch_size(self) -> int:
        return len(self.labels)

    def as_dict(self) -> Dict[str, np.ndarray]:
        """The arrays that land on the device, by name."""
        out = {"labels": self.labels, "weights": self.weights}
        if self.x is not None:
            out["x"] = self.x
        else:
            out.update(indices=self.indices, values=self.values, nnz=self.nnz)
        return out


def packed_layout(batch: Batch):
    """(name, offset, nbytes, shape, dtype) per array, from the views'
    addresses inside ``batch.packed`` — or None when an array is not a
    dense C-contiguous view into it (a strided view can have bounds
    inside the buffer without its bytes being the run [off, off+nbytes))."""
    try:  # numpy >= 2.0 moved it; 1.x has the top-level name
        from numpy.lib.array_utils import byte_bounds
    except ImportError:
        byte_bounds = np.byte_bounds

    packed = batch.packed
    if packed is None or not packed.flags.c_contiguous:
        return None
    base, end = byte_bounds(packed)
    layout = []
    for k, v in batch.as_dict().items():
        if not v.flags.c_contiguous:
            return None
        lo, hi = byte_bounds(v)
        if lo < base or hi > end:
            return None
        layout.append((k, lo - base, v.nbytes, v.shape, str(v.dtype)))
    return tuple(layout)


def packed_shard_layout(entries, n_shards: int):
    """Per-shard packing plan for a batch split by rows over ``n_shards``.

    ``entries`` is [(name, shape, dtype)]; every shape's leading dim must
    divide by ``n_shards``, else None (the caller stages per array).
    Returns (shard_entries, stride): ``shard_entries`` is
    [(name, seg_off, seg_nbytes, global_shape, dtype)], ``seg_off`` the
    PACK_ALIGN-aligned offset of the array's rows INSIDE one shard's
    contiguous block, and ``stride`` the aligned size of that block, so
    shard ``d`` of the batch is bytes ``[d*stride, (d+1)*stride)`` of the
    repacked buffer and rides one copy."""
    shard_entries = []
    off = 0
    for name, shape, dtype in entries:
        if not shape or shape[0] % n_shards:
            return None
        rows = shape[0] // n_shards
        nb = rows * int(np.prod(shape[1:], dtype=np.int64)) * np.dtype(dtype).itemsize
        shard_entries.append((name, off, int(nb), tuple(shape), str(dtype)))
        off += _aligned(int(nb))
    return tuple(shard_entries), off


@dataclass
class BatchSpec:
    """Static-shape contract for a batch stream.

    batch_size: rows per batch. layout: 'ell' or 'dense'. max_nnz: K
    ('ell'). num_features: D ('dense'). overflow: 'truncate' | 'error'.
    value_dtype: float32 or float16 staged feature values (labels and
    weights stay float32)."""

    batch_size: int
    layout: str = "ell"
    max_nnz: Optional[int] = None
    num_features: Optional[int] = None
    overflow: str = "truncate"
    index_dtype: np.dtype = np.dtype(np.int32)
    value_dtype: np.dtype = np.dtype(np.float32)

    def __post_init__(self) -> None:
        check(self.layout in ("ell", "dense"), f"bad layout {self.layout!r}")
        check(self.overflow in ("truncate", "error"),
              f"bad overflow policy {self.overflow!r}")
        if self.layout == "ell":
            check(self.max_nnz is not None and self.max_nnz > 0,
                  "ell layout requires max_nnz")
        else:
            check(self.num_features is not None and self.num_features > 0,
                  "dense layout requires num_features")
        self.index_dtype = np.dtype(self.index_dtype)
        self.value_dtype = np.dtype(self.value_dtype)


def alloc_ell_slot(spec: BatchSpec, host=None):
    """(packed buffer, views) in the section order every ELL producer uses:
    indices, values, nnz, labels, weights."""
    B, K = spec.batch_size, int(spec.max_nnz)
    return alloc_packed_slot([
        ("indices", (B, K), spec.index_dtype),
        ("values", (B, K), spec.value_dtype),
        ("nnz", (B,), np.int32),
        ("labels", (B,), np.float32),
        ("weights", (B,), np.float32),
    ], host)


def alloc_dense_slot(spec: BatchSpec, host=None):
    """(packed buffer, views) in the section order every dense producer
    uses: x, labels, weights."""
    B, D = spec.batch_size, int(spec.num_features)
    return alloc_packed_slot([
        ("x", (B, D), spec.value_dtype),
        ("labels", (B,), np.float32),
        ("weights", (B,), np.float32),
    ], host)


_HOST = threading.local()


@contextlib.contextmanager
def host_pinning(pinning):
    """Inside the block, producers on this thread take page-locked host
    memory from ``pinning`` (None: none): a ring that ``alloc_ring``
    makes takes each slot's buffer from ``pinning.ring_slot(nbytes)``, a
    zeroed page-aligned uint8 array, and a dsserve client installs it in
    its receive pool (``pinning.bank``, ``register``, ``unregister``).
    A CUDA staging pipeline that copies directly drains its producer
    under it, so a producer that first iterates there, through any
    wrapper that iterates it on that thread, gets the pipeline's
    pinning; a producer drained elsewhere keeps unpinned buffers."""
    prev = getattr(_HOST, "pinning", None)
    _HOST.pinning = pinning
    try:
        yield
    finally:
        _HOST.pinning = prev


def current_host_pinning():
    """The ``host_pinning`` this thread runs under, or None."""
    return getattr(_HOST, "pinning", None)


def alloc_ring(alloc_slot, spec: BatchSpec, slots: int):
    """``slots`` (packed buffer, views) pairs of ``alloc_slot`` (
    ``alloc_ell_slot`` or ``alloc_dense_slot``), from this thread's
    ``host_pinning`` when it runs under one, else numpy."""
    pinning = current_host_pinning()
    host = pinning.ring_slot if pinning is not None else None
    return [alloc_slot(spec, host) for _ in range(slots)]


def fill_dense_rows(views, blk: RowBlock, spec: BatchSpec) -> int:
    """Write ``blk`` into the first ``blk.size`` rows of a fresh dense
    slot; returns the count of features dropped (ids >= D, compared as
    uint64 so wrapped negatives count too). Duplicate ids in a row add."""
    D = int(spec.num_features)
    x = views["x"]
    m = blk.size
    dropped = 0
    if blk.nnz:
        nnz_per_row = np.diff(blk.offset)
        keep = blk.index.astype(np.uint64, copy=False) < np.uint64(D)
        idx = blk.index.astype(np.int64)
        dropped = int((~keep).sum())
        if dropped and spec.overflow == "error":
            raise Error(f"feature index {int(idx.max())} >= num_features={D}")
        vals = (
            blk.value if blk.value is not None
            else np.ones(blk.nnz, dtype=np.float32)
        )
        # uniform row width with increasing ids (every tabular format):
        # one fancy assignment instead of the slower np.add.at scatter
        k0 = int(nnz_per_row[0]) if m else 0
        uniform = k0 > 0 and not dropped and np.all(nnz_per_row == k0)
        if uniform:
            idx2 = idx.reshape(m, k0)
            uniform = k0 == 1 or bool(np.all(idx2[:, 1:] > idx2[:, :-1]))
        # f32→f16 rounds to nearest and saturates to ±inf (chosen policy)
        with np.errstate(over="ignore"):
            if uniform:
                x[np.arange(m)[:, None], idx2] = vals.reshape(m, k0)
            else:
                row_ids = np.repeat(np.arange(m), nnz_per_row)
                np.add.at(x, (row_ids[keep], idx[keep]), vals[keep])
    views["labels"][:m] = blk.label
    views["weights"][:m] = 1.0 if blk.weight is None else blk.weight
    return dropped


def fill_ell_rows(views, row0: int, blk: RowBlock, spec: BatchSpec) -> int:
    """Write ``blk`` into rows ``[row0, row0 + blk.size)`` of an ELL slot
    (overwriting whatever a recycled slot held there); returns the count
    of features dropped (beyond K, or ids that do not fit the index
    dtype). Feature positions are kept: a dropped id leaves index 0 and
    value 0 in its slot, and ``nnz`` counts the features kept."""
    K = int(spec.max_nnz)
    m = blk.size
    rows = slice(row0, row0 + m)
    indices, values = views["indices"], views["values"]
    nnz_per_row = np.diff(blk.offset)
    over = nnz_per_row - K
    dropped = int(over[over > 0].sum()) if m else 0
    if dropped and spec.overflow == "error":
        raise Error(
            f"row nnz exceeds max_nnz={K} "
            f"(worst row has {int(nnz_per_row.max())})"
        )
    imax = np.uint64(np.iinfo(spec.index_dtype).max)
    vals = (
        blk.value if blk.value is not None
        else np.ones(blk.nnz, dtype=np.float32)
    )
    idx64 = blk.index.astype(np.uint64, copy=False)
    indices[rows] = 0
    values[rows] = 0
    k0 = int(nnz_per_row[0]) if m else 0
    # f32→f16 rounds to nearest and saturates to ±inf; that is the
    # chosen policy, so numpy's overflow warning is silenced
    with np.errstate(over="ignore"):
        if blk.nnz and 0 < k0 <= K and np.all(nnz_per_row == k0) and (
            int(idx64.max()) <= imax
        ):
            # uniform row width that fits: a reshape copy, no scatter
            indices[rows, :k0] = idx64.reshape(m, k0).astype(spec.index_dtype)
            values[rows, :k0] = vals.reshape(m, k0)
            nnz_kept = np.full(m, k0, dtype=np.int64)
        elif blk.nnz:
            row_ids = np.repeat(np.arange(m), nnz_per_row)
            pos = np.arange(blk.nnz) - np.repeat(blk.offset[:-1], nnz_per_row)
            keep = pos < K
            fits = idx64 <= imax
            n_unfit = int((keep & ~fits).sum())
            if n_unfit:
                if spec.overflow == "error":
                    raise Error(
                        f"feature index {int(idx64.max())} does not fit "
                        f"index dtype {spec.index_dtype}"
                    )
                dropped += n_unfit
                keep &= fits
            r, p = row0 + row_ids[keep], pos[keep]
            indices[r, p] = idx64[keep].astype(spec.index_dtype)
            values[r, p] = vals[keep]
            nnz_kept = np.bincount(row_ids[keep], minlength=m)
        else:
            nnz_kept = np.zeros(m, dtype=np.int64)
    views["nnz"][rows] = nnz_kept
    views["labels"][rows] = blk.label
    views["weights"][rows] = 1.0 if blk.weight is None else blk.weight
    return dropped


def pad_tail(views, fill: int) -> None:
    """Zero rows ``[fill:]`` of a (possibly recycled) slot: padding rows
    carry weight 0."""
    for v in views.values():
        v[fill:] = 0


def ell_batch(packed: np.ndarray, views, n_valid: int) -> Batch:
    return Batch(
        labels=views["labels"], weights=views["weights"], n_valid=n_valid,
        indices=views["indices"], values=views["values"], nnz=views["nnz"],
        packed=packed,
    )


class FixedShapeBatcher:
    """RowBlock stream → fixed-shape Batch stream in ``spec.layout``.
    Carries a partial remainder between blocks; the final batch is zero
    padded. Each batch owns a fresh packed buffer."""

    def __init__(self, spec: BatchSpec) -> None:
        self.spec = spec
        self.truncated_nnz = 0
        self._pending: List[RowBlock] = []
        self._pending_rows = 0

    def _emit(self, blk: RowBlock) -> Batch:
        if self.spec.layout == "dense":
            packed, views = alloc_dense_slot(self.spec)
            self.truncated_nnz += fill_dense_rows(views, blk, self.spec)
            return Batch(labels=views["labels"], weights=views["weights"],
                         n_valid=blk.size, x=views["x"], packed=packed)
        packed, views = alloc_ell_slot(self.spec)
        self.truncated_nnz += fill_ell_rows(views, 0, blk, self.spec)
        return ell_batch(packed, views, blk.size)

    def _merged(self) -> RowBlock:
        return (
            self._pending[0] if len(self._pending) == 1
            else RowBlock.concat(self._pending)
        )

    def push(self, blk: RowBlock) -> Iterator[Batch]:
        """Feed one RowBlock; yields zero or more full batches."""
        if blk.size == 0:
            return
        self._pending.append(blk)
        self._pending_rows += blk.size
        B = self.spec.batch_size
        while self._pending_rows >= B:
            merged = self._merged()
            rest = merged.size - B
            self._pending = [merged.slice(B, merged.size)] if rest else []
            self._pending_rows = rest
            yield self._emit(merged.slice(0, B))

    def flush(self) -> Optional[Batch]:
        """The final zero-padded partial batch, if any."""
        if not self._pending_rows:
            return None
        merged = self._merged()
        self._pending = []
        self._pending_rows = 0
        return self._emit(merged)

    def batches(self, blocks) -> Iterator[Batch]:
        """Whole stream → batches, flushing at the end."""
        for blk in blocks:
            yield from self.push(blk)
        tail = self.flush()
        if tail is not None:
            yield tail
