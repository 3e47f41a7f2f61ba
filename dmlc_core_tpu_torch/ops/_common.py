"""Argument checks, dispatch and the gradient scatters' scratch, shared
by the kernel-backed ops."""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

from ..utils.logging import Error
from . import _build

_VALUE_DTYPES = (torch.float32, torch.float16)


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when all are on
    the CPU; raises on a mix or any other device."""
    types = {t.device.type for t in tensors}
    if types == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise Error("tensors lie on different CUDA devices")
        return True
    if types == {"cpu"}:
        return False
    raise Error(f"tensors must all be on one CUDA device or all on the CPU, got {types}")


def wrap_index(indices: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """jnp.take's index rule as (row, valid): [0, n) reads itself,
    [-n, -1] wraps to idx + n, anything else is invalid (NaN forward,
    dropped by the gradient); invalid rows come back as 0."""
    j = indices.long()
    j = torch.where(j < 0, j + n, j)
    valid = (j >= 0) & (j < n)
    return torch.where(valid, j, 0), valid


def require(t: torch.Tensor, name: str, dtypes, shape) -> None:
    """Raise unless ``t`` is contiguous with a dtype in ``dtypes`` and
    ``shape`` (None entries match any size)."""
    if t.dtype not in dtypes:
        raise Error(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != len(shape) or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise Error(f"{name}: shape {tuple(t.shape)} does not match {shape}")
    if not t.is_contiguous():
        raise Error(f"{name}: must be contiguous")


def check_ell(indices: torch.Tensor, values: torch.Tensor) -> Tuple[int, int]:
    """(B, K) of a kernel's ELL operands: int32 indices and f32/f16
    values, both [B, K] and contiguous."""
    require(indices, "indices", (torch.int32,), (None, None))
    require(values, "values", _VALUE_DTYPES, tuple(indices.shape))
    return int(indices.shape[0]), int(indices.shape[1])


# entries of the flat batch a scatter tile takes (kTile in ell_kernels.cu);
# a partial's slot must stay below 2^30 (kSlotBias)
SCATTER_TILE = 256
_MAX_ENTRIES = (1 << 30) - SCATTER_TILE

# (device index, stream) -> the lock and scratch of that stream's
# scatters: the tile lists, which each call writes in full before its
# flush reads them, and the records, accumulators and flags, which every
# completed call leaves zeroed. Calls on one stream run in order, so they
# share one set; the lock keeps one call's tile and flush launches
# together when host threads share a stream (the launch releases the GIL)
_kept: Dict[Tuple[int, int], Tuple[threading.Lock, Dict[str, torch.Tensor]]] = {}
_kept_lock = threading.Lock()


def launch_scatter(name: str, device: torch.device, args, num_rows: int, entries: int,
                   cols: int) -> None:
    """Launch gradient scatter ``name`` (K2: ``cols`` 1, K4: E; its tile
    and flush kernels) over ``entries`` = B*K flat entries into
    ``num_rows`` rows on ``device``'s current stream, with the stream's
    scratch appended in the kernels' argument order: tile rows,
    partials, runs, records, accumulators, flags. A refused launch may
    leave records behind, so its stream's scratch is dropped (the next
    call zeroes a new one)."""
    if entries > _MAX_ENTRIES:
        raise Error(f"a gradient scatter takes at most {_MAX_ENTRIES} entries (B*K), "
                    f"got {entries}")
    tiles = -(-entries // SCATTER_TILE)
    slots = tiles * SCATTER_TILE
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    # a record of 4 int32 a row, the rows interleaved 16 ways
    need = {"rows": (slots, torch.int64, torch.empty),
            "parts": (slots * cols, torch.float32, torch.empty),
            "runs": (tiles, torch.int32, torch.empty),
            "meta": (4 * 16 * -(-max(num_rows, 1) // 16), torch.int32, torch.zeros),
            "acc": (slots * cols, torch.int64, torch.zeros),
            "flags": (slots * cols, torch.int32, torch.zeros)}
    with _kept_lock:
        lock, kept = _kept.setdefault(key, (threading.Lock(), {}))
    with lock:
        for part, (n, dtype, make) in need.items():
            if part not in kept or kept[part].numel() < n:
                kept[part] = make(n, dtype=dtype, device=device)
        try:
            _build.launch(name, device, *args, *(kept[part].data_ptr() for part in need))
        except Error:
            kept.clear()
            raise
