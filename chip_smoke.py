"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card's name and power limit (nvidia-smi) and device name;
2. build the hand-written CUDA kernels (ops/csrc/ell_kernels.cu) and
   report each instance's registers, spills and shared memory (ptxas);
3. each kernel at the Criteo slice's shapes (B=2048, K=39, E=16, D=2^20)
   against its plain PyTorch version on the card, on inputs with
   duplicate, padding, wrapped-negative and out-of-range indices and
   f32 and f16 values, and again at the edge shapes the kernels' designs
   branch on (K in {1, 33, 39, 64}, E in {1, 5, 16}, E = 33 and 64 in
   chunks of the gradient scatters, B a multiple of no block's rows nor
   B*K of the scatters' tiles), on the scatters' own edge inputs (every
   row naming the same K rows; every entry naming its own row, so a
   tile's table holds a whole tile of keys) and on a dense gradient that
   is not 16-byte aligned (through the C entry point); then the kernel,
   the plain version and a one-call PyTorch yardstick timed with CUDA
   events on Criteo-shaped inputs, beside the time of an empty launch
   (``floor_us``) and, for the scatters, of the zero-fill of their dense
   gradient (``zero_fill_us``);
4. the native producers on the host alone (no card): Criteo rowrec → ELL
   (f16 and f32), Criteo sparse libsvm and libfm → ELL, HIGGS libsvm and
   csv → dense, each held bit for bit against its plain version
   (``plain_batches``: the numpy rowrec decoder, or the text parser's
   Python grammar → ``FixedShapeBatcher``; neither runs the native parse
   core) on one block of rows, then timed in rows/s over a file of 2^18
   rows with one producer and with the thread count ``picked_threads``
   gives, and the plain version timed over the block, beside the host's
   CPU counts;
5. the slices, each producer → ``StagingPipeline(device="cuda")`` → SGD
   steps, after a warm-up pass once with one producer thread and once
   with ``picked_threads`` sub-shards (the main run: the kernels' launch counts read around it,
   finite falling loss, row-weighted, and the first staged batch equal
   to the host bytes): a synthetic
   Criteo-shaped rowrec shard (32 batches of rows, written 4 times over) → ``ell_batches`` → FactorizationMachine
   (f32 values) and LogisticRegression (f16 values); the same rows as
   sparse libsvm → ``ell_batches(format="libsvm")`` → FactorizationMachine;
   on these ELL paths the first step's loss and gradients are held
   against the plain versions on the card. Then HIGGS csv →
   ``dense_batches`` → LogisticRegression on ``x`` at B = 32768, whose
   first step is held against the same step on the CPU;
6. the indexed, shuffled path at the Criteo width: 2^18 rows written as
   rowrec with its index (``FileStream``, ``write_rowrec(index_stream=)``);
   ``ell_batches`` over the plain file and over ``?index=…&shuffle=``
   record, batch and window, each bit for bit against its plain version
   (one seek per record, the numpy decode and ``FixedShapeBatcher``) with
   one thread and with ``picked_threads`` sub-shards, then timed in
   rows/s on the host beside its ``io_stats`` (``gather_fallback_batches``
   must be 0); then FM SGD on the card over ``shuffle=batch``: a timed
   pass, an uninterrupted pass, and a pass that ``save_async``s params
   and position every 4 steps and stops at step 64, restored by a fresh
   ``Checkpointer`` into a new pipeline with ``skip_records``, whose
   batches must equal steps 65-128 of the uninterrupted pass, with the
   restored params equal to the saved ones, the loss falling and K1-K4
   launched per step as on the sequential FM path;
7. the compressed and multi-file inputs at the Criteo width: the shuffle
   phase's 2^18 rows written again through the port's
   ``IndexedRecordIOWriter`` as zlib blocks of 1 MiB (bench.py's
   ``rec_zlib``) and as gzip blocks of the writer's default 256 KiB; for
   each, ``ell_batches`` sequential and over ``shuffle=record|batch|
   window`` with one thread and ``picked_threads`` sub-shards, bit for
   bit against the uncompressed file's batches (sequential sub-shards
   against the plain version on the same compressed file: each block
   decoded with ``decode_block``, frames walked in Python,
   ``FixedShapeBatcher``), the indexed modes also at 3 parts; rows/s on
   the host beside the uncompressed file, the compression ratio and the
   seconds to decode every block; a second pass of ``shuffle=window``
   served from the decoded-block cache; FM SGD on the card over the zlib
   file with ``shuffle=batch`` (K1-K4 once a step, the loss falling, the
   first step held against the plain versions) beside the uncompressed
   pass; and the same rows as libsvm in one file, in 4 files read as a
   directory and as a regex, and through a ``#cachefile`` for two
   epochs (the second replayed from the cache), each into FM SGD, with
   batches equal to the one file's;
8. the two example ports (``dmlc_core_tpu_torch.examples``) on the card
   for two epochs each at their own sizes;
9. the ``entry()`` forward on the card against the CPU.

The native parse core (``dmlc_core_tpu_torch/native/fastparse.cc``) is
built with g++ beside the kernels' nvcc build, and its stamped source hash
must equal the sha256 of the file. It fails if any kernel instance spills
registers. It prints a ``{"ptxas": [...]}`` (with the scatters' dynamic
shared memory), a ``{"kernels": [...]}``, a ``{"producers": {...}}``, a
``{"slice": {...}}``, a ``{"shuffle": {...}}``, a ``{"codec": {...}}``
and an ``{"examples": {...}}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

B, K, E, D = 2048, 39, 16, 1 << 20
N_DENSE = 13  # Criteo: 13 dense columns in every row + 26 categorical
N_BATCHES = 32
# the Criteo slice's file holds its N_BATCHES batches this many times over,
# so each pass times 128 steps
SLICE_REPEATS = 4
# HIGGS: 28 dense features, staged 32768 rows a batch (bench.py:47)
HIGGS_D, HIGGS_B, HIGGS_BATCHES = 28, 32768, 16
# the producer phase: plain versions run one block of rows, the native
# producers are timed over a file of the block repeated to 2^18 rows
BLOCK_ROWS, PRODUCER_ROWS = 1 << 15, 1 << 18
# published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and
# f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
SRC = "dmlc_core_tpu_torch/ops/csrc/ell_kernels.cu"
# (B, K, E, D) of the edge inputs beside the slice's: K below, at and
# above a warp and the Criteo width, E scalar-lane (1, 5) and 16-byte-lane
# (16), E in more than one of K4's 16-column chunks with a scalar (33) and
# a float4 (64) flush, B a multiple of neither K1's 16 rows a block nor
# K3's 8, and B*K a multiple of none of K2's and K4's 256-entry tiles
KERNEL_NAMES = ("ell_matvec_fwd", "ell_matvec_bwd", "fm_pair_fwd", "fm_pair_bwd")
EDGE_SHAPES = [(1037, k, e, 1000) for k in (1, 33, 39, 64) for e in (1, 5, 16)]
EDGE_SHAPES += [(1037, 39, e, 1000) for e in (33, 64)]
# the gradient scatters' own edge inputs (see scatter_inputs)
SCATTER_KINDS = ("contention", "distinct")
# forward: elementwise |kernel - plain| <= FWD_ABS + FWD_REL·scale, where
# scale is the sum of the magnitudes of the terms summed (the sums run in
# another order, and the pair term ½Σ(s² − q) cancels, so its rounding
# error scales with s², not with the result); gradients: <= GRAD_REL ·
# max|plain| (f32 atomics on hot rows add in an order that changes from
# run to run)
FWD_REL, FWD_ABS, GRAD_REL = 1e-5, 1e-6, 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def close_enough(got, want, kind: str, what: str, scale=None) -> float:
    """Max |got - want| over finite entries, after requiring NaN at the
    same places; fails the run beyond the stated tolerance (``scale``
    defaults to |want|)."""
    got, want = got.float(), want.float()
    nan_g, nan_w = torch.isnan(got), torch.isnan(want)
    if not torch.equal(nan_g, nan_w):
        fail(f"{what}: NaN pattern differs ({int(nan_g.sum())} vs {int(nan_w.sum())})")
    fin = ~nan_w
    if not fin.any():
        return 0.0
    err = (got[fin] - want[fin]).abs()
    if kind == "fwd":
        ref = want.abs() if scale is None else scale.float()
        bad = err > FWD_ABS + FWD_REL * ref[fin]
    else:
        bad = err > GRAD_REL * float(want[fin].abs().max())
    if bool(bad.any()):
        fail(f"{what}: {int(bad.sum())} entries beyond tolerance (max err {float(err.max())})")
    return float(err.max())


def criteo_rows(rng, n: int, num_features: int):
    """Criteo-shaped rows: 13 dense columns (ids 0-12, values in [0,1))
    and 26 categorical ids with value 1; labels from a planted model."""
    idx = np.empty((n, K), dtype=np.int64)
    idx[:, :N_DENSE] = np.arange(N_DENSE)
    idx[:, N_DENSE:] = rng.integers(N_DENSE, num_features, (n, K - N_DENSE))
    val = np.ones((n, K), dtype=np.float32)
    val[:, :N_DENSE] = rng.uniform(0, 1, (n, N_DENSE))
    return idx, val


def edge_inputs(rng, dev, f16: bool):
    """ELL inputs at the slice shape with the cases the kernels must get
    right: duplicates in a row, padding slots and rows (index 0, value
    0), wrapped negatives in [-D, -1], and out-of-range indices (>= D and
    < -D) whose rows read NaN."""
    idx, val = criteo_rows(rng, B, D)
    val[:, N_DENSE:] = rng.normal(size=(B, K - N_DENSE))
    idx[16:48, 20:30] = idx[16:48, 20:21]           # duplicates
    idx[48:80, 30:] = 0                              # padding slots
    val[48:80, 30:] = 0
    idx[B - 64:] = 0                                  # padding rows
    val[B - 64:] = 0
    neg = rng.integers(1, D + 1, (32, 8))
    idx[80:112, 13:21] = -neg                         # wrapped negatives
    # out-of-range rows use no hot (dense) columns, so their NaN stays
    # in their own rows' gradient entries
    idx[:8, :N_DENSE] = rng.integers(N_DENSE, D, (8, N_DENSE))
    idx[:4, 5] = D + rng.integers(0, 1000, 4)
    idx[4:8, 6] = -D - 1 - rng.integers(0, 1000, 4)
    v_dtype = torch.float16 if f16 else torch.float32
    return (
        torch.from_numpy(idx.astype(np.int32)).to(dev),
        torch.from_numpy(val).to(dev, v_dtype),
    )


def edge_shape_inputs(rng, dev, f16: bool, b: int, k: int, d: int):
    """ELL inputs at an edge shape: indices over [-d, d) (half of them
    wrapped negatives), a row of duplicates, padding slots and rows, and
    one index above and one below the range in rows 3 and 4."""
    idx = rng.integers(-d, d, (b, k))
    val = rng.normal(size=(b, k)).astype(np.float32)
    idx[1] = idx[1, 0]                                 # duplicates
    idx[2, k // 2:] = 0                                # padding slots
    val[2, k // 2:] = 0
    idx[b - 3:] = 0                                    # padding rows
    val[b - 3:] = 0
    idx[3, 0] = d + 5                                  # out of range
    idx[4, k - 1] = -d - 5
    return (
        torch.from_numpy(idx.astype(np.int32)).to(dev),
        torch.from_numpy(val).to(dev, torch.float16 if f16 else torch.float32),
    )


def scatter_inputs(rng, dev, f16: bool, kind: str):
    """ELL inputs at the slice's B and K for the gradient scatters' tile
    tables: ``contention``, every row naming the same K rows (each tile
    names each row ~6.5 times); ``distinct``, every entry naming its own
    row of D = B*K (each tile's table holds a whole tile of keys).
    Returns (idx, val, D)."""
    if kind == "contention":
        d = 1000
        idx = np.broadcast_to(rng.integers(-d, d, K), (B, K))
    else:
        d = B * K
        idx = rng.permutation(d).reshape(B, K)
    val = rng.normal(size=(B, K)).astype(np.float32)
    return (
        torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32)).to(dev),
        torch.from_numpy(val).to(dev, torch.float16 if f16 else torch.float32),
        d,
    )


def shifted(t):
    """A copy of ``t`` that starts one element past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def check_unaligned_scatters(idx, val, v, s, g, err: dict) -> None:
    """K2 and K4 through their C entry points into zeroed dense gradients
    that are not 16-byte aligned (the wrappers' own are), against the
    plain versions."""
    from dmlc_core_tpu_torch.ops import _build, fm as opfm, sparse as ops

    d, e = v.shape
    f16 = int(val.dtype == torch.float16)
    gw = shifted(torch.zeros(d, device=v.device))
    gv = shifted(torch.zeros(d, e, device=v.device))
    if not (gw.data_ptr() % 16 and gv.data_ptr() % 16):
        fail("the shifted dense gradients are 16-byte aligned")
    b, k = idx.shape
    _build.launch("ell_matvec_bwd", v.device, idx.data_ptr(), val.data_ptr(), f16,
                  g.data_ptr(), gw.data_ptr(), b, k, d)
    _build.launch("fm_pair_bwd", v.device, idx.data_ptr(), val.data_ptr(), f16,
                  v.data_ptr(), s.data_ptr(), g.data_ptr(), gv.data_ptr(), b, k, e, d)
    err["ell_matvec_bwd"] = max(err["ell_matvec_bwd"], close_enough(
        gw, ops.ell_matvec_bwd_plain(idx, val, g, d), "grad", "K2 unaligned gw"))
    err["fm_pair_bwd"] = max(err["fm_pair_bwd"], close_enough(
        gv, opfm.fm_pair_bwd_plain(idx, val, v, s, g), "grad", "K4 unaligned gv"))


def check_kernels(idx, val, w, v, g, tag: str, err: dict) -> None:
    """K1-K4 against their plain versions on one input; the largest
    errors are kept in ``err``."""
    from dmlc_core_tpu_torch.ops import fm as opfm, sparse as ops

    d = w.shape[0]
    # magnitudes of the summed terms (NaN in out-of-range rows, whose
    # entries are compared by their NaN pattern alone)
    scale_k1 = ops.ell_matvec_fwd_plain(idx, val.abs(), w.abs())
    scale_s = opfm.fm_pair_fwd_plain(idx, val.abs(), v.abs())[1]
    err["ell_matvec_fwd"] = max(err["ell_matvec_fwd"], close_enough(
        ops.ell_matvec_fwd_kernel(idx, val, w),
        ops.ell_matvec_fwd_plain(idx, val, w), "fwd", f"K1 {tag}", scale_k1))
    err["ell_matvec_bwd"] = max(err["ell_matvec_bwd"], close_enough(
        ops.ell_matvec_bwd_kernel(idx, val, g, d),
        ops.ell_matvec_bwd_plain(idx, val, g, d), "grad", f"K2 {tag}"))
    pk, sk = opfm.fm_pair_fwd_kernel(idx, val, v)
    pp, sp = opfm.fm_pair_fwd_plain(idx, val, v)
    err["fm_pair_fwd"] = max(err["fm_pair_fwd"],
                             close_enough(pk, pp, "fwd", f"K3 pair {tag}",
                                          (scale_s ** 2).sum(-1)),
                             close_enough(sk, sp, "fwd", f"K3 s {tag}", scale_s))
    err["fm_pair_bwd"] = max(err["fm_pair_bwd"], close_enough(
        opfm.fm_pair_bwd_kernel(idx, val, v, sp, g),
        opfm.fm_pair_bwd_plain(idx, val, v, sp, g), "grad", f"K4 {tag}"))


def time_ms(fn, flush, n: int = 30) -> float:
    """Median device time of ``fn()`` over ``n`` calls (CUDA events),
    with the 50 MB L2 flushed before each so it starts cold. A device
    sleep before the start event lets the host enqueue the whole call
    first, so host overhead does not show up as device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(n):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def bound(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev, flush):
    """Compare K1-K4 with their plain versions on edge inputs, then time
    kernel / plain / library on Criteo-shaped inputs, beside an empty
    launch. Returns rows of the kernels line (without launches)."""
    import torch.nn.functional as F

    from dmlc_core_tpu_torch.ops import _build, fm as opfm, sparse as ops

    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.randn(D, generator=gen, device=dev) * 0.01
    v = torch.randn(D, E, generator=gen, device=dev) * 0.01
    g = torch.randn(B, generator=gen, device=dev)
    err = dict.fromkeys(KERNEL_NAMES, 0.0)
    for f16 in (False, True):
        tag = "f16" if f16 else "f32"
        idx, val = edge_inputs(rng, dev, f16)
        check_kernels(idx, val, w, v, g, tag, err)
        check_unaligned_scatters(idx, val, v, opfm.fm_pair_fwd_plain(idx, val, v)[1], g, err)
        for b, k, e, d in EDGE_SHAPES:
            idx_e, val_e = edge_shape_inputs(rng, dev, f16, b, k, d)
            check_kernels(idx_e, val_e, torch.randn(d, generator=gen, device=dev),
                          torch.randn(d, e, generator=gen, device=dev),
                          torch.randn(b, generator=gen, device=dev),
                          f"{tag} B={b} K={k} E={e}", err)
        for kind in SCATTER_KINDS:
            idx_s, val_s, d = scatter_inputs(rng, dev, f16, kind)
            check_kernels(idx_s, val_s, torch.randn(d, generator=gen, device=dev),
                          torch.randn(d, E, generator=gen, device=dev), g,
                          f"{tag} {kind}", err)
    torch.cuda.synchronize()

    # timing inputs: the main path's shape and data (f32 values)
    idx_np, val_np = criteo_rows(rng, B, D)
    idx = torch.from_numpy(idx_np.astype(np.int32)).to(dev)
    val = torch.from_numpy(val_np).to(dev)
    _, s = opfm.fm_pair_fwd_plain(idx, val, v)
    uniq = int(np.unique(idx_np).size)
    bk, vb = B * K, 4
    j = idx.reshape(-1).long()
    contrib_w = (g[:, None] * val).reshape(-1)
    contrib_v = (g[:, None, None] * val[..., None]
                 * (s[:, None, :] - val[..., None] * v[idx.long()])).reshape(-1, E)
    # (name, site, kernel, plain, library, bytes, operations, zero-fill of
    # the dense gradient the wrapper allocates or None)
    rows = [
        ("ell_matvec_fwd", "dmlc_core_tpu/ops/sparse.py:17",
         lambda: ops.ell_matvec_fwd_kernel(idx, val, w),
         lambda: ops.ell_matvec_fwd_plain(idx, val, w),
         lambda: F.embedding_bag(idx, w[:, None], per_sample_weights=val, mode="sum"),
         bk * (4 + vb) + uniq * 4 + B * 4, 2 * bk, None),
        ("ell_matvec_bwd", "dmlc_core_tpu/ops/sparse.py:17",
         lambda: ops.ell_matvec_bwd_kernel(idx, val, g, D),
         lambda: ops.ell_matvec_bwd_plain(idx, val, g, D),
         lambda: torch.zeros(D, device=dev).index_add_(0, j, contrib_w),
         bk * (4 + vb) + B * 4 + D * 4, 2 * bk,
         lambda: torch.zeros(D, dtype=torch.float32, device=dev)),
        ("fm_pair_fwd", "dmlc_core_tpu/models/fm.py:46",
         lambda: opfm.fm_pair_fwd_kernel(idx, val, v),
         lambda: opfm.fm_pair_fwd_plain(idx, val, v),
         lambda: F.embedding_bag(idx, v, per_sample_weights=val, mode="sum"),
         bk * (4 + vb) + uniq * E * 4 + B * 4 + B * E * 4, 4 * bk * E + 3 * B * E, None),
        ("fm_pair_bwd", "dmlc_core_tpu/models/fm.py:46",
         lambda: opfm.fm_pair_bwd_kernel(idx, val, v, s, g),
         lambda: opfm.fm_pair_bwd_plain(idx, val, v, s, g),
         lambda: torch.zeros(D, E, device=dev).index_add_(0, j, contrib_v),
         bk * (4 + vb) + B * 4 + B * E * 4 + uniq * E * 4 + D * E * 4, 5 * bk * E,
         lambda: torch.zeros(D, E, dtype=torch.float32, device=dev)),
    ]
    floor_ms = time_ms(lambda: _build.empty_launch(dev), flush)
    out = []
    for name, replaces, kern, plain, lib, nbytes, nops, zero_fill in rows:
        ms = time_ms(kern, flush)
        bound_ms, bound_by = bound(nbytes, nops)
        out.append({
            "name": name, "route": "cuda", "source": SRC, "replaces": replaces,
            "launches": 0, "max_abs_err": err[name],
            "ms": ms, "plain_ms": time_ms(plain, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": time_ms(lib, flush),
            "kernel_ms": ms, "bound_us": bound_ms * 1e3,
            "floor_us": floor_ms * 1e3,
            "zero_fill_us": None if zero_fill is None else time_ms(zero_fill, flush) * 1e3,
        })
    return out


def criteo_data(rng, rows: int, num_features: int):
    """Criteo-shaped rows (``criteo_rows``) with labels from a planted
    model whose dense columns carry most of the signal."""
    idx, val = criteo_rows(rng, rows, num_features)
    planted = rng.normal(size=num_features).astype(np.float32)
    planted[:N_DENSE] *= 4.0
    labels = ((planted[idx] * val).sum(1) > 0).astype(np.float32)
    return idx, val, labels


def rowrec_bytes(idx, val, labels) -> bytes:
    import io

    from dmlc_core_tpu_torch.data.row_block import RowBlock
    from dmlc_core_tpu_torch.data.rowrec import write_rowrec

    n = len(labels)
    blk = RowBlock(
        offset=np.arange(n + 1, dtype=np.int64) * K, label=labels,
        index=idx.reshape(-1).astype(np.uint32), value=val.reshape(-1),
    )
    out = io.BytesIO()
    write_rowrec(out, [blk])
    return out.getvalue()


def text_lines(cols, sep: str) -> bytes:
    """Columns of strings → the lines of a text file."""
    return "".join(sep.join(r) + "\n" for r in zip(*[c.tolist() for c in cols])).encode()


def criteo_text(idx, val, labels, fmt: str) -> bytes:
    """Criteo rows as sparse libsvm (13 ``j:val`` tokens and 26 bare ids,
    value 1) or libfm (``field:id:val`` and ``field:id``), as bench.py
    writes them."""
    cols = [np.char.mod("%d", labels.astype(np.int64))]
    for j in range(N_DENSE):
        tag = f"{j}:{j}" if fmt == "libfm" else f"{j}"
        cols.append(np.char.mod(f"{tag}:%.6f", val[:, j]))
    for j in range(N_DENSE, K):
        cols.append(np.char.mod(f"{j}:%d" if fmt == "libfm" else "%d", idx[:, j]))
    return text_lines(cols, " ")


def higgs_data(rng, rows: int):
    """HIGGS-shaped rows: 28 N(0,1) features, labels from a planted model."""
    x = rng.normal(size=(rows, HIGGS_D)).astype(np.float32)
    labels = (x @ rng.normal(size=HIGGS_D) > 0).astype(np.float32)
    return x, labels


def higgs_text(x, labels, fmt: str) -> bytes:
    """HIGGS rows as libsvm (``j:val``, ids 0-27) or csv (label first)."""
    cols = [np.char.mod("%d", labels.astype(np.int64))]
    for j in range(HIGGS_D):
        cols.append(np.char.mod("%.6f" if fmt == "csv" else f"{j}:%.6f", x[:, j]))
    return text_lines(cols, "," if fmt == "csv" else " ")


def write_file(path: str, block: bytes, repeats: int = 1) -> str:
    with open(path, "wb") as f:
        for _ in range(repeats):
            f.write(block)
    return path


def picked_threads(rows: int, batch: int) -> int:
    """The producer fan-out for a file of ``rows`` rows (bench.py's rule):
    every usable CPU, but no more sub-shards than leave each four full
    batches."""
    from dmlc_core_tpu_torch.utils.cpus import parse_threads

    return parse_threads(max(1, rows // (batch * 4)))


def native_source(uri, spec, nthread=None):
    from dmlc_core_tpu_torch.staging.fused import dense_batches, ell_batches

    if spec.layout == "dense":
        return dense_batches(uri, spec, nthread=nthread)
    return ell_batches(uri, spec, nthread=nthread)


def rows_per_sec(source) -> float:
    """Drain a producer alone; its rows over the wall time."""
    t0 = time.perf_counter()
    rows = sum(b.n_valid for b in source)
    dt = time.perf_counter() - t0
    source.close()
    return rows / dt


def batch_bits(batch):
    """A batch's arrays as bytes, with the sign of a zero value dropped:
    the native libsvm → dense kernel adds a row's features into a zeroed
    row, so a -0.0 feature stages as +0.0 (as in the JAX package)."""
    return [batch.n_valid] + [
        (v + v.dtype.type(0) if v.dtype.kind == "f" else v).tobytes()
        for v in batch.as_dict().values()]


def same_batches(native, plain, what: str) -> int:
    """Native and plain producer batches equal bit for bit (each checked
    as it is yielded: both recycle ring slots); returns the batch count."""
    n = 0
    for a, b in zip(native, plain, strict=True):
        if batch_bits(a) != batch_bits(b):
            fail(f"{what}: native batch {n} differs from the plain version")
        n += 1
    native.close()
    plain.close()
    return n


def producer_phase():
    """Every native producer against its plain version, and its rows/s on
    the host with one thread and with ``picked_threads``."""
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import plain_batches

    rng = np.random.default_rng(2)
    idx, val, labels = criteo_data(rng, BLOCK_ROWS, D)
    x, ylab = higgs_data(rng, BLOCK_ROWS)
    blocks = {
        "criteo.rec": rowrec_bytes(idx, val, labels),
        "criteo.libsvm": criteo_text(idx, val, labels, "libsvm"),
        "criteo.libfm": criteo_text(idx, val, labels, "libfm"),
        "higgs.libsvm": higgs_text(x, ylab, "libsvm"),
        "higgs.csv": higgs_text(x, ylab, "csv"),
    }
    ell = lambda vdt: BatchSpec(batch_size=B, max_nnz=K, value_dtype=vdt)  # noqa: E731
    dense = lambda vdt: BatchSpec(batch_size=HIGGS_B, layout="dense",  # noqa: E731
                                  num_features=HIGGS_D, value_dtype=vdt)
    streams = [
        ("rowrec_f16", "criteo.rec", "", ell(np.float16)),
        ("rowrec_f32", "criteo.rec", "", ell(np.float32)),
        ("criteo_libsvm_f32", "criteo.libsvm", "?format=libsvm", ell(np.float32)),
        ("criteo_libfm_f32", "criteo.libfm", "?format=libfm", ell(np.float32)),
        ("higgs_libsvm_f16", "higgs.libsvm", "", dense(np.float16)),
        ("higgs_csv_f32", "higgs.csv", "?format=csv&label_column=0", dense(np.float32)),
    ]
    out = {"host_cpus": os.cpu_count(), "affinity_cpus": len(os.sched_getaffinity(0)),
           "block_rows": BLOCK_ROWS, "rows": PRODUCER_ROWS, "streams": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, block in blocks.items():
            write_file(os.path.join(tmp, "block-" + name), block)
            write_file(os.path.join(tmp, name), block, PRODUCER_ROWS // BLOCK_ROWS)
        for name, fname, query, spec in streams:
            small = os.path.join(tmp, "block-" + fname) + query
            big = os.path.join(tmp, fname) + query
            n = same_batches(native_source(small, spec), plain_batches(small, spec), name)
            threads = picked_threads(PRODUCER_ROWS, spec.batch_size)
            out["streams"][name] = {
                "batches_compared": n,
                "native_rows_per_sec_1thread": rows_per_sec(native_source(big, spec)),
                "nthread": threads,
                "native_rows_per_sec": rows_per_sec(native_source(big, spec, threads)),
                "plain_rows_per_sec": rows_per_sec(plain_batches(small, spec)),
            }
    return out


def plain_loss(params, batch):
    """The model's loss with every kernel replaced by its plain version
    (differentiable PyTorch ops; their gradient is PyTorch's own)."""
    from dmlc_core_tpu_torch.models.common import bce_with_logits
    from dmlc_core_tpu_torch.ops.fm import fm_pair_fwd_plain
    from dmlc_core_tpu_torch.ops.sparse import ell_matvec_fwd_plain, weighted_mean

    idx, val = batch["indices"], batch["values"]
    scores = ell_matvec_fwd_plain(idx, val, params["w"]) + params["b"]
    if "v" in params:
        scores = scores + fm_pair_fwd_plain(idx, val, params["v"])[0]
    return weighted_mean(bce_with_logits(scores, batch["labels"]), batch["weights"])


class RowLog:
    """A producer that notes each batch's valid rows (and, with
    ``digests``, a hash of its packed bytes) as the staging thread pulls
    it (on the host: the timed loop gains no device work)."""

    def __init__(self, source, digests: bool = False) -> None:
        self.source, self.rows = source, []
        self.digests = [] if digests else None
        self.ring_slots = source.ring_slots

    def __iter__(self):
        for batch in self.source:
            self.rows.append(batch.n_valid)
            if self.digests is not None:
                self.digests.append(hashlib.blake2b(batch.packed).hexdigest())
            yield batch


def drive(name, model, source, dev, lr, min_steps: int = 20, stop_after=None,
          on_step=None, digests: bool = False, must_fall: bool = True):
    """One pass of a path: producer → StagingPipeline → SGD steps, ended
    early after ``stop_after`` steps; ``on_step(step, batch)`` runs after
    each step. Returns (stats, first batch, params before the first
    step); with ``digests`` the stats hold the hashes of the batches the
    steps took."""
    from dmlc_core_tpu_torch.ops import _build
    from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

    log = RowLog(source, digests)
    pipe = StagingPipeline(log, device=dev)
    losses, step_s, wait_s, first_wait = [], [], 0.0, None
    first = params0 = None
    _build.reset_launches()
    t_start = time.perf_counter()
    it = iter(pipe)
    while stop_after is None or len(losses) < stop_after:
        t0 = time.perf_counter()
        batch = next(it, None)
        t1 = time.perf_counter()
        wait_s += t1 - t0
        if batch is None:
            break
        if first is None:
            first_wait = t1 - t0
            first = {k: t.clone() for k, t in batch.items()}
            params0 = {k: p.detach().clone() for k, p in model.params().items()}
        losses.append(float(model.sgd_step(batch, lr=lr)))  # syncs the step
        step_s.append(time.perf_counter() - t1)
        if on_step is not None:
            on_step(len(losses), batch)
    wall = time.perf_counter() - t_start
    launches = dict(_build.launches)
    thr = pipe.throughput()
    if not drain_close(pipe, source):
        fail("staging pipeline did not close cleanly")
    n = len(losses)
    if n < min_steps:
        fail(f"{name}: only {n} steps ran")
    if not all(np.isfinite(losses)):
        fail(f"{name}: non-finite loss: {losses}")
    # row-weighted: a sub-shard's short tail batch counts by its rows
    rows = log.rows[:n]
    head = np.average(losses[:4], weights=rows[:4])
    tail = np.average(losses[-4:], weights=rows[-4:])
    if must_fall and not tail < head:
        fail(f"{name}: loss did not fall: first steps {head}, last steps {tail}: {losses}")
    extra = {} if log.digests is None else {"digests": log.digests[:n]}
    return {**extra,
        "steps": n, "step_ms": statistics.median(step_s) * 1e3,
        "step_ms_first": step_s[0] * 1e3, "steps_s_total": sum(step_s),
        "staged_rows_per_sec": thr["rows_per_sec"],
        "wait_share": wait_s / wall, "wall_s": wall, "first_batch_wait_s": first_wait,
        "stage_seconds": {k[5:]: v for k, v in thr.items() if k.startswith("secs_")},
        "loss_first": losses[0], "loss_last": losses[-1],
        "launches": launches,
    }, first, params0


def check_first_step(model, first, params0):
    """The first step's loss and gradients with the kernels against the
    same step with the plain versions, on the card."""
    model.load_state_dict(params0)
    loss_k, grads_k = model.loss_and_grads(first)
    params = {k: p.clone().requires_grad_() for k, p in params0.items()}
    loss_p = plain_loss(params, first)
    grads_p = dict(zip(params, torch.autograd.grad(loss_p, list(params.values()))))
    close_enough(loss_k.reshape(1), loss_p.detach().reshape(1), "fwd", "first-step loss")
    for k in grads_p:
        close_enough(grads_k[k], grads_p[k], "grad", f"first-step grad {k}")


def check_first_step_on_cpu(model, make, first, params0):
    """The first step's loss and gradients on the card against the same
    step on the CPU (a dense model: no kernel, a matmul in another
    order)."""
    model.load_state_dict(params0)
    loss_d, grads_d = model.loss_and_grads(first)
    cpu = make("cpu")
    cpu.load_state_dict({k: p.cpu() for k, p in params0.items()})
    loss_c, grads_c = cpu.loss_and_grads({k: t.cpu() for k, t in first.items()})
    close_enough(loss_d.cpu().reshape(1), loss_c.reshape(1), "fwd", "first-step loss vs CPU")
    for k in grads_c:
        close_enough(grads_d[k].cpu(), grads_c[k], "grad", f"first-step grad {k} vs CPU")


def profile_steps(model, batch, lr: float, n: int = 8):
    """Device time by kernel over ``n`` back-to-back SGD steps on one
    staged batch (torch.profiler), and the device's busy share of the
    window's wall time (the profiler's own overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        model.sgd_step(batch, lr=lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            model.sgd_step(batch, lr=lr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [(e.key, e.self_device_time_total) for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(t for _, t in dev) * 1e-6
    return {
        "steps": n, "wall_ms_per_step": wall / n * 1e3,
        "device_ms_per_step": busy / n * 1e3, "device_busy_share": busy / wall,
        # K1-K4 by name (their share of the step is this over the above)
        "kernel_ms_per_step": {
            name: sum(t for key, t in dev if f"{name}_kernel" in key) * 1e-3 / n
            for name in KERNEL_NAMES},
        "top": [{"name": k[:90], "ms_per_step": t * 1e-3 / n}
                for k, t in sorted(dev, key=lambda kt: -kt[1])[:8]],
    }


def check_staged(uri, spec, first) -> None:
    """The first staged batch equals the first host batch's bytes."""
    src = native_source(uri, spec)
    host = next(iter(src)).as_dict()
    for k, v in host.items():
        if not np.array_equal(first[k].cpu().numpy(), v):
            fail(f"staged {k} differs from the host batch")
    src.close()


def slice_phase(dev, num_features: int = D, embed_dim: int = E,
                n_batches: int = N_BATCHES):
    """Each path at full width: (name, uri, spec, model, lr, first-step
    check), driven through its native producer three times: a warm-up
    pass, a pass with one thread (``one_thread``) and a pass with the
    thread count ``picked_threads`` gives (the main run: checks, profile
    and launches)."""
    from dmlc_core_tpu_torch.models import FactorizationMachine, LogisticRegression
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    def fm(d):
        return FactorizationMachine(num_features, embed_dim, device=d,
                                    generator=torch.Generator(device=d).manual_seed(0))

    def lr_sparse(d):
        return LogisticRegression(num_features, device=d,
                                  generator=torch.Generator(device=d).manual_seed(0))

    def lr_dense(d):
        return LogisticRegression(HIGGS_D, device=d,
                                  generator=torch.Generator(device=d).manual_seed(0))

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        idx, val, labels = criteo_data(rng, n_batches * B, num_features)
        rows = n_batches * B * SLICE_REPEATS
        rec = write_file(os.path.join(tmp, "criteo.rec"), rowrec_bytes(idx, val, labels),
                         SLICE_REPEATS)
        svm = write_file(os.path.join(tmp, "criteo.libsvm"),
                         criteo_text(idx, val, labels, "libsvm"), SLICE_REPEATS)
        x, ylab = higgs_data(rng, HIGGS_B)
        csv = write_file(os.path.join(tmp, "higgs.csv"), higgs_text(x, ylab, "csv"),
                         HIGGS_BATCHES)
        ell = lambda vdt: BatchSpec(batch_size=B, max_nnz=K, value_dtype=vdt)  # noqa: E731
        paths = [
            ("fm", rec, ell(np.float32), fm, 0.5, "kernels"),
            ("lr", rec, ell(np.float16), lr_sparse, 0.5, "kernels"),
            ("libsvm_fm", svm + "?format=libsvm", ell(np.float32), fm, 0.5, "kernels"),
            ("csv_lr", csv + "?format=csv&label_column=0",
             BatchSpec(batch_size=HIGGS_B, layout="dense", num_features=HIGGS_D),
             lr_dense, 1.0, "cpu"),
        ]
        for name, uri, spec, make, lr, check in paths:
            n_rows = HIGGS_B * HIGGS_BATCHES if spec.layout == "dense" else rows
            threads = picked_threads(n_rows, spec.batch_size)
            min_steps = HIGGS_BATCHES - 2 if spec.layout == "dense" else 20
            # a pass that pays the path's first-use costs (allocator
            # growth, library handles), so the two timed passes start warm
            drive(name, make(dev), native_source(uri, spec), dev, lr, min_steps)
            one, _, _ = drive(name, make(dev), native_source(uri, spec), dev, lr, min_steps)
            model = make(dev)
            stats, first, params0 = drive(
                name, model, native_source(uri, spec, threads), dev, lr, min_steps)
            stats["nthread"] = threads
            stats["one_thread"] = one
            check_staged(uri, spec, first)
            if check == "kernels":
                check_first_step(model, first, params0)
            else:
                check_first_step_on_cpu(model, make, first, params0)
            stats["profile"] = profile_steps(model, first, lr)
            out[name] = stats
    return out


SHUFFLE_MODES = ("record", "batch", "window")


def write_indexed(path: str, idx, val, labels) -> str:
    """Criteo rows as rowrec with its ``.idx`` index, through the port's
    ``FileStream`` and ``write_rowrec(index_stream=)``; returns the path."""
    from dmlc_core_tpu_torch.data.row_block import RowBlock
    from dmlc_core_tpu_torch.data.rowrec import write_rowrec
    from dmlc_core_tpu_torch.io.stream import FileStream

    n = len(labels)
    blk = RowBlock(offset=np.arange(n + 1, dtype=np.int64) * K, label=labels,
                   index=idx.reshape(-1).astype(np.uint32), value=val.reshape(-1))
    with FileStream(path, "w") as f, FileStream(path + ".idx", "w") as fi:
        write_rowrec(f, [blk], index_stream=fi)
    return path


class Interleaved:
    """The plain versions of ``n`` sub-parts, batches taken round-robin as
    ``ShardedFusedBatches`` takes them from its sub-producers."""

    def __init__(self, uri: str, spec, n: int) -> None:
        from dmlc_core_tpu_torch.staging.fused import plain_batches

        self.parts = [plain_batches(uri, spec, t, n) for t in range(n)]

    def __iter__(self):
        iters = [iter(p) for p in self.parts]
        while iters:
            still = []
            for it in iters:
                batch = next(it, None)
                if batch is not None:
                    still.append(it)
                    yield batch
            iters = still

    def close(self) -> None:
        for p in self.parts:
            p.close()


def drain_stats(source):
    """Drain a producer alone: (rows/s, its io_stats) after the drain."""
    t0 = time.perf_counter()
    rows = sum(b.n_valid for b in source)
    dt = time.perf_counter() - t0
    stats = source.io_stats()
    source.close()
    return rows / dt, stats


def shuffle_producers(rec: str, spec):
    """Each shuffle mode's producer beside the sequential one: bit for bit
    against the plain version (one thread, and ``picked_threads``
    sub-shards against the plain sub-parts interleaved), then rows/s and
    the split's counters; ``gather_fallback_batches`` must stay 0."""
    from dmlc_core_tpu_torch.staging.fused import ell_batches, plain_batches

    threads = picked_threads(PRODUCER_ROWS, spec.batch_size)
    out = {"rows": PRODUCER_ROWS, "nthread": threads, "modes": {}}
    for mode in ("sequential",) + SHUFFLE_MODES:
        uri = rec if mode == "sequential" else f"{rec}?index={rec}.idx&shuffle={mode}&seed=3"
        row = {"batches_compared": same_batches(
            ell_batches(uri, spec), plain_batches(uri, spec), f"shuffle {mode}")}
        row["batches_compared_threads"] = same_batches(
            ell_batches(uri, spec, nthread=threads), Interleaved(uri, spec, threads),
            f"shuffle {mode} x{threads}")
        row["rows_per_sec_1thread"], row["io_stats_1thread"] = drain_stats(
            ell_batches(uri, spec))
        row["rows_per_sec"], row["io_stats"] = drain_stats(
            ell_batches(uri, spec, nthread=threads))
        for key in ("io_stats_1thread", "io_stats"):
            st = row[key]
            if mode != "sequential" and not (
                    st.get("gather_batches", 0) > 0
                    and st.get("gather_fallback_batches") == 0):
                fail(f"shuffle {mode}: not every batch took the gather path: {st}")
        out["modes"][mode] = row
    return out


def resumable_fm(rec: str, spec, dev, make, lr: float, tmp: str):
    """FM SGD on the card over ``shuffle=batch`` (the example's URI):
    a timed pass; an uninterrupted pass noting each batch; a pass that
    saves params and position every 4 steps with ``save_async`` and
    stops at step 64; then a fresh ``Checkpointer`` restores, and a new
    pipeline with ``skip_records`` takes the remaining steps, whose
    batches must equal the uninterrupted pass's."""
    from dmlc_core_tpu_torch.checkpoint import Checkpointer
    from dmlc_core_tpu_torch.convert import params_from_jax
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    uri = f"{rec}?index={rec}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
    timed, first, _ = drive("shuffle_fm", make(dev), ell_batches(uri, spec), dev, lr)
    check_staged(uri, spec, first)
    full, _, _ = drive("shuffle_fm full", make(dev), ell_batches(uri, spec), dev, lr,
                       digests=True)
    ck_dir = os.path.join(tmp, "ckpt")
    ck = Checkpointer(ck_dir, keep=2)
    model = make(dev)
    stop = full["steps"] // 2

    def save(step, batch):
        if step % 4 == 0:
            ck.save_async(step, model.params(),
                          meta={"epoch": 0, "records": step * B})

    head, _, _ = drive("shuffle_fm head", model, ell_batches(uri, spec), dev, lr,
                       stop_after=stop, on_step=save, digests=True)
    ck.wait()
    saved = {k: p.detach().cpu().numpy() for k, p in model.params().items()}
    fresh = Checkpointer(ck_dir, keep=2)
    step, tree = fresh.restore()
    meta = fresh.restore_meta()
    if step != stop or meta != {"epoch": 0, "records": stop * B}:
        fail(f"restored step {step} meta {meta}, saved step {stop}")
    for k, v in saved.items():
        if not np.array_equal(tree[k], v):
            fail(f"restored param {k} differs from the saved one")
    resumed = make(dev)
    resumed.load_state_dict(params_from_jax(tree, dev))
    tail, _, _ = drive("shuffle_fm tail", resumed,
                       ell_batches(f"{uri}&skip_records={meta['records']}", spec),
                       dev, lr, min_steps=1, digests=True, must_fall=False)
    if head["digests"] != full["digests"][:stop]:
        fail("the interrupted pass read other batches than the uninterrupted one")
    if tail["digests"] != full["digests"][stop:]:
        fail(f"the {tail['steps']} batches after the resume differ from steps "
             f"{stop + 1}-{full['steps']} of the uninterrupted pass")
    for s in (head, tail, full):
        del s["digests"]
    return {"uri": uri, "timed": timed, "uninterrupted": full, "head": head,
            "resumed": tail, "checkpoint": {"step": step, "meta": meta,
                                            "steps_kept": fresh.steps()}}


def shuffle_phase(dev, sequential_fm):
    """The indexed, shuffled path at the Criteo width: its producers on the
    host, and resumable FM SGD on the card; K1-K4 launch per step as on
    the sequential FM path (``sequential_fm``, the slice phase's)."""
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    def fm(d):
        return FactorizationMachine(D, E, device=d,
                                    generator=torch.Generator(device=d).manual_seed(0))

    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(3)
        t0 = time.perf_counter()
        rec = write_indexed(os.path.join(tmp, "criteo.rec"), *criteo_data(rng, PRODUCER_ROWS, D))
        out = {"write_s": time.perf_counter() - t0, "bytes": os.path.getsize(rec)}
        out["producers"] = shuffle_producers(rec, spec)
        out["fm"] = resumable_fm(rec, spec, dev, fm, 0.5, tmp)
    per_step = lambda s: {k: n / s["steps"] for k, n in s["launches"].items()}  # noqa: E731
    want = per_step(sequential_fm)
    for name in ("timed", "uninterrupted", "head", "resumed"):
        got = per_step(out["fm"][name])
        if got != want:
            fail(f"shuffled FM {name}: launches per step {got}, sequential {want}")
    return out


CODEC_BLOCK = 1 << 20  # bench.py's rec_zlib packing (bench.py:342-349)
MULTI_FILES = 4


def write_compressed(rec: str, dst: str, codec_name: str, block_bytes=None) -> str:
    """``rec``'s v1 frames, cut at its index's offsets, written again in
    compressed blocks by the port's ``IndexedRecordIOWriter`` (with its
    ``block:in`` index), as bench.py builds ``rec_zlib``."""
    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io.stream import FileStream

    with open(rec + ".idx") as f:
        offs = np.asarray(f.read().split()[1::2], dtype=np.int64)
    with open(rec, "rb") as f:
        data = f.read()
    kw = {} if block_bytes is None else {"block_bytes": block_bytes}
    with FileStream(dst, "w") as f, FileStream(dst + ".idx", "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec=codec_name, **kw)
        w.write_framed_block(data, np.sort(offs))
        w.flush()
    return dst


def decode_seconds(path: str):
    """Seconds to decode every block of a compressed file after reading
    it: walking its frames and decoding block by block on this thread,
    and on the decode pool; and the block count."""
    from dmlc_core_tpu_torch.io import codec
    from dmlc_core_tpu_torch.io.recordio import scan_compressed_blob

    with open(path, "rb") as f:
        view = memoryview(f.read())
    blobs, pos = [], 0
    while pos < len(view):
        blob, pos = scan_compressed_blob(view, pos)
        blobs.append(blob)
    t0 = time.perf_counter()
    raw = sum(len(codec.decode_block(b)[0]) for b in blobs)
    one = time.perf_counter() - t0
    t0 = time.perf_counter()
    pooled = sum(len(r) for r, _n in codec.decode_blocks(blobs))
    pool = time.perf_counter() - t0
    if pooled != raw:
        fail(f"{path}: the pool decoded {pooled} bytes, one thread {raw}")
    return {"blocks": len(blobs), "raw_bytes": raw, "decode_s_1thread": one,
            "decode_s_pool": pool, "pool_threads": codec.decode_threads()}


def codec_producers(files, spec, threads: int):
    """Each compressed file's batches bit for bit against the
    uncompressed file's, sequential and in each shuffle mode, one thread
    and ``threads`` sub-shards (sequential sub-shards against the plain
    version on the same compressed file), the indexed modes also at 3
    parts; then rows/s of all three files alone on the host, the
    decoded-block cache emptied before each pass."""
    from dmlc_core_tpu_torch.io import codec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    def uri(path, mode):
        return path if mode == "sequential" else f"{path}?index={path}.idx&shuffle={mode}&seed=3"

    out = {}
    for name in ("zlib", "gzip"):
        rows = {}
        for mode in ("sequential",) + SHUFFLE_MODES:
            got, want = uri(files[name], mode), uri(files["v1"], mode)
            row = {"batches_compared": same_batches(ell_batches(got, spec),
                                                    ell_batches(want, spec), f"{name} {mode}")}
            ref = (Interleaved(got, spec, threads) if mode == "sequential"
                   else ell_batches(want, spec, nthread=threads))
            row["batches_compared_threads"] = same_batches(
                ell_batches(got, spec, nthread=threads), ref, f"{name} {mode} x{threads}")
            if mode != "sequential":
                row["batches_compared_3parts"] = sum(
                    same_batches(ell_batches(got, spec, part, 3),
                                 ell_batches(want, spec, part, 3), f"{name} {mode} part {part}/3")
                    for part in range(3))
            rows[mode] = row
        out[name] = rows
    for mode in ("sequential",) + SHUFFLE_MODES:
        for name in ("v1", "zlib", "gzip"):
            row = out.setdefault(name, {}).setdefault(mode, {})
            # each pass decodes its blocks: none comes from an earlier one
            codec.default_decode_cache().clear()
            row["rows_per_sec_1thread"], row["io_stats_1thread"] = drain_stats(
                ell_batches(uri(files[name], mode), spec))
            row["rows_per_sec"], row["io_stats"] = drain_stats(
                ell_batches(uri(files[name], mode), spec, nthread=threads))
            for key in ("io_stats_1thread", "io_stats"):
                st = row[key]
                if mode != "sequential" and not (st.get("gather_batches", 0) > 0
                                                 and st.get("gather_fallback_batches") == 0):
                    fail(f"{name} {mode}: not every batch took the gather path: {st}")
    return out


def second_pass_from_cache(path: str, spec):
    """Two passes of ``shuffle=window`` over the zlib file with the same
    seed and epoch, the decoded-block cache cleared before the first:
    the second's batches equal the first's and its blocks come from the
    cache."""
    from dmlc_core_tpu_torch.io import codec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    codec.default_decode_cache().clear()
    uri = f"{path}?index={path}.idx&shuffle=window&seed=5&epoch=0"
    passes = []
    for _ in range(2):
        src = ell_batches(uri, spec)
        t0 = time.perf_counter()
        digests = [hashlib.blake2b(b.packed).hexdigest() for b in src]
        dt = time.perf_counter() - t0
        st = src.io_stats()
        src.close()
        passes.append({"rows_per_sec": len(digests) * spec.batch_size / dt, "batches": len(digests),
                       "decode_cache_hits": st["decode_cache_hits"],
                       "decode_cache_misses": st["decode_cache_misses"], "digests": digests})
    first, second = passes
    if second.pop("digests") != first.pop("digests"):
        fail("the second pass over the zlib file read other batches than the first")
    if not second["decode_cache_hits"] > 10 * max(second["decode_cache_misses"], 1):
        fail(f"the second pass was not served from the decoded-block cache: {second}")
    return {"uri": uri, "first": first, "second": second,
            "cache_mb": codec.default_decode_cache().max_bytes >> 20}


class Epochs:
    """A producer iterated ``n`` times in a row, as one stream of batches."""

    def __init__(self, source, n: int) -> None:
        self.source, self.n = source, n
        self.ring_slots = source.ring_slots

    def __iter__(self):
        for _ in range(self.n):
            yield from self.source

    def close(self) -> None:
        self.source.close()


def codec_phase(dev, sequential_fm):
    """Compressed, multi-file and cached inputs at the Criteo width: the
    producers on the host, then FM SGD on the card from each."""
    from dmlc_core_tpu_torch.io import codec
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    def fm(d):
        return FactorizationMachine(D, E, device=d,
                                    generator=torch.Generator(device=d).manual_seed(0))

    spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=np.float32)
    threads = picked_threads(PRODUCER_ROWS, B)
    out = {"available_codecs": codec.available_codecs(), "rows": PRODUCER_ROWS, "nthread": threads}
    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(3)
        idx, val, labels = criteo_data(rng, PRODUCER_ROWS, D)
        files = {"v1": write_indexed(os.path.join(tmp, "criteo.rec"), idx, val, labels)}
        for name, block in (("zlib", CODEC_BLOCK), ("gzip", None)):
            t0 = time.perf_counter()
            files[name] = write_compressed(files["v1"], os.path.join(tmp, f"criteo.{name}.rec"),
                                           name, block)
            out[name] = {"write_s": time.perf_counter() - t0,
                         "block_bytes": block or "default",
                         "bytes": os.path.getsize(files[name]),
                         "ratio": os.path.getsize(files["v1"]) / os.path.getsize(files[name]),
                         **decode_seconds(files[name])}
        out["v1_bytes"] = os.path.getsize(files["v1"])
        out["producers"] = codec_producers(files, spec, threads)
        out["second_pass"] = second_pass_from_cache(files["zlib"], spec)
        fm_runs = {}
        for name in ("v1", "zlib"):
            uri = f"{files[name]}?index={files[name]}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
            codec.default_decode_cache().clear()  # the pass decodes its blocks
            model = fm(dev)
            fm_runs[name], first, params0 = drive(f"codec_fm {name}", model,
                                                  ell_batches(uri, spec), dev, 0.5, digests=True)
            if name == "zlib":
                check_first_step(model, first, params0)
                check_staged(uri, spec, first)
        if fm_runs["zlib"]["digests"] != fm_runs["v1"]["digests"]:
            fail("FM over the zlib file took other batches than over the uncompressed file")
        # the same rows as libsvm: one file, 4 files (a directory, a regex)
        # and a #cachefile read for two epochs, each into FM
        text = criteo_text(idx, val, labels, "libsvm")
        svm = write_file(os.path.join(tmp, "criteo.libsvm"), text)
        parts = os.path.join(tmp, "parts")
        os.mkdir(parts)
        lines = text.splitlines(keepends=True)
        cut = np.linspace(0, len(lines), MULTI_FILES + 1).astype(int)
        for i in range(MULTI_FILES):
            write_file(os.path.join(parts, f"part-{i}"), b"".join(lines[cut[i]:cut[i + 1]]))
        text_runs = {}
        for name, u in (("one_file", svm), ("directory", parts),
                        ("regex", os.path.join(parts, "part-.*"))):
            text_runs[name], _, _ = drive(f"codec_fm {name}", fm(dev),
                                          ell_batches(u + "?format=libsvm", spec), dev, 0.5,
                                          digests=True)
            if text_runs[name]["digests"] != text_runs["one_file"]["digests"]:
                fail(f"FM over the libsvm {name} took other batches than over one file")
        cached = ell_batches(f"{svm}?format=libsvm#{os.path.join(tmp, 'svm.cache')}", spec)
        text_runs["cachefile_2_epochs"], _, _ = drive(
            "codec_fm cachefile", fm(dev), Epochs(cached, 2), dev, 0.5, digests=True)
        replays = cached.io_stats()["cache_epochs_replayed"]
        run = text_runs["cachefile_2_epochs"]
        half = run["steps"] // 2
        if replays != 1 or run["digests"] != text_runs["one_file"]["digests"] * 2:
            fail(f"the #cachefile's epochs ({replays} replayed) did not repeat the one file's "
                 "batches")
        run["cache_epochs_replayed"] = replays
        run["steps_per_epoch"] = half
    for s in (*fm_runs.values(), *text_runs.values()):
        del s["digests"]
    out["fm"] = fm_runs
    out["text_fm"] = text_runs
    per_step = lambda s: {k: n / s["steps"] for k, n in s["launches"].items()}  # noqa: E731
    want = per_step(sequential_fm)
    for name, s in (*fm_runs.items(), *text_runs.items()):
        got = per_step(s)
        if got != want or any(got[k] != 1 for k in KERNEL_NAMES):
            fail(f"codec FM {name}: launches per step {got}, sequential {want}")
    return out


def examples_phase(dev):
    """Both example ports on the card at their own sizes for two epochs,
    in a scratch directory: wall time, final loss, latest checkpoint."""
    from dmlc_core_tpu_torch.examples import train_criteo_rec, train_higgs

    out = {}
    old = os.environ.get("DMLC_SGD_EPOCHS")
    os.environ["DMLC_SGD_EPOCHS"] = "2"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, mod, fname in (("train_higgs", train_higgs, "higgs.libsvm"),
                                     ("train_criteo_rec", train_criteo_rec, "criteo.rec")):
                t0 = time.perf_counter()
                res = mod.main([os.path.join(tmp, fname)], device=dev)
                wall = time.perf_counter() - t0
                losses = [x for x in res["losses"] if x is not None]
                if not losses or not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
                    fail(f"{name}: losses {res['losses']}")
                out[name] = {"wall_s": wall, "loss_first": losses[0],
                             "loss_last": losses[-1], "latest_step": res["latest_step"]}
    finally:
        if old is None:
            os.environ.pop("DMLC_SGD_EPOCHS")
        else:
            os.environ["DMLC_SGD_EPOCHS"] = old
    return out

def ptxas_summary(log: str):
    """Registers, spill bytes and shared memory of each compiled kernel
    instance, from nvcc's ``-Xptxas -v`` output."""
    out = []
    for m in re.finditer(
        r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, "
        r"(\d+) bytes spill loads\s+ptxas info\s+: Used (\d+) registers"
        r"(?:, used \d+ barriers)?(?:, (\d+) bytes smem)?", log, re.S):
        name, stores, loads, regs, smem = m.groups()
        short = re.search(r"\d((?:ell_matvec|fm_pair|empty)\w*?_kernel(?:I\w*?E)?)E*v", name)
        out.append({"function": short.group(1) if short else name,
                    "registers": int(regs), "spill_bytes": int(stores) + int(loads),
                    "smem_bytes": int(smem or 0)})
    return out


def entry_phase(dev) -> None:
    from dmlc_core_tpu_torch.entry import entry

    f_gpu, (p_gpu, b_gpu) = entry(dev)
    f_cpu, (_, b_cpu) = entry("cpu")
    p_cpu = {k: t.detach().cpu() for k, t in p_gpu.items()}
    close_enough(f_gpu(p_gpu, b_gpu).detach().cpu(), f_cpu(p_cpu, b_cpu).detach(),
                 "fwd", "entry forward")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dmlc_core_tpu_torch.data import native
    from dmlc_core_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | {smi_line}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # nvcc and g++ side by side
        builds = [pool.submit(_build.build), pool.submit(native.build)]
        so, native_so = (b.result() for b in builds)
    print(f"kernel and native builds: {time.perf_counter() - t0:.1f} s -> "
          f"{so.name}, {native_so.name}")
    if native.source_hash() != native.source_sha256():
        fail(f"{native.library_path()} was not built from the checkout's fastparse.cc")
    ptxas = ptxas_summary(_build.build_log)
    print(json.dumps({"ptxas": ptxas, "dynamic_smem_bytes": _build.scatter_smem_bytes(K)}))
    if not ptxas:
        fail("no register report from the compiler (-Xptxas -v)")
    spills = [p["function"] for p in ptxas if p["spill_bytes"]]
    if spills:
        fail(f"kernel instances spill registers: {spills}")

    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    kernels = kernel_phase(dev, flush)
    del flush
    producers = producer_phase()
    slice_stats = slice_phase(dev)
    shuffle = shuffle_phase(dev, slice_stats["fm"])
    codec = codec_phase(dev, slice_stats["fm"])
    examples = examples_phase(dev)
    entry_phase(dev)
    torch.cuda.synchronize()

    main_runs = [*slice_stats.values(), shuffle["fm"]["timed"], codec["fm"]["zlib"]]
    for row in kernels:
        n = sum(s["launches"][row["name"]] for s in main_runs)
        if n == 0:
            fail(f"kernel {row['name']} was not launched on the main path")
        row["launches"] = n
    for name, s in slice_stats.items():
        # K1/K2 on every ELL path, K3/K4 on the FM ones, none on dense
        want = (() if name == "csv_lr" else KERNEL_NAMES if "fm" in name
                else KERNEL_NAMES[:2])
        if any(s["launches"][k] == 0 for k in want):
            fail(f"{name} path did not launch {want}: {s['launches']}")
        if name == "csv_lr" and any(s["launches"].values()):
            fail(f"the dense path launched ELL kernels: {s['launches']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"producers": producers}))
    print(json.dumps({"slice": slice_stats}))
    print(json.dumps({"shuffle": shuffle}))
    print(json.dumps({"codec": codec}))
    print(json.dumps({"examples": examples}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
