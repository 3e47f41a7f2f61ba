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
4. the slice: a synthetic Criteo-shaped rowrec shard → ``ell_batches`` →
   ``StagingPipeline(device="cuda")`` → FactorizationMachine SGD steps
   (f32 values), then LogisticRegression steps (f16 values), with the
   kernels' launch counts read around each path, finite falling loss,
   the first staged batch equal to the host bytes, and the first step's
   loss and gradients held against the plain versions on the card;
5. the ``entry()`` forward on the card against the CPU.

It fails if any kernel instance spills registers. It prints a
``{"ptxas": [...]}`` (with the scatters' dynamic shared memory), a
``{"kernels": [...]}`` and a
``{"slice": {...}}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

B, K, E, D = 2048, 39, 16, 1 << 20
N_DENSE = 13  # Criteo: 13 dense columns in every row + 26 categorical
N_BATCHES = 32
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


def write_shard(path: str, rows: int, num_features: int, seed: int = 0) -> None:
    from dmlc_core_tpu_torch.data.row_block import RowBlock
    from dmlc_core_tpu_torch.data.rowrec import write_rowrec

    rng = np.random.default_rng(seed)
    idx, val = criteo_rows(rng, rows, num_features)
    planted = rng.normal(size=num_features).astype(np.float32)
    planted[:N_DENSE] *= 4.0  # the dense columns carry most of the signal
    labels = ((planted[idx] * val).sum(1) > 0).astype(np.float32)
    blk = RowBlock(
        offset=np.arange(rows + 1, dtype=np.int64) * K, label=labels,
        index=idx.reshape(-1).astype(np.uint32), value=val.reshape(-1),
    )
    with open(path, "wb") as f:
        write_rowrec(f, [blk])


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


def drive(model, path, spec, dev, lr):
    """One pass of the main path: ell_batches → StagingPipeline → SGD.
    Returns (stats, first batch, params before the first step)."""
    from dmlc_core_tpu_torch.ops import _build
    from dmlc_core_tpu_torch.staging.fused import ell_batches
    from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

    source = ell_batches(path, spec)
    pipe = StagingPipeline(source, device=dev)
    losses, step_s, wait_s = [], [], 0.0
    first = params0 = None
    _build.reset_launches()
    t_start = time.perf_counter()
    it = iter(pipe)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        t1 = time.perf_counter()
        wait_s += t1 - t0
        if batch is None:
            break
        if first is None:
            first = {k: t.clone() for k, t in batch.items()}
            params0 = {k: p.detach().clone() for k, p in model.params().items()}
        losses.append(float(model.sgd_step(batch, lr=lr)))  # syncs the step
        step_s.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t_start
    launches = dict(_build.launches)
    thr = pipe.throughput()
    if not drain_close(pipe, source):
        fail("staging pipeline did not close cleanly")
    n = len(losses)
    if n < 20:
        fail(f"only {n} steps ran")
    if not all(np.isfinite(losses)):
        fail(f"non-finite loss: {losses}")
    head, tail = np.mean(losses[:4]), np.mean(losses[-4:])
    if not tail < head:
        fail(f"loss did not fall: first steps {head}, last steps {tail}")
    return {
        "steps": n, "step_ms": statistics.median(step_s) * 1e3,
        "staged_rows_per_sec": thr["rows_per_sec"],
        "wait_share": wait_s / wall, "wall_s": wall,
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


def check_staged(path, spec, dev, first) -> None:
    """The first staged batch equals the host batch's bytes."""
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    src = ell_batches(path, spec)
    host = next(iter(src)).as_dict()
    src.close()
    for k, v in host.items():
        if not np.array_equal(first[k].cpu().numpy(), v):
            fail(f"staged {k} differs from the host batch")


def slice_phase(dev, num_features: int = D, embed_dim: int = E,
                n_batches: int = N_BATCHES):
    from dmlc_core_tpu_torch.models import FactorizationMachine, LogisticRegression
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "criteo.rec")
        write_shard(path, n_batches * B, num_features)
        for name, make, vdt, lr in (
            ("fm", lambda g: FactorizationMachine(num_features, embed_dim, device=dev, generator=g),
             np.float32, 0.5),
            ("lr", lambda g: LogisticRegression(num_features, device=dev, generator=g),
             np.float16, 0.5),
        ):
            spec = BatchSpec(batch_size=B, max_nnz=K, value_dtype=vdt)
            model = make(torch.Generator(device=dev).manual_seed(0))
            stats, first, params0 = drive(model, path, spec, dev, lr)
            check_staged(path, spec, dev, first)
            check_first_step(model, first, params0)
            stats["profile"] = profile_steps(model, first, lr)
            out[name] = stats
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
    so = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s -> {so.name}")
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
    slice_stats = slice_phase(dev)
    entry_phase(dev)
    torch.cuda.synchronize()

    for row in kernels:
        n = sum(s["launches"][row["name"]] for s in slice_stats.values())
        if n == 0:
            fail(f"kernel {row['name']} was not launched on the main path")
        row["launches"] = n
    for name, s in slice_stats.items():
        if s["launches"]["ell_matvec_fwd"] == 0 or s["launches"]["ell_matvec_bwd"] == 0:
            fail(f"{name} path did not launch K1/K2")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"slice": slice_stats}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
