"""The plain side of the check that decides ``correct``.

From the rows the benchmark generated and the file's layout it works
out, without the program, which rows each batch of a sequential epoch
holds: part ``t`` of ``n`` (one a producer thread) owns the bytes
``[ceil(size/n)·t, ceil(size/n)·(t+1))``, the step rounded up to 4 bytes
for RecordIO, each bound moved forward to the next record start (a
RecordIO record starting on the bound is the part's; a text line
starting on it is the previous part's, since the bound moves past the
next newline), as dmlc-core's ``InputSplitBase::ResetPartition`` does;
each part is cut into batches of B rows, its last padded with rows of
weight 0, and the batches are taken from the parts in turn. It holds
the staged batches to those, whole or by their sums (``batch_sums``),
then runs the configuration's plain model through the first steps and
compares the program's readings with its own.
"""

from __future__ import annotations

import importlib.util
import math
import os
from typing import Dict, List, Sequence

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def config_reference(name: str):
    """The plain reference module beside ``configs/<name>.json``."""
    path = os.path.join(HERE, "configs", name + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def part_rows(starts: np.ndarray, nparts: int, text: bool) -> List[tuple]:
    """(first row, end row) of each part of a file whose rows start at
    ``starts`` (the last entry is the file's size)."""
    size = int(starts[-1])
    step = -(-size // nparts)
    if not text:
        step = -(-step // 4) * 4
    row_starts = starts[:-1]

    def snap(pos: int) -> int:
        if pos >= size:
            return len(row_starts)
        if pos == 0:
            return 0
        side = "right" if text else "left"
        return int(np.searchsorted(row_starts, pos, side=side))

    return [(snap(min(step * t, size)), snap(min(step * (t + 1), size)))
            for t in range(nparts)]


def batch_plan(parts: Sequence[tuple], batch: int) -> List[tuple]:
    """(first file row, valid rows) of each batch of an epoch, in the
    order the parts' batches are taken in turn."""
    per_part = [[(b, min(batch, e - b)) for b in range(s, e, batch)] for s, e in parts]
    out = []
    for r in range(max((len(p) for p in per_part), default=0)):
        out += [p[r] for p in per_part if r < len(p)]
    return out


def make_batch(rows, layout, first: int, n_valid: int, batch: int) -> Dict[str, np.ndarray]:
    """The arrays a staged batch of file rows ``[first, first + n_valid)``
    holds, padding rows all zero."""
    sel = layout.order(np.arange(first, first + n_valid))
    out = {"labels": np.zeros(batch, np.float32), "weights": np.zeros(batch, np.float32)}
    out["labels"][:n_valid] = rows.labels[sel]
    out["weights"][:n_valid] = 1.0
    if rows.x is not None:
        out["x"] = np.zeros((batch, rows.x.shape[1]), np.float32)
        out["x"][:n_valid] = rows.x[sel]
    else:
        k = rows.idx.shape[1]
        out["indices"] = np.zeros((batch, k), np.int32)
        out["indices"][:n_valid] = rows.idx[sel]
        out["values"] = np.zeros((batch, k), np.float32)
        out["values"][:n_valid] = rows.val[sel]
        out["nnz"] = np.zeros(batch, np.int32)
        out["nnz"][:n_valid] = k
    return out


def epoch_plan(layout, parts: int, batch: int, text: bool) -> List[tuple]:
    """(first file row, valid rows) of each batch of a sequential epoch
    read by ``parts`` producer threads."""
    return batch_plan(part_rows(layout.starts, parts, text), batch)


def first_batches(rows, layout, parts: int, batch: int, text: bool, count: int):
    """The first ``count`` batches of a sequential epoch, and the file rows
    they hold."""
    plan = epoch_plan(layout, parts, batch, text)[:count]
    held = np.concatenate([layout.order(np.arange(f, f + n)) for f, n in plan])
    return [make_batch(rows, layout, f, n, batch) for f, n in plan], held


SUM_SPAN = 1021  # the position weights of ``batch_sums`` run 1..SUM_SPAN


def batch_sums(arrays: Dict[str, np.ndarray]) -> np.ndarray:
    """One int64 a batch's array, by sorted name: the sum of its entries'
    32-bit patterns, entry ``j`` (flat) weighted by ``j % SUM_SPAN + 1``.
    Exact (under 2^61 for up to 2^20 entries), and moved by any entry
    changed, a row or batch replaced, or two entries swapped whose places
    differ modulo ``SUM_SPAN``."""
    out = []
    for k in sorted(arrays):
        flat = np.ascontiguousarray(arrays[k]).reshape(-1).view(np.int32).astype(np.int64)
        w = np.arange(flat.size, dtype=np.int64) % SUM_SPAN + 1
        out.append(int((flat * w).sum()))
    return np.array(out, dtype=np.int64)


def sum_mismatches(seen: np.ndarray, places: np.ndarray, rows, layout, plan: List[tuple],
                   batch: int) -> int:
    """Batches whose sums (``seen`` [n, arrays], the batch's place in its
    epoch in ``places``) differ from the reference's for that place."""
    want = {}
    bad = 0
    for sums, pos in zip(seen, places.tolist()):
        if pos >= len(plan):
            bad += 1
            continue
        if pos not in want:
            want[pos] = batch_sums(make_batch(rows, layout, *plan[pos], batch))
        bad += int(not np.array_equal(sums, want[pos]))
    return bad


def run_steps(ref, params0: Dict[str, torch.Tensor], batches, lr: float,
              precision: str = "float32", fault: str = "") -> dict:
    """The plain model through ``batches`` from ``params0``: each step's
    loss, the first gradient, the state after one step and after all.
    ``fault`` plants one of the faults the check must catch:
    ``half`` (the second half of every batch left out, the mean taken
    over the rest) or ``frozen`` (the update never applied)."""
    dt = getattr(ref, "DTYPES", {}).get(precision, torch.float32)
    p = {k: v.to(dt).clone() for k, v in params0.items()}
    start = {k: v.clone() for k, v in p.items()}
    out = {"losses": [], "start": start}
    for i, b in enumerate(batches):
        if fault == "half":
            b = dict(b)
            wt = b["weights"].clone()
            wt[wt.shape[0] // 2:] = 0
            b["weights"] = wt
        loss, grads = ref.loss_and_grads(p, b, precision)
        out["losses"].append(float(loss))
        if i == 0:
            out["grads"] = {k: g.float() for k, g in grads.items()}
        if fault != "frozen":
            for k in p:
                p[k] = p[k] - lr * grads[k].to(dt)
        if i == 0:
            out["after1"] = {k: v.clone() for k, v in p.items()}
    out["after"] = p
    return out


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def norm_gaps(got: Dict[str, float], want: Dict[str, float], keep: Sequence[str]) -> dict:
    """Per leaf, the gap between the program's norm and the reference's,
    over the larger of the reference leaf's norm and the median leaf's."""
    med = float(np.median([want[k] for k in keep]))
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keep}


def compare_steps(prog: dict, ref: dict, lr: float) -> dict:
    """The numbers the check compares (each a share of the reference's):

    - ``loss_gap``: the widest gap of a step's loss;
    - ``grad_gap``: the first gradient as the optimizer got it, worked
      out from the state after one step, ``(p0 - p1) / lr``; the widest
      gap of a leaf's norm;
    - ``change_gap``: the parameters' change over all the steps; the
      widest gap of a leaf's norm.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of both norms."""
    gref = {k: _norm(g) for k, g in ref["grads"].items()}
    med = float(np.median(list(gref.values())))
    keep = [k for k in gref if gref[k] >= 1e-3 * med]
    p0 = {k: v.float() for k, v in prog["start"].items()}
    gprog = {k: _norm((p0[k] - prog["after1"][k].float()) / lr) for k in keep}
    dprog = {k: _norm(prog["after"][k].float() - p0[k]) for k in keep}
    r0 = {k: v.float() for k, v in ref["start"].items()}
    dref = {k: _norm(ref["after"][k].float() - r0[k]) for k in keep}
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(map(math.isfinite, prog["losses"])):
        losses.append(math.inf)
    g = norm_gaps(gprog, gref, keep)
    d = norm_gaps(dprog, dref, keep)
    return {"loss_gap": max(losses), "grad_gap": max(g.values()), "change_gap": max(d.values()),
            "leaves": {k: {"grad": g[k], "change": d[k]} for k in keep}}


def batch_mismatches(staged: List[Dict[str, torch.Tensor]], want: List[Dict[str, np.ndarray]]) -> int:
    """Entries of the staged batches that differ from the reference's
    (a missing batch, array or shape counts all its entries)."""
    bad = 0
    for i, w in enumerate(want):
        got = staged[i] if i < len(staged) else {}
        for k, arr in w.items():
            t = got.get(k)
            if t is None or tuple(t.shape) != arr.shape:
                bad += arr.size
                continue
            host = t.cpu().numpy()
            if host.dtype != arr.dtype:
                bad += arr.size
                continue
            bad += int(np.count_nonzero(host != arr))
    return bad
