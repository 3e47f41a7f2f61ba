"""The factorization-machine pair term over ELL batches.

With ``xv[b,k,e] = values[b,k] · v[indices[b,k], e]``:
``s = Σ_k xv``, ``q = Σ_k xv²`` and ``pair[b] = ½ Σ_e (s² − q)`` — the
O(B·K·E) form of dmlc_core_tpu/models/fm.py:46-54. On CUDA tensors the
forward is kernel K3 (which also returns ``s`` for the backward) and the
gradient w.r.t. ``v`` is kernel K4,
``gv[idx,e] += g · val · (s[b,e] − val · v[idx,e])``; on CPU tensors the
plain versions below run. Indices follow jnp.take as in ops/sparse.py.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import check_ell, launch_scatter, on_cuda, require, wrap_index

__all__ = [
    "fm_pair",
    "fm_pair_bwd",
    "fm_pair_bwd_into",
    "fm_pair_bwd_kernel",
    "fm_pair_bwd_plain",
    "fm_pair_fwd",
    "fm_pair_fwd_kernel",
    "fm_pair_fwd_plain",
]


def _gather(indices, v):
    j, valid = wrap_index(indices, v.shape[0])
    return j, valid, torch.where(valid[..., None], v[j], float("nan"))


def fm_pair_fwd_plain(indices, values, v):
    """Plain version of K3: (pair f32[B], s f32[B,E])."""
    _, _, emb = _gather(indices, v)
    xv = emb * values.float()[..., None]
    s = xv.sum(1)
    pair = 0.5 * (s * s - (xv * xv).sum(1)).sum(-1)
    return pair, s


def fm_pair_bwd_plain(indices, values, v, s, g):
    """Plain version of K4: dense f32[D,E] gradient w.r.t. ``v``."""
    j, valid, emb = _gather(indices, v)
    x = values.float()[..., None]
    coef = g[:, None, None] * x * (s[:, None, :] - x * emb)
    coef = torch.where(valid[..., None], coef, 0.0)
    gv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    return gv.index_add_(0, j.reshape(-1), coef.reshape(-1, v.shape[1]))


def fm_pair_fwd_kernel(indices, values, v):
    """K3 on CUDA tensors."""
    B, K = check_ell(indices, values)
    require(v, "v", (torch.float32,), (None, None))
    D, E = int(v.shape[0]), int(v.shape[1])
    pair = torch.empty(B, dtype=torch.float32, device=v.device)
    s = torch.empty(B, E, dtype=torch.float32, device=v.device)
    if B and K and E:
        _build.launch(
            "fm_pair_fwd", v.device, indices.data_ptr(), values.data_ptr(),
            int(values.dtype == torch.float16), v.data_ptr(), pair.data_ptr(),
            s.data_ptr(), B, K, E, D,
        )
    else:
        pair.zero_()
        s.zero_()
    return pair, s


def fm_pair_bwd_into(indices, values, v, s, g, gv):
    """K4 on CUDA tensors into the zeroed dense gradient ``gv`` (f32[D,E],
    contiguous): the same inputs give the same bits on every launch."""
    B, K = check_ell(indices, values)
    require(v, "v", (torch.float32,), (None, None))
    D, E = int(v.shape[0]), int(v.shape[1])
    require(s, "s", (torch.float32,), (B, E))
    require(g, "g", (torch.float32,), (B,))
    require(gv, "gv", (torch.float32,), (D, E))
    if B and K and E:
        launch_scatter(
            "fm_pair_bwd", v.device,
            (indices.data_ptr(), values.data_ptr(), int(values.dtype == torch.float16),
             v.data_ptr(), s.data_ptr(), g.data_ptr(), gv.data_ptr(), B, K, E, D),
            D, B * K, E)
    return gv


def fm_pair_bwd_kernel(indices, values, v, s, g):
    """K4 on CUDA tensors: the zeroed dense gradient is allocated here."""
    gv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    return fm_pair_bwd_into(indices, values, v, s, g, gv)


def fm_pair_fwd(indices, values, v):
    if on_cuda(indices, values, v):
        return fm_pair_fwd_kernel(indices, values, v)
    return fm_pair_fwd_plain(indices, values, v)


def fm_pair_bwd(indices, values, v, s, g):
    if on_cuda(indices, values, v, s, g):
        return fm_pair_bwd_kernel(indices, values, v, s, g)
    return fm_pair_bwd_plain(indices, values, v, s, g)


class _FmPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, indices, values, v):
        pair, s = fm_pair_fwd(indices, values, v)
        ctx.save_for_backward(indices, values, v, s)
        return pair

    @staticmethod
    def backward(ctx, g):
        indices, values, v, s = ctx.saved_tensors
        return None, None, fm_pair_bwd(indices, values, v, s, g.contiguous())


def fm_pair(indices, values, v):
    """indices i32[B,K], values f32|f16[B,K], v f32[D,E] → f32[B],
    differentiable w.r.t. ``v``."""
    return _FmPair.apply(indices, values, v)
