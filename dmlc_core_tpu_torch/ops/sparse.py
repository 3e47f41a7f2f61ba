"""Sparse ops on ELL (capped-CSR) batches.

``ell_matvec`` is the batched sparse dot ``out[b] = Σ_k values[b,k] ·
w[indices[b,k]]`` (dmlc data.h Row::SDot); its forward is kernel K1 and
its gradient w.r.t. ``w`` kernel K2 (``ops/csrc/ell_kernels.cu``) on CUDA
tensors, and the plain versions below on CPU tensors. Indices follow
jnp.take: [-D, -1] wraps, other out-of-range indices read NaN and their
gradient is dropped. Padding slots carry value 0, so no mask is needed.
"""

from __future__ import annotations

import torch

from . import _build
from ._common import check_ell, launch_scatter, on_cuda, require, wrap_index

__all__ = [
    "ell_matmul",
    "ell_matvec",
    "ell_matvec_bwd",
    "ell_matvec_bwd_into",
    "ell_matvec_bwd_kernel",
    "ell_matvec_bwd_plain",
    "ell_matvec_fwd",
    "ell_matvec_fwd_kernel",
    "ell_matvec_fwd_plain",
    "ell_to_dense",
    "weighted_mean",
]

_NAN = float("nan")


def ell_matvec_fwd_plain(indices, values, w):
    """Plain version of K1: f32[B]."""
    j, valid = wrap_index(indices, w.shape[0])
    wv = torch.where(valid, w[j], _NAN)
    return (values.float() * wv).sum(-1)


def ell_matvec_bwd_plain(indices, values, g, num_features: int):
    """Plain version of K2: dense f32[D] gradient w.r.t. ``w``."""
    j, valid = wrap_index(indices, num_features)
    contrib = torch.where(valid, g[:, None] * values.float(), 0.0)
    gw = torch.zeros(num_features, dtype=torch.float32, device=g.device)
    return gw.index_add_(0, j.reshape(-1), contrib.reshape(-1))


def ell_matvec_fwd_kernel(indices, values, w):
    """K1 on CUDA tensors."""
    B, K = check_ell(indices, values)
    require(w, "w", (torch.float32,), (None,))
    out = torch.empty(B, dtype=torch.float32, device=w.device)
    if B and K:
        _build.launch(
            "ell_matvec_fwd", w.device, indices.data_ptr(), values.data_ptr(),
            int(values.dtype == torch.float16), w.data_ptr(), out.data_ptr(),
            B, K, w.shape[0],
        )
    else:
        out.zero_()
    return out


def ell_matvec_bwd_into(indices, values, g, gw):
    """K2 on CUDA tensors into the zeroed dense gradient ``gw`` (f32[D],
    contiguous): the same inputs give the same bits on every launch."""
    B, K = check_ell(indices, values)
    require(g, "g", (torch.float32,), (B,))
    require(gw, "gw", (torch.float32,), (None,))
    if B and K:
        D = int(gw.shape[0])
        launch_scatter(
            "ell_matvec_bwd", g.device,
            (indices.data_ptr(), values.data_ptr(), int(values.dtype == torch.float16),
             g.data_ptr(), gw.data_ptr(), B, K, D),
            D, B * K, 1)
    return gw


def ell_matvec_bwd_kernel(indices, values, g, num_features: int):
    """K2 on CUDA tensors: the zeroed dense gradient is allocated here."""
    gw = torch.zeros(num_features, dtype=torch.float32, device=g.device)
    return ell_matvec_bwd_into(indices, values, g, gw)


def ell_matvec_fwd(indices, values, w):
    if on_cuda(indices, values, w):
        return ell_matvec_fwd_kernel(indices, values, w)
    return ell_matvec_fwd_plain(indices, values, w)


def ell_matvec_bwd(indices, values, g, num_features: int):
    if on_cuda(indices, values, g):
        return ell_matvec_bwd_kernel(indices, values, g, num_features)
    return ell_matvec_bwd_plain(indices, values, g, num_features)


class _EllMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, indices, values, w):
        ctx.save_for_backward(indices, values)
        ctx.num_features = w.shape[0]
        return ell_matvec_fwd(indices, values, w)

    @staticmethod
    def backward(ctx, g):
        indices, values = ctx.saved_tensors
        gw = ell_matvec_bwd(indices, values, g.contiguous(), ctx.num_features)
        return None, None, gw  # indices and values are data


def ell_matvec(indices, values, w):
    """indices i32[B,K], values f32|f16[B,K], w f32[D] → f32[B],
    differentiable w.r.t. ``w``."""
    return _EllMatvec.apply(indices, values, w)


def ell_matmul(indices, values, table):
    """out[b,:] = Σ_k values[b,k] · table[indices[b,k], :] → f32[B, E]
    (plain PyTorch: no path of this slice runs it)."""
    j, valid = wrap_index(indices, table.shape[0])
    gathered = torch.where(valid[..., None], table[j], _NAN)
    return torch.einsum("bk,bke->be", values.float(), gathered)


def ell_to_dense(indices, values, num_features: int):
    """ELL → dense [B, D] in the values' dtype; duplicate indices
    accumulate, [-D, -1] wraps, other out-of-range indices are dropped."""
    b = indices.shape[0]
    j, valid = wrap_index(indices, num_features)
    rows = torch.arange(b, device=indices.device)[:, None].expand_as(j)
    dense = torch.zeros(b, num_features, dtype=values.dtype,
                        device=values.device)
    return dense.index_put_((rows[valid], j[valid]), values[valid],
                            accumulate=True)


def weighted_mean(per_row, weights):
    """Weight-masked mean: padding rows (weight 0) contribute nothing."""
    return (per_row * weights).sum() / torch.clamp(weights.sum(), min=1e-9)
