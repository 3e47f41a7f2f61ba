"""Plain reference of the criteo_fm configuration: a second-order
factorization machine (Rendle 2010) under the mean binary cross-entropy
of the rows that weigh 1, and its SGD step, in plain PyTorch.

    score = b + sum_k x_k w[i_k] + 1/2 sum_e [(sum_k x_k v[i_k,e])^2 - sum_k (x_k v[i_k,e])^2]

It imports nothing of the program. ``precision`` is ``float32`` (TF32
off: the reference) or ``bfloat16`` (the control: parameters, products,
sums and the update in bfloat16)."""

from __future__ import annotations

import torch

# the nearest precision below the configuration's float32: the control
CONTROL = "bfloat16"

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def init_params(cfg, seed: int, device) -> dict:
    """The weights both sides start from, made on ``device`` from the seed
    in two large calls: w and v N(0, 0.01^2), b 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    d, e = cfg["num_features"], cfg["embed_dim"]
    return {"w": torch.randn(d, generator=g, device=device) * 0.01,
            "v": torch.randn(d, e, generator=g, device=device) * 0.01,
            "b": torch.zeros((), device=device)}


def loss_and_grads(params: dict, batch: dict, precision: str = "float32"):
    """(loss, gradients by name) of one batch; ``params`` in the
    precision's dtype."""
    dt = DTYPES[precision]
    idx = batch["indices"].long()
    x = batch["values"].to(dt)
    y = batch["labels"].to(dt)
    wt = batch["weights"].to(dt)
    w, v, b = params["w"], params["v"], params["b"]
    lin = (x * w[idx]).sum(1)
    xv = x[..., None] * v[idx]                      # [B, K, E]
    s = xv.sum(1)                                   # [B, E]
    pair = 0.5 * (s * s - (xv * xv).sum(1)).sum(1)
    score = lin + pair + b
    per_row = torch.clamp(score, min=0) - score * y + torch.log1p(torch.exp(-score.abs()))
    den = torch.clamp(wt.sum(), min=1e-9)
    loss = (per_row * wt).sum() / den
    r = wt * (torch.sigmoid(score) - y) / den        # d loss / d score
    flat = idx.reshape(-1)
    gw = torch.zeros_like(w).index_add_(0, flat, (r[:, None] * x).reshape(-1))
    coef = r[:, None, None] * x[..., None] * (s[:, None, :] - xv)
    gv = torch.zeros_like(v).index_add_(0, flat, coef.reshape(-1, v.shape[1]))
    return loss, {"w": gw, "v": gv, "b": r.sum()}
