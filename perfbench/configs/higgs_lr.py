"""Plain reference of the higgs_lr configuration: logistic regression on
dense rows under the mean binary cross-entropy of the rows that weigh 1,
and its SGD step, in plain PyTorch.

It imports nothing of the program. ``precision`` is ``float32`` (TF32
off: the reference) or ``tf32`` (the control: each matrix product's
inputs rounded to TF32's 10-bit mantissa, accumulated in float32, as
the tensor cores do)."""

from __future__ import annotations

import torch

# the nearest precision below the configuration's float32: the control
CONTROL = "tf32"


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32: the low 13 mantissa bits rounded
    off, to nearest."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def init_params(cfg, seed: int, device) -> dict:
    """The weights both sides start from, made on ``device`` from the seed:
    w N(0, 0.01^2), b 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {"w": torch.randn(cfg["num_features"], generator=g, device=device) * 0.01,
            "b": torch.zeros((), device=device)}


def loss_and_grads(params: dict, batch: dict, precision: str = "float32"):
    """(loss, gradients by name) of one batch."""
    mm = tf32 if precision == "tf32" else (lambda t: t)
    x = batch["x"].float()
    y = batch["labels"].float()
    wt = batch["weights"].float()
    w, b = params["w"], params["b"]
    score = mm(x) @ mm(w) + b
    per_row = torch.clamp(score, min=0) - score * y + torch.log1p(torch.exp(-score.abs()))
    den = torch.clamp(wt.sum(), min=1e-9)
    loss = (per_row * wt).sum() / den
    r = wt * (torch.sigmoid(score) - y) / den
    return loss, {"w": mm(x).T @ mm(r), "b": r.sum()}
