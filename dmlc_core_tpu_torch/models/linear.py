"""Sparse linear / logistic regression over staged batches: either the
'ell' layout (``indices``/``values``) or a dense ``x``, detected by key.
The loss is weight-masked, so zero-padded rows are no-ops."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.sparse import ell_matvec, weighted_mean
from ..utils.device import DeviceLike
from .common import Batch, SparseModel, bce_with_logits

__all__ = ["LinearRegression", "LogisticRegression", "scores"]


def scores(w: torch.Tensor, b: torch.Tensor, batch: Batch) -> torch.Tensor:
    """``x·w + b`` for a dense batch, ``ell_matvec + b`` for an ELL one."""
    if "x" in batch:
        return batch["x"].float() @ w + b
    return ell_matvec(batch["indices"], batch["values"], w) + b


class _LinearBase(SparseModel):
    """Parameters ``w`` f32[D] and ``b`` f32[]; subclasses define the
    per-row loss."""

    def __init__(
        self,
        num_features: int,
        l2: float = 0.0,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__(device, {"w": (num_features,), "b": ()}, generator)
        self.num_features = num_features
        self.l2 = l2

    def per_row_loss(self, s: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def loss(self, batch: Batch) -> torch.Tensor:
        per_row = self.per_row_loss(scores(self.w, self.b, batch), batch["labels"])
        data_loss = self._mean(per_row, batch["weights"])
        if self.l2:
            data_loss = data_loss + self._penalty(self.l2 * torch.sum(self.w ** 2))
        return data_loss

    def sgd_step(self, batch: Batch, lr: float = 0.1) -> torch.Tensor:
        return super().sgd_step(batch, lr)


class LinearRegression(_LinearBase):
    """Least squares on sparse rows."""

    def forward(self, batch: Batch) -> torch.Tensor:
        return scores(self.w, self.b, batch)

    def per_row_loss(self, s, labels):
        return 0.5 * (s - labels) ** 2


class LogisticRegression(_LinearBase):
    """Binary logistic regression, the flagship learner."""

    def forward(self, batch: Batch) -> torch.Tensor:
        return torch.sigmoid(scores(self.w, self.b, batch))

    def per_row_loss(self, s, labels):
        return bce_with_logits(s, labels)

    @torch.no_grad()
    def accuracy(self, batch: Batch) -> torch.Tensor:
        pred = scores(self.w, self.b, batch) > 0
        hits = (pred == (batch["labels"] > 0.5)).float()
        return weighted_mean(hits, batch["weights"])
