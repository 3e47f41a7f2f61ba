"""Second-order factorization machine over ELL batches (Rendle 2010):
score = b + Σ w_i x_i + ½ Σ_e [(Σ_i v_ie x_i)² − Σ_i v_ie² x_i²], with the
linear term on ``ell_matvec`` (kernels K1/K2) and the pair term on
``fm_pair`` (kernels K3/K4)."""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.fm import fm_pair
from ..ops.sparse import ell_matvec
from ..utils.device import DeviceLike
from .common import Batch, SparseModel, bce_with_logits

__all__ = ["FactorizationMachine"]


class FactorizationMachine(SparseModel):
    """Parameters ``w`` f32[D], ``v`` f32[D,E] and ``b`` f32[]."""

    def __init__(
        self,
        num_features: int,
        embed_dim: int = 16,
        l2: float = 0.0,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__(
            device,
            {"w": (num_features,), "v": (num_features, embed_dim), "b": ()},
            generator,
        )
        self.num_features = num_features
        self.embed_dim = embed_dim
        self.l2 = l2

    def forward(self, batch: Batch) -> torch.Tensor:
        idx, val = batch["indices"], batch["values"]
        pair = self._shard_sum("v", fm_pair(idx, val, self.v))
        return ell_matvec(idx, val, self.w) + pair + self.b

    def loss(self, batch: Batch) -> torch.Tensor:
        per_row = bce_with_logits(self(batch), batch["labels"])
        data_loss = self._mean(per_row, batch["weights"])
        if self.l2:
            data_loss = data_loss + self._penalty(self.l2 * (
                torch.sum(self.w ** 2) + self._shard_sum("v", torch.sum(self.v ** 2))
            ))
        return data_loss

    def sgd_step(self, batch: Batch, lr: float = 0.05) -> torch.Tensor:
        return super().sgd_step(batch, lr)
