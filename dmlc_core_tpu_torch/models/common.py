"""Shared learner pieces: a stable loss, the SGD update and the
parameter plumbing every model shares."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.sparse import weighted_mean
from ..utils.device import DeviceLike, resolve_device

__all__ = ["SparseModel", "bce_with_logits", "sgd_update"]

Params = Dict[str, torch.Tensor]
Batch = Dict[str, torch.Tensor]


def bce_with_logits(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary cross-entropy on logits, per row.
    Labels may be {0,1} or {-1,1} (remapped here)."""
    y = torch.where(labels < 0.5, 0.0, 1.0)
    return (
        torch.clamp(scores, min=0) - scores * y
        + torch.log1p(torch.exp(-torch.abs(scores)))
    )


@torch.no_grad()
def sgd_update(params: Params, grads: Params, lr: float) -> Params:
    """``p ← p − lr·g`` for every parameter, IN PLACE (the JAX version
    returns new arrays; updating in place keeps one copy of the 64 MiB
    FM table). Returns ``params``."""
    for k, p in params.items():
        p.add_(grads[k], alpha=-lr)
    return params


class SparseModel(nn.Module):
    """An nn.Module whose parameters are named as in the JAX package's
    param dicts (``w``, ``b``, ``v``), plus the step machinery.

    A model placed on a rank mesh (``parallel.place_model``) holds this
    rank's block of each parameter and an ``spmd`` whose collectives make
    its loss, scores and gradients those of the global batch and the
    global parameters (``parallel/spmd.py``)."""

    spmd = None

    def __init__(self, device: DeviceLike, shapes: Dict[str, Tuple[int, ...]],
                 generator: Optional[torch.Generator]) -> None:
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        for name, shape in shapes.items():
            data = (
                torch.zeros(shape, dtype=torch.float32, device=dev)
                if name == "b"
                else torch.randn(shape, generator=generator,
                                 dtype=torch.float32, device=dev) * 0.01
            )
            self.register_parameter(name, nn.Parameter(data))

    def params(self) -> Params:
        """The parameters by name (the tensors themselves, not copies)."""
        return dict(self.named_parameters())

    def place(self, placed, spmd) -> None:
        """Take this rank's blocks (``parallel.Placed`` by name) as the
        parameters, with the ``spmd`` that computes the global step."""
        self._placement = {}
        for name, p in placed.items():
            self.register_parameter(name, nn.Parameter(p.local))
            self._placement[name] = p
        self.spmd = spmd

    def placed(self):
        """The parameters as ``parallel.Placed`` blocks of their global
        shapes (a placed model only): the tree a sharded checkpoint saves
        and the template its restore places by."""
        from ..parallel.spmd import Placed

        out = {}
        for name, param in self.named_parameters():
            p = self._placement[name]
            out[name] = Placed(param.detach(), p.shape, p.index, p.replica_id, p.spec, p.mesh)
        return out

    @torch.no_grad()
    def load_placed(self, tree) -> None:
        """Copy restored blocks (``Placed`` by name) into the parameters."""
        for name, param in self.named_parameters():
            param.copy_(tree[name].local)

    def _mean(self, per_row: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        if self.spmd is None:
            return weighted_mean(per_row, weights)
        return self.spmd.mean(per_row, weights)

    def _shard_sum(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x if self.spmd is None else self.spmd.shard_sum(name, x)

    def _penalty(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.spmd is None else self.spmd.penalty(x)

    def loss(self, batch: Batch) -> torch.Tensor:
        raise NotImplementedError

    def loss_and_grads(self, batch: Batch) -> Tuple[torch.Tensor, Params]:
        """(loss, grads) without the update: the half step a multi-host
        loop all-reduces before one shared ``sgd_update``."""
        params = self.params()
        loss = self.loss(batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if self.spmd is not None:
            return self.spmd.reduce(loss, grads)
        return loss.detach(), grads

    def sgd_step(self, batch: Batch, lr: float) -> torch.Tensor:
        """One SGD step, updating the parameters in place; returns the
        loss before the update."""
        loss, grads = self.loss_and_grads(batch)
        sgd_update(self.params(), grads, lr)
        return loss
