"""The port's logistic regression and its input, as a higgs_lr cell
runs them: ``dense_batches`` (the fused csv producer, with the port's
default threads) into ``LogisticRegression.sgd_step`` (a dense matrix
product, no ELL kernel)."""

from __future__ import annotations

import torch

from dmlc_core_tpu_torch.models import LogisticRegression
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import dense_batches


def spec(cfg, traffic) -> BatchSpec:
    return BatchSpec(batch_size=traffic["batch_size"], layout="dense",
                     num_features=cfg["num_features"])


def source(uri: str, batch_spec: BatchSpec):
    return dense_batches(uri, batch_spec)


@torch.no_grad()
def build(cfg, params, device) -> LogisticRegression:
    model = LogisticRegression(cfg["num_features"], device=device)
    for name, p in model.params().items():
        p.copy_(params[name])
    return model
