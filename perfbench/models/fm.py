"""The port's factorization machine and its input, as a criteo_fm cell
runs them: ``ell_batches`` (the fused rowrec producer, with the port's
default threads) into ``FactorizationMachine.sgd_step`` (kernels
K1-K4)."""

from __future__ import annotations

import numpy as np
import torch

from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches


def spec(cfg, traffic) -> BatchSpec:
    return BatchSpec(batch_size=traffic["batch_size"], max_nnz=cfg["max_nnz"],
                     value_dtype=np.float32)


def source(uri: str, batch_spec: BatchSpec):
    return ell_batches(uri, batch_spec)


@torch.no_grad()
def build(cfg, params, device) -> FactorizationMachine:
    model = FactorizationMachine(cfg["num_features"], cfg["embed_dim"], device=device)
    for name, p in model.params().items():
        p.copy_(params[name])
    return model
