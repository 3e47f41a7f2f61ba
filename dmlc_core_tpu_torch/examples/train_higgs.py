"""HIGGS-style logistic regression: libsvm file → parse → dense
fixed-shape batches → the card → SGD, with a checkpoint each epoch (the
port of ``examples/train_higgs.py``).

    python -m dmlc_core_tpu_torch.examples.train_higgs [/path/to/data.libsvm]

Generates the same synthetic file as the JAX example when the path does
not exist (default ``$TMPDIR/higgs_demo.libsvm``). Checkpoints go to
``higgs_ckpts_torch/`` beside the data; a run resumes from the newest
one at the next epoch. ``DMLC_SGD_EPOCHS`` sets the epochs (default 3).
One process only: a tracker or ``DMLC_NUM_WORKER`` > 1 raises.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np

from ..checkpoint import Checkpointer
from ..convert import params_from_jax
from ..data import create_parser
from ..models import LogisticRegression
from ..staging.batcher import BatchSpec, FixedShapeBatcher
from ..staging.pipeline import StagingPipeline, drain_close
from ..utils.device import DeviceLike, resolve_device
from ._common import check_single_worker, ckpt_dir

D = 29  # 28 features + the id-0 column of 0-based libsvm ids
B = 1024
LR = 0.5


def synth(path: str, rows: int = 20000, d: int = 28) -> None:
    """The JAX example's synthetic file, byte for byte."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=d)
    with open(path, "w") as f:
        for _ in range(rows):
            x = rng.normal(size=d)
            y = int(x @ w > 0)
            feats = " ".join(f"{j}:{x[j]:.5f}" for j in range(d))
            f.write(f"{y} {feats}\n")


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> Dict:
    """Train; returns ``{"epochs", "losses", "latest_step", "params"}``
    (the last loss of each epoch run, params as numpy)."""
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(device)
    check_single_worker()
    path = argv[0] if argv else os.path.join(tempfile.gettempdir(), "higgs_demo.libsvm")
    if not os.path.exists(path):
        print(f"generating synthetic data at {path}")
        synth(path)
    model = LogisticRegression(num_features=D, device=dev)
    ck = Checkpointer(ckpt_dir(path, "higgs_ckpts_torch"), keep=2)
    start = ck.latest_step()
    if start is not None:
        _, tree = ck.restore(start)
        model.load_state_dict(params_from_jax(tree, dev))
        print(f"resumed from epoch {start}")
    first = 0 if start is None else start + 1
    spec = BatchSpec(batch_size=B, layout="dense", num_features=D)
    epochs = int(os.environ.get("DMLC_SGD_EPOCHS", "3"))
    losses = []
    for epoch in range(first, epochs):
        parser = create_parser(path, type="libsvm")
        pipe = StagingPipeline(FixedShapeBatcher(spec).batches(iter(parser)), device=dev)
        loss = None
        try:
            for batch in pipe:
                loss = model.sgd_step(batch, lr=LR)
        finally:
            # the pipeline first, then its source, unless the join timed out
            drain_close(pipe, parser)
        stats = pipe.throughput()
        loss_str = "n/a (empty shard)" if loss is None else f"{float(loss):.4f}"
        print(f"epoch {epoch}: loss={loss_str} "
              f"({stats['rows_per_sec']:,.0f} rows/s into {dev})")
        ck.save(epoch, model.params())
        losses.append(None if loss is None else float(loss))
    print("latest checkpoint step:", ck.latest_step())
    return {"epochs": list(range(first, epochs)), "losses": losses,
            "latest_step": ck.latest_step(),
            "params": {k: v.detach().cpu().numpy() for k, v in model.params().items()}}


if __name__ == "__main__":
    main()
