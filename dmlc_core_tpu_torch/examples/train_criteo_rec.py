"""Criteo-style factorization machine: rowrec RecordIO with an index →
shuffled ``ell_batches`` → the card → FM SGD, with mid-epoch position
checkpoints and resume (the port of ``examples/train_criteo_rec.py``,
single process).

    python -m dmlc_core_tpu_torch.examples.train_criteo_rec [/path/to/data.rec]

Generates the JAX example's synthetic shard and its index, byte for
byte, when the path does not exist (default ``$TMPDIR/criteo_demo.rec``).
Each epoch reads ``?index=…&shuffle=batch&batch_size=2048&seed=1&
epoch=e``: spans of 2048 records in a (seed, epoch) order. Every 4 steps
at a span-aligned position the params are saved in the background with
the data position ``{"epoch", "records"}``; a run resumes from the
newest checkpoint with ``&skip_records=`` and so reads on from the
record where the save was made. Checkpoints go to
``criteo_ckpts_v2_torch/`` beside the data. ``DMLC_SGD_EPOCHS`` sets the
epochs (default 3); ``DMLC_SGD_OUT=<p>`` writes the final params to
``<p>.rank0.npz``. One process only: a tracker or ``DMLC_NUM_WORKER`` >
1 raises.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np

from ..checkpoint import Checkpointer
from ..convert import params_from_jax
from ..data.row_block import RowBlock
from ..data.rowrec import write_rowrec
from ..io.stream import FileStream
from ..models import FactorizationMachine
from ..staging.batcher import BatchSpec
from ..staging.fused import ell_batches
from ..staging.pipeline import StagingPipeline, drain_close
from ..utils.device import DeviceLike, resolve_device
from ._common import check_single_worker, ckpt_dir

N_FEATURES = 1 << 14
K = 39  # 13 dense + 26 categorical, Criteo-shaped
EMBED = 8
B = 2048
LR = 0.1
SAVE_EVERY = 4  # steps between mid-epoch position checkpoints


def synth(path: str, rows: int = 20000) -> None:
    """The JAX example's synthetic shard and ``.idx`` index, byte for
    byte; both are written under temporary names and the index is
    published first, so a reader that sees the data sees its index."""
    rng = np.random.default_rng(0)
    idx = np.empty((rows, K), dtype=np.uint32)
    idx[:, :13] = np.arange(13)
    idx[:, 13:] = rng.integers(13, N_FEATURES, (rows, 26))
    val = np.ones((rows, K), dtype=np.float32)
    val[:, :13] = rng.uniform(0, 1, (rows, 13))
    w = rng.normal(size=N_FEATURES) / np.sqrt(K)
    labels = ((w[idx] * val).sum(axis=1) > 0).astype(np.float32)
    blk = RowBlock(offset=np.arange(rows + 1, dtype=np.int64) * K, label=labels,
                   index=idx.reshape(-1), value=val.reshape(-1))
    tmp, itmp = f"{path}.tmp{os.getpid()}", f"{path}.idx.tmp{os.getpid()}"
    with FileStream(tmp, "w") as f, FileStream(itmp, "w") as fi:
        write_rowrec(f, [blk], index_stream=fi)
    os.replace(itmp, path + ".idx")
    os.replace(tmp, path)


def index_count(idx_path: str) -> int:
    with open(idx_path) as f:
        return sum(1 for line in f if line.strip())


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> Dict:
    """Train; returns ``{"start_step", "start_epoch", "skip", "gstep",
    "losses", "latest_step", "params"}`` (every step's loss, params as
    numpy)."""
    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(device)
    check_single_worker()
    path = argv[0] if argv else os.path.join(tempfile.gettempdir(), "criteo_demo.rec")
    if not os.path.exists(path):
        print(f"generating synthetic rowrec shard at {path}")
        synth(path)
    model = FactorizationMachine(N_FEATURES, embed_dim=EMBED, device=dev)
    # steps are global batch counts with an (epoch, records) position
    ck = Checkpointer(ckpt_dir(path, "criteo_ckpts_v2_torch"), keep=2)
    gstep, start_epoch, skip = 0, 0, 0
    start = ck.latest_step()
    if start is not None:
        gstep, tree = ck.restore(start)
        model.load_state_dict(params_from_jax(tree, dev))
        pos = ck.restore_meta(start)
        if pos is not None:
            start_epoch = int(pos["epoch"])
            rec = pos["records"]
            # a dict by rank, or a bare count in older checkpoints
            skip = int(rec.get("0", 0)) if isinstance(rec, dict) else int(rec)
            print(f"resumed step {gstep} at epoch {start_epoch}, {skip} records in")
        else:
            # no position (a crash before the sidecar landed): keep the
            # params and replay from epoch 0 rather than skip data
            print(f"resumed step {gstep}; no data position recorded, "
                  "replaying from epoch 0")
    resumed = {"start_step": start, "start_epoch": start_epoch, "skip": skip}
    spec = BatchSpec(batch_size=B, layout="ell", max_nnz=K)
    has_index = os.path.exists(path + ".idx")
    total = index_count(path + ".idx") if has_index else 0
    epochs = int(os.environ.get("DMLC_SGD_EPOCHS", "3"))
    losses = []
    for epoch in range(start_epoch, epochs):
        # shuffle=batch: spans of B records in a (seed, epoch) order, so
        # epoch= and skip_records= land a resume on the exact record
        uri = (f"{path}?index={path}.idx&shuffle=batch&batch_size={B}"
               f"&seed=1&epoch={epoch}" + (f"&skip_records={skip}" if skip else "")
               if has_index else path)
        stream = ell_batches(uri, spec)
        pipe = StagingPipeline(stream, device=dev)
        loss = None
        consumed, skip = skip, 0
        try:
            for batch in pipe:
                loss = model.sgd_step(batch, lr=LR)
                losses.append(float(loss))
                consumed += int((batch["weights"] > 0).sum())
                gstep += 1
                # only span-aligned positions resume; a padded tail batch
                # is covered by the epoch-end save below
                if has_index and gstep % SAVE_EVERY == 0 and consumed % B == 0:
                    ck.save_async(gstep, model.params(), meta={
                        "epoch": epoch, "records": {"0": min(consumed, total)}})
        finally:
            # the pipeline first, then its source, unless the join timed out
            drain_close(pipe, stream)
        stats = pipe.throughput()
        loss_str = "n/a (empty shard)" if loss is None else f"{float(loss):.4f}"
        print(f"epoch {epoch}: loss={loss_str} "
              f"({stats['rows_per_sec']:,.0f} rows/s, "
              f"{stats['mb_per_sec']:,.0f} MB/s into {dev})")
        # the next resume starts the following epoch from its first record
        ck.save_async(gstep, model.params(), meta={"epoch": epoch + 1, "records": 0})
    ck.wait()
    print("latest checkpoint step:", ck.latest_step())
    params = {k: v.detach().cpu().numpy() for k, v in model.params().items()}
    out = os.environ.get("DMLC_SGD_OUT")
    if out:
        tmp = f"{out}.rank0.npz.tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, gstep=gstep, **params)
        os.replace(tmp, f"{out}.rank0.npz")
    return {**resumed, "gstep": gstep, "losses": losses,
            "latest_step": ck.latest_step(), "params": params}


if __name__ == "__main__":
    main()
