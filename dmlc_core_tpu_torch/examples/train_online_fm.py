"""Online learning: a paced generator → a live RecordIO stream → FM SGD on
the card (the port of ``examples/train_online_fm.py``).

The writer appends fixed-K rows to a growing stream directory
(``stream/writer.py``: codec blocks, durable watermark commits, rotation
by size); the trainer follows the manifest live through the same
``io.split.create`` factory as a sealed data set: a windowed shuffle
inside the committed watermark, rotation as an epoch boundary, a clean
end at EOS. Each batch is packed into pinned host memory and copied to
the card, where the FM step runs K1-K4.

One process (demo):  python -m dmlc_core_tpu_torch.examples.train_online_fm
    runs the generator on a thread and trains while it writes.

Two terminals:
    python -m dmlc_core_tpu_torch.examples.train_online_fm --produce /tmp/fm_stream
    python -m dmlc_core_tpu_torch.examples.train_online_fm /tmp/fm_stream

Several trainers (tracker-leased micro-shards, each committed once):
    python -m dmlc_core_tpu_torch.tracker.submit --cluster local --num-workers 2 \\
        python -m dmlc_core_tpu_torch.examples.train_online_fm /tmp/fm_stream

Env knobs: ``DMLC_STREAM_MAX_LAG`` caps how far the writer may run ahead
of the slowest acked reader; ``DMLC_STREAM_POLL`` sets the tail poll.
"""

from __future__ import annotations

import os
import shutil
import struct
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..io import split as io_split
from ..models import FactorizationMachine
from ..stream import StreamWriter
from ..utils.device import DeviceLike, resolve_device
from ._common import join_tracker

N_FEATURES = 1 << 12
K = 8  # nnz a row, fixed: a row packs to one flat struct
B = 256
EMBED = 8
LR = 0.1
_ROW = struct.Struct("<f" + "I" * K + "f" * K)  # label, idx[K], val[K]
# the same layout as a numpy record, to unpack a batch of rows at once
_ROW_DTYPE = np.dtype([("label", "<f4"), ("idx", "<u4", (K,)), ("val", "<f4", (K,))])


def make_row(rng: np.random.Generator, w: np.ndarray) -> bytes:
    idx = rng.integers(0, N_FEATURES, K, dtype=np.uint32)
    val = rng.uniform(0, 1, K).astype(np.float32)
    label = float((w[idx] * val).sum() > 0)
    return _ROW.pack(label, *idx.tolist(), *val.tolist())


def produce(dir_path: str, rows: int = 8000, rows_per_sec: float = 4000.0) -> None:
    """The generator: paced appends with durable commits and rotation by
    size; each sealed shard is an indexed RecordIO file any offline job
    reads. The rows are the JAX example's, byte for byte."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=N_FEATURES) / np.sqrt(K)
    chunk = max(1, int(rows_per_sec * 0.01))
    with StreamWriter(dir_path, codec="zlib", rotate_bytes=64 << 10,
                      commit_records=200) as writer:
        for i in range(rows):
            writer.append(make_row(rng, w))
            if i % chunk == chunk - 1:
                time.sleep(0.01)
    print(f"producer: {rows} rows appended, stream sealed (EOS)")


def to_batch(rows: List[bytes], device: torch.device) -> Dict[str, torch.Tensor]:
    """One fixed-shape ELL batch of parsed rows, packed in pinned host
    memory (on a CUDA device) and copied to ``device``; a short tail pads
    with weight 0, which the weighted loss ignores."""
    n = len(rows)
    pin = device.type == "cuda"
    host = {
        "indices": torch.zeros((B, K), dtype=torch.int32, pin_memory=pin),
        "values": torch.zeros((B, K), dtype=torch.float32, pin_memory=pin),
        "labels": torch.zeros(B, dtype=torch.float32, pin_memory=pin),
        "weights": torch.zeros(B, dtype=torch.float32, pin_memory=pin),
    }
    if n:
        recs = np.frombuffer(b"".join(rows), dtype=_ROW_DTYPE, count=n)
        host["indices"].numpy()[:n] = recs["idx"].astype(np.int32)
        host["values"].numpy()[:n] = recs["val"]
        host["labels"].numpy()[:n] = recs["label"]
        host["weights"].numpy()[:n] = 1.0
    return {k: t.to(device, non_blocking=pin) for k, t in host.items()}


def train(src, model: FactorizationMachine, device: torch.device, rank: int = 0) -> Dict:
    """Train one step a ``B``-record chunk of ``src`` until EOS; returns
    the rows, the losses and the wall seconds."""
    seen, losses, last_gen = 0, [], 0
    t0 = time.monotonic()
    while True:
        chunk = src.next_batch(B)
        if chunk is None:
            break  # EOS: the writer closed and every committed row is read
        rows = list(src.extract_records(chunk))
        losses.append(float(model.sgd_step(to_batch(rows, device), lr=LR)))
        seen += len(rows)
        gen = getattr(src, "generation", 0)
        if gen != last_gen:
            # a rotation is a dataset switch: the sealed shard is final
            print(f"rank {rank}: rotated into generation {gen}")
            last_gen = gen
        if len(losses) % 10 == 0:
            print(f"rank {rank} step {len(losses)}: loss={losses[-1]:.4f} "
                  f"rows={seen} lag={src.lag_seconds():.2f}s")
    return {"rows": seen, "losses": losses, "wall_s": time.monotonic() - t0}


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> Dict:
    """Produce (``--produce [dir]``) or train; training returns ``{"rank",
    "rows", "steps", "losses", "wall_s", "params", "io_stats"}``."""
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--produce":
        produce(argv[1] if len(argv) > 1 else os.path.join(tempfile.gettempdir(),
                                                           "fm_stream"))
        return {}
    dev = resolve_device(device)
    dir_path = argv[0] if argv else os.path.join(tempfile.gettempdir(), "fm_stream_demo")
    # under the launcher: a rendezvous as any worker's; the workers share
    # the stream through tracker-leased micro-shards
    worker, rank, _world = join_tracker()
    producer = None
    if worker is None and not argv:
        # the demo: nobody writes yet, so the generator runs here
        shutil.rmtree(dir_path, ignore_errors=True)
        os.makedirs(dir_path, exist_ok=True)
        producer = threading.Thread(target=produce, args=(dir_path,), daemon=True,
                                    name="online-fm-producer")
        producer.start()
    model = FactorizationMachine(N_FEATURES, embed_dim=EMBED, device=dev)
    # the manifest URI makes create() follow the stream: aligned windows
    # shuffled inside the committed watermark, so the order depends only
    # on the seed and the rotations; several workers lease micro-shards
    uri = dir_path + "/manifest.json?shuffle=window&window=1024&seed=7"
    if worker is not None:
        uri += "&dynamic_shards=1"
    src = io_split.create(uri, threaded=False)
    try:
        res = train(src, model, dev, rank)
        stats = src.io_stats()
    finally:
        src.close()
        if producer is not None:
            producer.join(timeout=60)
    loss = f"{res['losses'][-1]:.4f}" if res["losses"] else "n/a"
    print(f"rank {rank}: stream drained — {res['rows']} rows in {res['wall_s']:.1f}s "
          f"({res['rows'] / max(res['wall_s'], 1e-9):,.0f} rows/s), final loss={loss}")
    if worker is not None:
        worker.shutdown()
    return {"rank": rank, "rows": res["rows"], "steps": len(res["losses"]),
            "losses": res["losses"], "wall_s": res["wall_s"], "io_stats": stats,
            "params": {k: v.detach().cpu().numpy() for k, v in model.params().items()}}


if __name__ == "__main__":
    main()
