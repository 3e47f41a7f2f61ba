"""Entry points: the flagship model's forward function and example args
(the port of ``__graft_entry__.entry``), and ``dryrun_multichip``, one
meshed training run across rank processes (the port of
``__graft_entry__.dryrun_multichip``).

    python -m dmlc_core_tpu_torch.entry --dryrun N [--device cpu]
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch.func import functional_call

from .models import LogisticRegression
from .utils.device import DeviceLike, resolve_device
from .utils.logging import Error

__all__ = ["dryrun_multichip", "entry", "example_batch"]


def example_batch(batch_size: int = 8, k: int = 4, num_features: int = 32):
    """The reference's example ELL batch (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    return {
        "indices": rng.integers(0, num_features, (batch_size, k)).astype(np.int32),
        "values": rng.normal(size=(batch_size, k)).astype(np.float32),
        "nnz": np.full(batch_size, k, dtype=np.int32),
        "labels": rng.integers(0, 2, batch_size).astype(np.float32),
        "weights": np.ones(batch_size, dtype=np.float32),
    }


def entry(device: DeviceLike = None):
    """(forward, (params, batch)) for sparse logistic regression over an
    ELL batch on ``device`` (default ``cuda``): ``forward(params, batch)``
    returns the per-row probabilities f32[B]."""
    dev = resolve_device(device)
    num_features = 32
    model = LogisticRegression(
        num_features, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0),
    )
    batch = {
        k: torch.from_numpy(v).to(dev)
        for k, v in example_batch(num_features=num_features).items()
    }

    def forward(params, batch):
        return functional_call(model, params, (batch,))

    return forward, (model.params(), batch)


DRYRUN_TIMEOUT = 900  # a wedged rank must not hang the caller


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     init: Optional[Mapping[str, np.ndarray]] = None) -> Dict[str, Any]:
    """One meshed FM training run over ``n_devices`` rank processes,
    started through the port's launcher (``tracker.submit --cluster
    local``): a ``(n/2, 2)`` data × model mesh with ``v`` split over
    ``model`` for even n, ``(n,)`` for odd n. Each rank runs rowrec →
    ``process_shard`` → ``ell_batches`` → ``StagingPipeline(mesh=)`` →
    ``data_parallel_step``, then a sharded save and a restore by template
    with its ``meta`` (``.bin`` at n = 1, as in the JAX package).

    ``device`` defaults to the card: NCCL when each rank has a card of
    its own, gloo when ranks share one; ``device="cpu"`` runs gloo on the CPU.
    ``init``: the starting params (numpy, global shapes), such as the
    JAX package's ``FactorizationMachine(64, 8).init(PRNGKey(0))``; by
    default the port's own seed-0 init. Prints and returns the report
    with the JAX keys (``mesh``, ``steps``, ``loss``, ``packed_shard_dma``,
    ``packed_shard_batches``, ``device_puts``, ``puts_per_device``): the
    put counts summed over the ranks, ``puts_per_device`` keyed by rank.
    """
    dev = resolve_device(device)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as out:
        if init is not None:
            np.savez(os.path.join(out, "init.npz"), **{k: np.asarray(v) for k, v in init.items()})
        env = dict(os.environ, PYTHONPATH=repo)
        cmd = [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit", "--cluster",
               "local", "--num-workers", str(n_devices), "--host-ip", "127.0.0.1",
               sys.executable, "-m", "dmlc_core_tpu_torch.entry", "--dryrun-rank",
               dev.type, out]
        try:
            proc = subprocess.run(cmd, env=env, cwd=repo, capture_output=True, text=True,
                                  timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired as e:
            raise Error(f"dryrun_multichip: ranks ran past {DRYRUN_TIMEOUT} s") from e
        if proc.returncode != 0:
            raise Error(f"dryrun_multichip ranks failed (rc {proc.returncode}):\n"
                        f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(out, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    head = ranks[0]
    report = {
        "ok": True,
        "mesh": head["mesh"],
        "steps": head["steps"],
        "loss": round(head["loss"], 4),
        "loss_exact": head["loss"],
        "codecs": head["codecs"],
        "packed_shard_dma": all(r["staging"]["packed_shard_dma"] for r in ranks),
        "packed_shard_batches": head["staging"]["packed_shard_batches"],
        "device_puts": sum(r["staging"]["device_puts"] for r in ranks),
        "puts_per_device": {f"rank{r['rank']}:{k}": v for r in ranks
                            for k, v in r["staging"]["puts_per_device"].items()},
        "backend": head["backend"],
        "foreign_modules": sorted({m for r in ranks for m in r["foreign_modules"]}),
        "telemetry": head["telemetry"],
    }
    print(f"dryrun_multichip OK: mesh={report['mesh']} pipeline steps={report['steps']} "
          f"loss={head['loss']:.4f}")
    print("dryrun_multichip report: " + json.dumps(report))
    return report


def _dryrun_rank(device_type: str, out: str) -> None:
    """One rank of ``dryrun_multichip`` (under the launcher)."""
    from .checkpoint import Checkpointer
    from .convert import placed_from_jax
    from .data.row_block import RowBlock
    from .data.rowrec import write_rowrec
    from .io.codec import available_codecs
    from .io.stream import FileStream
    from .models import FactorizationMachine
    from .parallel import (P, data_parallel_step, destroy_process_group,
                           init_process_group, make_mesh, place_model, process_shard)
    from .staging.batcher import BatchSpec
    from .staging.fused import ell_batches
    from .staging.pipeline import StagingPipeline, drain_close
    from .telemetry import to_json as telemetry_snapshot

    cuda = device_type == "cuda"
    # the launcher starts every rank on this host: NCCL when each rank
    # has a card of its own, gloo when ranks share one
    n = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    backend = "nccl" if cuda and n <= torch.cuda.device_count() else "gloo"
    rank, n = init_process_group(backend=backend, device=device_type)
    # no try/finally: a rank that fails must not report the job done to
    # the tracker (destroy_process_group ends its session), so that the
    # launcher sees the failure
    if n % 2 == 0 and n > 1:  # data × model (dp + tp)
        mesh = make_mesh((n // 2, 2), ("data", "model"))
        model_par = 2
    else:
        mesh = make_mesh((n,), ("data",))
        model_par = 1
    num_features, embed_dim = 64, 8
    batch_size = 4 * max(n // model_par, 1)
    model = FactorizationMachine(
        num_features, embed_dim, device=mesh.device,
        generator=torch.Generator(device=mesh.device).manual_seed(0))
    rules = {"v": P(None, "model")} if model_par > 1 else None
    place_model(model, mesh, rules)
    init_path = os.path.join(out, "init.npz")
    if os.path.exists(init_path):
        model.load_placed(placed_from_jax(dict(np.load(init_path)), mesh, rules))
    step = data_parallel_step(lambda m, b: m.sgd_step(b, lr=0.05), mesh, "data", rules)
    k = 4
    n_rows = batch_size * 2
    rng = np.random.default_rng(0)
    blk = RowBlock(
        offset=np.arange(n_rows + 1, dtype=np.int64) * k,
        label=rng.integers(0, 2, n_rows).astype(np.float32),
        index=rng.integers(0, num_features, n_rows * k).astype(np.uint32),
        value=rng.normal(size=n_rows * k).astype(np.float32),
    )
    # every rank of the mesh reads the global batches and stages its
    # data coordinate's rows (the JAX package's one-process layout), so
    # the rowrec shard each rank reads is the whole file: part 0 of 1
    rank, world = process_shard()
    with tempfile.TemporaryDirectory() as tmp:
        rec = os.path.join(tmp, "dryrun.rec")
        with FileStream(rec, "w") as f:
            write_rowrec(f, [blk])
        spec = BatchSpec(batch_size=batch_size, layout="ell", max_nnz=k)
        stream = ell_batches(rec, spec, part_index=0, num_parts=1)
        pipe = StagingPipeline(stream, mesh=mesh, data_axis="data")
        steps = 0
        loss = None
        for batch in pipe:
            loss = step(model, batch)
            steps += 1
        staging = pipe.staging_stats()
        rows = pipe.rows_staged
        drain_close(pipe, stream)
    want_steps = math.ceil(n_rows / batch_size)
    if not (staging["packed_shard_dma"] and staging["packed_shard_batches"] == steps
            and staging["per_array_batches"] == 0):
        raise Error(f"rank {rank}: the batches did not ride the packed-shard path: {staging}")
    if steps != want_steps or rows != n_rows:
        raise Error(f"rank {rank}: {steps} steps over {rows} rows, want "
                    f"{want_steps} over {n_rows}")
    loss_val = float(loss)
    if not np.isfinite(loss_val):
        raise Error(f"rank {rank}: non-finite loss {loss_val}")
    # the sharded save, and the restore by template onto the same mesh,
    # bit for bit, with the data position (a shared base: the ranks
    # run on one host)
    ck = Checkpointer(os.path.join(out, "ckpts"), sharded=model_par > 1 or None)
    pos = {"epoch": 0, "records": int(rows)}
    ck.save(1, model.placed(), meta=pos)
    got_step, back = ck.restore(template=model.placed())
    if got_step != 1 or ck.restore_meta() != pos:
        raise Error(f"rank {rank}: restored step {got_step}, meta {ck.restore_meta()}")
    for name, p in model.placed().items():
        if back[name].spec != p.spec or not torch.equal(back[name].local, p.local):
            raise Error(f"rank {rank}: restored {name} differs from the saved one")
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": world, "mesh": mesh.shape, "steps": steps,
                   "loss": loss_val, "codecs": available_codecs(), "staging": staging,
                   "backend": backend, "telemetry": telemetry_snapshot(),
                   "foreign_modules": sorted(
                       m for m in sys.modules if m.split(".")[0] in ("jax", "dmlc_core_tpu"))},
                  f)
    destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 3 and argv[0] == "--dryrun-rank":
        _dryrun_rank(argv[1], argv[2])
        return 0
    if argv[:1] == ["--dryrun"] and len(argv) in (2, 4):
        device = argv[3] if len(argv) == 4 and argv[2] == "--device" else None
        dryrun_multichip(int(argv[1]), device)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
