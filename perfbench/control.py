"""Readings that set each cell's limits: the control and the faults.

    python perfbench/control.py --seeds 1,2,3 [--cells a,b]

For each cell and seed it builds the cell's first batches from the
generated rows (no file, no window: the steps need none) and runs the
plain reference three ways beside the float32 one: the control (the
configuration's ``CONTROL`` precision: bfloat16 for a float32 model
without matrix products, TF32 for one with them), half of every batch
left out with the mean taken over the rest, and the update never
applied. Each is compared with the float32 reference as the program is
(``reference.compare_steps``); one JSON line a cell and seed. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
KINDS = ("control", "half", "frozen")


def readings(c, seed: int, device) -> dict:
    import torch

    from perfbench import gen, reference

    cfg, traffic = c.config, dict(c.traffic, file_rows=c.config["train_rows"])
    ref = reference.config_reference(cfg["name"])
    rows = gen.make_rows(seed, traffic["block_rows"], cfg)
    _, lengths = gen.encode_rows(rows, traffic)
    layout = gen.layout_of(lengths, traffic)
    # one producer thread, the port's default
    want, _ = reference.first_batches(rows, layout, 1, traffic["batch_size"],
                                      traffic["encoding"] != "rowrec", 3)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()} for b in want]
    params0 = ref.init_params(cfg, seed, device)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    base = reference.run_steps(ref, params0, batches, cfg["lr"])
    out = {"cell": c.name, "seed": seed}
    for kind in KINDS:
        run = reference.run_steps(
            ref, params0, batches, cfg["lr"],
            precision=ref.CONTROL if kind == "control" else "float32",
            fault="" if kind == "control" else kind)
        gaps = reference.compare_steps(run, base, cfg["lr"])
        out[kind] = {k: gaps[k] for k in ("loss_gap", "grad_gap", "change_gap")}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--cells", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from perfbench import run

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        names = [w["name"] for w in json.load(f)["workloads"]]
    if args.cells:
        names = args.cells.split(",")
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for name in names:
        c = run.load_cell(name)
        for seed in (int(s) for s in args.seeds.split(",")):
            print(json.dumps(readings(c, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
