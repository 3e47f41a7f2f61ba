"""Run one cell of the benchmark of ``dmlc_core_tpu_torch`` once.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's cards. The run
generates the cell's file from the seed into ``$TMPDIR``, makes the
weights on the card from the seed, builds (first run in a checkout) or
loads the port's kernels and parse core from the checkout's ``.build/``,
trains through the first steps and one whole epoch (set-up), then
trains for ``--seconds`` seconds (the window) and prints one JSON line
last on standard output. With ``--trace 1`` it also drains the producer
alone before the window and profiles a slice after it, and the line
holds the per-layer metrics instead of the end-to-end ones. The check
that decides ``correct`` runs after the window (``reference.py``); each
number it compares is printed beside its limit on standard error and
under ``checks``, last in the line.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Dict, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules no run may hold once its window has closed
FOREIGN = ("jax", "jaxlib", "flax", "dmlc_core_tpu")
FIRST_STEPS = 3         # the steps the reference follows
PROFILE_SECONDS = 2.0   # the profiled slice after a traced window
# set-up batches copied whole for the check: the producer's ring (10
# slots) and the pipeline's pinned slots (4) wrap several times over them
EXACT_BATCHES = 40
SAMPLE_EVERY = 8        # a window batch's sums are kept with odds 1 in 8
BAD_SUM = -(1 << 63)    # a batch array of the wrong type or size


def read_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_cell(name: str, override: Optional[dict] = None,
              bench: Optional[dict] = None) -> SimpleNamespace:
    """The cell's entry in BENCHMARK.json (or ``bench``) with its
    configuration, traffic mix, limits and per-layer metrics, each found
    by name."""
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = read_json(os.path.relpath(os.path.join(ROOT, cfg["file"]), HERE))
    traffic = read_json("traffic", cell["traffic"] + ".json")
    override = override or {}
    config.update(override.get("config", {}))
    traffic.update(override.get("traffic", {}))
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return SimpleNamespace(name=name, cell=cell, config=config, traffic=traffic,
                           limits=read_json("limits", name + ".json"), per_layer=per_layer,
                           end_to_end=[m for m in bench["end_to_end"]
                                       if name in m.get("workloads", [name])])


def load_metric(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def foreign_modules():
    """The top-level names in ``sys.modules`` that no run may load,
    compared whole (``dmlc_core_tpu_torch`` is not ``dmlc_core_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FOREIGN))


def power_limit() -> Optional[float]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def distinct_ids(idx, batch: int) -> float:
    """``u``: the mean number of distinct ids in ``batch`` consecutive rows."""
    import numpy as np

    n = len(idx) // batch
    return float(np.mean([len(np.unique(idx[i * batch:(i + 1) * batch])) for i in range(n)]))


class BatchLog:
    """What the check reads of the staged batches, as the loop hands them
    to the step: the first ``EXACT_BATCHES`` copied to the host whole,
    then ``reference.batch_sums`` worked out on the device for every
    later batch of set-up and for a sample of the window's, drawn from
    the seed; each with its place in its epoch."""

    def __init__(self, want: Dict, seed: int, device) -> None:
        import numpy as np
        import torch

        from perfbench import reference

        self.names = sorted(want)
        self.dtypes = {k: torch.from_numpy(want[k][:0]).dtype for k in self.names}
        span = max(a.size for a in want.values())
        self.pos_w = torch.arange(span, device=device) % reference.SUM_SPAN + 1
        self.rng = np.random.default_rng([seed, 0xC4EC])
        self.window = False
        self.exact, self.exact_places = [], []
        self.sums, self.places = [], []
        self.window_sums = 0

    def __call__(self, batch: Dict, pos: int) -> None:
        import torch

        if not self.window and len(self.exact) < EXACT_BATCHES:
            self.exact.append({k: t.cpu() for k, t in batch.items()})
            self.exact_places.append(pos)
            return
        if self.window:
            if self.rng.random() * SAMPLE_EVERY >= 1.0:
                return
            self.window_sums += 1
        out = []
        for k in self.names:
            t = batch.get(k)
            if t is None or t.dtype != self.dtypes[k] or t.numel() > self.pos_w.numel():
                out.append(torch.full((), BAD_SUM, dtype=torch.int64, device=self.pos_w.device))
                continue
            flat = t.reshape(-1).view(torch.int32).to(torch.int64)
            out.append((flat * self.pos_w[:flat.numel()]).sum())
        self.sums.append(torch.stack(out))
        self.places.append(pos)


def drain_rate(source, batches: int) -> float:
    """Valid rows a second of ``source`` drained alone for ``batches``."""
    t0, rows = time.perf_counter(), 0
    try:
        for n, b in enumerate(source, 1):
            rows += b.n_valid
            if n >= batches:
                break
        return rows / (time.perf_counter() - t0)
    finally:
        source.close()


def check(c: SimpleNamespace, rows, layout, prog: dict, log: BatchLog, parts: int,
          device) -> tuple:
    """The numbers that decide ``correct``, each beside its limit, and the
    per-leaf gaps: the plain reference works the batches out from the
    generated rows, holds the staged ones to them and follows the
    program's first steps."""
    import numpy as np
    import torch

    from perfbench import reference

    cfg, traffic = c.config, c.traffic
    B = traffic["batch_size"]
    plan = reference.epoch_plan(layout, parts, B, traffic["encoding"] != "rowrec")
    want = [reference.make_batch(rows, layout, *plan[p], B) if p < len(plan) else {}
            for p in log.exact_places]
    held = np.concatenate([layout.order(np.arange(f, f + n)) for f, n in plan[:FIRST_STEPS]])
    if len(np.unique(held)) != len(held):
        raise RuntimeError("the first batches repeat rows: change rotate_rows")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        batches = [{k: torch.from_numpy(v).to(device) for k, v in b.items()}
                   for b in want[:FIRST_STEPS]]
        ref_out = reference.run_steps(reference.config_reference(cfg["name"]),
                                      prog["start"], batches, cfg["lr"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    gaps = reference.compare_steps(prog, ref_out, cfg["lr"])
    epoch_rows = prog["epoch_rows"]
    numbers = {"loss_gap": gaps["loss_gap"], "grad_gap": gaps["grad_gap"],
               "change_gap": gaps["change_gap"],
               "batch_mismatch": (reference.batch_mismatches(log.exact, want)
                                  + sum(p != i for i, p in enumerate(log.exact_places))),
               "batch_sum_mismatch": (reference.sum_mismatches(
                   prog["sums"], np.array(log.places), rows, layout, plan, B)
                   + (log.window_sums == 0)),
               "epoch_rows_gap": (sum(abs(r - layout.rows) for r in epoch_rows)
                                  if epoch_rows else math.inf),
               "nonfinite_losses": prog["nonfinite"]}
    return {k: {"value": v, "limit": c.limits[k]} for k, v in numbers.items()}, gaps["leaves"]


def per_layer(c: SimpleNamespace, window: dict, capture, producer_rate, u: float, kind: str,
              cuda: bool) -> Dict[str, dict]:
    """The cell's per-layer metrics, each read by its own file; a reader
    that finds nothing to read leaves its metric out."""
    cfg, b = c.config, c.traffic["batch_size"]
    peaks = read_json("peaks.json")["devices"].get(kind)

    def least_seconds(nbytes, flops):
        if peaks is None:
            return None
        return max(nbytes / peaks["bytes_per_s"], flops / peaks["float32_flops"])

    def roofline(parts, work):
        if capture is None or peaks is None:
            return None
        secs, events = capture.kernel(parts)
        if not events or secs <= 0:
            return None
        least = least_seconds(*work(b, cfg.get("max_nnz", 0), cfg.get("embed_dim", 0), u))
        return 100.0 * least / (secs / events)

    ctx = SimpleNamespace(
        window=window, trace=capture, producer_rows_per_s=producer_rate,
        least_seconds=least_seconds, roofline=roofline,
        power_limit_w=power_limit() if cuda else None,
        counts={"model": cfg["model"], "B": b, "K": cfg.get("max_nnz", 0),
                "E": cfg.get("embed_dim", 0), "F": cfg["num_features"], "u": u})
    metrics = {}
    for m in c.per_layer:
        got = load_metric(m["name"]).read(ctx)
        if got is None:
            continue
        value, extra = got if isinstance(got, tuple) else (got, {})
        metrics[m["name"]] = {"value": value, "unit": m["unit"], **extra}
    return metrics


def run_cell(c: SimpleNamespace, seed: int, seconds: float, trace: bool, device,
             t_process: float) -> dict:
    """One run of cell ``c`` on ``device``; returns the result's line
    as a dict (``checks`` last)."""
    import numpy as np
    import torch

    from dmlc_core_tpu_torch.data import native

    from perfbench import gen, reference
    from perfbench import trace as trace_mod
    from perfbench.loop import Feed, Stepper

    cfg, traffic = c.config, c.traffic
    adapter = importlib.import_module(f"perfbench.models.{cfg['model']}")
    ref = reference.config_reference(cfg["name"])
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda *a: None)
    B = traffic["batch_size"]
    traffic = dict(traffic, file_rows=cfg["train_rows"])
    workdir = tempfile.mkdtemp(prefix="perfbench-")
    marks = {"start": time.perf_counter() - t_process}
    try:
        rows, layout, path = gen.make_input(seed, cfg, traffic, workdir)
        marks["input"] = time.perf_counter() - t_process
        uri = path + traffic["query"]
        u = distinct_ids(rows.idx, B) if rows.idx is not None else 0.0
        if cuda:
            from dmlc_core_tpu_torch.ops import _build

            _build.build()
        native.load()
        marks["builds"] = time.perf_counter() - t_process
        params0 = ref.init_params(cfg, seed, device)
        model = adapter.build(cfg, params0, device)
        sync()
        marks["model"] = time.perf_counter() - t_process
        spec = adapter.spec(cfg, traffic)
        log = BatchLog(reference.make_batch(rows, layout, 0, 0, B), seed, device)
        feed = Feed(lambda e: adapter.source(uri, spec), device)
        stepper = Stepper(model, cfg["lr"], feed)

        # set-up: the first steps, kept for the check, then whole epochs
        it = feed.epoch(0)
        snap = {}
        for i in range(FIRST_STEPS):
            stepper.run(it, until=lambda: stepper.steps > i, on_batch=log)
            if i == 0 or i == FIRST_STEPS - 1:
                snap[i] = {k: p.detach().clone() for k, p in model.params().items()}
        first_losses = list(stepper.losses)
        marks["first_steps"] = time.perf_counter() - t_process
        epoch = 0
        while True:
            if not stepper.run(it, until=lambda: False, on_batch=log):
                epoch += 1
                if epoch >= traffic["warmup_epochs"]:
                    break
                it = feed.epoch(epoch)
        producer_rate = (drain_rate(adapter.source(uri, spec), traffic["producer_batches"])
                         if trace else None)
        sync()
        setup_s = time.perf_counter() - t_process

        # the window
        log.window = True
        stepper.reset_clocks()
        stepper.losses = []
        feed.stage_dispatch_s, feed.staged_batches = 0.0, 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        now = time.perf_counter
        while True:
            it = feed.epoch(epoch)
            if stepper.run(it, until=lambda: now() >= deadline, on_batch=log):
                break
            epoch += 1
        sync()
        t1 = time.perf_counter()
        thr = (feed.pipe.throughput() if feed.pipe is not None
               else {"secs_stage_dispatch": 0.0, "batches": 0})
        window = {"seconds": t1 - t0, "steps": stepper.steps, "rows": stepper.rows,
                  "wait_s": stepper.wait_s, "step_s": stepper.step_s,
                  "starts": list(stepper.starts),
                  "stage_dispatch_s": feed.stage_dispatch_s + thr["secs_stage_dispatch"],
                  "staged_batches": feed.staged_batches + int(thr["batches"])}
        window_losses = torch.stack(stepper.losses) if stepper.losses else torch.zeros(0)

        capture = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                feed.span = record_function
                end = time.perf_counter() + PROFILE_SECONDS
                while not stepper.run(it, until=lambda: now() >= end):
                    epoch += 1
                    it = feed.epoch(epoch)
                sync()
                feed.span = lambda name: contextlib.nullcontext()
            capture = trace_mod.load(prof, workdir)
        it.close()
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        nonfinite = int((~torch.isfinite(window_losses)).sum())
        first_losses = [float(x) for x in first_losses]
        epoch_rows = list(feed.epoch_rows)
        parts = feed.parts
        sums = (torch.stack(log.sums).cpu().numpy() if log.sums
                else np.zeros((0, len(log.names)), np.int64))
        log.sums = []
        del model, feed, stepper, it, window_losses
        if cuda:
            torch.cuda.empty_cache()

        # the check: the plain reference from the generated rows
        t_check = time.perf_counter()
        prog = {"start": params0, "after1": snap[0], "after": snap[FIRST_STEPS - 1],
                "losses": first_losses, "sums": sums, "epoch_rows": epoch_rows,
                "nonfinite": nonfinite}
        checks, leaves = check(c, rows, layout, prog, log, parts, device)
        marks["check_s"] = time.perf_counter() - t_check
        correct = all(v["value"] <= v["limit"] for v in checks.values())

        dev_info = {"platform": "gpu" if cuda else device.type,
                    "kind": torch.cuda.get_device_name(device) if cuda else device.type,
                    "count": 1, "memory_peak_bytes": int(peak)}
        if not trace:
            metrics = {"rows_per_s": {"value": window["rows"] / window["seconds"],
                                      "unit": "rows/s"},
                       "setup_s": {"value": setup_s, "unit": "s"}}
            out = {"correct": correct, "attempted": window["steps"], "failed": nonfinite,
                   "metrics": metrics, "device": dev_info}
        else:
            metrics = per_layer(c, window, capture, producer_rate, u, dev_info["kind"], cuda)
            if capture is not None:
                dev_info["busy_s"] = capture.busy_s
                dev_info["window_s"] = capture.window_s
            out = {"correct": correct, "attempted": window["steps"], "failed": nonfinite,
                   "metrics": metrics, "device": dev_info}
            if capture is not None:
                out["breakdown"] = capture.breakdown()
        out["info"] = {"producer_parts": parts, "torch_threads": torch.get_num_threads(),
                       "batches_whole": len(log.exact), "batches_summed": len(log.places),
                       "window_batches_summed": log.window_sums, "u": u,
                       "epochs_whole": len(epoch_rows),
                       "window_steps": window["steps"], "window_rows": window["rows"],
                       "file_bytes": int(layout.starts[-1]), "leaves": leaves,
                       "setup_marks_s": marks}
        out["checks"] = checks
        return out
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache a run builds stays in the checkout, at fixed paths
    build = os.path.join(ROOT, ".build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    c = load_cell(args.workload)
    import torch

    chips = int(c.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    out = run_cell(c, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   T_PROCESS)
    found = foreign_modules()
    if found:
        print(f"no result: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in out["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
