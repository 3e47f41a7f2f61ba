"""Parent against change on one card: the Criteo FM slice and a
full-width 2-worker ring job, driven through the ``chip_smoke.py`` of
the tree it runs in.

    cd <tree> && python3 <repo>/chip_ab.py <label>

Run it from the root of each tree (a ``git archive`` of the parent
unpacked into a git-ignored directory, and of the change), in turns
(parent, change, change, parent) within one chip call, so both see the
same card and host. It builds that tree's kernels and parse core, drives
5 passes of the 128-step FM path (D = 2^20, E = 16, K = 39, B = 2048,
f32, ``picked_threads`` producers) after a warm-up pass, then 12 ring
steps of 2 workers over 2^16 indexed rows, and prints one line
``AB {...}``: each FM pass's staged rows/s, wait share and step ms, and
each rank's median step split (steps 3-12).
"""

import json
import os
import statistics
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.getcwd())  # the tree under test, not this file's
import chip_smoke as cs  # noqa: E402
from dmlc_core_tpu_torch.data import native  # noqa: E402
from dmlc_core_tpu_torch.models import FactorizationMachine  # noqa: E402
from dmlc_core_tpu_torch.ops import _build  # noqa: E402
from dmlc_core_tpu_torch.staging.batcher import BatchSpec  # noqa: E402

FM_PASSES, RING_STEPS, RING_ROWS = 5, 12, 1 << 16


def main(label: str) -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this comparison needs a GPU")
    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(_build.build), pool.submit(native.build)]:
            f.result()
    dev = torch.device("cuda", 0)
    out = {"tree": label, "fm": [], "ring": []}
    with tempfile.TemporaryDirectory() as tmp:
        idx, val, labels = cs.criteo_data(np.random.default_rng(0), cs.N_BATCHES * cs.B, cs.D)
        rec = cs.write_file(os.path.join(tmp, "criteo.rec"), cs.rowrec_bytes(idx, val, labels),
                            cs.SLICE_REPEATS)
        spec = BatchSpec(batch_size=cs.B, max_nnz=cs.K, value_dtype=np.float32)
        threads = cs.picked_threads(cs.N_BATCHES * cs.B * cs.SLICE_REPEATS, cs.B)

        def make():
            return FactorizationMachine(cs.D, cs.E, device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(0))

        cs.drive("warm", make(), cs.native_source(rec, spec, threads), dev, 0.5)
        for _ in range(FM_PASSES):
            st, _, _ = cs.drive("fm", make(), cs.native_source(rec, spec, threads), dev, 0.5)
            out["fm"].append({k: st[k] for k in ("staged_rows_per_sec", "wait_share",
                                                 "step_ms")})
        irec = cs.write_indexed(os.path.join(tmp, "c.rec"),
                                *cs.criteo_data(np.random.default_rng(3), RING_ROWS, cs.D))
        script = os.path.join(tmp, "w.py")
        with open(script, "w") as f:
            f.write(cs.COLL_WORKER.format(repo=os.getcwd()))
        prefix = os.path.join(tmp, "ring")
        _, wall = cs.submit_job(["--num-workers", "2", sys.executable, script, irec, prefix,
                                 "ring", str(RING_STEPS), "0.5", "cuda", str(cs.D), str(cs.E),
                                 str(cs.B), str(cs.K)])
        for r in range(2):
            with open(f"{prefix}.rank{r}.json") as f:
                res = json.load(f)
            out["ring"].append({k: statistics.median(v[2:]) * 1e3
                                for k, v in res["split_s"].items()})
        out["ring_wall_s"] = wall
    print("AB " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
