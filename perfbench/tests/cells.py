"""The cells the tests drive: those of BENCHMARK.json, and the
``criteo_fm`` cells whose files wait under ``perfbench/`` for a later
change to list them in BENCHMARK.json (PERF.md, Open questions), with
the configuration and the kernels' rooflines they report."""

import json
import os

from perfbench import run

SOURCE = "https://www.csie.ntu.edu.tw/~cjlin/libsvmtools/datasets/binary.html#criteo"
WAITING_CONFIG = {"name": "criteo_fm", "source": SOURCE,
                  "file": "perfbench/configs/criteo_fm.json", "reduced": ["train_rows"],
                  "why": "second-order FM over 39 hashed Criteo fields (K1-K4)"}
WAITING = [{"name": f"criteo_fm.{t}", "config": "criteo_fm", "traffic": t, "chips": 1,
            "why": f"{t}, B 8192, the port's default threads"} for t in ("rec_seq", "libsvm")]
ROOFLINES = ("ell_matvec_fwd", "ell_matvec_bwd", "fm_pair_fwd", "fm_pair_bwd")


def bench() -> dict:
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        out = json.load(f)
    names = [w["name"] for w in WAITING]
    out["configs"].append(WAITING_CONFIG)
    out["workloads"] += WAITING
    for m in out["per_layer"]:
        m["workloads"] = m["workloads"] + names
    out["per_layer"] += [{"name": f"roofline.{k}", "unit": "%", "better": "higher",
                          "source": "device_trace", "layer": "kernels",
                          "moves": "rows_per_s", "workloads": names} for k in ROOFLINES]
    return out


def load(name: str, override=None):
    return run.load_cell(name, override, bench())
