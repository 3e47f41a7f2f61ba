"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import json
import os
import re

import pytest

from perfbench import run

ROOT = run.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"][1] == "perfbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith("perfbench/") and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert w["config"] in names and one_line(w["why"])
        names.append(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"rows_per_s", "setup_s"}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) < 64 * 1024


def test_configs_state_what_they_reduce():
    for c in bench()["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and all(k in cfg for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, "perfbench", "configs", c["name"] + ".py"))


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_the_harness_finds_a_cells_files_by_name(cell):
    c = run.load_cell(cell)
    assert c.config["name"] == c.cell["config"]
    assert c.traffic["batch_size"] > 0 and set(c.limits) == {
        "loss_gap", "grad_gap", "change_gap", "batch_mismatch", "batch_sum_mismatch",
        "epoch_rows_gap", "nonfinite_losses"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(run.load_metric(m["name"]).read)
    assert {m["name"] for m in c.end_to_end} == {"rows_per_s", "setup_s"}
