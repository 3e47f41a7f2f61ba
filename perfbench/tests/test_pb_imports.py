"""What a run may load: never JAX nor the JAX package, compared by whole
top-level module names; the plain side imports nothing of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "dmlc_core_tpu", "benchmarks", "bench", "chip_smoke"}


def imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_foreign_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dmlc_core_tpu_torch_fake", object())
    assert "dmlc_core_tpu" not in run.foreign_modules()
    monkeypatch.setitem(sys.modules, "dmlc_core_tpu.io.fake", object())
    assert "dmlc_core_tpu" in run.foreign_modules()


@pytest.mark.parametrize("path", sorted(sources()))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "gen.py", "encode.py", "configs/criteo_fm.py",
                                  "configs/higgs_lr.py"])
def test_the_plain_side_imports_nothing_of_the_program(name):
    assert "dmlc_core_tpu_torch" not in imports(os.path.join(HERE, name))


def cli(cwd):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "higgs_lr.csv",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def no_result(proc):
    return proc.returncode != 0 and not any(
        line.startswith("{") for line in proc.stdout.splitlines())


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert no_result(cli(run.ROOT))


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    with open(tmp_path / "BENCHMARK.json") as f:
        paths = json.load(f)["paths"]
    for p in paths:
        shutil.copytree(os.path.join(run.ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    assert no_result(cli(tmp_path))
