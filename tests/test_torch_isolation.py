"""The port stands alone: importing every module of dmlc_core_tpu_torch
and chip_smoke loads neither jax nor any dmlc_core_tpu module; its native
parse core is the library built from its own fastparse.cc; entry points
default to the card and raise when there is none; chip_smoke fails
without a card, and in a directory without the repo."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch import convert, entry as entry_mod
from dmlc_core_tpu_torch.examples import train_criteo_rec, train_higgs
from dmlc_core_tpu_torch.models import FactorizationMachine, LogisticRegression
from dmlc_core_tpu_torch.staging import pipeline
from dmlc_core_tpu_torch.staging.batcher import BatchSpec, FixedShapeBatcher
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.utils.logging import Error

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import dmlc_core_tpu_torch
for m in pkgutil.walk_packages(dmlc_core_tpu_torch.__path__, "dmlc_core_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.")
             or n == "dmlc_core_tpu" or n.startswith("dmlc_core_tpu."))
print("LOADED", len([n for n in sys.modules if n.startswith("dmlc_core_tpu_torch.")]))
print("BAD", bad)
print("NAMES", " ".join(sorted(n for n in sys.modules if n.startswith("dmlc_core_tpu_torch."))))
"""

# the modules of the indexed, shuffled path, the checkpoints, the example
# ports and the codec layer: each must be among those imported
NEW_MODULES = {
    "dmlc_core_tpu_torch.checkpoint",
    "dmlc_core_tpu_torch.io.stream",
    "dmlc_core_tpu_torch.io.filesystem",
    "dmlc_core_tpu_torch.io.serializer",
    "dmlc_core_tpu_torch.io.split",
    "dmlc_core_tpu_torch.io.recordio",
    "dmlc_core_tpu_torch.examples",
    "dmlc_core_tpu_torch.examples._common",
    "dmlc_core_tpu_torch.examples.train_higgs",
    "dmlc_core_tpu_torch.examples.train_criteo_rec",
    "dmlc_core_tpu_torch.io.codec",
    "dmlc_core_tpu_torch.utils.env",
}


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=120, cwd=str(REPO), env=_clean_env(),
    )
    assert proc.returncode == 0, proc.stderr
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines())
    assert int(lines["LOADED"]) >= 30  # every module was imported
    assert NEW_MODULES <= set(lines["NAMES"].split())
    assert lines["BAD"] == "[]"


def test_default_device_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = next(FixedShapeBatcher(BatchSpec(batch_size=1, max_nnz=1)).batches(
        [RowBlock(offset=np.array([0, 1]), label=np.zeros(1, np.float32),
                  index=np.zeros(1, np.uint32))]))
    calls = [
        lambda: entry_mod.entry(),
        lambda: pipeline.StagingPipeline([]),
        lambda: pipeline.stage_batch(batch),
        lambda: FactorizationMachine(8, 2),
        lambda: LogisticRegression(8),
        lambda: convert.params_from_jax({"w": np.zeros(2, np.float32)}),
        lambda: train_higgs.main(["unused.libsvm"]),
        lambda: train_criteo_rec.main(["unused.rec"]),
    ]
    for call in calls:
        with pytest.raises(Error, match="torch.cuda.is_available"):
            call()


_MAPS_PROBE = """
import sys
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.data import native
native.parse_libsvm(b"1 0:1\\n", 0)
with open("/proc/self/maps") as f:
    for line in f:
        if ".so" in line and ("fastparse" in line or "dmlc_tpu" in line):
            print(line.split()[-1])
"""


def test_port_loads_only_its_own_native_library():
    """The port's parse core is the library built from its own
    fastparse.cc under .build/native/, never the JAX package's."""
    proc = subprocess.run(
        [sys.executable, "-c", _MAPS_PROBE.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=300, cwd=str(REPO), env=_clean_env(),
    )
    assert proc.returncode == 0, proc.stderr
    mapped = set(proc.stdout.split())
    assert mapped, "no native library mapped"
    assert not any("libdmlc_tpu_native" in m for m in mapped)
    assert all(Path(m).parent == REPO / ".build" / "native" for m in mapped), mapped


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path, alone):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    script = REPO / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=120, cwd=str(script.parent), env=_clean_env(),
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_only_the_codec_layer_imports_compression():
    """io/codec.py is the port's one compression site: no other module of
    the port, nor chip_smoke.py, imports zlib, gzip, zstandard or lz4."""
    import ast

    banned = {"zlib", "gzip", "zstandard", "lz4"}
    sources = [*sorted((REPO / "dmlc_core_tpu_torch").rglob("*.py")), REPO / "chip_smoke.py"]
    found = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            if any(n.split(".")[0] in banned for n in names):
                found.append(f"{path.relative_to(REPO)}:{node.lineno}")
    # zlib, and the guarded zstandard and lz4, all in io/codec.py
    assert {f.split(":")[0] for f in found} == {"dmlc_core_tpu_torch/io/codec.py"}
    assert len(found) == 3
