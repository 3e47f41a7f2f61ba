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

# the tracker, the launcher, the collective, the shard service, the
# journal and dsserve: numpy, sockets and subprocesses, without torch
TRACKER_MODULES = [
    "dmlc_core_tpu_torch.tracker",
    "dmlc_core_tpu_torch.tracker.protocol",
    "dmlc_core_tpu_torch.tracker.topology",
    "dmlc_core_tpu_torch.tracker.supervisor",
    "dmlc_core_tpu_torch.tracker.client",
    "dmlc_core_tpu_torch.tracker.tracker",
    "dmlc_core_tpu_torch.tracker.collective",
    # the dynamic shard service and the control-plane journal
    "dmlc_core_tpu_torch.tracker.shardsvc",
    "dmlc_core_tpu_torch.tracker.journal",
    "dmlc_core_tpu_torch.tracker.opts",
    "dmlc_core_tpu_torch.tracker.launcher",
    "dmlc_core_tpu_torch.tracker.submit",
    "dmlc_core_tpu_torch.tracker.backends",
    "dmlc_core_tpu_torch.tracker.backends.local",
    # the cluster backends and the YARN application master: launchers
    # that build commands and run binaries, without torch
    "dmlc_core_tpu_torch.tracker.backends.ssh",
    "dmlc_core_tpu_torch.tracker.backends.mpi",
    "dmlc_core_tpu_torch.tracker.backends.sge",
    "dmlc_core_tpu_torch.tracker.backends.slurm",
    "dmlc_core_tpu_torch.tracker.backends.mesos",
    "dmlc_core_tpu_torch.tracker.backends.kubernetes",
    "dmlc_core_tpu_torch.tracker.backends.tpu_pod",
    "dmlc_core_tpu_torch.tracker.backends.yarn",
    "dmlc_core_tpu_torch.tracker.yarn_am",
    # the telemetry the tracker records into, the profiler hooks and the
    # tools: torch only once a caller imports it
    "dmlc_core_tpu_torch.telemetry",
    "dmlc_core_tpu_torch.telemetry.registry",
    "dmlc_core_tpu_torch.telemetry.export",
    "dmlc_core_tpu_torch.telemetry.tracing",
    "dmlc_core_tpu_torch.telemetry.timeseries",
    "dmlc_core_tpu_torch.telemetry.aggregate",
    "dmlc_core_tpu_torch.utils.profiler",
    "dmlc_core_tpu_torch.utils.timer",
    "dmlc_core_tpu_torch.tools",
    "dmlc_core_tpu_torch.tools.__main__",
    # dsserve: a server process and the client's receive path load no
    # torch (the staging pipeline that adopts the slots does)
    "dmlc_core_tpu_torch.dsserve",
    "dmlc_core_tpu_torch.dsserve.wire",
    "dmlc_core_tpu_torch.dsserve.server",
    "dmlc_core_tpu_torch.dsserve.client",
    "dmlc_core_tpu_torch.concurrency",
    "dmlc_core_tpu_torch.concurrency.threaded_iter",
    "dmlc_core_tpu_torch.io.shm",
    "dmlc_core_tpu_torch.staging.batcher",
    "dmlc_core_tpu_torch.staging.fused",
    # the autoscale controller in the tracker, and the retry, fault and
    # span-fetch layers a dsserve server reads fault:// data through
    "dmlc_core_tpu_torch.tracker.autoscale",
    "dmlc_core_tpu_torch.io.filesystem",
    "dmlc_core_tpu_torch.io.retry",
    "dmlc_core_tpu_torch.io.faults",
    "dmlc_core_tpu_torch.io.spanfetch",
    "dmlc_core_tpu_torch.io.split",
    # the remote filesystems and the host-shared block cache (its daemon
    # is a tools process)
    "dmlc_core_tpu_torch.io.cloudfs",
    "dmlc_core_tpu_torch.io.blockcache",
    # live streams and point lookups: a stream writer and a lookup server
    # (tools serve) are processes without torch
    "dmlc_core_tpu_torch.stream",
    "dmlc_core_tpu_torch.stream.manifest",
    "dmlc_core_tpu_torch.stream.writer",
    "dmlc_core_tpu_torch.stream.source",
    "dmlc_core_tpu_torch.io.lookup",
    # parameter structs, registries and configs, the row-block iterators,
    # thread lifecycles and the common helpers: host code without torch
    "dmlc_core_tpu_torch.params",
    "dmlc_core_tpu_torch.params.parameter",
    "dmlc_core_tpu_torch.params.registry",
    "dmlc_core_tpu_torch.params.config",
    "dmlc_core_tpu_torch.examples.parameter_demo",
    "dmlc_core_tpu_torch.data.row_iter",
    "dmlc_core_tpu_torch.data.row_block",
    "dmlc_core_tpu_torch.concurrency.thread_group",
    "dmlc_core_tpu_torch.utils.common",
]

# the modules of the indexed, shuffled path, the checkpoints, the example
# ports (the online FM too), the codec layer, the tracker, dsserve,
# autoscale, the fault layer, the remote filesystems, the block cache, the
# streams and the point lookups: each must be among those imported
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
    "dmlc_core_tpu_torch.io.retry",
    "dmlc_core_tpu_torch.examples.train_online_fm",
    # the mesh, the data-parallel step and the rank script's entry
    "dmlc_core_tpu_torch.parallel",
    "dmlc_core_tpu_torch.parallel.mesh",
    "dmlc_core_tpu_torch.parallel.spmd",
    "dmlc_core_tpu_torch.entry",
    *TRACKER_MODULES,
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


def test_chip_smoke_imports_only_the_port_at_any_depth():
    """Every import in chip_smoke.py, inside functions and in the scripts
    it writes for its worker processes too, names the standard library,
    numpy, torch, the port or chip_smoke itself: no test module (whose
    conftest imports jax), nothing of JAX or of the JAX package; and no
    path of the tests is put on sys.path. The script's fake binaries are
    the test suite's."""
    import re

    sys.path.insert(0, str(REPO / "tests"))
    import chip_smoke
    import test_backend_fakes

    src = (REPO / "chip_smoke.py").read_text()
    names = set()
    for m in re.finditer(r"^\s*(?:from\s+([\w.]+)\s+import\b|import\s+([\w., ]+?)\s*(?:#.*)?$)",
                         src, re.M):
        parts = [m.group(1)] if m.group(1) else m.group(2).split(",")
        names |= {p.strip().split(" ")[0].split(".")[0] for p in parts}
    assert {"json", "numpy", "torch", "dmlc_core_tpu_torch"} <= names
    assert names - set(sys.stdlib_module_names) == {
        "numpy", "torch", "dmlc_core_tpu_torch", "chip_smoke"}
    assert not re.search(r"sys\.path\.(insert|append)\([^\n]*tests", src)
    assert set(chip_smoke.FOREIGN_MODULES) >= {"jax", "jaxlib", "dmlc_core_tpu"}
    assert chip_smoke.FAKE_BINARIES == {"ssh": test_backend_fakes.FAKE_SSH,
                                        "srun": test_backend_fakes.FAKE_SRUN,
                                        "mpirun": test_backend_fakes.FAKE_MPIRUN}


_TRACKER_PROBE = """
import importlib, sys
sys.path.insert(0, {repo!r})
for m in {mods!r}:
    importlib.import_module(m)
print(sorted(n for n in sys.modules if n.split(".")[0] in ("torch", "jax", "dmlc_core_tpu")))
"""


def test_tracker_modules_load_neither_torch_nor_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _TRACKER_PROBE.format(repo=str(REPO), mods=TRACKER_MODULES)],
        capture_output=True, text=True, timeout=120, cwd=str(REPO), env=_clean_env(),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_a_rank_process_loads_neither_jax_nor_the_jax_package(tmp_path):
    """The rank script of ``dryrun_multichip`` (``python -m
    dmlc_core_tpu_torch.entry --dryrun-rank``), run whole in a world of
    one: the modules it loaded include no ``jax`` and no
    ``dmlc_core_tpu``."""
    import json

    env = dict(_clean_env(), DMLC_NUM_WORKER="1")
    env.pop("DMLC_TRACKER_URI", None)
    proc = subprocess.run(
        [sys.executable, "-m", "dmlc_core_tpu_torch.entry", "--dryrun-rank", "cpu",
         str(tmp_path)],
        capture_output=True, text=True, timeout=120, cwd=str(REPO), env=env,
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads((tmp_path / "rank0.json").read_text())
    assert report["steps"] == 2 and report["mesh"] == {"data": 1}
    assert report["foreign_modules"] == []


def test_cryptography_is_imported_lazily():
    """The card's host has no ``cryptography``: no port module, nor
    chip_smoke, imports it at import time (``cloudfs`` imports it only
    to mint a service-account token), and the registry resolves every
    remote scheme without it."""
    probe = _PROBE + """
from dmlc_core_tpu_torch.io.filesystem import FileSystem
for u in ("http://h/x", "https://h/x", "s3://b/k", "gs://b/k", "hdfs://n/x",
          "viewfs://n/x", "azure://c/b"):
    print("FS", u, type(FileSystem.get_instance(u)).__name__)
print("CRYPTO", [n for n in sys.modules if n.split(".")[0] == "cryptography"])
"""
    proc = subprocess.run(
        [sys.executable, "-c", probe.format(repo=str(REPO))],
        capture_output=True, text=True, timeout=120, cwd=str(REPO), env=_clean_env(),
    )
    assert proc.returncode == 0, proc.stderr
    assert "CRYPTO []" in proc.stdout.splitlines()
    got = {line.split()[1]: line.split()[2] for line in proc.stdout.splitlines()
           if line.startswith("FS ")}
    assert got == {"http://h/x": "HttpFileSystem", "https://h/x": "HttpFileSystem",
                   "s3://b/k": "S3FileSystem", "gs://b/k": "GCSFileSystem",
                   "hdfs://n/x": "WebHdfsFileSystem", "viewfs://n/x": "WebHdfsFileSystem",
                   "azure://c/b": "AzureBlobFileSystem"}


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
