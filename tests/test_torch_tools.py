"""The port's ``python -m dmlc_core_tpu_torch.tools`` (info, trace, top)
and the tracker's telemetry endpoint, with both packages on the wire:
``tools info`` (a copy of tests/test_tools.py::test_info_reports_features
with the port's torch section), ``info <uri>`` refused, a port worker
heartbeating to a JAX tracker and a JAX worker to a port tracker with
``tools top --once --json`` of each package against each tracker, a
pinned ``DMLC_METRICS_PORT``, the ``DMLC_METRICS_REPORT`` end-of-job
report, and ``trace report`` on a recorded file. Every tracker is closed
and joined with a timeout."""

import json
import socket
import subprocess
import sys
import time

import pytest

from dmlc_core_tpu import tools as jax_tools
from dmlc_core_tpu.telemetry import default_registry as jax_default_registry
from dmlc_core_tpu.telemetry import timeseries as jax_ts
from dmlc_core_tpu.tracker import client as jax_client
from dmlc_core_tpu.tracker import tracker as jax_tracker
from dmlc_core_tpu_torch import tools
from dmlc_core_tpu_torch.telemetry import default_registry, tracing
from dmlc_core_tpu_torch.telemetry import timeseries as ts
from dmlc_core_tpu_torch.tracker import client as port_client
from dmlc_core_tpu_torch.tracker import tracker as port_tracker

JOIN_S = 30
TRACKERS = {"port": port_tracker.RabitTracker, "jax": jax_tracker.RabitTracker}
WORKERS = {"port": port_client.RabitWorker, "jax": jax_client.RabitWorker}
TOOLS = {"port": tools, "jax": jax_tools}


def run_cli(argv, capsys, mod=tools):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_info_reports_features(capsys):
    """`tools info` emits the build_info report: the port's parse core
    and its fused producers, the codecs, and the torch runtime with the
    CUDA kernels' source hash; importing the package initialised no
    CUDA."""
    from dmlc_core_tpu_torch.data import native as native_mod
    from dmlc_core_tpu_torch.io.codec import available_codecs
    from dmlc_core_tpu_torch.ops import _build

    rc, out, _ = run_cli(["info"], capsys)
    assert rc == 0
    info = json.loads(out)
    assert info["native_available"] is True
    assert info["native_source_hash"] == native_mod.source_sha256()
    assert set(info["fused_kernels"]) == {
        "libsvm_dense", "csv_dense", "rowrec_ell", "libfm_ell",
        "libsvm_ell",
    }
    assert all(info["fused_kernels"].values())
    assert info["codecs"] == available_codecs()
    assert {"raw", "zlib", "gzip"} <= set(info["codecs"])
    import torch

    assert info["torch"]["version"] == torch.__version__
    assert info["torch"]["cuda"] == torch.version.cuda
    assert info["torch"]["device_count"] == len(info["torch"]["devices"])
    assert info["kernels"]["source_sha256"] == _build.source_sha256()
    assert info["kernels"]["names"] == sorted(_build.KERNELS)


def test_package_import_loads_no_torch():
    probe = ("import sys, dmlc_core_tpu_torch, dmlc_core_tpu_torch.tools; "
             "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def test_info_with_a_shard_uri_names_the_roadmap_item(capsys):
    rc, _, err = run_cli(["info", "corpus.rec"], capsys)
    assert rc == 1
    assert "ROADMAP.md §1 item 7" in err


@pytest.mark.parametrize("argv", [["cached", "stats"], ["cached", "flush"]])
def test_cached_names_the_roadmap_item(capsys, tmp_path, argv):
    """``tools cached``, which named ROADMAP.md §1 item 8b until that
    item was ported, now runs the JAX package's subcommand: with no
    daemon on the socket both packages fail alike, rc 1 and the same
    message."""
    argv = [*argv, "--socket", str(tmp_path / "absent.sock")]
    got = run_cli(argv, capsys)
    want = run_cli(argv, capsys, mod=jax_tools)
    assert got == want
    assert got[0] == 1 and "no block-cache daemon" in got[2]


def test_trace_report_prints_the_stall_attribution(tmp_path, capsys):
    tracing.reset()
    tracing.set_enabled(True)
    try:
        for _ in range(3):
            with tracing.span("dmlc:transfer_wait"):
                time.sleep(0.003)
            with tracing.span("dmlc:step"):
                time.sleep(0.001)
        path = tracing.dump(str(tmp_path / "t.json"))
    finally:
        tracing.set_enabled(None)
        tracing.reset()
    rc, out, _ = run_cli(["trace", "report", path, "--gap-ms", "1"], capsys)
    assert rc == 0
    assert "transfer_wait" in out and "starvation gaps >= 1.0 ms: 3" in out
    rc, out, _ = run_cli(["trace", "report", path, "--json"], capsys)
    assert json.loads(out) == tracing.stall_report(tracing.load_trace(path))
    # one file in, one out: the operator errors are the JAX tool's
    assert run_cli(["trace", "merge", path], capsys)[0] == 2
    assert run_cli(["trace", "dump"], capsys)[0] == 2


def _heartbeat_rows(worker_pkg, tracker, rows_per_beat):
    """One rendezvoused worker of ``worker_pkg`` that counts rows into its
    package's registry and heartbeats between increments."""
    w = WORKERS[worker_pkg]("127.0.0.1", tracker.port, jobid="0")
    w.start(world_size=1)
    reg = default_registry() if worker_pkg == "port" else jax_default_registry()
    c = reg.counter("io.split.records")
    for _ in range(4):
        c.inc(rows_per_beat)
        time.sleep(0.12)
        w.heartbeat()
    return w


@pytest.mark.parametrize("worker_pkg,tracker_pkg", [("port", "jax"), ("jax", "port")])
def test_cross_package_heartbeats_and_top(monkeypatch, capsys, worker_pkg, tracker_pkg):
    """A worker of one package heartbeats to the other's tracker; the
    tracker's /metrics.json?window= answers nonzero windowed rows/s for
    the rank, and ``tools top --once --json`` of BOTH packages against
    that tracker derive the same model."""
    monkeypatch.setenv("DMLC_TS_INTERVAL", "0.1")
    monkeypatch.setenv("DMLC_TS", "on")
    tracker = TRACKERS[tracker_pkg]("127.0.0.1", 1)
    tracker.start(1)
    try:
        w = _heartbeat_rows(worker_pkg, tracker, 500)
        assert tracker.metrics.updates >= 4
        models = {}
        for pkg in ("port", "jax"):
            rc, out, err = run_cli(
                ["top", str(tracker.metrics_port), "--once", "--json", "--window", "60"],
                capsys, TOOLS[pkg])
            assert rc == 0, err
            models[pkg] = json.loads(out)
        assert models["port"]["ranks"]["0"]["rows_per_sec"] > 0
        # the two renderings of one endpoint agree (the tracker's own
        # sampler may add a sample between the two scrapes)
        assert models["port"]["ranks"]["0"] == models["jax"]["ranks"]["0"]
        rc, out, _ = run_cli(["top", str(tracker.metrics_port), "--once"], capsys)
        assert rc == 0 and "dmlc top" in out and "rows/s" in out
        w.shutdown()
        deadline = time.monotonic() + JOIN_S  # the JAX join has no timeout
        while tracker.alive():
            assert time.monotonic() < deadline
            time.sleep(0.05)
    finally:
        tracker.close()
    rep = tracker.metrics_report
    assert rep is not None and rep["per_rank"]["0"]["counters"]["io.split.records"] > 0


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_port_pins_the_endpoint_and_report_is_written(monkeypatch, capsys, tmp_path):
    """DMLC_METRICS_PORT binds the tracker's endpoint to that port (and
    ``tools top`` with no endpoint reads it from the same variable);
    DMLC_METRICS_REPORT receives the end-of-job report; the port closes
    with the tracker, so a relaunch on the pinned port binds again."""
    port = _free_port()
    report = tmp_path / "report.json"
    monkeypatch.setenv("DMLC_METRICS_PORT", str(port))
    monkeypatch.setenv("DMLC_METRICS_REPORT", str(report))
    monkeypatch.setenv("DMLC_TS_INTERVAL", "0.1")
    for attempt in range(2):
        tracker = port_tracker.RabitTracker("127.0.0.1", 1)
        tracker.start(1)
        try:
            assert tracker.metrics_port == port
            w = _heartbeat_rows("port", tracker, 100)
            rc, out, err = run_cli(["top", "--once", "--json", "--window", "60"], capsys)
            assert rc == 0, err
            assert json.loads(out)["ranks"]["0"]["rows_per_sec"] > 0
            w.shutdown()
            assert tracker.join(timeout=JOIN_S)
        finally:
            tracker.close()
        full = json.loads(report.read_text())
        assert full["n_ranks"] == 1
        assert ts.windowed(full["timeseries"]["per_rank"]["0"], 60.0)["samples"] >= 2
        assert jax_ts.windowed(full["timeseries"]["per_rank"]["0"], 60.0) == \
            ts.windowed(full["timeseries"]["per_rank"]["0"], 60.0)


def test_metrics_http_off_serves_nothing(monkeypatch):
    monkeypatch.setenv("DMLC_METRICS_HTTP", "0")
    tracker = port_tracker.RabitTracker("127.0.0.1", 1)
    tracker.start(1)
    try:
        assert tracker.metrics_port is None
    finally:
        tracker.close()
