"""The port's ``python -m dmlc_core_tpu_torch.tools`` (info, trace, top)
and the tracker's telemetry endpoint, with both packages on the wire:
``tools info`` (a copy of tests/test_tools.py::test_info_reports_features
with the port's torch section), ``info <uri>`` against the JAX tool's,
``tools serve`` as a process answering port and JAX clients, a port worker
heartbeating to a JAX tracker and a JAX worker to a port tracker with
``tools top --once --json`` of each package against each tracker, a
pinned ``DMLC_METRICS_PORT``, the ``DMLC_METRICS_REPORT`` end-of-job
report, and ``trace report`` on a recorded file. Every tracker is closed
and joined with a timeout."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

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
REPO = Path(__file__).resolve().parent.parent
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


def test_info_with_a_shard_uri_names_the_roadmap_item(capsys, tmp_path):
    """``info <uri>``, which named ROADMAP.md §1 item 7d until that item
    was ported, now describes the shard as the JAX tool does: a missing
    shard fails alike (rc 1), and an indexed shard's ``shard`` section
    (key count, block geometry, codec) equals the JAX tool's."""
    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io.stream import FileStream

    missing = str(tmp_path / "corpus.rec")
    got, want = run_cli(["info", missing], capsys), run_cli(["info", missing], capsys,
                                                            mod=jax_tools)
    assert got[0] == want[0] == 1
    path = str(tmp_path / "shard.rec")
    with FileStream(path, "w") as f, FileStream(path + ".idx", "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec="zlib", block_bytes=256)
        for i in range(90):
            w.write_record(b"r%04d" % i * (1 + i % 5), key=10 * i)
        w.flush()
    rc, out, _ = run_cli(["info", path], capsys)
    jrc, jout, _ = run_cli(["info", path], capsys, mod=jax_tools)
    assert rc == jrc == 0
    shard = json.loads(out)["shard"]
    assert shard == json.loads(jout)["shard"]
    assert shard["records"] == shard["keys"] == 90 and shard["codec"] == "zlib"
    assert shard["blocks"] > 1


def _serve(tmp_path, uri, pkg="dmlc_core_tpu_torch", extra=()):
    """``python -m <pkg>.tools serve uri --port-file …`` as a subprocess;
    returns (proc, port) once the port file names the endpoint."""
    pf = tmp_path / f"{pkg}.port.json"
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.tools", "serve", uri, "--port-file", str(pf), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO))
    deadline = time.monotonic() + 60
    while not pf.exists():
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            out, err = proc.communicate(timeout=30)
            raise AssertionError(f"serve never wrote its port file: {err[-2000:]}")
        time.sleep(0.05)
    return proc, json.loads(pf.read_text())["port"]


def _stop(proc):
    """SIGTERM; (rc, stderr) within 30 s."""
    import signal

    proc.send_signal(signal.SIGTERM)
    try:
        _, err = proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate(timeout=30)
        raise AssertionError("serve did not exit on SIGTERM")
    return proc.returncode, err


def _zlib_shard(tmp_path, n=300):
    from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
    from dmlc_core_tpu_torch.io.stream import FileStream

    path = str(tmp_path / "served.rec")
    with FileStream(path, "w") as f, FileStream(path + ".idx", "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec="zlib", block_bytes=512)
        for i in range(n):
            w.write_record(b"%05d" % i + bytes([i % 256]) * (i % 37), key=i)
        w.flush()
    return path


def test_serve_answers_lookups_scrapes_metrics_and_exits_on_sigterm(tmp_path):
    """``tools serve --port-file --metrics-port --warm``: a port client and
    a JAX client get the in-process handle's bytes (negatives None), the
    ``/metrics`` scrape has ``dmlc_io_lookup_request_seconds``, and
    SIGTERM ends it with rc 0 and a last JSON stats line on stderr."""
    from dmlc_core_tpu.io.lookup import LookupClient as JaxClient
    from dmlc_core_tpu_torch.io import retry
    from dmlc_core_tpu_torch.io.lookup import LookupClient, RecordLookup

    path = _zlib_shard(tmp_path)
    mport = _free_port()
    proc, port = _serve(tmp_path, path, extra=("--metrics-port", str(mport),
                                               "--warm", "4"))
    keys = [0, 5, 299, 1000, 77, 5]
    h = RecordLookup(path)
    try:
        want = h.lookup(keys)
        for cls in (LookupClient, JaxClient):
            c = cls("127.0.0.1", port)
            assert c.lookup(keys) == want and want[3] is None
            c.close()
        with retry.request(f"http://127.0.0.1:{mport}/metrics", timeout=30.0) as resp:
            text = resp.read().decode()
        assert "dmlc_io_lookup_request_seconds" in text
    finally:
        h.close()
        rc, err = _stop(proc)
    assert rc == 0, err[-2000:]
    assert "warmed 4 blocks" in err
    stats = json.loads(err.strip().splitlines()[-1])
    assert stats["requests"] == 2 and stats["negatives"] == 2
    assert stats["shard"]["records"] == 300


def test_jax_serve_answers_a_port_client(tmp_path):
    """The JAX package's ``tools serve`` process answers the port's
    client with the port handle's bytes."""
    from dmlc_core_tpu_torch.io.lookup import LookupClient, RecordLookup

    path = _zlib_shard(tmp_path, 120)
    proc, port = _serve(tmp_path, path, pkg="dmlc_core_tpu")
    h = RecordLookup(path)
    try:
        c = LookupClient("127.0.0.1", port)
        keys = list(range(0, 130, 7))
        assert c.lookup(keys) == h.lookup(keys)
        assert c.stats()["shard"] == h.describe()
        c.close()
    finally:
        h.close()
        rc, _ = _stop(proc)
    assert rc == 0


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
