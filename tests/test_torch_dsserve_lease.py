"""The port's dsserve in lease mode (servers leasing micro-shards from the
tracker's shard service, the client committing ``shard_done``), and its
tier under the port's launcher:

- the lease-mode cases of ``tests/test_dsserve.py`` on the port: the
  bit-identity matrix over raw and zlib files and the fused and generic
  batchers, empty micro-shards, the epoch riding the stream, the chaos
  drill (one of two ``tools dsserve serve`` processes killed mid-stream),
  a FIN'd but uncommitted lease released when its client dies, every
  endpoint dead, ``submit --dsserve`` end to end and dry, the SIGTERM
  retire, the in-process retire, the hold budget and endpoint discovery;
- across the packages: JAX servers feed a port client under a port
  tracker, and port servers a JAX client under a JAX tracker, each
  micro-shard bit for bit the static part's;
- the tier's elastic verbs (``DsServeTier.add_worker`` /
  ``retire_worker``).

Every tracker, server and subprocess is closed or joined with a timeout."""

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from dmlc_core_tpu.dsserve import DsServeBatches as JaxBatches
from dmlc_core_tpu.dsserve import DsServeServer as JaxServer
from dmlc_core_tpu.staging import BatchSpec as JaxSpec
from dmlc_core_tpu.tracker import tracker as jax_tracker
from dmlc_core_tpu_torch.dsserve import DsServeBatches, DsServeServer
from dmlc_core_tpu_torch.dsserve import wire
from dmlc_core_tpu_torch.io.split import fileset_signature
from dmlc_core_tpu_torch.staging import fused
from dmlc_core_tpu_torch.tracker import protocol
from dmlc_core_tpu_torch.tracker import tracker as port_tracker
from dmlc_core_tpu_torch.tracker.backends.local import DsServeTier
from dmlc_core_tpu_torch.utils.logging import Error

from test_torch_dsserve import BATCH, K, N_ROWS, drain_packed, spec_of, uri_of, write_corpus

REPO = Path(__file__).resolve().parent.parent
JOIN_S = 60  # bound of every tracker join in this file
RUN_S = 180  # bound of every launched job
TRACKERS = {"port": port_tracker.RabitTracker, "jax": jax_tracker.RabitTracker}


@pytest.fixture
def corpus(tmp_path):
    return write_corpus(str(tmp_path / "d.rec"), str(tmp_path / "d.idx"))


@pytest.fixture
def corpus_zlib(tmp_path):
    return write_corpus(str(tmp_path / "z.rec"), str(tmp_path / "z.idx"), codec="zlib")


def start_tracker(pkg, monkeypatch, ttl="2.0"):
    """A tracker of ``pkg`` that the env points at: 6 micro-shards an
    epoch, leases reclaimed ``ttl`` seconds after their last renew (read
    when the service is built, so pinned first)."""
    monkeypatch.setenv("DMLC_SHARD_OVERSPLIT", "6")
    monkeypatch.setenv("DMLC_SHARD_LEASE_TTL", ttl)
    t = TRACKERS[pkg]("127.0.0.1", 1)
    t.start(1)
    monkeypatch.setenv("DMLC_TRACKER_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_TRACKER_PORT", str(t.port))
    monkeypatch.setenv("DMLC_TASK_ID", "0")
    monkeypatch.delenv("DMLC_SHARD_RANK", raising=False)
    return t


def close_tracker(t):
    t.close()
    if isinstance(t, port_tracker.RabitTracker):
        assert t.join(timeout=JOIN_S)


@pytest.fixture
def tracker(monkeypatch):
    t = start_tracker("port", monkeypatch)
    yield t
    close_tracker(t)


def static_part_shas(uri, spec, m):
    """sha256 of each static part (i, m)'s packed bytes."""
    out = []
    for i in range(m):
        p = fused.ell_batches(uri, spec, part_index=i, num_parts=m)
        out.append(drain_packed(p)[1])
        p.close()
    return out


def hashing(shas):
    def on_slot(shard, seq, payload):
        shas.setdefault(shard, hashlib.sha256()).update(payload.tobytes())
    return on_slot


def spawn_server(tmp_path, i, env_extra):
    """One ``tools dsserve serve`` process: (process, "host:port")."""
    pf = str(tmp_path / f"srv{i}.port")
    env = dict(os.environ, PYTHONPATH=str(REPO), **env_extra)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tools", "dsserve", "serve",
         "--port", "0", "--port-file", pf, "--rank", str(100 + i)], env=env)
    deadline = time.monotonic() + 30
    while not os.path.exists(pf):
        assert proc.poll() is None, f"server {i} died at startup"
        assert time.monotonic() < deadline, f"server {i} never bound"
        time.sleep(0.05)
    with open(pf) as f:
        ep = json.load(f)
    return proc, f"{ep['host']}:{ep['port']}"


def reap(*procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=JOIN_S)


# -- lease-mode bit identity ---------------------------------------------------------


@pytest.mark.parametrize("container", ["v1", "zlib"])
@pytest.mark.parametrize("path", ["fused", "generic"])
def test_leased_bit_identity_matrix(container, path, corpus, corpus_zlib, tracker):
    """A tracker-leased drain from 2 in-process servers: each micro-shard's
    packed bytes equal the static part's, over raw and zlib files and
    the fused and generic (overflow='error') batchers."""
    rec, idx = corpus if container == "v1" else corpus_zlib
    spec = spec_of(overflow="error" if path == "generic" else "truncate")
    uri = uri_of(rec, idx)
    s1 = DsServeServer(rank=101).start()
    s2 = DsServeServer(rank=102).start()
    try:
        c = DsServeBatches(f"dsserve://127.0.0.1:{s1.port},127.0.0.1:{s2.port}{uri}",
                           spec, mode="lease")
        shas = {}
        c.on_slot = hashing(shas)
        rows = sum(b.n_valid for b in c)
        stats = c.io_stats()
        c.close()
    finally:
        s1.close()
        s2.close()
    summary = tracker.shards.summary()
    m = summary["n_shards"]
    assert rows == N_ROWS
    assert summary["completed"] == m == stats["shards_recorded"]
    assert stats["mode"] == "dsserve:lease"
    assert sorted(shas) == list(range(m))
    assert [shas[i].hexdigest() for i in range(m)] == static_part_shas(uri, spec, m)


@pytest.mark.parametrize("direction", ["jax_servers", "port_servers"])
def test_leased_drain_across_packages(corpus, monkeypatch, direction):
    """JAX servers feed a port client under a port tracker, and port
    servers a JAX client under a JAX tracker: every micro-shard once,
    bit for bit the static part."""
    rec, idx = corpus
    uri = uri_of(rec, idx)
    if direction == "jax_servers":
        tr = start_tracker("port", monkeypatch)
        server_cls, client_cls, spec = JaxServer, DsServeBatches, spec_of()
    else:
        tr = start_tracker("jax", monkeypatch)
        server_cls, client_cls = DsServeServer, JaxBatches
        spec = JaxSpec(batch_size=BATCH, layout="ell", max_nnz=K)
    try:
        s1 = server_cls(rank=101).start()
        s2 = server_cls(rank=102).start()
        try:
            c = client_cls(f"dsserve://127.0.0.1:{s1.port},127.0.0.1:{s2.port}{uri}",
                           spec, mode="lease")
            shas = {}
            c.on_slot = hashing(shas)
            rows = sum(b.n_valid for b in c)
            c.close()
        finally:
            s1.close()
            s2.close()
        summary = tr.shards.summary()
    finally:
        close_tracker(tr)
    m = summary["n_shards"]
    assert rows == N_ROWS
    assert summary["completed"] == m and summary["duplicates"] == 0
    assert [shas[i].hexdigest() for i in range(m)] == static_part_shas(uri, spec_of(), m)


def test_empty_micro_shards_commit_and_epoch_completes(tmp_path, tracker):
    """An oversplit beyond the row count makes zero-row micro-shards;
    their FIN arrives with no slots and is committed all the same."""
    rec, idx = write_corpus(str(tmp_path / "tiny.rec"), str(tmp_path / "tiny.idx"), n=4)
    srv = DsServeServer(rank=101).start()
    try:
        c = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec_of(),
                           mode="lease")
        done = []
        c.on_shard_done = lambda shard, status: done.append((shard, status))
        rows = sum(b.n_valid for b in c)
        c.close()
    finally:
        srv.close()
    summary = tracker.shards.summary()
    m = summary["n_shards"]
    assert rows == 4
    assert summary["completed"] == m
    assert sorted(s for s, _ in done) == list(range(m))


def test_epoch_rides_the_stream(corpus, tracker):
    """epoch=1 through dsserve is epoch 1's permutation locally."""
    rec, idx = corpus
    srv = DsServeServer(rank=101).start()
    try:
        c = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec_of(),
                           mode="lease", epoch=1)
        shas = {}
        c.on_slot = hashing(shas)
        rows = sum(b.n_valid for b in c)
        c.close()
    finally:
        srv.close()
    m = tracker.shards.summary()["n_shards"]
    assert rows == N_ROWS
    want = static_part_shas(uri_of(rec, idx, "&epoch=1"), spec_of(), m)
    assert [shas[i].hexdigest() for i in range(m)] == want
    assert static_part_shas(uri_of(rec, idx), spec_of(), m)[0] != want[0]


# -- failover ------------------------------------------------------------------------


def test_chaos_server_sigkill_mid_stream_fails_over(corpus, tracker, tmp_path):
    """Two ``tools dsserve serve`` processes; one dies after 3 slots (its
    kill-after-slots knob, always mid-shard): its connection drops, its
    lease is reclaimed after the TTL, the survivor serves the stranded
    micro-shard in full, and the drain is exactly-once and bit for bit
    the static parts."""
    rec, idx = corpus
    uri = uri_of(rec, idx)
    base = {"DMLC_TRACKER_URI": "127.0.0.1", "DMLC_TRACKER_PORT": str(tracker.port)}
    victim, ep0 = spawn_server(tmp_path, 0, {**base, "DMLC_DSSERVE_KILL_AFTER_SLOTS": "3"})
    survivor, ep1 = spawn_server(tmp_path, 1, base)
    try:
        c = DsServeBatches(f"dsserve://{ep0},{ep1}{uri}", spec_of(), mode="lease")
        shas = {}
        c.on_slot = hashing(shas)
        rows = sum(b.n_valid for b in c)
        stats = c.io_stats()
        c.close()
        assert victim.wait(timeout=30) == 9  # the knob fired
    finally:
        reap(victim, survivor)
    summary = tracker.shards.summary()
    m = summary["n_shards"]
    assert rows == N_ROWS
    assert summary["completed"] == m and summary["reclaimed"] >= 1
    assert stats["endpoints_dead"] == 1 and stats["shards_recorded"] == m
    assert [shas[i].hexdigest() for i in range(m)] == static_part_shas(uri, spec_of(), m)


def test_finned_uncommitted_lease_released_on_client_death(corpus, tracker):
    """A client that dies after a shard's FIN but before committing it
    strands nothing: the server releases every lease its stream took,
    and a fresh client completes the epoch."""
    rec, idx = corpus
    srv = DsServeServer(rank=101).start()
    try:
        sig = fileset_signature(rec, idx, "indexed_recordio")
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        try:
            wire.send_frame(sock, wire.KIND_HELLO, {
                "uri": uri_of(rec, idx), "mode": "lease", "epoch": 0, "fileset": sig,
                "spec": {"batch_size": BATCH, "layout": "ell", "max_nnz": K,
                         "num_features": None, "overflow": "truncate",
                         "index_dtype": "int32", "value_dtype": "float32"},
            })
            kind, _m, _p, _s, _e = wire.recv_frame(sock)
            assert kind == wire.KIND_OK
            while True:  # up to the first FIN, then die
                kind, _m, _p, _s, _e = wire.recv_frame(sock)
                if kind == wire.KIND_SHARD_FIN:
                    break
        finally:
            sock.close()
        deadline = time.monotonic() + 10
        while tracker.shards.summary()["reclaimed"] < 1:
            assert time.monotonic() < deadline, "lease never released"
            time.sleep(0.05)
        c = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec_of(),
                           mode="lease")
        rows = sum(b.n_valid for b in c)
        c.close()
    finally:
        srv.close()
    summary = tracker.shards.summary()
    assert rows == N_ROWS
    assert summary["completed"] == summary["n_shards"] and summary["duplicates"] == 0


def test_all_endpoints_dead_raises(corpus, tracker):
    rec, idx = corpus
    port = protocol.find_free_port("127.0.0.1", 20000, 30000)
    c = DsServeBatches(f"dsserve://127.0.0.1:{port}{uri_of(rec, idx)}", spec_of(),
                       mode="lease", connect_timeout=0.5)
    with pytest.raises(Error, match="every dsserve endpoint failed"):
        for _ in c:
            pass
    c.close()


def test_lease_mode_needs_a_tracker(corpus, monkeypatch):
    monkeypatch.delenv("DMLC_TRACKER_URI", raising=False)
    monkeypatch.delenv("DMLC_TRACKER_PORT", raising=False)
    rec, idx = corpus
    with pytest.raises(Error, match="needs a tracker"):
        DsServeBatches(f"dsserve://127.0.0.1:1{uri_of(rec, idx)}", spec_of(), mode="lease")


# -- the tier under the launcher ---------------------------------------------------


DSSERVE_PAYLOAD = """\
import os, sys
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches

spec = BatchSpec(batch_size={batch}, layout="ell", max_nnz={k})
src = ell_batches("dsserve://" + os.environ["DMLC_DSSERVE"] + {uri!r}, spec)
rows = sum(b.n_valid for b in src)
print("drained", rows, src.io_stats()["mode"], src.io_stats()["shards_recorded"], flush=True)
src.close()
"""


def run_job(cmd, env, timeout=RUN_S):
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=str(REPO), start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, stdout, stderr)


def job_env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), DMLC_RENDEZVOUS_GRACE="1")
    for k in ("DMLC_TRACKER_URI", "DMLC_TRACKER_PORT", "DMLC_SHARD_RANK", "DMLC_TASK_ID"):
        env.pop(k, None)
    return dict(env, **extra)


def test_submit_dsserve_tier_end_to_end(corpus, tmp_path):
    """``submit --dsserve 2``: the tier starts beside the tracker, the
    payload drains the whole file through ``DMLC_DSSERVE`` in lease mode
    (4 micro-shards, each committed once), and the tier goes with the
    job."""
    rec, idx = corpus
    script = tmp_path / "payload.py"
    script.write_text(DSSERVE_PAYLOAD.format(repo=str(REPO), uri=uri_of(rec, idx),
                                             batch=BATCH, k=K))
    proc = run_job([sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
                    "--cluster", "local", "--num-workers", "1", "--host-ip", "127.0.0.1",
                    "--dsserve", "2", sys.executable, str(script)],
                   job_env(DMLC_SHARD_OVERSPLIT="4"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    drained = [line.split()[1:] for line in proc.stdout.splitlines()
               if line.startswith("drained")]
    assert drained == [[str(N_ROWS), "dsserve:lease", "4"]]
    assert proc.stderr.count("dsserve worker pid") == 2


def test_submit_dsserve_dry_run():
    proc = run_job([sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
                    "--cluster", "local", "--num-workers", "1", "--dsserve", "2",
                    "--dry-run", "true"], job_env(), timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.count("dsserve worker") == 2
    assert "dmlc_core_tpu_torch.tools dsserve serve" in proc.stdout


def test_tier_adds_and_retires_workers(corpus, monkeypatch):
    """The tier's elastic verbs: ``add_worker`` spawns a server and
    publishes it to the endpoints file, ``retire_worker`` SIGTERMs the
    newest, which exits 0; lease identities start at task id 1000."""
    tr = start_tracker("port", monkeypatch)
    envs = {"DMLC_TRACKER_URI": "127.0.0.1", "DMLC_TRACKER_PORT": tr.port}
    tier = DsServeTier(1, envs)
    try:
        assert tier.n_live() == 1 and [w.task_id for w in tier._workers] == [1000]
        ep = tier.add_worker()
        with open(tier.endpoints_file) as f:
            assert json.load(f)["endpoints"] == tier.endpoints.split(",")
        assert tier.n_live() == 2 and ep == tier.endpoints.split(",")[1]
        assert tier.retire_worker(grace=30.0) == ep
        retiree = tier._retirees[0]
        assert retiree.proc.wait(timeout=30) == 0
        with open(tier.endpoints_file) as f:
            assert json.load(f)["endpoints"] == [tier.endpoints]
        assert tier.n_live() == 1
    finally:
        tier.stop()
        close_tracker(tr)
    assert not os.path.exists(tier.endpoints_file)


# -- graceful retire ------------------------------------------------------------------


def test_sigterm_graceful_retire_releases_leases_promptly(corpus, tmp_path, monkeypatch):
    """SIGTERM on a dsserve worker is the graceful retire: it finishes its
    in-flight shard, ends its streams, releases every lease it holds and
    exits 0, so the survivor serves the rest without waiting out the
    30 s TTL. The servers' egress is paced (``DMLC_DSSERVE_WIRE_BPS``) so
    the signal lands mid-stream with leases held; the bytes are
    untouched."""
    rec, idx = corpus
    run_sigterm_retire(rec, idx, uri_of(rec, idx), tmp_path, monkeypatch,
                       {"DMLC_DSSERVE_WIRE_BPS": "200000"})


def test_sigterm_graceful_retire_under_fault_latency(corpus, tmp_path, monkeypatch):
    """The same retire with the servers slowed as the JAX test slows
    them: ``fault://latency_ms`` on every read of the shard (latency
    only: the bytes, and so the static parts' digests, are the clean
    file's)."""
    rec, idx = corpus
    slow = uri_of(f"fault://latency_ms=30,spikes=200,cap=4096,seed=5{rec}", idx)
    run_sigterm_retire(rec, idx, slow, tmp_path, monkeypatch, {})


def run_sigterm_retire(rec, idx, uri, tmp_path, monkeypatch, pace):
    """Drain ``uri`` from two leasing servers, SIGTERM one after the
    third slot, and hold the shards to the clean file's static parts."""
    tr = start_tracker("port", monkeypatch, ttl="30.0")
    base = {"DMLC_TRACKER_URI": "127.0.0.1", "DMLC_TRACKER_PORT": str(tr.port),
            "DMLC_DSSERVE_SHM": "off", **pace}
    retiree, ep0 = spawn_server(tmp_path, 0, base)
    survivor, ep1 = spawn_server(tmp_path, 1, base)
    try:
        c = DsServeBatches(f"dsserve://{ep0},{ep1}/{uri.lstrip('/')}", spec_of(),
                           mode="lease")
        shas, seen = {}, []
        record = hashing(shas)

        def on_slot(shard, seq, payload):
            record(shard, seq, payload)
            seen.append(shard)
            if len(seen) == 3:
                retiree.send_signal(signal.SIGTERM)

        c.on_slot = on_slot
        t0 = time.monotonic()
        rows = sum(b.n_valid for b in c)
        elapsed = time.monotonic() - t0
        c.close()
        assert retiree.wait(timeout=20) == 0
        assert elapsed < 20.0, f"drain took {elapsed:.1f}s: a TTL stall"
    finally:
        reap(retiree, survivor)
        close_tracker(tr)
    summary = tr.shards.summary()
    m = summary["n_shards"]
    assert rows == N_ROWS
    assert summary["completed"] == m and summary["duplicates"] == 0
    assert [shas[i].hexdigest() for i in range(m)] == static_part_shas(uri_of(rec, idx),
                                                                       spec_of(), m)


def test_inprocess_retire_mid_drain_exactly_once(corpus, tracker):
    """``DsServeServer.retire()`` mid-drain: the retiring server takes no
    new shard, the sibling finishes the epoch, exactly once."""
    rec, idx = corpus
    s1 = DsServeServer(rank=101).start()
    s2 = DsServeServer(rank=102).start()
    try:
        c = DsServeBatches(f"dsserve://127.0.0.1:{s1.port},127.0.0.1:{s2.port}"
                           f"{uri_of(rec, idx)}", spec_of(), mode="lease")
        seen = []

        def on_slot(shard, seq, payload):
            seen.append(shard)
            if len(seen) == 2:
                s1.retire()

        c.on_slot = on_slot
        rows = sum(b.n_valid for b in c)
        c.close()
        assert s1.retiring
        assert s2.shards_streamed >= 1
    finally:
        s1.close()
        s2.close()
    summary = tracker.shards.summary()
    assert rows == N_ROWS
    assert summary["completed"] == summary["n_shards"] and summary["duplicates"] == 0


def test_retire_keeps_finned_leases_until_the_client_commits(corpus, tracker, monkeypatch):
    """A retiring server gives back the micro-shards whose SHARD_FIN it
    sent only once its client has closed the stream (renewing them
    meanwhile), so its release never overtakes the client's commit and
    hands the shard to the sibling. With every commit slowed (as a loaded
    host slows them), the in-process retire still streams each
    micro-shard once: no duplicate done, and the two servers' FINs add
    up to the shard count."""
    from dmlc_core_tpu_torch.tracker import shardsvc

    rec, idx = corpus
    real_done = shardsvc.ShardLeaseClient.done

    def slow_done(self, *args, **kwargs):
        time.sleep(0.3)
        return real_done(self, *args, **kwargs)

    monkeypatch.setattr(shardsvc.ShardLeaseClient, "done", slow_done)
    s1 = DsServeServer(rank=101).start()
    s2 = DsServeServer(rank=102).start()
    try:
        c = DsServeBatches(f"dsserve://127.0.0.1:{s1.port},127.0.0.1:{s2.port}"
                           f"{uri_of(rec, idx)}", spec_of(), mode="lease")
        seen = []

        def on_slot(shard, seq, payload):
            seen.append(shard)
            if len(seen) == 2:
                s1.retire()

        c.on_slot = on_slot
        rows = sum(b.n_valid for b in c)
        c.close()
        assert s1.retiring
    finally:
        s1.close()
        s2.close()
    summary = tracker.shards.summary()
    assert rows == N_ROWS
    assert summary["completed"] == summary["n_shards"] and summary["duplicates"] == 0
    assert s1.shards_streamed + s2.shards_streamed == summary["n_shards"]


# -- the hold budget and discovery -------------------------------------------------------


def test_hold_budget_backpressure_never_drops(corpus, tracker, monkeypatch):
    """A hold budget far below one micro-shard's bytes still drains the
    epoch exactly once, and the peak gauge records the held bytes."""
    from dmlc_core_tpu_torch.dsserve.client import _HELD_BYTES

    rec, idx = corpus
    monkeypatch.setenv("DMLC_DSSERVE_HOLD_MB", "0.01")
    s1 = DsServeServer(rank=101).start()
    s2 = DsServeServer(rank=102).start()
    try:
        c = DsServeBatches(f"dsserve://127.0.0.1:{s1.port},127.0.0.1:{s2.port}"
                           f"{uri_of(rec, idx)}", spec_of(), mode="lease")
        rows = sum(b.n_valid for b in c)
        c.close()
    finally:
        s1.close()
        s2.close()
    summary = tracker.shards.summary()
    assert rows == N_ROWS
    assert summary["completed"] == summary["n_shards"] and summary["duplicates"] == 0
    assert _HELD_BYTES.value() > 0


def test_client_discovers_endpoints_from_file(corpus, tracker, tmp_path, monkeypatch):
    """DMLC_DSSERVE_FILE: a client dialed at one endpoint picks the second
    out of the endpoints file and the drain stays exactly once."""
    rec, idx = corpus
    s1 = DsServeServer(rank=101).start()
    s2 = DsServeServer(rank=102).start()
    eps = tmp_path / "endpoints.json"
    eps.write_text(json.dumps({"endpoints": [f"127.0.0.1:{s1.port}",
                                             f"127.0.0.1:{s2.port}"]}))
    monkeypatch.setenv("DMLC_DSSERVE_FILE", str(eps))
    try:
        c = DsServeBatches(f"dsserve://127.0.0.1:{s1.port}{uri_of(rec, idx)}", spec_of(),
                           mode="lease")
        deadline = time.monotonic() + 5
        while len(c.endpoints) < 2:
            assert time.monotonic() < deadline, "discovery never added s2"
            time.sleep(0.02)
        rows = sum(b.n_valid for b in c)
        c.close()
    finally:
        s1.close()
        s2.close()
    summary = tracker.shards.summary()
    assert rows == N_ROWS
    assert summary["completed"] == summary["n_shards"] and summary["duplicates"] == 0
