"""The port's dynamic shard service (``tracker/shardsvc.py``) and
``io.split.DynamicShardSource`` against the JAX package's:

- the cases of ``tests/test_shardsvc.py`` with ``dmlc_core_tpu_torch``
  (the ledger and the service on a fake clock on both packages; the
  lease protocol over a port tracker; the driver's bit identity with the
  static parts; heartbeat renewal; the supervisor's reclaim hook; a
  shard-only job under the port's submit; a worker killed mid-lease);
- across the packages: JAX lease clients drain an epoch from a port
  tracker and port clients from a JAX tracker, exactly once; a port
  dynamic drain equals the JAX package's dynamic drain of the same file
  under a tracker of either package (sequential, and ``shuffle=record``
  through the gather path), and the fused rowrec producer's batches over
  leased micro-shards equal the JAX producer's with no gather fallback;
- the port's Criteo example with ``DMLC_DYNAMIC_SHARDS=1``: two CPU
  workers under the port's submit.

Every tracker, thread and subprocess is joined with a timeout."""

import hashlib
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu.staging import BatchSpec as JaxSpec
from dmlc_core_tpu.staging import ell_batches as jax_ell_batches
from dmlc_core_tpu.tracker import shardsvc as jax_shardsvc
from dmlc_core_tpu.tracker import tracker as jax_tracker
from dmlc_core_tpu_torch.examples import train_criteo_rec
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
from dmlc_core_tpu_torch.io.stream import FileStream
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches
from dmlc_core_tpu_torch.tracker import shardsvc
from dmlc_core_tpu_torch.tracker import tracker as port_tracker
from dmlc_core_tpu_torch.tracker.client import RabitWorker
from dmlc_core_tpu_torch.tracker.shardsvc import ShardLeaseClient
from dmlc_core_tpu_torch.tracker.supervisor import Supervisor
from dmlc_core_tpu_torch.utils.logging import Error

REPO = Path(__file__).resolve().parent.parent
N_ROWS = 3000
JOIN_S = 60  # bound of every thread and tracker join in this file
RUN_S = 120  # bound of every launched job
TRACKERS = {"port": port_tracker.RabitTracker, "jax": jax_tracker.RabitTracker}
SERVICES = {"port": shardsvc, "jax": jax_shardsvc}


@pytest.fixture
def corpus(tmp_path):
    rec = str(tmp_path / "data.rec")
    idx = str(tmp_path / "data.idx")
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi)
        for i in range(N_ROWS):
            w.write_record(b"%06d|" % i + b"p" * 25, i)
        w.flush_block()
    return rec, idx


def start_tracker(pkg, n, monkeypatch, oversplit="4"):
    """A live tracker of ``pkg`` that the env (and so every lease client
    built without an address) points at."""
    monkeypatch.setenv("DMLC_SHARD_OVERSPLIT", oversplit)
    t = TRACKERS[pkg]("127.0.0.1", n)
    t.start(n)
    monkeypatch.setenv("DMLC_TRACKER_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_TRACKER_PORT", str(t.port))
    monkeypatch.setenv("DMLC_TASK_ID", "0")
    # a RabitWorker.start() elsewhere in this process binds the lease
    # identity to ITS rendezvous rank: keep it out of here
    monkeypatch.delenv("DMLC_SHARD_RANK", raising=False)
    return t


def close_tracker(t):
    t.close()
    if isinstance(t, port_tracker.RabitTracker):
        assert t.join(timeout=JOIN_S)


@pytest.fixture
def tracker(monkeypatch):
    t = start_tracker("port", 1, monkeypatch)
    yield t
    close_tracker(t)


def drain_sha(split, gather=False, batch=512, h=None):
    """(rows, sha256) of a split's full emission, in emission order; with
    ``h`` the bytes go on into that hash."""
    h = hashlib.sha256() if h is None else h
    rows = 0
    if gather:
        while True:
            g = split.next_gather_batch(batch)
            if g is None:
                break
            buf, starts, sizes = g
            flat = buf.reshape(-1) if buf.ndim > 1 else buf
            for s, z in zip(starts.tolist(), sizes.tolist()):
                h.update(flat[s:s + z].tobytes())
            rows += len(starts)
    else:
        while True:
            rec = split.next_record()
            if rec is None:
                break
            h.update(rec)
            rows += 1
    return rows, h.hexdigest()


def run_threads(fns):
    threads = [threading.Thread(target=fn, daemon=True) for fn in fns]
    for th in threads:
        th.start()
    for th in threads:
        th.join(JOIN_S)
    assert not any(th.is_alive() for th in threads)


# -- the ledger and the service on a fake clock, on both packages ----------------


@pytest.fixture(params=["port", "jax"])
def svc_mod(request):
    return SERVICES[request.param]


def test_ledger_grant_done_exactly_once(svc_mod):
    led = svc_mod.ShardLedger(epoch=0, n_shards=4)
    now = 100.0
    leases = [led.grant(0, now, ttl=10.0) for _ in range(4)]
    assert sorted(lease.shard for lease in leases) == [0, 1, 2, 3]
    assert led.grant(0, now, ttl=10.0) is None  # everything leased
    assert not led.complete()
    for lease in leases:
        status, secs = led.record_done(lease.shard, 0, now + 1.0)
        assert status == "recorded" and secs == 1.0
    assert led.complete()
    assert led.record_done(2, 1, now + 2.0) == ("duplicate", None)
    assert led.duplicates == 1


def test_ledger_rejects_done_for_never_granted_shard(svc_mod):
    led = svc_mod.ShardLedger(epoch=0, n_shards=4)
    led.grant(0, 100.0, ttl=10.0)  # shard 0 leased, 1-3 still queued
    with pytest.raises(ValueError, match="never granted"):
        led.record_done(1, 0, 101.0)
    assert not led.done and led.queue_depth() == 3


def test_ledger_expiry_reclaim_and_steal(svc_mod):
    led = svc_mod.ShardLedger(epoch=0, n_shards=2)
    l0 = led.grant(0, 100.0, ttl=5.0)
    led.grant(1, 100.0, ttl=5.0)
    assert led.renew_rank(1, 104.0, ttl=5.0) == 1  # rank 0 goes silent
    assert led.reclaim_expired(106.0) == [l0.shard]
    assert led.reclaimed == 1
    # the reclaimed shard goes first (queue front), to another rank: stolen
    l0b = led.grant(1, 106.0, ttl=5.0)
    assert l0b.shard == l0.shard and led.stolen == 1
    # the slow holder finishes first: the first done wins
    assert led.record_done(l0.shard, 0, 107.0)[0] == "recorded"
    assert led.record_done(l0.shard, 1, 108.0)[0] == "duplicate"


def test_ledger_never_regrants_a_completed_shard(svc_mod):
    led = svc_mod.ShardLedger(epoch=0, n_shards=2)
    l0 = led.grant(0, 100.0, ttl=5.0)
    assert led.reclaim_expired(106.0) == [l0.shard]
    assert led.queue_depth() == 2
    assert led.record_done(l0.shard, 0, 107.0)[0] == "recorded"
    l1 = led.grant(1, 107.0, ttl=5.0)
    assert l1 is not None and l1.shard != l0.shard
    assert led.grant(1, 107.0, ttl=5.0) is None
    assert led.record_done(l1.shard, 1, 108.0)[0] == "recorded"
    assert led.complete()


def test_ledger_voluntary_release(svc_mod):
    led = svc_mod.ShardLedger(epoch=0, n_shards=2)
    l0 = led.grant(0, 100.0, ttl=30.0)
    assert not led.release(l0.shard, rank=1)  # only the holder releases
    assert led.release(l0.shard, rank=0)
    assert led.queue_depth() == 2 and led.reclaimed == 1
    l0b = led.grant(1, 101.0, ttl=30.0)
    assert l0b.shard == l0.shard and l0b.stolen
    assert led.record_done(l0.shard, 1, 102.0)[0] == "recorded"
    assert not led.release(l0.shard, rank=1)


def test_ledger_reclaim_rank_immediate(svc_mod):
    led = svc_mod.ShardLedger(epoch=0, n_shards=4)
    for _ in range(2):
        led.grant(0, 100.0, ttl=30.0)
    led.grant(1, 100.0, ttl=30.0)
    assert len(led.reclaim_rank(0)) == 2 and led.queue_depth() == 3
    assert len(led.leases) == 1  # rank 1's lease untouched


def test_service_wait_then_done_and_renew_semantics(svc_mod):
    clock = [1000.0]
    svc = svc_mod.ShardService(n_workers=1, oversplit=2, ttl=8.0, clock=lambda: clock[0])
    a = svc.lease(0, 0, None)
    b = svc.lease(0, 0, None)
    assert {a["status"], b["status"]} == {"lease"}
    w = svc.lease(0, 0, None)
    assert w["status"] == "wait" and 0.05 <= w["backoff"] <= 1.0
    assert svc.renew(0, 0)["renewed"] == 2
    assert svc.done(0, 0, a["shard"])["status"] == "recorded"
    assert svc.done(0, 0, b["shard"])["epoch_complete"] is True
    assert svc.lease(0, 0, None)["status"] == "done"
    assert svc.lease(0, 1, None)["status"] == "lease"  # a fresh ledger
    clock[0] += 100.0
    assert svc.renew(0, 1)["status"] == "lost"


def test_service_rejects_stale_dataset_done_after_switch(svc_mod):
    svc = svc_mod.ShardService(n_workers=1, oversplit=2, ttl=30.0)
    a = svc.lease(0, 0, "train")
    b = svc.lease(0, 0, "train")
    assert svc.done(0, 0, a["shard"], "train")["status"] == "recorded"
    assert svc.done(0, 0, b["shard"], "train")["status"] == "recorded"
    v = svc.lease(0, 0, "val")  # train drained: the data set switches
    assert v["status"] == "lease"
    stale = svc.done(0, 0, v["shard"], "train")
    assert stale["status"] == "error" and "dataset switch" in stale["error"]
    assert svc.release(0, 0, v["shard"], "train")["status"] == "error"
    assert svc._epochs[0].leases  # the val lease is untouched
    assert svc.done(0, 0, v["shard"], "val")["status"] == "recorded"


def test_service_all_complete_gates_partial_epochs(svc_mod):
    svc = svc_mod.ShardService(n_workers=1, oversplit=2, ttl=30.0)
    assert not svc.all_complete()  # no shard work happened at all
    a = svc.lease(0, 0, None)
    assert not svc.all_complete()
    assert svc.done(0, 0, a["shard"])["status"] == "recorded"
    assert not svc.all_complete()  # one shard still queued
    b = svc.lease(0, 0, None)
    assert svc.done(0, 0, b["shard"])["status"] == "recorded"
    assert svc.all_complete()


def test_service_ledger_eviction_never_orphans_live_work(svc_mod):
    clock = [1000.0]
    svc = svc_mod.ShardService(n_workers=1, oversplit=1, ttl=30.0, clock=lambda: clock[0])
    for ep in range(1, svc.keep_epochs + 1):
        assert svc.lease(0, ep, None)["status"] == "lease"
    assert svc.lease(0, 0, None)["status"] == "error"  # behind the window
    # ahead of it: evicting epoch 1 would strand its live holder
    assert svc.lease(1, svc.keep_epochs + 1, None)["status"] == "error"
    shard = next(iter(svc._epochs[1].leases))
    assert svc.done(0, 1, shard)["status"] == "recorded"
    assert svc.lease(1, svc.keep_epochs + 1, None)["status"] == "lease"


def test_service_handle_is_unkillable(svc_mod):
    svc = svc_mod.ShardService(n_workers=2, oversplit=1)
    for cmd, rank, payload in (("shard_lease", -1, "{}"), ("shard_lease", 0, "not json"),
                               ("shard_done", 0, "{}"), ("shard_lease", 0, "[1,2]"),
                               ("shard_nope", 0, "{}")):
        assert json.loads(svc.handle(cmd, rank, payload))["status"] == "error"
    for rank in (0, 7):  # a rank above n_workers joins mid-epoch
        ok = json.loads(svc.handle("shard_lease", rank, '{"epoch": 0}'))
        assert ok["status"] == "lease" and ok["num_shards"] == 2


def test_summary_counts_evicted_epochs(svc_mod):
    clk = [100.0]
    svc = svc_mod.ShardService(1, oversplit=2, ttl=30.0, clock=lambda: clk[0])
    n_epochs = svc_mod.ShardService.keep_epochs + 4
    for ep in range(n_epochs):
        for _ in range(2):
            resp = svc.lease(0, ep, None)
            assert resp["status"] == "lease"
            clk[0] += 1.0
            assert svc.done(0, ep, resp["shard"])["status"] == "recorded"
    s = svc.summary()
    assert s["epochs_retired"] == 4
    assert len(s["epochs"]) == svc_mod.ShardService.keep_epochs
    assert s["granted"] == s["completed"] == 2 * n_epochs
    assert s["reclaimed"] == 0 and s["duplicates"] == 0


def test_service_answers_equal_the_jax_service():
    """The same request stream through both packages' services (one
    fake clock, expiry, steal, release, a dataset switch, bad frames)
    gives the same response frames, byte for byte, and summaries."""
    frames = [("shard_lease", 0, '{"epoch":0,"fileset":"a"}'),
              ("shard_lease", 1, '{"epoch":0,"fileset":"a"}'),
              ("shard_renew", 1, '{"epoch":0}'),
              ("shard_lease", 0, '{"epoch":0,"fileset":"a"}'),
              ("shard_done", 0, '{"epoch":0,"shard":2}'),
              ("shard_release", 1, '{"epoch":0,"shard":1}'),
              ("shard_lease", 2, '{"epoch":0}'),
              ("shard_done", 2, '{"epoch":0,"shard":1}'),
              ("shard_done", 0, '{"epoch":0,"shard":1}'),
              ("shard_lease", 0, '{"epoch":0,"fileset":"a"}'),
              ("shard_done", 0, '{"epoch":0,"shard":0}'),
              ("shard_done", 0, '{"epoch":0,"shard":3}'),
              ("shard_lease", 1, '{"epoch":0,"fileset":"b"}'),
              ("shard_done", 1, '{"epoch":0,"shard":9}'),
              ("shard_lease", -1, "{}"), ("shard_renew", 0, "[]")]
    out = {}
    for pkg, mod in SERVICES.items():
        clock = [50.0]
        svc = mod.ShardService(n_workers=2, oversplit=2, ttl=4.0, clock=lambda: clock[0])
        answers = []
        for i, (cmd, rank, payload) in enumerate(frames):
            clock[0] += 1.5 if i == 3 else 0.25  # rank 0's first lease expires
            answers.append(svc.handle(cmd, rank, payload))
        out[pkg] = (answers, svc.summary())
    assert out["port"] == out["jax"]
    assert out["port"][1]["stolen"] == out["port"][1]["reclaimed"] == 1


# -- the lease protocol over a port tracker ---------------------------------------


def test_lease_protocol_end_to_end(tracker):
    c = ShardLeaseClient("127.0.0.1", tracker.port, rank=0)
    seen = []
    while True:
        r = c.lease(0, fileset="sig")
        if r["status"] != "lease":
            break
        seen.append(r["shard"])
        assert r["num_shards"] == 4 and r["ttl"] > 0
    assert sorted(seen) == [0, 1, 2, 3]
    assert c.renew(0)["status"] == "ok"
    for s in seen:
        assert c.done(0, s)["status"] == "recorded"
    assert c.lease(0, fileset="sig")["status"] == "done"
    r = c.lease(0, fileset="other")  # a sequential data set switch
    assert r["status"] == "lease"
    assert c.lease(0, fileset="third")["status"] == "error"
    c.release(0, r["shard"])
    tracker.close()
    assert tracker.join(timeout=JOIN_S)
    assert tracker.metrics_report["shards"]["completed"] == 4


def test_heartbeat_renews_leases(tracker):
    c = ShardLeaseClient("127.0.0.1", tracker.port, rank=0)
    r = c.lease(0)
    assert r["status"] == "lease"
    led = tracker.shards._epochs[0]
    before = led.leases[r["shard"]].expires
    time.sleep(0.05)
    w = RabitWorker("127.0.0.1", tracker.port)
    w.rank = 0  # heartbeat() needs an assigned rank
    w.heartbeat({"counters": {}, "gauges": {}, "histograms": {}})
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline and led.leases[r["shard"]].expires <= before:
        time.sleep(0.01)
    assert led.leases[r["shard"]].expires > before


def test_rendezvous_binds_the_lease_identity(tracker, monkeypatch):
    """``RabitWorker.start`` sets ``DMLC_SHARD_RANK`` to the rendezvous
    rank (the rank heartbeats renew by), as the JAX client does."""
    monkeypatch.setenv("DMLC_SHARD_RANK", "9")
    w = RabitWorker("127.0.0.1", tracker.port, jobid="0")
    assert w.start(world_size=1) == 0
    assert os.environ["DMLC_SHARD_RANK"] == "0"
    w.shutdown()
    assert tracker.join(timeout=JOIN_S)


def test_supervisor_hook_reclaims_leases(tracker):
    c = ShardLeaseClient("127.0.0.1", tracker.port, rank=0)
    assert c.lease(0)["status"] == "lease"
    assert c.lease(0)["status"] == "lease"
    shardsvc.reclaim_task(0, "localhost")
    assert tracker.shards.summary()["reclaimed"] == 2
    assert tracker.shards.summary()["queue_depth"] == 4


def test_reclaim_task_translates_task_id_to_rank(tracker):
    tracker.shards.note_task_rank("3", 1)
    c = ShardLeaseClient("127.0.0.1", tracker.port, rank=1)
    assert c.lease(0)["status"] == "lease"
    peer = ShardLeaseClient("127.0.0.1", tracker.port, rank=0)
    assert peer.lease(0)["status"] == "lease"
    shardsvc.reclaim_task(3, "localhost")
    assert tracker.shards.summary()["reclaimed"] == 1
    assert [lease.rank for lease in tracker.shards._epochs[0].leases.values()] == [0]


def test_lease_client_repins_rank_from_env(tracker, monkeypatch):
    monkeypatch.setenv("DMLC_TASK_ID", "0")
    c = ShardLeaseClient("127.0.0.1", tracker.port)  # defaulted rank
    assert c.rank == 0
    monkeypatch.setenv("DMLC_SHARD_RANK", "5")  # start() ran
    assert c.lease(0)["status"] == "lease"
    assert c.rank == 5
    assert [lease.rank for lease in tracker.shards._epochs[0].leases.values()] == [5]
    c2 = ShardLeaseClient("127.0.0.1", tracker.port, rank=2)
    assert c2.lease(0)["status"] == "lease" and c2.rank == 2


def test_closing_the_tracker_deregisters_its_service(monkeypatch):
    t = start_tracker("port", 1, monkeypatch)
    assert shardsvc.active_service() is t.shards
    close_tracker(t)
    assert shardsvc.active_service() is None
    shardsvc.reclaim_task(0, "localhost")  # a no-op, not an error


# -- lease clients of one package against a tracker of the other ------------------


@pytest.mark.parametrize("tracker_pkg,client_pkg", [("port", "jax"), ("jax", "port")])
def test_lease_clients_drain_an_epoch_from_the_other_packages_tracker(
        monkeypatch, tracker_pkg, client_pkg):
    """Three clients of one package drain two epochs from a tracker of the
    other, in the JAX wire form: every micro-shard recorded exactly once,
    ``completed == granted``, no duplicate."""
    t = start_tracker(tracker_pkg, 3, monkeypatch, oversplit="3")
    recorded, errors = [], []
    lock = threading.Lock()

    def worker(rank):
        try:
            c = SERVICES[client_pkg].ShardLeaseClient("127.0.0.1", t.port, rank=rank)
            for epoch in (0, 1):
                while True:
                    r = c.lease(epoch, "sig")
                    if r["status"] == "done":
                        break
                    if r["status"] == "wait":
                        time.sleep(r["backoff"])
                        continue
                    assert r["status"] == "lease" and r["num_shards"] == 9
                    assert c.renew(epoch)["status"] == "ok"
                    d = c.done(epoch, r["shard"], "sig")
                    with lock:
                        recorded.append((epoch, r["shard"], d["status"]))
        except Exception as e:  # noqa: BLE001 - surfaced by the assert below
            errors.append((rank, e))

    try:
        run_threads([lambda r=r: worker(r) for r in range(3)])
        summary = t.shards.summary()
    finally:
        close_tracker(t)
    assert not errors, errors
    assert sorted((e, s) for e, s, _ in recorded) == [(e, s) for e in (0, 1) for s in range(9)]
    assert {st for _, _, st in recorded} == {"recorded"}
    assert summary["completed"] == summary["granted"] == 18
    assert summary["duplicates"] == 0


# -- DynamicShardSource ------------------------------------------------------------


@pytest.mark.parametrize("mode,gather", [("record", True), ("", False)])
def test_dynamic_drain_bit_identical_to_static(tracker, corpus, mode, gather):
    """One worker leases the shards in order 0..M-1: its drain equals the
    static ``(i, M)`` drains concatenated, shuffled and sequential."""
    rec, idx = corpus
    q = f"?index={idx}&seed=5" + (f"&shuffle={mode}" if mode else "")
    src = io_split.create(rec + q + "&dynamic_shards=1", type="recordio", threaded=False)
    assert src.supports_gather() == gather
    rows, sha = drain_sha(src, gather=gather)
    M = src.num_shards
    stats = src.io_stats()
    src.close()
    assert rows == N_ROWS
    assert stats["leases"] == M == stats["shards_recorded"] == 4
    assert stats["mode"].startswith("dynamic:")
    h = hashlib.sha256()
    total = 0
    for i in range(M):
        sp = io_split.create(rec + q, type="recordio", part_index=i, num_parts=M,
                             threaded=False)
        total += drain_sha(sp, gather=gather, h=h)[0]
        sp.close()
    assert total == N_ROWS
    assert h.hexdigest() == sha, "dynamic emission diverged from static"


@pytest.mark.parametrize("tracker_pkg", ["port", "jax"])
@pytest.mark.parametrize("mode,gather", [("record", True), ("", False)])
def test_dynamic_drain_equals_the_jax_dynamic_drain(corpus, monkeypatch, tracker_pkg,
                                                    mode, gather):
    """The port's dynamic drain of a file equals the JAX package's dynamic
    drain of it under a JAX tracker, with the port's source under a
    tracker of either package; both sign the data set alike."""
    rec, idx = corpus
    uri = f"{rec}?index={idx}&seed=5&dynamic_shards=1" + (f"&shuffle={mode}" if mode else "")
    t = start_tracker("jax", 1, monkeypatch)
    try:
        src = jax_split.create(uri, type="recordio", threaded=False)
        want = drain_sha(src, gather=gather)
        want_sig = src._fileset
        src.close()
    finally:
        close_tracker(t)
    t = start_tracker(tracker_pkg, 1, monkeypatch)
    try:
        src = io_split.create(uri, type="recordio", threaded=False)
        got = drain_sha(src, gather=gather)
        assert src._fileset == want_sig
        stats = src.io_stats()
        src.close()
        summary = t.shards.summary()
    finally:
        close_tracker(t)
    assert got == want and got[0] == N_ROWS
    assert stats["shards_recorded"] == 4 and stats["shards_duplicate"] == 0
    assert summary["completed"] == summary["granted"] == 4


@pytest.mark.parametrize("mode", ["record", "batch"])
def test_fused_producer_over_leased_shards_equals_jax(tmp_path, monkeypatch, mode):
    """``ell_batches`` over ``&dynamic_shards=1`` reads a
    ``DynamicShardSource`` through the gather kernel with no fallback
    copy: its batches equal the JAX producer's under a JAX tracker, and
    each micro-shard's batches equal the static part's."""
    rec = write_indexed_rowrec(str(tmp_path / "d.rec"), 900, seed=3)
    uri = f"{rec}?index={rec}.idx&shuffle={mode}&batch_size=75&seed=2&dynamic_shards=1"
    t = start_tracker("jax", 1, monkeypatch, oversplit="3")
    try:
        jax_src = jax_ell_batches(uri, JaxSpec(batch_size=75, max_nnz=6))
        want = (snapshot(jax_src), (jax_src.truncated_nnz, jax_src.rows_out))
    finally:
        close_tracker(t)
    t = start_tracker("port", 1, monkeypatch, oversplit="3")
    try:
        src = ell_batches(uri, BatchSpec(batch_size=75, max_nnz=6))
        leased = []
        src._split.on_lease = lambda shard, m: leased.append((shard, m))
        batches = [(b.n_valid, tuple(b.as_dict()), b.packed.copy()) for b in src]
        stats = src.io_stats()
        got = (batches, (src.truncated_nnz, src.rows_out))
        src.close()
    finally:
        close_tracker(t)
    assert got[1] == want[1] and len(got[0]) == len(want[0]) == 12
    for (gn, gk, gp), (wn, wk, wp) in zip(got[0], want[0]):
        assert (gn, gk) == (wn, wk) and np.array_equal(gp, wp)
    assert stats["mode"].startswith("dynamic:")
    assert stats["gather_batches"] > 0 and stats["gather_fallback_batches"] == 0
    assert leased == [(0, 3), (1, 3), (2, 3)]
    static = []  # 300 rows a part: 4 batches each, no partial batch
    for i in range(3):
        static += snapshot(ell_batches(uri.replace("&dynamic_shards=1", ""),
                                       BatchSpec(batch_size=75, max_nnz=6), i, 3))
    assert len(static) == len(batches) == 12
    for (gn, gk, gp), (wn, wk, wp) in zip(batches, static):
        assert (gn, gk) == (wn, wk) and np.array_equal(gp, wp)


def write_indexed_rowrec(path, n, seed):
    """``n`` rowrec rows of 0-8 features with weights, and the ``.idx``
    index, through the port's writer."""
    from dmlc_core_tpu_torch.data.row_block import RowBlock
    from dmlc_core_tpu_torch.data.rowrec import write_rowrec

    rng = np.random.default_rng(seed)
    offset = np.r_[0, np.cumsum(rng.integers(0, 9, n))].astype(np.int64)
    blk = RowBlock(offset=offset, label=rng.integers(0, 2, n).astype(np.float32),
                   index=rng.integers(0, 5000, int(offset[-1])).astype(np.uint32),
                   value=rng.normal(size=int(offset[-1])).astype(np.float32),
                   weight=rng.uniform(0.5, 2, n).astype(np.float32))
    with FileStream(path, "w") as f, FileStream(path + ".idx", "w") as fi:
        write_rowrec(f, [blk], index_stream=fi)
    return path


def snapshot(stream):
    """Copies of a producer's batches as they are yielded (ring slots are
    recycled); the stream is closed."""
    out = [(b.n_valid, tuple(b.as_dict()), b.packed.copy()) for b in stream]
    stream.close()
    return out


def test_dynamic_threaded_wraps_per_shard_readahead(tracker, corpus):
    rec, idx = corpus
    uri = rec + f"?index={idx}&dynamic_shards=1"
    src = io_split.create(uri, type="recordio", threaded=True)
    # the probe (never read) stays bare: a read-ahead thread on it would
    # drain the whole set in the background
    assert not isinstance(src._get_probe(), io_split.ThreadedInputSplit)
    shard0 = src._make_splitter(0, 1, 0)
    assert isinstance(shard0, io_split.ThreadedInputSplit)
    shard0.close()
    rows, sha = drain_sha(src)
    src.close()
    src2 = io_split.create(uri, type="recordio", threaded=False)
    src2.epoch = 1  # a fresh ledger; the same content (no shuffle)
    rows2, sha2 = drain_sha(src2)
    src2.close()
    assert rows == rows2 == N_ROWS and sha == sha2


def test_two_workers_split_the_epoch_exactly_once(corpus, monkeypatch):
    rec, idx = corpus
    t = start_tracker("port", 2, monkeypatch)
    results, recorded = {}, []
    lock = threading.Lock()

    def one(rank):
        client = ShardLeaseClient("127.0.0.1", t.port, rank=rank)
        src = io_split.DynamicShardSource(
            make_splitter=lambda shard, M, ep: io_split.IndexedRecordIOSplitter(
                rec, idx, shard, M, shuffle="record", seed=9, epoch=ep),
            client=client, windowed_hint=True)

        def on_done(shard, status):
            with lock:
                recorded.append((shard, status))

        src.on_shard_done = on_done
        results[rank] = drain_sha(src, gather=True)[0]
        src.close()

    try:
        run_threads([lambda r=r: one(r) for r in range(2)])
    finally:
        close_tracker(t)
    assert sum(results.values()) == N_ROWS
    assert [s for _, s in recorded].count("recorded") == 8 == len(recorded)
    assert sorted(s for s, _ in recorded) == list(range(8))


def test_epoch_advance_and_fresh_ledger(tracker, corpus):
    rec, idx = corpus
    src = io_split.create(f"{rec}?index={idx}&shuffle=record&seed=2&dynamic_shards=1",
                          type="recordio", threaded=False)
    r0, sha0 = drain_sha(src, gather=True)
    src.before_first()
    r1, sha1 = drain_sha(src, gather=True)
    src.close()
    assert r0 == r1 == N_ROWS
    assert sha0 != sha1  # another epoch, another permutation
    assert tracker.shards.summary()["completed"] == 8


def test_create_sugar_and_guards(tracker, corpus):
    """The JAX package's guards: ``reset_partition``, ``skip_records``,
    ``shuffle_parts`` and a ``#cachefile`` raise with dynamic shards;
    whole-set introspection needs no lease."""
    rec, idx = corpus
    src = io_split.create(f"{rec}?index={idx}&dynamic_shards=1", type="recordio",
                          threaded=False)
    with pytest.raises(Error, match="no static partition"):
        src.reset_partition(0, 2)
    assert src.total_size() == os.path.getsize(rec)
    src.close()
    for extra, match in (("&skip_records=8", "static sharding"),
                         ("&shuffle_parts=2", "num_shuffle_parts"),
                         ("#" + rec + ".cache", "cachefile")):
        for mod, err in ((io_split, Error), (jax_split, Exception)):
            with pytest.raises(err, match=match):
                mod.create(f"{rec}?index={idx}&dynamic_shards=1{extra}", type="recordio",
                           threaded=False)


def test_plain_batches_refuse_dynamic_shards(tmp_path):
    """The plain version of micro-shard i of M is the static part (i, M):
    ``plain_batches`` takes no ``dynamic_shards``."""
    from dmlc_core_tpu_torch.staging.fused import plain_batches

    rec = write_indexed_rowrec(str(tmp_path / "p.rec"), 20, seed=1)
    with pytest.raises(Error, match="static part"):
        plain_batches(f"{rec}?index={rec}.idx&dynamic_shards=1",
                      BatchSpec(batch_size=4, max_nnz=6))


def test_close_releases_live_lease_immediately(tracker, corpus):
    rec, idx = corpus
    uri = f"{rec}?index={idx}&shuffle=record&seed=3&dynamic_shards=1"
    src = io_split.create(uri, type="recordio", threaded=False)
    assert src.next_record() is not None  # a live lease on one shard
    held = src.current_shard
    src.close()
    s = tracker.shards.summary()
    assert s["reclaimed"] == 1 and s["queue_depth"] == s["n_shards"]
    peer = io_split.create(uri, type="recordio", threaded=False)
    rows, _ = drain_sha(peer)
    stats = peer.io_stats()
    peer.close()
    assert rows == N_ROWS and stats["shards_recorded"] == s["n_shards"]
    assert held in range(s["n_shards"])


def test_fileset_signature_normalizes_local_uri_forms(corpus, monkeypatch):
    """``file:///d/x.rec``, ``/d/x.rec`` and a ``fault://``-wrapped
    ``/d/x.rec`` sign alike, and as the JAX package signs them."""
    rec, idx = corpus
    seen = []

    class _Probe:
        rank = 0

        def lease(self, epoch, fileset=None):
            seen.append(fileset)
            return {"status": "done"}

    monkeypatch.setenv("DMLC_TRACKER_URI", "127.0.0.1")
    monkeypatch.setenv("DMLC_TRACKER_PORT", "1")  # never dialed
    for form in (f"{rec}?index={idx}&dynamic_shards=1",
                 f"file://{rec}?index={idx}&dynamic_shards=1",
                 f"fault://latency_ms=1,seed=5{rec}?index={idx}&dynamic_shards=1"):
        src = io_split.create(form, type="recordio", threaded=False)
        src._client = _Probe()
        assert src.next_record() is None  # the probe answers done
        src.close()
    assert len(seen) == 3 and len(set(seen)) == 1, seen
    assert seen[0] == jax_split.fileset_signature(rec, idx, "indexed_recordio")


def test_create_without_tracker_fails_loudly(corpus, monkeypatch):
    rec, idx = corpus
    monkeypatch.delenv("DMLC_TRACKER_URI", raising=False)
    monkeypatch.delenv("DMLC_TRACKER_PORT", raising=False)
    with pytest.raises(Error, match="DMLC_TRACKER_URI"):
        io_split.create(f"{rec}?index={idx}&dynamic_shards=1", type="recordio",
                        threaded=False)


# -- jobs under the port's submit ---------------------------------------------------


def run_job(cmd, env, cwd, timeout=RUN_S):
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=cwd, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, stdout, stderr)


def job_env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    for k in ("DMLC_TRACKER_URI", "DMLC_TRACKER_PORT", "DMLC_SHARD_RANK"):
        env.pop(k, None)
    return dict(env, **extra)


SHARD_ONLY_WORKER = """\
import sys
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.io import split as io_split

src = io_split.create({uri!r}, type="recordio", threaded=False)
n = 0
while src.next_record() is not None:
    n += 1
src.close()
print("drained", n, flush=True)
"""


@pytest.mark.parametrize("journal", [False, True])
def test_submit_shard_only_job_finishes_clean(corpus, tmp_path, journal):
    """A payload that speaks only the lease protocol (no rendezvous) ends
    the port's local job cleanly, with the JAX package's log lines; with
    ``--tracker-journal`` the supervised tracker journals the ledger."""
    rec, idx = corpus
    script = tmp_path / "worker.py"
    uri = f"{rec}?index={idx}&shuffle=record&seed=2&dynamic_shards=1"
    script.write_text(SHARD_ONLY_WORKER.format(repo=str(REPO), uri=uri))
    report, jdir = tmp_path / "report.json", tmp_path / "journal"
    proc = run_job([sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit",
                    "--cluster", "local", "--num-workers", "2", "--host-ip", "127.0.0.1",
                    "--shard-oversplit", "2",
                    *(["--tracker-journal", str(jdir)] if journal else []),
                    sys.executable, str(script)],
                   job_env(DMLC_RENDEZVOUS_GRACE="1", DMLC_METRICS_REPORT=str(report)),
                   str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    drained = sum(int(line.split()[-1]) for line in proc.stdout.splitlines()
                  if line.startswith("drained"))
    assert drained == N_ROWS
    assert (("job finished without a rabit rendezvous (supervised tracker" if journal
             else "job finished via the shard service without a rabit rendezvous")
            in proc.stderr)
    shards = json.loads(report.read_text())["shards"]
    assert shards["completed"] == shards["granted"] == shards["n_shards"] == 4
    if journal:
        from dmlc_core_tpu_torch.tracker import journal as jn

        done = jn.read_journal(str(jdir))[0]["shards"]["epochs"]["0"]["done"]
        assert sorted(int(s) for s in done) == [0, 1, 2, 3]


CHAOS_WORKER = """\
import hashlib, json, os, sys
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.io import split as io_split

out = {out!r}
task = os.environ["DMLC_TASK_ID"]
attempt = int(os.environ.get("DMLC_NUM_ATTEMPT", "0"))
src = io_split.create({uri!r}, type="recordio", threaded=False)
cur = {{}}

def on_lease(shard, num_shards):
    cur["shard"], cur["h"], cur["rows"] = shard, hashlib.sha256(), 0

def on_done(shard, status):
    # commit only on the exactly-once answer
    if status == "recorded":
        p = os.path.join(out, "shard_%d.json" % shard)
        with open(p + ".tmp", "w") as f:
            json.dump({{"rows": cur["rows"], "sha": cur["h"].hexdigest(),
                       "task": task, "attempt": attempt}}, f)
        os.replace(p + ".tmp", p)

src.on_lease = on_lease
src.on_shard_done = on_done
n = 0
while True:
    rec = src.next_record()
    if rec is None:
        break
    cur["h"].update(rec)
    cur["rows"] += 1
    n += 1
    if task == "0" and attempt == 0 and n >= 37:
        os._exit(9)  # die mid-lease: a partly drained micro-shard is out
src.close()
"""


def test_chaos_kill_mid_lease_exactly_once(corpus, tmp_path, monkeypatch):
    """3 workers; one dies mid-lease. The supervisor's failure hook
    reclaims its lease, the relaunched worker and its peers finish the
    epoch, every micro-shard is committed exactly once and equals the
    static part shard for shard."""
    rec, idx = corpus
    run_kill_mid_lease(rec, f"{rec}?index={idx}&shuffle=record&seed=4&dynamic_shards=1",
                       idx, tmp_path, monkeypatch)


def test_chaos_kill_mid_lease_exactly_once_under_fault_chaos(corpus, tmp_path, monkeypatch):
    """The same drill with ``fault://`` chaos on the data path, as the
    JAX test runs it: seeded resets, healed by the retry layer, while
    leases move around. The committed shards equal the clean static
    parts."""
    rec, idx = corpus
    uri = f"fault://resets=1,seed=11{rec}?index={idx}&shuffle=record&seed=4&dynamic_shards=1"
    run_kill_mid_lease(rec, uri, idx, tmp_path, monkeypatch)


def run_kill_mid_lease(rec, uri, idx, tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_SHARD_LEASE_TTL", "2.0")
    t = start_tracker("port", 3, monkeypatch)
    out = tmp_path / "out"
    out.mkdir()
    script = tmp_path / "worker.py"
    script.write_text(CHAOS_WORKER.format(repo=str(REPO), out=str(out), uri=uri))

    def launch(task_id, host, attempt):
        env = job_env(DMLC_TRACKER_URI="127.0.0.1", DMLC_TRACKER_PORT=str(t.port),
                      DMLC_TASK_ID=str(task_id), DMLC_NUM_ATTEMPT=str(attempt))
        return subprocess.Popen([sys.executable, str(script)], env=env)

    sup = Supervisor(launch, hosts=["localhost"], max_attempt=3,
                     host_fail_limit=float("inf"), relaunch_backoff=0.1,
                     on_task_failure=shardsvc.reclaim_task)
    done = threading.Event()
    errors = []

    def run():
        try:
            sup.run(3)
        except Exception as e:  # noqa: BLE001 - surfaced by the assert below
            errors.append(e)
        done.set()

    threading.Thread(target=run, daemon=True).start()
    try:
        assert done.wait(RUN_S), "the supervised job did not end"
        summary = t.shards.summary()
    finally:
        close_tracker(t)
    assert not errors, errors
    M = summary["n_shards"]
    committed = {int(f.name.split("_")[1].split(".")[0]): json.loads(f.read_text())
                 for f in out.glob("shard_*.json")}
    assert sorted(committed) == list(range(M))
    assert sup.relaunches >= 1 and summary["reclaimed"] >= 1
    assert summary["completed"] == M
    for i in range(M):
        sp = io_split.create(f"{rec}?index={idx}&shuffle=record&seed=4", type="recordio",
                             part_index=i, num_parts=M, threaded=False)
        rows, sha = drain_sha(sp)
        sp.close()
        assert (committed[i]["rows"], committed[i]["sha"]) == (rows, sha), i
    assert sum(c["rows"] for c in committed.values()) == N_ROWS


DRIVER = """
import json, os, sys, time
import numpy as np
sys.path.insert(0, {repo!r})
from dmlc_core_tpu_torch.examples import train_criteo_rec

# a tap on the example's producer: each epoch's leased micro-shards in
# lease order and a copy of every batch it yields, in order. Task 1
# holds its first lease for SLOW_S, so task 0 drains the other
# micro-shards of epoch 0 and the ranks train unequal batch counts
SLOW_S = 3.0
task = os.environ["DMLC_TASK_ID"]
FIELDS = ("labels", "weights", "indices", "values", "nnz")
epochs = []
real = train_criteo_rec.ell_batches


class Tap:
    def __init__(self, src):
        self.src, self.ring_slots = src, src.ring_slots
        self.log = {{"leases": [], "batches": []}}
        epochs.append(self.log)
        src._split.on_lease = self.on_lease

    def on_lease(self, shard, num_shards):
        self.log["leases"].append(shard)
        if task == "1" and len(epochs) == 1 and len(self.log["leases"]) == 1:
            time.sleep(SLOW_S)

    def __iter__(self):
        for b in self.src:
            self.log["batches"].append(
                dict({{k: np.array(getattr(b, k)) for k in FIELDS}}, n_valid=b.n_valid))
            yield b

    def __getattr__(self, name):
        return getattr(self.src, name)


train_criteo_rec.ell_batches = lambda *a, **kw: Tap(real(*a, **kw))
res = train_criteo_rec.main(sys.argv[1:], device="cpu")
np.savez({out!r} + task + ".npz",
         **{{f"e{{e}}_b{{i}}_{{k}}": v for e, log in enumerate(epochs)
            for i, b in enumerate(log["batches"]) for k, v in b.items()}})
with open({out!r} + task + ".json", "w") as f:
    json.dump(dict({{k: v for k, v in res.items() if k != "params"}},
                   leases=[log["leases"] for log in epochs],
                   batches=[len(log["batches"]) for log in epochs]), f)
"""


def tapped_batches(res, path):
    """Each epoch's batches a rank trained, as the driver's tap saved them."""
    z = np.load(path)
    fields = ("labels", "weights", "indices", "values", "nnz", "n_valid")
    return [[{k: z[f"e{e}_b{i}_{k}"] for k in fields} for i in range(n)]
            for e, n in enumerate(res["batches"])]


def valid_rows(batches):
    """The rows of a batch stream without its padding, field by field."""
    return {k: np.concatenate([b[k][:int(b["n_valid"])] for b in batches])
            for k in ("labels", "weights", "indices", "values", "nnz")}


def jax_replay(streams, params, path):
    """The collective job in one process with the JAX package, over the
    batches each rank trained: a round takes every rank's next batch,
    ``[grads, 1]`` from ``jax.grad`` of the JAX FM (zeros for a rank
    with none left) folded in ``reference_allreduce``'s order, divided
    by the contributor count, one ``sgd_update``; an epoch ends on the
    round nobody contributes to. Returns the params and the step count."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from dmlc_core_tpu.models import FactorizationMachine as JaxFM
    from dmlc_core_tpu.models import sgd_update as jax_sgd_update
    from dmlc_core_tpu.tracker import collective as jax_coll

    model = JaxFM(train_criteo_rec.N_FEATURES, embed_dim=train_criteo_rec.EMBED)
    grad_fn = jax.jit(model.loss_and_grads)
    params = {k: jnp.asarray(v) for k, v in params.items()}
    dim = ravel_pytree(params)[0].size
    steps = 0
    for epoch in range(len(streams[0])):
        its = [iter(s[epoch]) for s in streams]
        while True:
            vecs = []
            for it in its:
                batch = next(it, None)
                if batch is None:
                    vecs.append(np.zeros(dim + 1, np.float32))
                    continue
                feed = {k: v for k, v in batch.items() if k != "n_valid"}
                _, grads = grad_fn(params, feed)
                vecs.append(np.concatenate([np.asarray(ravel_pytree(grads)[0], np.float32),
                                            np.ones(1, np.float32)]))
            summed = jax_coll.reference_allreduce(vecs, "sum", path)
            if float(summed[-1]) == 0:
                break
            unravel = ravel_pytree(params)[1]
            params = jax_sgd_update(params, unravel(jnp.asarray(summed[:-1] / summed[-1])),
                                    train_criteo_rec.LR)
            steps += 1
    return {k: np.asarray(v) for k, v in params.items()}, steps


def test_criteo_example_over_leased_micro_shards(tmp_path):
    """The port's Criteo example with ``DMLC_DYNAMIC_SHARDS=1``: two CPU
    workers under the port's submit lease 4 micro-shards an epoch for two
    epochs; the ranks end bit-identical and every micro-shard is done
    exactly once. One worker holds its first lease a while, so in epoch 0
    the other drains more micro-shards and some rounds have one
    contributor. Each rank's batches hold the rows of the micro-shards it
    leased, in lease order, as the JAX package's static parts read them;
    the final params equal a one-process JAX replay of those batches
    (``[grads, 1]`` a round, divided by the contributor count) within
    1e-4 of max |param|."""
    from dmlc_core_tpu_torch.models import FactorizationMachine

    data = str(tmp_path / "c.rec")
    rows = 4 * train_criteo_rec.B + 300  # 4 micro-shards of 2 batches each
    train_criteo_rec.synth(data, rows)
    out, res = str(tmp_path / "model"), str(tmp_path / "res")
    script = tmp_path / "drv.py"
    script.write_text(DRIVER.format(repo=str(REPO), out=res))
    report = tmp_path / "report.json"
    proc = run_job(
        [sys.executable, "-m", "dmlc_core_tpu_torch.tracker.submit", "--cluster", "local",
         "--num-workers", "2", "--host-ip", "127.0.0.1", "--shard-oversplit", "2",
         sys.executable, str(script), data],
        job_env(DMLC_DYNAMIC_SHARDS="1", DMLC_SGD_EPOCHS="2", DMLC_SGD_PATH="tree",
                DMLC_SGD_OUT=out, DMLC_METRICS_REPORT=str(report),
                DMLC_LINK_WAIT_TIMEOUT="60"),
        str(tmp_path))
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-3000:])
    models = [np.load(f"{out}.rank{r}.npz") for r in range(2)]
    for k in models[0].files:
        assert models[0][k].tobytes() == models[1][k].tobytes(), k
    shards = json.loads(report.read_text())["shards"]
    M = 4
    assert shards["n_shards"] == M and shards["epochs"] == [0, 1]
    assert shards["completed"] == shards["granted"] == 2 * M and shards["duplicates"] == 0
    task = {json.load(open(f"{res}{t}.json"))["rank"]: t for t in range(2)}
    assert sorted(task) == [0, 1]
    results = [json.load(open(f"{res}{task[r]}.json")) for r in range(2)]
    assert all(r["world"] == 2 for r in results)
    streams = [tapped_batches(results[r], f"{res}{task[r]}.npz") for r in range(2)]
    # the slowed worker drew one micro-shard of epoch 0: unequal rounds
    assert sorted(len(results[r]["leases"][0]) for r in range(2)) == [1, 3], results
    assert results[0]["batches"][0] != results[1]["batches"][0], results
    spec = JaxSpec(batch_size=train_criteo_rec.B, layout="ell", max_nnz=train_criteo_rec.K)
    for epoch in range(2):
        leased = [results[r]["leases"][epoch] for r in range(2)]
        assert sorted(leased[0] + leased[1]) == list(range(M)), leased
        uri = (f"{data}?index={data}.idx&shuffle=batch&batch_size={train_criteo_rec.B}"
               f"&seed=1&epoch={epoch}")
        parts = []
        for i in range(M):
            src = jax_ell_batches(uri, spec, part_index=i, num_parts=M)
            parts.append([dict(b.as_dict(), n_valid=b.n_valid) for b in src])
            src.close()
        for r in range(2):
            want = valid_rows([b for i in leased[r] for b in parts[i]])
            got = valid_rows(streams[r][epoch])
            for k in want:
                assert np.array_equal(got[k], want[k]), (epoch, r, k)
    init = {k: v.detach().numpy() for k, v in FactorizationMachine(
        train_criteo_rec.N_FEATURES, train_criteo_rec.EMBED, device="cpu").params().items()}
    want, steps = jax_replay(streams, init, "tree")
    assert int(models[0]["gstep"]) == steps == results[0]["gstep"]
    for k, v in want.items():
        got = models[0][k]
        tol = 1e-4 * max(float(np.abs(v).max()), 1e-30)
        assert np.abs(got - v).max() <= tol, (k, np.abs(got - v).max(), tol)
        assert not np.array_equal(got, init[k]), f"{k} never moved"
