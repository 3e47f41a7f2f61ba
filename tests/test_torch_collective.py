"""The port's collective engine (``dmlc_core_tpu_torch.tracker.collective``)
against the JAX package's (``dmlc_core_tpu.tracker.collective``), on the
CPU over real localhost sockets.

- ``reference_allreduce``: the port's oracle equals the JAX one bit for
  bit (sum/max/min, int and float, tree and ring, n = 1..5);
- the port engine's ``allreduce``/``broadcast``/``barrier`` equal the JAX
  ``reference_allreduce`` bit for bit, and so does a mixed world of port
  and JAX engines, under a port tracker and under a JAX tracker;
- fault tolerance (copies of ``tests/test_collective.py``): seeded link
  resets heal, a faulted ring round is still exact, a dead worker
  rejoins, bootstraps from a peer and replays, the death watch unblocks
  a survivor, the chaos spec is validated and draws the JAX schedule;
- the chaos drill: a 3-process numpy SGD job under the port's
  ``Supervisor``, one worker SIGKILLed mid-round, relaunched and
  bootstrapped: its final model equals the clean run's bit for bit.

Every tracker, thread and subprocess is joined with a timeout and closed
on the way out.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from dmlc_core_tpu.tracker import client as jax_client
from dmlc_core_tpu.tracker import collective as jax_coll
from dmlc_core_tpu.tracker import tracker as jax_tracker
from dmlc_core_tpu_torch.io import retry
from dmlc_core_tpu_torch.tracker import client as port_client
from dmlc_core_tpu_torch.tracker import collective as coll_mod
from dmlc_core_tpu_torch.tracker import tracker as port_tracker
from dmlc_core_tpu_torch.tracker.collective import (
    Collective,
    DeathWatch,
    active_watch,
    notify_task_failure,
    reference_allreduce,
    set_active_watch,
)
from dmlc_core_tpu_torch.tracker.protocol import FramedSocket
from dmlc_core_tpu_torch.tracker.supervisor import Supervisor
from dmlc_core_tpu_torch.utils.logging import Error

REPO = Path(__file__).resolve().parent.parent
JOIN_S = 60  # every join in this file is bounded

@pytest.fixture(autouse=True)
def _bounded_link_waits(monkeypatch):
    """A worker waits at most 60 s for a peer's dial (300 s by default),
    in this process and in the workers it launches; a test may set less."""
    monkeypatch.setenv("DMLC_LINK_WAIT_TIMEOUT", "60")


PKGS = {
    "port": (port_tracker.RabitTracker, port_client.RabitWorker, Collective),
    "jax": (jax_tracker.RabitTracker, jax_client.RabitWorker, jax_coll.Collective),
}


# -- harness -----------------------------------------------------------------


def run_collective(n, body, io_timeout=30.0, engines=None, tracker_pkg="port",
                   **coll_kw):
    """One real-socket job: a tracker plus ``n`` threaded workers, worker
    ``i`` of package ``engines[i]`` (default all port), each running
    ``body(coll, rank)`` over a wired engine. Returns results by rank;
    raises on any worker error or a worker still running after the
    join's timeout."""
    engines = engines or ["port"] * n
    tracker = PKGS[tracker_pkg][0]("127.0.0.1", n)
    tracker.start(n)
    results = [None] * n
    errors = []

    def one(i):
        _, worker_cls, coll_cls = PKGS[engines[i]]
        try:
            w = worker_cls("127.0.0.1", tracker.port, jobid=str(i))
            rank = w.start(world_size=n if i == 0 else -1)
            c = coll_cls(w, io_timeout=io_timeout, **coll_kw)
            try:
                results[rank] = body(c, rank)
            finally:
                c.close(linger=0.2)
                w.shutdown()
        except Exception as e:  # noqa: BLE001 - surfaced via errors
            errors.append((i, e))

    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(n)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=JOIN_S)
        assert not [t for t in threads if t.is_alive()], "a worker thread wedged"
        assert not errors, errors
        if tracker_pkg == "port":
            assert tracker.join(timeout=JOIN_S), "the tracker never saw every shutdown"
    finally:
        tracker.close()
    return results


def _inputs(n, dtype, size=37, signed=True):
    """Per-rank deterministic arrays; size 37 is coprime with every
    tested world size, so ring segments are uneven."""
    out = []
    rng = np.random.default_rng(1234)
    for _ in range(n):
        a = rng.integers(-50 if signed else 0, 50, size)
        if np.issubdtype(np.dtype(dtype), np.floating):
            a = a + rng.random(size)
        out.append(np.asarray(a, dtype=dtype))
    return out


CASES = [(op, path, dtype) for op in ("sum", "max", "min") for path in ("tree", "ring")
         for dtype in (np.float64, np.int64)]


# -- the reference oracle -----------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_reference_allreduce_equals_jax(n, dtype):
    arrs = _inputs(n, dtype, size=41)
    for op in ("sum", "max", "min"):
        for path in ("tree", "ring"):
            got = reference_allreduce(arrs, op, path)
            want = jax_coll.reference_allreduce(arrs, op, path)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (op, path)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 8])
def test_reference_paths_agree_on_exact_ops(n):
    arrs = _inputs(n, np.int64)
    for op in ("sum", "max", "min"):
        assert np.array_equal(reference_allreduce(arrs, op, "tree"),
                              reference_allreduce(arrs, op, "ring")), op
    f = _inputs(n, np.float64)
    for op in ("max", "min"):
        assert np.array_equal(reference_allreduce(f, op, "tree"),
                              reference_allreduce(f, op, "ring"))


def test_reference_rejects_unknown():
    with pytest.raises(Error):
        reference_allreduce([np.zeros(3)], "bogus")
    with pytest.raises(Error):
        reference_allreduce([np.zeros(3), np.zeros(3)], "sum", path="star")


def test_frames_are_the_jax_engines():
    assert coll_mod._HDR.format == jax_coll._HDR.format
    assert (coll_mod._FRAME_MAGIC, coll_mod._MAX_PAYLOAD) == (
        jax_coll._FRAME_MAGIC, jax_coll._MAX_PAYLOAD)
    kinds = ("K_DATA", "K_RESULT", "K_RESET", "K_RS", "K_AG", "K_CKREQ", "K_CK", "K_ERR")
    assert [getattr(coll_mod, k) for k in kinds] == [getattr(jax_coll, k) for k in kinds]


# -- the engine against the JAX reference -------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_allreduce_bit_identical_to_jax_reference(n):
    """sum/max/min × tree/ring × float64/int64: every rank's result
    equals the JAX package's single-process reference bit for bit, and
    the engine counts its rounds, bytes and waits."""
    inputs = {np.float64: _inputs(n, np.float64), np.int64: _inputs(n, np.int64)}

    def body(c, rank):
        outs = [c.allreduce(inputs[dtype][rank], op, path=path)
                for (op, path, dtype) in CASES]
        return outs, c.io_stats()

    results = run_collective(n, body)
    for ci, (op, path, dtype) in enumerate(CASES):
        ref = jax_coll.reference_allreduce(inputs[dtype], op, path)
        for rank in range(n):
            got = results[rank][0][ci]
            assert got.dtype == np.dtype(dtype) and got.tobytes() == ref.tobytes(), \
                (op, path, dtype, rank)
    stats = results[0][1]
    if n == 1:  # a world of one moves no bytes, as in the JAX engine
        assert stats["rounds"]["local"] == len(CASES) and stats["bytes"] == 0
    else:
        assert stats["rounds"]["tree"] == stats["rounds"]["ring"] == len(CASES) // 2
        assert stats["bytes"] == sum(inputs[d][0].nbytes for _, _, d in CASES)
    assert stats["recoveries"] == 0 and stats["link_wait_secs"] >= 0


@pytest.mark.parametrize("tracker_pkg", ["port", "jax"])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_mixed_world_shares_rounds_bit_identically(n, tracker_pkg):
    """Port and JAX engines, alternating by rank, in one world: every
    allreduce, broadcast and barrier equals the JAX reference bit for
    bit on every rank, under either package's tracker."""
    engines = ["port" if i % 2 == 0 else "jax" for i in range(n)]
    inputs = {np.float64: _inputs(n, np.float64), np.int64: _inputs(n, np.int64)}
    payload = np.arange(23, dtype=np.float32) * 1.5 - 4

    def body(c, rank):
        outs = [c.allreduce(inputs[dtype][rank], op, path=path)
                for (op, path, dtype) in CASES]
        c.barrier()
        outs.append(c.broadcast(payload if rank == n - 1 else np.zeros_like(payload),
                                root=n - 1))
        return outs

    results = run_collective(n, body, engines=engines, tracker_pkg=tracker_pkg)
    for ci, (op, path, dtype) in enumerate(CASES):
        ref = jax_coll.reference_allreduce(inputs[dtype], op, path)
        for rank in range(n):
            assert results[rank][ci].tobytes() == ref.tobytes(), (op, path, dtype, rank)
    for rank in range(n):
        assert results[rank][-1].tobytes() == payload.tobytes()


def test_allreduce_f32_2d_and_custom_reducer():
    n = 3
    arrs = [np.arange(12, dtype=np.float32).reshape(3, 4) * (r + 1) for r in range(n)]

    def body(c, rank):
        s = c.allreduce(arrs[rank], "sum", path="tree")
        # any elementwise f(acc, contrib) callable is a reducer
        p = c.allreduce(arrs[rank] + 1.0, np.multiply, path="tree")
        return s, p

    results = run_collective(n, body)
    ref_s = jax_coll.reference_allreduce(arrs, "sum", "tree")
    ref_p = jax_coll.reference_allreduce([a + 1.0 for a in arrs], np.multiply, "tree")
    for s, p in results:
        assert s.shape == (3, 4) and np.array_equal(s, ref_s)
        assert np.array_equal(p, ref_p)


def test_size_based_path_choice_is_counted():
    """path=None routes payloads >= ring_bytes over the ring; the engine's
    counters say which path each round took."""
    n = 2
    big = [np.arange(4096, dtype=np.int64) + r for r in range(n)]
    small = [np.arange(4, dtype=np.int64) + r for r in range(n)]

    def body(c, rank):
        return c.allreduce(big[rank], "sum"), c.allreduce(small[rank], "sum"), c.io_stats()

    for b, s, stats in run_collective(n, body, ring_bytes=1024):
        assert np.array_equal(b, jax_coll.reference_allreduce(big, "sum", "ring"))
        assert np.array_equal(s, jax_coll.reference_allreduce(small, "sum", "tree"))
        assert stats["rounds"] == {"tree": 1, "ring": 1, "bcast": 0, "local": 0}
        assert stats["bytes"] == big[0].nbytes + small[0].nbytes


@pytest.mark.parametrize("path", ["tree", "ring"])
def test_frames_carry_real_flow_ids_and_rounds_reach_the_registry(path):
    """Every frame header carries the sender's flight-recorder flow id
    (the JAX engine's wire form): in a mixed port/JAX world, each flow a
    port engine sends lands as a finish in the JAX receiver's recorder
    and the reverse, never 0; each round runs under a
    dmlc:allreduce_wait span and ticks the registry series the engine's
    io_stats() keeps."""
    from dmlc_core_tpu.telemetry import tracing as jax_tracing
    from dmlc_core_tpu_torch.telemetry import default_registry
    from dmlc_core_tpu_torch.telemetry import tracing

    n = 2
    arrs = [np.arange(4096, dtype=np.float64) * (r + 1) for r in range(n)]
    recorders = (tracing, jax_tracing)
    for mod in recorders:
        mod.reset()
        mod.set_enabled(True)
    before = default_registry().snapshot()
    try:
        def body(c, rank):  # the JAX engine keeps no io_stats()
            out = c.allreduce(arrs[rank], "sum", path=path)
            return out, getattr(c, "io_stats", lambda: None)()

        results = run_collective(n, body, engines=["port", "jax"])
        port_ev = tracing.to_chrome_trace()["traceEvents"]
        jax_ev = jax_tracing.to_chrome_trace()["traceEvents"]
    finally:
        for mod in recorders:
            mod.set_enabled(None)
            mod.reset()
    ref = jax_coll.reference_allreduce(arrs, "sum", path)
    assert all(r[0].tobytes() == ref.tobytes() for r in results)

    def ids(events, ph):
        return {e["id"] for e in events if e["ph"] == ph and e["name"] == "rpc"}

    port_sent, jax_got = ids(port_ev, "s"), ids(jax_ev, "f")
    jax_sent, port_got = ids(jax_ev, "s"), ids(port_ev, "f")
    assert port_sent & jax_got and jax_sent & port_got
    assert 0 not in port_sent | jax_sent
    assert port_got <= jax_sent | port_sent
    assert any(e["ph"] == "X" and e["name"] == "dmlc:allreduce_wait" for e in port_ev)
    after = default_registry().snapshot()

    def delta(kind, key, field=None):
        now, was = after[kind].get(key, 0), before[kind].get(key, 0)
        return (now[field] - (was[field] if was else 0)) if field else now - was

    (stats,) = [r[1] for r in results if r[1] is not None]
    assert stats["bytes"] == arrs[0].nbytes and stats["rounds"][path] == 1
    assert delta("counters", f'tracker.collective.rounds{{path="{path}"}}') == 1
    assert delta("counters", "tracker.collective.bytes") == stats["bytes"]
    assert delta("histograms", "tracker.collective.link_wait_seconds", "count") == 1


@pytest.mark.parametrize("engine,n", [("port", 2), ("port", 3), ("jax", 2)])
def test_a_ring_round_larger_than_the_socket_buffers(engine, n):
    """16 MB a rank: every rank's first ring segment is larger than the
    loopback sockets' buffers. The port sends it on a helper thread while
    it receives, so the round completes over the ring with no recovery.
    The JAX engine sends before it receives: both ranks block in
    ``sendall`` until the io timeout, recover, and retry over the tree."""
    big = [np.arange(4 << 20, dtype=np.float32) * (r + 1) + 0.5 for r in range(n)]

    def body(c, rank):
        return c.allreduce(big[rank], "sum", path="ring"), c.recoveries

    results = run_collective(n, body, io_timeout=2.0, engines=[engine] * n)
    want = jax_coll.reference_allreduce(big, "sum", "ring" if engine == "port" else "tree")
    for got, recoveries in results:
        assert got.tobytes() == want.tobytes()
        assert recoveries == (0 if engine == "port" else 1)


@pytest.mark.parametrize("root", [0, 1, 2, 3])
def test_broadcast_from_any_root(root):
    n = 4
    payload = np.arange(19, dtype=np.float64) * 3.5 - 7

    def body(c, rank):
        return c.broadcast(payload if rank == root else np.zeros_like(payload), root=root)

    for got in run_collective(n, body):
        assert np.array_equal(got, payload)


def test_barrier_orders_ranks():
    n = 3
    hits = []

    def body(c, rank):
        hits.append(("pre", rank))
        c.barrier()
        hits.append(("post", rank))
        return True

    assert all(run_collective(n, body))
    first_post = next(i for i, (k, _) in enumerate(hits) if k == "post")
    assert len([h for h in hits[:first_post] if h[0] == "pre"]) == n


def test_world_of_one_is_local():
    tracker = port_tracker.RabitTracker("127.0.0.1", 1)
    tracker.start(1)
    try:
        w = port_client.RabitWorker("127.0.0.1", tracker.port, jobid="0")
        w.start(world_size=1)
        c = Collective(w)
        a = np.arange(5, dtype=np.float32)
        assert np.array_equal(c.allreduce(a, "sum"), a)
        assert np.array_equal(c.broadcast(a, root=0), a)
        c.barrier()
        assert c.load_checkpoint(timeout=0.5) == (0, None)
        with pytest.raises(Error):
            c.allreduce(a, "bogus")
        with pytest.raises(Error):
            c.broadcast(a, root=5)
        # close() with no live links returns at once, not after the linger
        t0 = time.perf_counter()
        c2 = Collective(w)
        c2.close(linger=5.0)
        assert time.perf_counter() - t0 < 1.0
        c.close()
        w.shutdown()
        assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


def test_oversized_payload_raises_checked_error(monkeypatch):
    eng = Collective.__new__(Collective)  # the check precedes any IO
    monkeypatch.setattr(coll_mod, "_MAX_PAYLOAD", 8)
    with pytest.raises(Error, match="frame limit"):
        eng._send_frame(0, coll_mod.K_DATA, 0, 0, b"x" * 9)


# -- fault tolerance ----------------------------------------------------------


def test_seeded_link_resets_heal_bit_identical(monkeypatch):
    """Links half-closed mid-job at seeded rounds: both endpoints run the
    reset flood + re-rendezvous, and every round stays bit-identical."""
    monkeypatch.setenv("DMLC_COLLECTIVE_FAULTS", "resets=2,seed=7")
    n, rounds = 3, 12

    def inp(rank, r):
        return np.arange(8, dtype=np.float64) * (rank + 1) + r

    def body(c, rank):
        return [c.allreduce(inp(rank, r), "sum", path="tree") for r in range(rounds)], \
            c.recoveries

    fired = retry.stats()["faults_injected"]
    results = run_collective(n, body)
    assert sum(rec for _, rec in results) > 0, "no reset ever fired"
    assert retry.stats()["faults_injected"] > fired  # each fired fault counts
    for r in range(rounds):
        ref = jax_coll.reference_allreduce([inp(k, r) for k in range(n)], "sum", "tree")
        for rank in range(n):
            assert np.array_equal(results[rank][0][r], ref), (rank, r)


def test_ring_round_faulted_by_reset_still_exact(monkeypatch):
    """A ring round a reset aborts retries over the tree; with int64
    payloads both fold orders are exact, so every result still equals the
    reference whichever rounds faulted."""
    monkeypatch.setenv("DMLC_COLLECTIVE_FAULTS", "resets=2,seed=3")
    n, rounds = 3, 8
    arrs = [[np.arange(513, dtype=np.int64) * (k + 1) + r for k in range(n)]
            for r in range(rounds)]

    def body(c, rank):
        return [c.allreduce(arrs[r][rank], "sum", path="ring") for r in range(rounds)]

    results = run_collective(n, body, ring_bytes=64)
    for r in range(rounds):
        ref = jax_coll.reference_allreduce(arrs[r], "sum", "ring")
        for rank in range(n):
            assert np.array_equal(results[rank][r], ref), (rank, r)


def test_dead_worker_rejoins_bootstraps_and_replays():
    """B dies mid-job; A finds the dead link and re-enters the
    rendezvous; B' reclaims rank 1 through the jobid memo, pulls A's
    in-memory checkpoint, fast-forwards its round clock, replays the
    missed rounds from A's result cache and joins the live round."""
    n = 2
    tracker = port_tracker.RabitTracker("127.0.0.1", n)
    tracker.start(n)

    def inp(rank, r):
        return np.arange(8, dtype=np.float64) * (rank + 1) + r

    refs = [jax_coll.reference_allreduce([inp(k, r) for k in range(n)], "sum", "tree")
            for r in range(6)]
    a_out, a_err = [], []

    def run_a():
        try:
            w = port_client.RabitWorker("127.0.0.1", tracker.port, jobid="0")
            rank = w.start(world_size=n)
            c = Collective(w, io_timeout=30)
            for r in range(6):
                a_out.append(c.allreduce(inp(rank, r), "sum", path="tree"))
                if r == 2:
                    c.checkpoint(b"state-after-round-2", version=3)
            c.close()
            w.shutdown()
        except Exception as e:  # noqa: BLE001
            a_err.append(e)

    ta = threading.Thread(target=run_a, daemon=True)
    try:
        b = port_client.RabitWorker("127.0.0.1", tracker.port, jobid="1")
        ta.start()
        rank_b = b.start(world_size=-1)
        cb = Collective(b, io_timeout=30)
        for r in range(5):
            assert np.array_equal(cb.allreduce(inp(rank_b, r), "sum", path="tree"), refs[r])
        b.close()  # B dies abruptly: links torn down mid-job
        cb.close(linger=0.0)
        time.sleep(0.2)
        w2 = port_client.RabitWorker("127.0.0.1", tracker.port, jobid="1")
        assert w2.start(world_size=-1) == rank_b  # the jobid memo
        c2 = Collective(w2, io_timeout=30)
        assert c2.load_checkpoint() == (3, b"state-after-round-2")
        assert c2.seq == 3
        for r in range(3, 6):  # rounds 3-4 replay from A's cache, 5 is live
            assert np.array_equal(c2.allreduce(inp(rank_b, r), "sum", path="tree"), refs[r])
        c2.close()
        w2.shutdown()
        ta.join(JOIN_S)
        assert not ta.is_alive() and not a_err, a_err
        assert all(np.array_equal(a_out[r], refs[r]) for r in range(6))
        assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


def test_wedged_peer_death_discovered_by_watch_push_not_timeout():
    """B wedges without closing its sockets; only the tracker's death
    watch push can unblock A before its io_timeout, which is set far
    beyond the test's joins."""
    n = 2
    tracker = port_tracker.RabitTracker("127.0.0.1", n)
    tracker.start(n)

    def inp(rank, r):
        return np.arange(6, dtype=np.float64) * (rank + 1) + r

    refs = [jax_coll.reference_allreduce([inp(k, r) for k in range(n)], "sum", "tree")
            for r in range(2)]
    a_out, a_err = [], []
    a_recovered = threading.Event()

    def run_a():
        try:
            w = port_client.RabitWorker("127.0.0.1", tracker.port, jobid="0")
            rank = w.start(world_size=n)
            c = Collective(w, io_timeout=600)
            for r in range(2):
                a_out.append(c.allreduce(inp(rank, r), "sum", path="tree"))
            if c.recoveries:
                a_recovered.set()
            c.close()
            w.shutdown()
        except Exception as e:  # noqa: BLE001
            a_err.append(e)

    ta = threading.Thread(target=run_a, daemon=True)
    try:
        b = port_client.RabitWorker("127.0.0.1", tracker.port, jobid="1")
        ta.start()
        rank_b = b.start(world_size=-1)
        cb = Collective(b, io_timeout=30)
        assert np.array_equal(cb.allreduce(inp(rank_b, 0), "sum", path="tree"), refs[0])
        time.sleep(0.3)
        tracker.watch.note_task_rank("1", rank_b)
        tracker.watch.notify("1")  # what the supervisor's observer does
        w2 = port_client.RabitWorker("127.0.0.1", tracker.port, jobid="1")
        assert w2.start(world_size=-1) == rank_b
        c2 = Collective(w2, io_timeout=30)
        c2.load_checkpoint(timeout=5)
        for r in range(c2.seq, 2):
            assert np.array_equal(c2.allreduce(inp(rank_b, r), "sum", path="tree"), refs[r])
        c2.close()
        w2.shutdown()
        ta.join(JOIN_S)
        assert not ta.is_alive(), "A never unblocked: watch push broken"
        assert not a_err and a_recovered.is_set()
        assert all(np.array_equal(a_out[r], refs[r]) for r in range(2))
        cb.close(linger=0.0)
        b.close()
        assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


# -- the death watch ----------------------------------------------------------


def _pipe_watcher():
    a, b = socket.socketpair()
    return FramedSocket(a), FramedSocket(b)


def test_deathwatch_fans_out_except_dead_rank():
    watch = DeathWatch()
    pairs = [_pipe_watcher() for _ in range(3)]
    for r, (t, _) in enumerate(pairs):
        watch.add(r, t)
    watch.note_task_rank("job-b", 1)
    watch.notify("job-b", host="h1")
    for r in (0, 2):
        fs = pairs[r][1]
        fs.sock.settimeout(5)
        msg = json.loads(fs.recv_str())
        assert msg == {"dead_rank": 1, "task_id": "job-b", "host": "h1"}
    pairs[1][1].sock.settimeout(0.2)
    with pytest.raises((socket.timeout, TimeoutError, ConnectionError)):
        pairs[1][1].recv_str()
    assert watch.notices == 1
    watch.close()
    for _, fs in pairs:
        fs.close()


def test_deathwatch_unknown_task_falls_back_to_int_and_drops_dead():
    watch = DeathWatch()
    t0, w0 = _pipe_watcher()
    t1, w1 = _pipe_watcher()
    watch.add(0, t0)
    watch.add(1, t1)
    w0.close()
    t0.close()
    watch.notify(7)  # no task memo: the task id is the rank
    w1.sock.settimeout(5)
    assert json.loads(w1.recv_str())["dead_rank"] == 7
    assert 0 not in watch._watchers
    t1b, w1b = _pipe_watcher()
    watch.add(1, t1b)  # a relaunched worker's connection replaces the old
    watch.notify(0)
    w1b.sock.settimeout(5)
    assert json.loads(w1b.recv_str())["dead_rank"] == 0
    watch.close()
    for fs in (w1, w1b):
        fs.close()


def test_notify_task_failure_reaches_the_live_tracker_and_is_noop_without():
    tracker = port_tracker.RabitTracker("127.0.0.1", 2)
    try:
        assert active_watch() is tracker.watch
        t, w = _pipe_watcher()
        tracker.watch.add(0, t)
        notify_task_failure(1, "host")
        w.sock.settimeout(5)
        assert json.loads(w.recv_str())["dead_rank"] == 1
        w.close()
    finally:
        tracker.close()
    assert active_watch() is None
    prev = active_watch()
    set_active_watch(None)
    try:
        notify_task_failure(3, "host")  # must not raise
    finally:
        set_active_watch(prev)


@pytest.mark.parametrize("spec", ["resets=3,seed=5", "resets=2,seed=7", "resets=2,seed=3",
                                  "delay_ms=5,seed=1", "resets=1,spikes=2,delay_ms=1,seed=9"])
def test_chaos_schedule_is_the_jax_engines(spec):
    for rank in range(4):
        assert coll_mod._PeerChaos(spec, rank).events == jax_coll._PeerChaos(spec, rank).events


def test_chaos_spec_validation():
    with pytest.raises(Error):
        coll_mod._PeerChaos("bogus_knob=1", 0)
    with pytest.raises(Error):
        coll_mod._PeerChaos("resets=abc", 0)
    with pytest.raises(Error):
        coll_mod._PeerChaos("kill_seq=1,kill_phase=middle", 0)
    c = coll_mod._PeerChaos("resets=3,seed=5,kill_seq=2,kill_rank=1,kill_attempt=1", 0)
    assert (c.kill_rank, c.kill_seq, c.kill_attempt, c.kill_phase) == (1, 2, 1, "sent")
    assert len(c.events) == 3
    assert coll_mod._PeerChaos("resets=3,seed=5", 0).events == \
        coll_mod._PeerChaos("resets=3,seed=5", 0).events


# -- the chaos drill ----------------------------------------------------------

DRILL_WORKER = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
from dmlc_core_tpu_torch.tracker.client import RabitWorker
from dmlc_core_tpu_torch.tracker.collective import Collective

w = RabitWorker()
rank = w.start()
world = w.world_size
c = Collective(w, io_timeout=60)

DIM, STEPS, SAVE_EVERY = 64, {steps}, 3
params = np.zeros(DIM)
step0 = 0
if int(os.environ.get("DMLC_NUM_ATTEMPT", "0")) > 0:
    version, state = c.load_checkpoint()
    if state:
        params = np.frombuffer(state, dtype=np.float64).copy()
        step0 = int(version)

for s in range(step0, STEPS):
    g = np.sin(np.arange(DIM) * (rank + 1) + s).astype(np.float64)
    total = c.allreduce(g, "sum", path="tree")
    params = params - 0.01 * (total / world)
    if (s + 1) % SAVE_EVERY == 0:
        c.checkpoint(params.tobytes(), version=s + 1)

out = os.environ["DRILL_OUT"]
tmp = f"{{out}}.rank{{rank}}.tmp{{os.getpid()}}"
np.save(tmp + ".npy", params)
os.replace(tmp + ".npy", f"{{out}}.rank{{rank}}.npy")
c.close()
w.shutdown()
"""


def _run_drill(tmp_path, tag, steps, faults):
    """3-worker SGD job under the port's Supervisor; returns per-rank
    final params and the supervisor."""
    tracker = port_tracker.RabitTracker("127.0.0.1", 3)
    tracker.start(3)
    out = str(tmp_path / f"model_{tag}")
    script = tmp_path / f"drill_{tag}.py"
    script.write_text(DRILL_WORKER.format(repo=str(REPO), steps=steps))
    procs = []

    def launch(task_id, host, attempt):
        env = os.environ.copy()
        env.update({"DMLC_TRACKER_URI": "127.0.0.1", "DMLC_TRACKER_PORT": str(tracker.port),
                    "DMLC_TASK_ID": str(task_id), "DMLC_NUM_ATTEMPT": str(attempt),
                    "DRILL_OUT": out})
        env.pop("DMLC_COLLECTIVE_FAULTS", None)
        if faults:
            env["DMLC_COLLECTIVE_FAULTS"] = faults
        procs.append(subprocess.Popen([sys.executable, str(script)], env=env))
        return procs[-1]

    sup = Supervisor(launch, hosts=["localhost"], max_attempt=3,
                     host_fail_limit=float("inf"), relaunch_backoff=0.1,
                     on_task_failure=[notify_task_failure])
    check = sup.run_in_thread(3, "drill-supervisor", grace=JOIN_S)
    try:
        assert tracker.join(timeout=JOIN_S), "the drill never finished"
        sup._thread.join(JOIN_S)
        assert not sup._thread.is_alive() and check() is None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=JOIN_S)
        tracker.close()
    return [np.load(f"{out}.rank{r}.npy") for r in range(3)], sup


def test_chaos_drill_kill_mid_round_equals_clean_run(tmp_path):
    """One worker SIGKILLed at the start of round 4 (a checkpoint exists
    at round 3), relaunched by the supervisor, the survivors unblocked by
    the death watch: the final model equals the clean run's bit for bit
    on every rank."""
    steps = 10
    clean, _ = _run_drill(tmp_path, "clean", steps, "")
    chaos, sup = _run_drill(tmp_path, "chaos", steps, "kill_seq=4,kill_rank=2,kill_phase=start")
    assert sup.relaunches >= 1, "the kill never fired"
    for r in range(3):
        assert np.array_equal(clean[r], clean[0]) and np.array_equal(chaos[r], chaos[0])
    assert np.array_equal(chaos[0], clean[0])
