"""The port's tracker (``dmlc_core_tpu_torch.tracker``) against the JAX
package's (``dmlc_core_tpu.tracker``) on the CPU: the topology maps, the
wire bytes, the submit options, the rendezvous over real sockets in both
directions (port workers under a JAX tracker, JAX workers under a port
tracker, and a mixed world), the tracker's defences against hostile
clients (copies of ``tests/test_tracker.py``), every cluster's backend
resolving as in the JAX package, and the refusal of an unknown cluster.
Every tracker and thread is joined with a timeout and closed on the way
out."""

import random
import socket
import threading
import time

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dmlc_core_tpu.tracker import client as jax_client
from dmlc_core_tpu.tracker import opts as jax_opts
from dmlc_core_tpu.tracker import protocol as jax_protocol
from dmlc_core_tpu.tracker import topology as jax_topology
from dmlc_core_tpu.tracker import tracker as jax_tracker
from dmlc_core_tpu_torch.tracker import client as port_client
from dmlc_core_tpu_torch.tracker import opts as port_opts
from dmlc_core_tpu_torch.tracker import protocol
from dmlc_core_tpu_torch.tracker import topology
from dmlc_core_tpu_torch.tracker import tracker as port_tracker
from dmlc_core_tpu_torch.tracker.backends import get_backend
from dmlc_core_tpu_torch.tracker.client import RabitWorker
from dmlc_core_tpu_torch.tracker.protocol import MAGIC, FramedSocket
from dmlc_core_tpu_torch.tracker.tracker import RabitTracker
from dmlc_core_tpu_torch.utils.logging import Error

JOIN_S = 30  # every join in this file is bounded

@pytest.fixture(autouse=True)
def _bounded_link_waits(monkeypatch):
    """A worker waits at most 60 s for a peer's dial (300 s by default),
    in this process and in the workers it launches; a test may set less."""
    monkeypatch.setenv("DMLC_LINK_WAIT_TIMEOUT", "60")


TRACKERS = {"port": port_tracker.RabitTracker, "jax": jax_tracker.RabitTracker}
WORKERS = {"port": port_client.RabitWorker, "jax": jax_client.RabitWorker}


# -- topology ----------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 65))
def test_topology_equals_jax(n):
    assert topology.get_tree(n) == jax_topology.get_tree(n)
    tree_map, parent_map = topology.get_tree(n)
    assert topology.get_ring(tree_map, parent_map) == jax_topology.get_ring(tree_map, parent_map)
    assert topology.get_link_map(n) == jax_topology.get_link_map(n)
    assert [topology.get_neighbors(r, n) for r in range(n)] == \
        [jax_topology.get_neighbors(r, n) for r in range(n)]


@settings(max_examples=60, deadline=None)
@given(st.integers(min_value=1, max_value=400))
def test_topology_fuzz_equals_jax_and_is_a_ring(n):
    tree2, parent2, ring2 = topology.get_link_map(n)
    assert (tree2, parent2, ring2) == jax_topology.get_link_map(n)
    # relabeled ring-next is rank+1 and every rank is visited once
    assert all(ring2[r] == ((r - 1) % n, (r + 1) % n) for r in range(n))
    assert parent2[0] == -1 and sorted(tree2) == list(range(n))


# -- wire bytes ----------------------------------------------------------------


def _wire(pkg, ops):
    """The bytes ``ops`` put on a socket through ``pkg``'s FramedSocket."""
    a, b = socket.socketpair()
    fs = pkg.FramedSocket(a)
    for kind, value in ops:
        getattr(fs, f"send_{kind}")(value)
    a.close()
    chunks = []
    while True:
        chunk = b.recv(65536)
        if not chunk:
            break
        chunks.append(chunk)
    b.close()
    return b"".join(chunks)


@pytest.mark.parametrize("ops", [
    [("int", MAGIC), ("int", -1), ("int", 3), ("str", "NULL"), ("str", "start")],
    [("str", ""), ("str", "ünïcødé ✓"), ("int", 2**31 - 1), ("int", -(2**31))],
    [("str", "x" * 70000), ("int", 7)],
])
def test_framed_socket_bytes_equal_jax(ops):
    assert _wire(protocol, ops) == _wire(jax_protocol, ops)
    # and the port reads back what the JAX side wrote
    a, b = socket.socketpair()
    try:
        jfs, pfs = jax_protocol.FramedSocket(a), FramedSocket(b)
        for kind, value in ops:
            getattr(jfs, f"send_{kind}")(value)
        b.settimeout(5)
        assert [getattr(pfs, f"recv_{kind}")() for kind, _ in ops] == [v for _, v in ops]
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("cmd,ctx", [("start", None), ("recover", "00-ab-cd-01"),
                                     ("metrics", ""), ("shard_lease", "t\x1dx")])
def test_pack_cmd_equals_jax(cmd, ctx):
    packed = protocol.pack_cmd(cmd, ctx)
    assert packed == jax_protocol.pack_cmd(cmd, ctx)
    assert protocol.unpack_cmd(packed) == jax_protocol.unpack_cmd(packed)


def test_command_set_equals_jax():
    names = [n for n in dir(jax_protocol) if n.startswith("CMD_")]
    assert [getattr(protocol, n) for n in names] == [getattr(jax_protocol, n) for n in names]
    assert protocol.RENDEZVOUS_CMDS == jax_protocol.RENDEZVOUS_CMDS
    assert protocol.SHARD_CMDS == jax_protocol.SHARD_CMDS
    assert (protocol.MAGIC, FramedSocket.MAX_STR) == (jax_protocol.MAGIC,
                                                       jax_protocol.FramedSocket.MAX_STR)


def test_framed_socket_rejects_a_hostile_length():
    a, b = socket.socketpair()
    try:
        a.sendall((-5).to_bytes(4, "little", signed=True))
        b.settimeout(5)
        with pytest.raises(ConnectionError, match="invalid string length"):
            FramedSocket(b).recv_str()
    finally:
        a.close()
        b.close()


# -- options -------------------------------------------------------------------

ARGVS = [
    ["--cluster", "local", "--num-workers", "3", "--worker-memory", "2g", "echo", "hi"],
    ["--cluster", "local", "--num-workers", "2", "--", "python", "t.py", "--x"],
    ["--cluster", "ssh", "--num-workers", "1", "--num-servers", "2", "--host-file", "h",
     "--server-memory", "512m", "./app", "data"],
    ["--cluster", "local", "--num-workers", "4", "--local-num-attempt", "2", "--host-ip",
     "127.0.0.1", "--env", "A=1", "--env", "B=2", "--files", "f1", "--auto-file-cache", "0",
     "python", "-m", "m"],
    ["--cluster", "kubernetes", "--num-workers", "2", "--jobname", "tj", "--log-level",
     "DEBUG", "--dry-run", "./app"],
    ["--cluster", "local", "--num-workers", "2", "--autoscale", "1:4", "--dsserve", "2",
     "--shard-oversplit", "8", "--trace-dir", "/tmp/x", "--block-cache", "python", "a.py"],
    ["--cluster", "tpu-pod", "--num-workers", "2", "--tpu-name", "pod1", "python3", "t.py"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_get_opts_equals_jax(argv):
    assert vars(port_opts.get_opts(argv)) == vars(jax_opts.get_opts(argv))


def test_get_opts_errors_equal_jax(monkeypatch):
    monkeypatch.delenv("DMLC_SUBMIT_CLUSTER", raising=False)
    for mod in (port_opts, jax_opts):
        with pytest.raises(RuntimeError, match="--cluster is not specified"):
            mod.get_opts(["--num-workers", "1", "true"])
        with pytest.raises(RuntimeError, match="Invalid memory"):
            mod.get_memory_mb("2x")
        with pytest.raises(SystemExit):
            mod.get_opts(["--cluster", "local", "--num-workers", "1", "--autoscale",
                          "0:2", "true"])
    monkeypatch.setenv("DMLC_SUBMIT_CLUSTER", "ssh")
    assert port_opts.get_opts(["--num-workers", "1", "true"]).cluster == "ssh"


def test_bind_scan_takes_the_next_port_when_listen_loses_the_race(monkeypatch):
    """Two trackers scanning one range may both bind a port before either
    listens (SO_REUSEADDR); the loser's listen fails with EADDRINUSE, and
    the scan must go on to the next port with a fresh socket (a second
    bind of the bound one fails with EINVAL, which ended a supervised
    tracker under a loaded test run)."""
    import errno

    with socket.socket() as probe:  # a free port to start the scan at
        probe.bind(("127.0.0.1", 0))
        start = probe.getsockname()[1]
    real_listen = socket.socket.listen
    ports = []

    def listen(sock, *args):
        ports.append(sock.getsockname()[1])
        if len(ports) == 1:
            raise OSError(errno.EADDRINUSE, "another tracker listened first")
        return real_listen(sock, *args)

    monkeypatch.setattr(socket.socket, "listen", listen)
    sock, port = protocol.bind_first_free("127.0.0.1", start, start + 50)
    try:
        assert port > start and ports[-1] == port
    finally:
        sock.close()


# -- backends and refusals -----------------------------------------------------


@pytest.mark.parametrize("cluster", port_opts.CLUSTERS)
def test_get_backend_resolves_as_jax(cluster):
    """Every cluster the options accept resolves, in both packages, to
    the submit of a backend module of the same name."""
    from dmlc_core_tpu.tracker.backends import get_backend as jax_get_backend

    assert port_opts.CLUSTERS == jax_opts.CLUSTERS
    port, jax = get_backend(cluster), jax_get_backend(cluster)
    assert port.__name__ == jax.__name__ == "submit"
    assert port.__module__.startswith("dmlc_core_tpu_torch.tracker.backends.")
    assert port.__module__.replace("dmlc_core_tpu_torch.", "dmlc_core_tpu.") == jax.__module__


def test_unknown_cluster_raises():
    with pytest.raises(Error, match="Unknown submission cluster"):
        get_backend("nomad")


@pytest.mark.parametrize("env,item", [
    ({"DMLC_AUTOSCALE": "1:4"}, "7b"),
])
def test_tracker_refuses_unported_features(monkeypatch, env, item):
    """The tracker refused ``DMLC_AUTOSCALE`` until ROADMAP.md §1 item
    7b was ported: now it starts the autoscale controller from it (no
    tracker feature is refused any more), and a malformed spec leaves a
    fixed fleet instead of a dead tracker."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DMLC_AUTOSCALE_INTERVAL", "60")
    tr = RabitTracker("127.0.0.1", 1)
    try:
        tr.start(1)
        assert tr.autoscaler is not None
        assert tr.metrics.report()["autoscale"]["max_workers"] == 4
    finally:
        tr.close()
        assert tr.join(timeout=10)
    monkeypatch.setenv("DMLC_AUTOSCALE", "banana")
    tr = RabitTracker("127.0.0.1", 1)
    try:
        tr.start(1)
        assert tr.autoscaler is None and "autoscale" not in tr.metrics.report()
    finally:
        tr.close()
        assert tr.join(timeout=10)


# -- rendezvous over real sockets, across the two packages ----------------------


def run_workers(tracker, n, pkgs, jobid_fn=str):
    """``n`` threaded workers, worker ``i`` of package ``pkgs[i]``; each
    rendezvouses, records its view and shuts down."""
    results = [None] * n
    errors = []

    def one(i):
        try:
            w = WORKERS[pkgs[i]]("127.0.0.1", tracker.port, jobid=jobid_fn(i))
            rank = w.start(world_size=n if i == 0 else -1)
            results[i] = (rank, w.parent, w.world_size, sorted(w.links),
                          w.ring_prev, w.ring_next)
            w.shutdown()
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    threads = [threading.Thread(target=one, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not [t for t in threads if t.is_alive()], "a worker wedged"
    assert not errors, errors
    return results


def check_wiring(results, n):
    assert sorted(r[0] for r in results) == list(range(n))
    tree, parent, ring = jax_topology.get_link_map(n)
    for rank, par, world, links, rprev, rnext in results:
        assert world == n and par == parent[rank] and (rprev, rnext) == (
            ring[rank] if n > 1 else (-1, -1))
        expected = set(tree[rank]) | ({rprev, rnext} - {-1, rank})
        assert set(links) == expected, (rank, links, expected)


def recover_pair(tracker, worker_cls):
    """Two workers; the first dies and a relaunch reclaims its rank with
    cmd=recover while the survivor re-rendezvouses: links re-wired."""
    w0 = worker_cls("127.0.0.1", tracker.port, jobid="0")
    w1 = worker_cls("127.0.0.1", tracker.port, jobid="1")
    t1 = threading.Thread(target=lambda: w1.start(world_size=-1), daemon=True)
    t1.start()
    r0 = w0.start(world_size=2)
    t1.join(JOIN_S)
    assert not t1.is_alive()
    w0.log("hello from worker")
    r1 = w1.rank
    w0.close()
    dead = w1.links.pop(r0, None)
    if dead is not None:
        dead.close()
    w0b = worker_cls("127.0.0.1", tracker.port, jobid="0")
    got = {}
    t_rec = threading.Thread(target=lambda: got.setdefault("w1", w1.start(recover_rank=r1)),
                             daemon=True)
    t_rec.start()
    got["w0"] = w0b.start(recover_rank=r0)
    t_rec.join(JOIN_S)
    assert not t_rec.is_alive()
    assert got == {"w0": r0, "w1": r1}
    assert r0 in w1.links and r1 in w0b.links
    w0b.shutdown()
    w1.shutdown()


@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("tracker_pkg,worker_pkg", [("jax", "port"), ("port", "jax"),
                                                    ("port", "port")])
def test_rendezvous_across_packages(tracker_pkg, worker_pkg, n):
    tracker = TRACKERS[tracker_pkg]("127.0.0.1", n)
    tracker.start(n)
    try:
        check_wiring(run_workers(tracker, n, [worker_pkg] * n), n)
        if tracker_pkg == "port":
            assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


@pytest.mark.parametrize("tracker_pkg,worker_pkg", [("jax", "port"), ("port", "jax"),
                                                    ("port", "port")])
def test_recover_reclaims_the_rank_across_packages(tracker_pkg, worker_pkg):
    tracker = TRACKERS[tracker_pkg]("127.0.0.1", 2)
    tracker.start(2)
    try:
        recover_pair(tracker, WORKERS[worker_pkg])
        deadline = time.monotonic() + 5
        while not any("hello from worker" in m for m in tracker.messages):
            assert time.monotonic() < deadline, "the print relay never arrived"
            time.sleep(0.05)
        if tracker_pkg == "port":
            assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


@pytest.mark.parametrize("tracker_pkg", ["port", "jax"])
def test_mixed_world_rendezvous(tracker_pkg):
    n = 6
    tracker = TRACKERS[tracker_pkg]("127.0.0.1", n)
    tracker.start(n)
    try:
        check_wiring(run_workers(tracker, n, ["port", "jax"] * 3), n)
        if tracker_pkg == "port":
            assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


def test_heartbeat_payload_is_kept_per_rank():
    tracker = RabitTracker("127.0.0.1", 1)
    tracker.start(1)
    try:
        w = RabitWorker("127.0.0.1", tracker.port, jobid="0")
        with pytest.raises(RuntimeError, match="before start"):
            w.heartbeat({"x": 1})
        w.start(world_size=1)
        w.heartbeat({"counters": {"steps": 3}})
        jw = jax_client.RabitWorker("127.0.0.1", tracker.port, jobid="0")
        jw.rank = 0
        jw.heartbeat({"counters": {"steps": 4}})  # a JAX worker reads the reply
        deadline = time.monotonic() + 5
        while tracker.metrics.per_rank().get(0, {}).get("counters", {}).get("steps") != 4:
            assert time.monotonic() < deadline
            time.sleep(0.05)
        assert tracker.metrics.updates == 2
        w.shutdown()
        assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


def test_join_returns_false_when_the_timeout_passes():
    tracker = RabitTracker("127.0.0.1", 2)
    tracker.start(2)
    try:
        t0 = time.monotonic()
        assert tracker.join(timeout=0.3) is False
        assert 0.3 <= time.monotonic() - t0 < 2
        assert tracker.alive()
    finally:
        tracker.close()
    deadline = time.monotonic() + 5
    while tracker.alive():
        assert time.monotonic() < deadline, "close() left the state thread running"
        time.sleep(0.05)
    assert tracker.join(timeout=0) is True


def test_tracker_worker_envs():
    tracker = RabitTracker("127.0.0.1", 1)
    try:
        envs = tracker.worker_envs()
        assert envs["DMLC_TRACKER_URI"] == "127.0.0.1"
        assert isinstance(envs["DMLC_TRACKER_PORT"], int)
    finally:
        tracker.close()


def test_worker_shutdown_and_close_are_idempotent():
    tracker = RabitTracker("127.0.0.1", 1)
    tracker.start(1)
    try:
        w = RabitWorker("127.0.0.1", tracker.port, jobid="0")
        assert w.start(world_size=1) == 0
        w.shutdown()
        w.shutdown()
        w.close()
        w.close()
        assert w.links == {} and w._listener is None
        assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


def test_await_peer_links_times_out_on_half_dead_peer(monkeypatch):
    monkeypatch.setenv("DMLC_LINK_WAIT_TIMEOUT", "0.5")
    w = RabitWorker("127.0.0.1", 1, jobid="x")
    w.rank = 0
    w._listener = protocol.make_listener("127.0.0.1", 0)
    port = w._listener.getsockname()[1]
    mute = socket.create_connection(("127.0.0.1", port), timeout=5)
    try:
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="timed out .* incoming peer"):
            w._await_peer_links(2)
        assert time.monotonic() - t0 < 5
        assert w.links == {} and w._listener.fileno() < 0
    finally:
        mute.close()
        w.close()


def test_peer_connect_timeout_is_explicit(monkeypatch):
    monkeypatch.setenv("DMLC_PEER_CONNECT_TIMEOUT", "2.5")
    assert RabitWorker("127.0.0.1", 1, jobid="x").connect_timeout == 2.5
    lst = protocol.make_listener("127.0.0.1", 0, backlog=1)
    try:
        sock = protocol.connect_peer("127.0.0.1", lst.getsockname()[1], 3, timeout=2.5)
        assert sock.gettimeout() is None
        peer, _ = lst.accept()
        assert FramedSocket(peer).recv_int() == 3
        sock.close()
        peer.close()
    finally:
        lst.close()


def test_connect_worker_retry_rides_out_a_late_tracker(monkeypatch):
    """A worker dialing before the tracker listens redials with backoff
    until it is there; with a budget of 0 it fails at once."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    with pytest.raises(ConnectionRefusedError):
        protocol.connect_worker_retry("127.0.0.1", port, -1, 1, "0", "start", retry_secs=0)
    late = {}

    def serve_later():
        time.sleep(0.5)
        late["tracker"] = RabitTracker("127.0.0.1", 1, port=port, port_end=port + 1)
        late["tracker"].start(1)

    t = threading.Thread(target=serve_later, daemon=True)
    t.start()
    try:
        w = RabitWorker("127.0.0.1", port, jobid="0")
        assert w.start(world_size=1) == 0
        w.shutdown()
        t.join(JOIN_S)
        assert late["tracker"].join(timeout=JOIN_S)
    finally:
        t.join(JOIN_S)
        if "tracker" in late:
            late["tracker"].close()


# -- hostile clients -------------------------------------------------------------


def _raw_conn(port):
    return socket.create_connection(("127.0.0.1", port), timeout=10)


def _handshake(port, rank=-1, world=-1, jobid="NULL", cmd="start"):
    fs = FramedSocket(_raw_conn(port))
    fs.send_int(MAGIC)
    assert fs.recv_int() == MAGIC
    fs.send_int(rank)
    fs.send_int(world)
    fs.send_str(jobid)
    fs.send_str(cmd)
    return fs


def _closed_on_us(fs):
    fs.sock.settimeout(10)
    try:
        data = fs.sock.recv(4)
    except (ConnectionResetError, OSError):
        data = b""
    return data == b""


def test_tracker_survives_garbage_and_truncated_clients():
    tracker = RabitTracker("127.0.0.1", 2)
    tracker.start(2)
    try:
        c = _raw_conn(tracker.port)
        c.sendall(b"\xde\xad\xbe\xef" * 4)
        c.close()
        c = _raw_conn(tracker.port)
        c.sendall(MAGIC.to_bytes(4, "little"))
        c.close()
        _handshake(tracker.port, cmd="frobnicate").close()
        _handshake(tracker.port, rank=99, cmd="shutdown").close()
        _handshake(tracker.port, rank=99, cmd="watch").close()
        c = _raw_conn(tracker.port)
        c.sendall(MAGIC.to_bytes(4, "little"))
        c.recv(4)
        c.sendall((0).to_bytes(4, "little") * 2)
        c.sendall((-5).to_bytes(4, "little", signed=True))
        c.close()
        results = run_workers(tracker, 2, ["port", "port"])
        assert sorted(r[0] for r in results) == [0, 1]
        assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


def test_tracker_rejects_goodset_outside_neighbors():
    tracker = RabitTracker("127.0.0.1", 1)
    tracker.start(1)
    try:
        fs = _handshake(tracker.port, world=1)
        assert fs.recv_int() == 0
        fs.recv_int()
        fs.recv_int()
        for _ in range(fs.recv_int()):
            fs.recv_int()
        fs.recv_int()
        fs.recv_int()
        fs.send_int(1)
        fs.send_int(77)  # a wired link to a rank outside the neighbor set
        assert _closed_on_us(fs)
        fs.close()
        w = RabitWorker("127.0.0.1", tracker.port, jobid="fresh")
        assert w.start(world_size=-1) == 0  # the leaked rank is reusable
        w.shutdown()
        assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


def test_tracker_batch_survives_death_mid_brokering():
    tracker = RabitTracker("127.0.0.1", 2)
    tracker.start(2)
    try:
        survivor = RabitWorker("127.0.0.1", tracker.port, jobid="good")
        state = {}
        t = threading.Thread(target=lambda: state.setdefault("rank", survivor.start(world_size=2)),
                             daemon=True)
        t.start()
        time.sleep(0.2)
        fs = _handshake(tracker.port, jobid="bad")
        fs.recv_int()
        fs.close()
        replacement = RabitWorker("127.0.0.1", tracker.port, jobid="bad2")
        r2 = replacement.start(world_size=-1)
        t.join(timeout=20)
        assert not t.is_alive(), "survivor never finished wiring"
        assert {state["rank"], r2} == {0, 1}
        assert r2 in survivor.links and state["rank"] in replacement.links
        survivor.shutdown()
        replacement.shutdown()
        assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


def test_pending_worker_unblocked_by_recover():
    tracker = RabitTracker("127.0.0.1", 2)
    tracker.start(2)
    try:
        f1 = _handshake(tracker.port, world=2, jobid="h1")
        f2 = _handshake(tracker.port, jobid="h2")

        def leak(fs):
            fs.recv_int()
            fs.close()

        leakers = [threading.Thread(target=leak, args=(f,), daemon=True) for f in (f1, f2)]
        for t in leakers:
            t.start()
        for t in leakers:
            t.join(timeout=15)
        assert not any(t.is_alive() for t in leakers)
        time.sleep(0.3)
        fresh = RabitWorker("127.0.0.1", tracker.port, jobid="fresh")
        state = {}
        t = threading.Thread(target=lambda: state.setdefault("rank", fresh.start(world_size=-1)),
                             daemon=True)
        t.start()
        time.sleep(0.3)
        recoverer = RabitWorker("127.0.0.1", tracker.port, jobid="rec")
        r_rec = recoverer.start(recover_rank=1)
        t.join(timeout=20)
        assert not t.is_alive(), "pending worker was never assigned"
        assert {state["rank"], r_rec} == {0, 1}
        fresh.shutdown()
        recoverer.shutdown()
        assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


def test_tracker_drops_slow_loris_client():
    tracker = RabitTracker("127.0.0.1", 2, client_timeout=1.0)
    tracker.start(2)
    stall = _raw_conn(tracker.port)  # connects, never sends a byte
    try:
        assert sorted(r[0] for r in run_workers(tracker, 2, ["port", "port"])) == [0, 1]
        assert tracker.join(timeout=JOIN_S)
    finally:
        stall.close()
        tracker.close()


def test_inflight_rank_cannot_be_claimed():
    tracker = RabitTracker("127.0.0.1", 2, client_timeout=5.0)
    tracker.start(2)
    try:
        honest = _handshake(tracker.port, rank=0, world=2, jobid="jA")
        assert honest.recv_int() == 0
        time.sleep(0.3)
        hijack = _handshake(tracker.port, rank=0, jobid="jB")
        with pytest.raises((ConnectionError, OSError)):
            hijack.recv_int()
        hijack.close()
        honest.close()
    finally:
        tracker.close()


def test_inflight_jobid_cannot_claim_second_rank():
    tracker = RabitTracker("127.0.0.1", 4, client_timeout=5.0)
    tracker.start(4)
    try:
        honest = _handshake(tracker.port, rank=0, world=4, jobid="jA")
        assert honest.recv_int() == 0
        time.sleep(0.3)
        dup = _handshake(tracker.port, rank=3, jobid="jA")
        with pytest.raises((ConnectionError, OSError)):
            dup.recv_int()
        dup.close()
        honest.close()
    finally:
        tracker.close()


def test_tracker_rejects_rank_hijack():
    tracker = RabitTracker("127.0.0.1", 2)
    tracker.start(2)
    try:
        w0 = RabitWorker("127.0.0.1", tracker.port, jobid="0")
        w1 = RabitWorker("127.0.0.1", tracker.port, jobid="1")
        t1 = threading.Thread(target=lambda: w1.start(world_size=-1), daemon=True)
        t1.start()
        r0 = w0.start(world_size=2)
        t1.join(timeout=15)
        assert not t1.is_alive()
        fs = _handshake(tracker.port, rank=r0, jobid="evil", cmd="start")
        assert _closed_on_us(fs)
        fs.close()
        w0.shutdown()
        w1.shutdown()
        assert tracker.join(timeout=JOIN_S)
    finally:
        tracker.close()


def _fake_tracker(srv, n_wait, dial_mute=False):
    """A tracker that hands one worker rank 0 of 2 with ``n_wait``
    incoming links, none of which ever identifies."""
    conn, _ = srv.accept()
    fs = FramedSocket(conn)
    assert fs.recv_int() == MAGIC
    fs.send_int(MAGIC)
    fs.recv_int()
    fs.recv_int()
    fs.recv_str()
    assert protocol.unpack_cmd(fs.recv_str())[0] == "start"
    for v in (0, -1, 2, 0, -1, -1):  # rank, parent, world, n_tree, prev, next
        fs.send_int(v)
    fs.recv_int()
    fs.send_int(0)
    fs.send_int(n_wait)
    fs.recv_int()
    port = fs.recv_int()
    if dial_mute:
        mute = socket.create_connection(("127.0.0.1", port))
        mute.settimeout(10)
        try:
            mute.recv(1)  # hold open until the worker gives up
        except OSError:
            pass
        mute.close()
    conn.close()


@pytest.mark.parametrize("dial_mute", [False, True], ids=["never_dials", "never_identifies"])
def test_worker_link_wait_times_out_not_wedges(monkeypatch, dial_mute):
    srv = protocol.make_listener("127.0.0.1", 0, backlog=1)
    t = threading.Thread(target=_fake_tracker, args=(srv, 1, dial_mute), daemon=True)
    t.start()
    monkeypatch.setenv("DMLC_LINK_WAIT_TIMEOUT", "0.4")
    try:
        w = RabitWorker(tracker_uri="127.0.0.1", tracker_port=srv.getsockname()[1])
        with pytest.raises(RuntimeError, match="timed out after .* incoming"):
            w.start()
        t.join(JOIN_S)
        assert not t.is_alive()
    finally:
        srv.close()


def test_close_terminates_state_thread():
    tracker = RabitTracker("127.0.0.1", 2)
    tracker.start(2)
    assert tracker.alive()
    tracker.close()
    assert tracker.join(timeout=5), "close() left the state thread running"


def test_jobs_over_random_world_sizes_complete():
    """A seeded handful of world sizes, each rendezvoused by port workers
    with random job ids: ranks unique, links as the topology says."""
    rng = random.Random(7)
    for n in rng.sample(range(2, 12), 3):
        tracker = RabitTracker("127.0.0.1", n)
        tracker.start(n)
        try:
            ids = [f"job{rng.randrange(10**6)}-{i}" for i in range(n)]
            check_wiring(run_workers(tracker, n, ["port"] * n, ids.__getitem__), n)
            assert tracker.join(timeout=JOIN_S)
        finally:
            tracker.close()


def _wired_trio(tracker):
    """Three port workers rendezvoused under ``tracker``, by rank (n = 3:
    every pair is linked, by the tree or the ring)."""
    ws = [RabitWorker("127.0.0.1", tracker.port, jobid=str(i)) for i in range(3)]
    threads = [threading.Thread(target=w.start, kwargs={"world_size": 3 if i == 0 else -1},
                                daemon=True) for i, w in enumerate(ws)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)
    return sorted(ws, key=lambda w: w.rank)


def _restart(w, out, key):
    def run():
        try:
            out[key] = w.start(recover_rank=w.rank)
        except RuntimeError as e:
            out[key] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _drop(w, peer):
    w.links.pop(peer).close()


def _linked(a, b):
    """a's and b's links to each other are the two ends of one socket."""
    a.links[b.rank].sendall((a.rank * 10 + b.rank).to_bytes(4, "little"))
    b.links[a.rank].settimeout(5)
    return int.from_bytes(b.links[a.rank].recv(4), "little") == a.rank * 10 + b.rank


@pytest.mark.parametrize("tracker_pkg", ["port", "jax"])
def test_a_stale_good_link_does_not_steal_an_accept(monkeypatch, tracker_pkg):
    """The wedge of the JAX package's faulted-ring test, made
    deterministic. Rank 0 dropped its link to 1 but still counts its link
    to 2 as good, though 2 has dropped it (2 reports 0 bad, 1 reports 0
    bad). Sessions in the order 0, 2, 1: rank 0 waits for 1 alone. The
    JAX tracker tells 2 to dial 0 too; 2's dial takes 0's one accept, and
    rank 1 then waits for a dial that never comes. The port's tracker
    has 2 wait for 0 instead (0 is not waiting for 2), lets 1 dial 0, and
    0 wires 2 when it finds its stale link dead and re-enters."""
    monkeypatch.setenv("DMLC_LINK_WAIT_TIMEOUT", "3")
    tracker = TRACKERS[tracker_pkg]("127.0.0.1", 3)
    tracker.start(3)
    w0, w1, w2 = _wired_trio(tracker)
    out = {}
    try:
        _drop(w0, 1)
        _drop(w2, 0)
        _drop(w1, 0)
        threads = [_restart(w0, out, 0)]
        time.sleep(0.3)
        threads.append(_restart(w2, out, 2))
        time.sleep(0.3)
        threads.append(_restart(w1, out, 1))
        if tracker_pkg == "jax":
            for t in threads:
                t.join(JOIN_S)
            assert isinstance(out[1], RuntimeError) and "timed out" in str(out[1])
            return
        threads[0].join(JOIN_S)
        threads[2].join(JOIN_S)
        assert (out[0], out[1]) == (0, 1) and _linked(w0, w1)
        assert threads[1].is_alive(), "rank 2 should wait for rank 0 to dial"
        _drop(w0, 2)  # rank 0 reads the EOF of its stale link and re-enters
        threads.append(_restart(w0, out, 0))
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads)
        assert (out[0], out[1], out[2]) == (0, 1, 2)
        assert _linked(w0, w1) and _linked(w0, w2) and _linked(w1, w2)
    finally:
        for w in (w0, w1, w2):
            w.close()
        tracker.close()
