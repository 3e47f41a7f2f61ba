"""Rank rendezvous tracker (rabit protocol) + parameter-server bootstrap
(the port of ``dmlc_core_tpu/tracker/tracker.py``).

Reference: tracker/dmlc_tracker/tracker.py (SURVEY §2.6): TCP server on
ports 9091-9999; workers connect with cmd ∈ {start, recover, shutdown,
print}; the tracker assigns ranks (batch, sorted by host), sends each
worker its tree/ring neighbors, and brokers peer connections until the
graph is wired. ``recover`` re-issues a restarted worker's previous rank
(job-id memo) with the current neighbor endpoints — the failure-recovery
contract rabit builds on.

Telemetry: ``cmd=metrics`` heartbeats feed a ``ClusterAggregator``
(``RabitTracker.metrics``) that merges the ranks' registry snapshots and
time-series samples; a loopback HTTP endpoint serves it (``/metrics``,
``/metrics.json?window=N``; ``DMLC_METRICS_PORT`` pins the port,
``DMLC_METRICS_HTTP=0`` turns it off), ``DMLC_METRICS_REPORT`` names a
file for the end-of-job report, the tracker samples its own registry
under the ``tracker`` pseudo-rank, and its handshakes, heartbeat merges
and rank assignments are spans and instants on the flight recorder.

The dynamic shard service (``shardsvc.py``) rides the same socket: its
four commands are answered off the state thread, a heartbeat renews the
rank's leases, and a job that only leased shards ends cleanly without a
rendezvous. With a journal directory (``--journal`` /
``DMLC_TRACKER_JOURNAL``, ``journal.py``) the ledger's transitions and
the rank assignments are written ahead of each answer, and a tracker
started on the same directory replays them: leases expire
conservatively, completions and ranks survive. With ``DMLC_AUTOSCALE=
min:max`` (``submit --autoscale``) the tracker runs the autoscale
controller (``autoscale.py``) over its windowed cluster view, publishes
its status as the report's ``autoscale`` section and journals its
budget, which a relaunched tracker hands back to its controller.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import socket
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..telemetry import ClusterAggregator, serve_metrics
from ..telemetry import timeseries as _timeseries
from ..telemetry import tracing as _tracing
from ..utils.logging import Error
from . import autoscale as _autoscale
from . import collective as _collective
from . import journal as _journal
from . import shardsvc as _shardsvc
from .protocol import (
    CMD_METRICS,
    CMD_PRINT,
    CMD_RECOVER,
    CMD_SHUTDOWN,
    CMD_START,
    CMD_WATCH,
    MAGIC,
    RENDEZVOUS_CMDS,
    SHARD_CMDS,
    FramedSocket,
    bind_first_free,
    find_free_port,
    unpack_cmd,
)
from .supervisor import RendezvousNeverCompleted
from .topology import get_link_map

__all__ = [
    "RabitTracker",
    "PSTracker",
    "submit",
    "worker_env",
    "get_host_ip",
]

logger = logging.getLogger("dmlc_core_tpu_torch.tracker")


def get_host_ip(host_ip: Optional[str] = None) -> str:
    """Best-effort externally-visible IP (reference get_host_ip,
    tracker.py:389-407)."""
    if host_ip is None or host_ip == "auto":
        host_ip = "ip"
    if host_ip == "dns":
        return socket.getfqdn()
    if host_ip == "ip":
        try:
            ip = socket.gethostbyname(socket.getfqdn())
        except socket.gaierror:
            ip = socket.gethostbyname(socket.gethostname())
        if ip.startswith("127."):
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:  # noqa: L014 (UDP route probe, not a rendezvous/data socket)
                probe.connect(("10.255.255.255", 1))
                ip = probe.getsockname()[0]
        return ip
    return host_ip


class ProtocolError(Exception):
    """A client sent fields that violate the rendezvous protocol.

    Raised instead of assert (the reference tracker asserts on
    client-controlled fields and dies, tracker.py:293-311; this rebuild
    drops the offending connection and keeps serving)."""


class WorkerEntry:
    """One accepted worker connection through rank assignment
    (reference SlaveEntry, tracker.py:58-135)."""

    def __init__(self, conn: socket.socket, addr: Tuple) -> None:
        self.sock = FramedSocket(conn)
        self.host = socket.getaddrinfo(addr[0], None)[0][4][0]
        magic = self.sock.recv_int()
        if magic != MAGIC:
            raise ConnectionError(
                f"invalid magic {magic:#x} from {self.host}"
            )
        self.sock.send_int(MAGIC)
        self.rank = self.sock.recv_int()
        self.world_size = self.sock.recv_int()
        self.jobid = self.sock.recv_str()
        # the cmd string may carry a piggybacked trace context
        # (protocol.pack_cmd), kept opaque and unread
        self.cmd, self.trace_ctx = unpack_cmd(self.sock.recv_str())
        self.wait_accept = 0
        #: the ranks this worker waits to dial in (``wait_accept`` of them)
        self.waiting_for: Set[int] = set()
        self.port: Optional[int] = None
        #: filled for cmd == 'print' (log line) / cmd == 'metrics'
        #: (JSON telemetry snapshot) — the two one-payload commands
        self.print_msg: Optional[str] = None

    def decide_rank(self, job_map: Dict[str, int]) -> int:
        if self.rank >= 0:
            return self.rank
        if self.jobid != "NULL" and self.jobid in job_map:
            return job_map[self.jobid]
        return -1

    def assign_rank(
        self,
        rank: int,
        wait_conn: Dict[int, "WorkerEntry"],
        tree_map: Dict[int, List[int]],
        parent_map: Dict[int, int],
        ring_map: Dict[int, Tuple[int, int]],
        lock: Optional[threading.Lock] = None,
    ) -> List[int]:
        """Send rank/topology, then broker peer connections until this
        worker has wired every missing link (reference assign_rank,
        tracker.py:80-135).

        ``lock`` guards wait_conn when sessions run concurrently
        (_BrokerPool): two non-adjacent sessions sharing a neighbor both
        read its endpoint and decrement its wait_accept. Snapshots are
        taken under the lock; client I/O happens outside it."""
        guard = lock if lock is not None else threading.Lock()
        self.rank = rank
        nnset: Set[int] = set(tree_map[rank])
        rprev, rnext = ring_map[rank]
        self.sock.send_int(rank)
        self.sock.send_int(parent_map[rank])
        self.sock.send_int(len(tree_map))
        self.sock.send_int(len(nnset))
        for r in nnset:
            self.sock.send_int(r)
        if rprev != -1 and rprev != rank:
            nnset.add(rprev)
            self.sock.send_int(rprev)
        else:
            self.sock.send_int(-1)
        if rnext != -1 and rnext != rank:
            nnset.add(rnext)
            self.sock.send_int(rnext)
        else:
            self.sock.send_int(-1)
        while True:
            ngood = self.sock.recv_int()
            # client-controlled count: bound BEFORE reading, or a hostile
            # client feeds an unbounded int stream into the brokering
            # session
            if not 0 <= ngood <= len(nnset):
                raise ProtocolError(
                    f"rank {rank} reported {ngood} good links; neighbor "
                    f"set has only {len(nnset)}"
                )
            goodset = {self.sock.recv_int() for _ in range(ngood)}
            if not goodset.issubset(nnset):
                # client-controlled field: never assert (the reference
                # asserts and kills its accept thread here)
                raise ProtocolError(
                    f"rank {rank} reported links {sorted(goodset - nnset)} "
                    f"outside its neighbor set {sorted(nnset)}"
                )
            badset = nnset - goodset
            with guard:
                # dial only a peer that waits for THIS rank. A peer that
                # still counts its link to us as good (it has not yet read
                # the EOF of the link we dropped) is not waiting for us:
                # our dial would take one of its accepts meant for another
                # rank, which then waits forever (the JAX tracker's wedge).
                # We wait for it instead; it re-enters the rendezvous once
                # it reads that EOF.
                conset = [
                    (r, wait_conn[r].host, wait_conn[r].port)
                    for r in badset
                    if r in wait_conn and rank in wait_conn[r].waiting_for
                ]
            self.sock.send_int(len(conset))
            self.sock.send_int(len(badset) - len(conset))
            for r, host, port in conset:
                self.sock.send_str(host)
                self.sock.send_int(port)  # type: ignore[arg-type]
                self.sock.send_int(r)
            nerr = self.sock.recv_int()
            if nerr != 0:
                continue
            self.port = self.sock.recv_int()
            done: List[int] = []
            with guard:
                for r, _host, _port in conset:
                    peer = wait_conn.get(r)
                    if peer is None:
                        continue
                    peer.waiting_for.discard(rank)
                    peer.wait_accept -= 1
                    if peer.wait_accept == 0:
                        done.append(r)
                for r in done:
                    wait_conn.pop(r, None)
            self.waiting_for = badset - {r for r, _h, _p in conset}
            self.wait_accept = len(self.waiting_for)
            return done


class _BrokerPool:
    """Concurrent assign_rank sessions, serialized per neighborhood.

    The r3 tracker brokered one ``assign_rank`` exchange at a time on the
    accept thread, so one slow-but-alive client stalled every other
    worker for up to client_timeout per recv. Sessions are multi-round
    client exchanges, so full parallelism is tempting — but unsafe: for
    neighbors A and B, exactly one of (A connects to B) / (B connects to
    A) must happen, which the protocol decides by "was the peer already
    registered in wait_conn when I queried?". Two neighbors brokering
    concurrently can BOTH miss each other and deadlock waiting for the
    other to dial in.

    So: a session for rank r waits while any ACTIVE session belongs to a
    rank adjacent to r (tree link or ring prev/next) — the miss-each-
    other race exists only between direct neighbors. Everyone else
    brokers fully in parallel (shared-peer wait_conn mutations are
    guarded by ``lock``): a stalling client delays only its 3-4 topology
    neighbors, not the pod. Registration into wait_conn happens INSIDE
    the session thread before the reservation is released, preserving
    the serial tracker's happens-before for neighbor pairs.
    """

    def __init__(self, events: "queue.Queue", wait_conn, tree_map,
                 parent_map, ring_map) -> None:
        self._events = events
        self._wait_conn = wait_conn
        self._maps = (tree_map, parent_map, ring_map)
        self._lock = threading.Lock()
        self._active: Dict[int, Set[int]] = {}  # rank -> closed nbr set
        self._queued: List[Tuple["WorkerEntry", int]] = []

    def _closed_set(self, rank: int) -> Set[int]:
        tree_map, _, ring_map = self._maps
        nbrs = set(tree_map[rank]) | {rank}
        rprev, rnext = ring_map[rank]
        if rprev != -1:
            nbrs.add(rprev)
        if rnext != -1:
            nbrs.add(rnext)
        return nbrs

    def submit(self, entry: "WorkerEntry", rank: int) -> None:
        with self._lock:
            self._queued.append((entry, rank))
            self._pump()

    def idle(self) -> bool:
        with self._lock:
            return not self._active and not self._queued

    def _pump(self) -> None:
        """Start every queued session not adjacent to an active one.
        Caller holds the lock."""
        still: List[Tuple["WorkerEntry", int]] = []
        for entry, rank in self._queued:
            # conflict iff rank is in an active session's closed set
            # (adjacency is symmetric: rank ∈ closed(s) ⇔ s ∈ closed(rank))
            if any(rank in act for act in self._active.values()):
                still.append((entry, rank))
                continue
            self._active[rank] = self._closed_set(rank)
            threading.Thread(
                target=self._run, args=(entry, rank), daemon=True,
                name=f"rabit-broker-{rank}",
            ).start()
        self._queued = still

    def _run(self, entry: "WorkerEntry", rank: int) -> None:
        tree_map, parent_map, ring_map = self._maps
        try:
            entry.assign_rank(
                rank, self._wait_conn, tree_map, parent_map, ring_map,
                lock=self._lock,
            )
        except (ProtocolError, ConnectionError, OSError) as e:
            entry.sock.close()
            with self._lock:
                del self._active[rank]
                self._pump()
            self._events.put(("assign_failed", entry, rank, e))
            return
        with self._lock:
            # register BEFORE releasing the neighborhood: a neighbor's
            # session must observe this worker in wait_conn
            if entry.wait_accept > 0:
                self._wait_conn[rank] = entry
            del self._active[rank]
            self._pump()
        self._events.put(("assigned", entry, rank, None))


class RabitTracker:
    """Rendezvous server (reference RabitTracker, tracker.py:137-334).

    Three thread roles (the reference runs everything on one thread and
    stalls the job on one slow client):
    - accept thread: ``accept()`` + one short-lived handshake thread per
      connection (a slow-loris handshake occupies only its own thread);
    - state thread: the rendezvous state machine, fed by a queue of
      handshake-complete and session-complete events — sole owner of
      job_map/todo_nodes/pending/shutdown;
    - broker sessions: _BrokerPool above.
    """

    def __init__(
        self,
        host_ip: str,
        n_workers: int,
        port: int = 9091,
        port_end: int = 9999,
        client_timeout: float = 60.0,
        journal_dir: Optional[str] = None,
    ) -> None:
        #: per-socket recv/send deadline: a stalling (slow-loris) client
        #: must not wedge the accept loop. Timeouts raise socket.timeout
        #: (an OSError), which the handshake treats like any dead
        #: connection. The protocol has no auth (as upstream rabit): the
        #: tracker only defends liveness + state consistency.
        self.client_timeout = client_timeout
        sock, bound = bind_first_free(host_ip, port, port_end)
        self.sock = sock
        self.host_ip = host_ip
        self.port = bound
        self.n_workers = n_workers
        self.thread: Optional[threading.Thread] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._events: "queue.Queue" = queue.Queue()
        self.start_time: Optional[float] = None
        self.end_time: Optional[float] = None
        self.messages: List[str] = []  # relayed worker 'print' logs
        # per-rank heartbeat snapshots aggregated cluster-wide, served
        # over a loopback HTTP endpoint while the job runs and dumped as
        # a JSON report at its end (DMLC_METRICS_REPORT=<path>)
        self.metrics = ClusterAggregator()
        self.metrics_report: Optional[Dict[str, object]] = None
        self.metrics_port: Optional[int] = None
        self._metrics_server = None
        # the tracker samples its OWN registry into the cluster store
        # under the "tracker" pseudo-rank: that is how the shard
        # queue-depth gauge (tracker.shards.queue_depth) gets a history
        self._ts_ring = _timeseries.TimeSeriesRing(
            on_sample=lambda s: self.metrics.timeseries.add(
                _timeseries.TRACKER_RANK, [s]
            )
        )
        # the control-plane journal (journal.py): with a journal
        # directory the ledger transitions and rank assignments are
        # written ahead of each answer, and a tracker started on the same
        # directory replays them: leases expire conservatively,
        # completions and ranks survive, exactly-once holds across a crash
        if journal_dir is None:
            journal_dir = os.environ.get("DMLC_TRACKER_JOURNAL") or None
        self._journal: Optional[_journal.Journal] = None
        self._recovered_ranks: Dict[str, int] = {}
        self._recovered_autoscale: Optional[Dict[str, object]] = None
        self.recovery_summary: Optional[Dict[str, object]] = None
        #: bumped per tracker generation: journal records tell pre-crash
        #: from post-relaunch assignments by this number
        self._topo_epoch = 1
        if journal_dir:
            self._journal = _journal.Journal(journal_dir)
        # the dynamic shard service (shardsvc.py): a leased micro-shard
        # work queue on this tracker's socket, idle until the first
        # cmd=shard_lease, so static jobs pay nothing. Registered
        # process-globally so the supervisor's failure hook can reclaim
        # a dead task's leases at once.
        self.shards = _shardsvc.ShardService(n_workers, journal=self._journal)
        _shardsvc.set_active(self.shards)
        if self._journal is not None and self._journal.recovered:
            state = self._journal.state
            shard_summary = self.shards.restore(state)
            self._recovered_ranks = {
                j: int(r["rank"]) for j, r in (state.get("ranks") or {}).items()
            }
            for jobid, rank in self._recovered_ranks.items():
                self.shards.note_task_rank(jobid, rank)
            self._recovered_autoscale = state.get("autoscale")
            self._topo_epoch = 1 + max(
                (int(r.get("topo_epoch", 0))
                 for r in (state.get("ranks") or {}).values()),
                default=0,
            )
            self.recovery_summary = {
                "journal_dir": journal_dir,
                **self._journal.recovery_info,
                **shard_summary,
                "ranks_recovered": len(self._recovered_ranks),
            }
            logger.info(
                "@tracker recovered from journal %s: %s",
                journal_dir, self.recovery_summary,
            )
        # collective peer-death watch (collective.py): workers holding a
        # cmd=watch connection learn of a supervisor-reported task
        # failure the instant the supervisor does. Registered
        # process-globally, so the supervisor's on_task_failure observer
        # list can name collective.notify_task_failure without wiring.
        self.watch = _collective.DeathWatch()
        _collective.set_active_watch(self.watch)
        # the elastic autoscale controller (autoscale.py): built in
        # start() from DMLC_AUTOSCALE; None is a fixed fleet
        self.autoscaler: Optional[_autoscale.AutoscaleController] = None
        logger.info("start listen on %s:%d", host_ip, self.port)

    def worker_envs(self) -> Dict[str, object]:
        """Env contract for workers (reference slave_envs,
        tracker.py:177-183)."""
        return {
            "DMLC_TRACKER_URI": self.host_ip,
            "DMLC_TRACKER_PORT": self.port,
        }

    # -- accept + handshake threads ------------------------------------------
    def _accept_loop(self) -> None:
        """accept() and hand each connection to its own handshake thread.
        Exits when the listening socket is closed."""
        while True:
            try:
                conn, addr = self.sock.accept()
            except OSError:
                return  # socket closed (tracker.close())
            conn.settimeout(self.client_timeout)
            threading.Thread(
                target=self._handshake, args=(conn, addr), daemon=True,
                name="rabit-handshake",
            ).start()

    def _handshake_reply(self, entry: "WorkerEntry") -> bool:
        """Read a one-string payload and answer what is answered off the
        state thread; True when the connection is done with."""
        if entry.cmd in (CMD_PRINT, CMD_METRICS) or entry.cmd in SHARD_CMDS:
            # read the one-string payload here too: it is the other
            # blocking recv a hostile client could stall on
            entry.print_msg = entry.sock.recv_str()
        if entry.cmd == CMD_METRICS:
            # answer with the tracker's wall stamp: the worker brackets
            # the exchange and estimates its clock offset from the RTT
            # midpoint (client.py heartbeat → tracing.set_clock_offset)
            try:
                entry.sock.send_str(
                    json.dumps({"wall_ns": time.time_ns()})  # noqa: L008 (wall stamp for clock alignment, not a duration)
                )
            except OSError:
                pass
        if entry.cmd in SHARD_CMDS:
            # shard lease traffic is answered HERE, off the state
            # thread: the ledger has its own lock, and lease latency
            # does not ride the event queue. One request frame in, one
            # JSON response frame out, connection closed.
            entry.sock.send_str(
                self.shards.handle(entry.cmd, entry.rank, entry.print_msg or "")
            )
            entry.sock.close()
            return True
        if entry.cmd == CMD_WATCH:
            # collective death watch: the connection STAYS OPEN and
            # is push-only from here on, so it never touches the
            # state thread. A fabricated rank is dropped: it could
            # otherwise evict a live watcher.
            if not 0 <= entry.rank < self.n_workers:
                logger.warning(
                    "watch registration from invalid rank %d — "
                    "dropping connection", entry.rank,
                )
                entry.sock.close()
                return True
            self.watch.add(entry.rank, entry.sock)
            return True
        return False

    def _handshake(self, conn: socket.socket, addr: Tuple) -> None:
        """Blocking WorkerEntry construction off the state thread: a
        slow-loris client burns only this thread's timeout. The work done
        here (payload read, reply) runs under a handler span carrying the
        client's trace context, so a merged timeline draws the flow arrow
        from the worker's wait span (a ``shard_lease_wait`` among them) to
        this handling."""
        try:
            entry = WorkerEntry(conn, addr)
            # bounded span vocabulary: a hostile cmd string must not
            # mint unbounded span names on the ring
            kind = entry.cmd if entry.cmd in RENDEZVOUS_CMDS else "unknown"
            with _tracing.handler_span(
                f"dmlc:tracker_{kind}", entry.trace_ctx, rank=entry.rank
            ):
                if self._handshake_reply(entry):
                    return
        except (ConnectionError, OSError) as e:
            logger.warning("bad handshake: %s", e)
            conn.close()
            return
        self._events.put(("entry", entry, None, None))

    # -- state machine --------------------------------------------------------
    def _accept_workers(self, n_workers: int) -> None:
        shutdown: Dict[int, WorkerEntry] = {}
        wait_conn: Dict[int, WorkerEntry] = {}
        # a journal-recovered tracker re-seeds the jobid→rank memo, so a
        # surviving worker's cmd=recover (and a relaunched worker's
        # memo'd cmd=start) is answered with the rank it held before the
        # crash; peer links re-broker from scratch
        job_map: Dict[str, int] = dict(self._recovered_ranks)
        pending: List[WorkerEntry] = []
        todo_nodes: List[int] = []
        deferred_shutdown: List[WorkerEntry] = []
        inflight: Dict[int, str] = {}  # rank → jobid, session running
        started: Set[int] = set()      # ranks whose assignment COMPLETED
        tree_map = parent_map = ring_map = None
        broker: Optional[_BrokerPool] = None
        if job_map:
            # ranks existed before the crash, so the topology must too:
            # without it the first cmd=recover after a relaunch would be
            # refused as "recover before any worker started"
            tree_map, parent_map, ring_map = get_link_map(n_workers)
            todo_nodes = list(range(n_workers))
            broker = _BrokerPool(
                self._events, wait_conn, tree_map, parent_map, ring_map,
            )

        def check_proto(ok: bool, why: str) -> None:
            if not ok:
                raise ProtocolError(why)

        def flush_deferred() -> None:
            """Shutdowns that arrived while their wait_conn entry was
            still pending a concurrent session's decrement: accept once
            the entry clears; reject only when no in-flight session can
            ever clear it (a genuine protocol violation)."""
            still: List[WorkerEntry] = []
            for d in deferred_shutdown:
                if d.rank in shutdown:
                    logger.warning(
                        "protocol error from %s: duplicate shutdown from "
                        "rank %d — dropping connection", d.host, d.rank,
                    )
                    d.sock.close()
                    continue
                if d.rank in wait_conn:
                    if broker is not None and not broker.idle():
                        still.append(d)
                        continue
                    logger.warning(
                        "protocol error from %s: shutdown from rank %d "
                        "still wiring peers — dropping connection",
                        d.host, d.rank,
                    )
                    d.sock.close()
                    continue
                shutdown[d.rank] = d
                logger.debug("shutdown signal from %d (deferred)", d.rank)
            deferred_shutdown[:] = still

        def submit(entry: WorkerEntry, rank: int) -> None:
            # reserve the rank at submit time (failure returns it via the
            # assign_failed event); inflight carries the ownership the
            # serial tracker got for free from synchronous assignment
            if rank in todo_nodes:
                todo_nodes.remove(rank)
            inflight[rank] = entry.jobid
            broker.submit(entry, rank)

        while len(shutdown) != n_workers:
            try:
                kind, entry, rank_done, err = self._events.get(timeout=0.5)
            except queue.Empty:
                flush_deferred()  # broker may have drained meanwhile
                continue
            flush_deferred()
            if kind == "stop":
                logger.info("@tracker stopped before job completion")
                # a closed-early job still reports what aggregated
                self._finish_metrics_report()
                return
            if kind == "assign_failed":
                logger.warning(
                    "assigning rank %d to %s failed: %s — rank returned "
                    "to pool",
                    rank_done, entry.host, err,
                )
                inflight.pop(rank_done, None)
                todo_nodes.insert(0, rank_done)
                continue
            if kind == "assigned":
                inflight.pop(rank_done, None)
                started.add(rank_done)
                if entry.jobid != "NULL":
                    job_map[entry.jobid] = rank_done
                    # failure reports are task-keyed; leases are held and
                    # death-watch pushes sent by rendezvous rank: record
                    # the translation
                    self.shards.note_task_rank(entry.jobid, rank_done)
                    self.watch.note_task_rank(entry.jobid, rank_done)
                    if self._journal is not None:
                        self._journal.append(
                            _journal.K_RANK_ASSIGN, jobid=entry.jobid,
                            rank=rank_done, world=n_workers,
                            topo_epoch=self._topo_epoch,
                        )
                logger.debug(
                    "%s from %s; assigned rank %d",
                    entry.cmd, entry.host, rank_done,
                )
                # rendezvous milestones on the tracker's timeline row
                _tracing.instant(
                    "dmlc:tracker_rank_assigned",
                    rank=rank_done, cmd=entry.cmd,
                )
                if len(started) == n_workers and self.start_time is None:
                    logger.info(
                        "@tracker all of %d nodes are started", n_workers
                    )
                    self.start_time = time.time()
                continue
            # Any protocol violation (or a socket dying mid-exchange) drops
            # THIS connection; the state machine keeps serving the rest of
            # the job (the reference dies here).
            try:
                if entry.cmd == CMD_PRINT:
                    msg = entry.print_msg or ""
                    self.messages.append(msg.strip())
                    logger.info("%s", msg.strip())
                    continue
                if entry.cmd == CMD_METRICS:
                    # a fabricated out-of-range rank must not mint
                    # unbounded per-rank payloads
                    check_proto(
                        0 <= entry.rank < n_workers,
                        f"metrics heartbeat from invalid rank "
                        f"{entry.rank}",
                    )
                    # the aggregator validates and drops malformed payloads
                    with _tracing.span(
                        "dmlc:tracker_heartbeat", rank=entry.rank
                    ):
                        self.metrics.update(entry.rank, entry.print_msg or "")
                        # a heartbeat proves the worker alive: extend its
                        # shard leases, so the ledger only reclaims work
                        # from workers that went silent
                        self.shards.renew_all(entry.rank)
                    continue
                if entry.cmd == CMD_SHUTDOWN:
                    check_proto(
                        0 <= entry.rank < n_workers,
                        f"shutdown from invalid rank {entry.rank}",
                    )
                    check_proto(
                        entry.rank not in shutdown,
                        f"duplicate shutdown from rank {entry.rank}",
                    )
                    if entry.rank in wait_conn:
                        # a concurrent session may not have applied its
                        # wait_conn decrement yet — defer, don't reject
                        deferred_shutdown.append(entry)
                        continue
                    shutdown[entry.rank] = entry
                    logger.debug("shutdown signal from %d", entry.rank)
                    continue
                check_proto(
                    entry.cmd in (CMD_START, CMD_RECOVER),
                    f"unknown command {entry.cmd!r}",
                )
                if tree_map is None:
                    check_proto(
                        entry.cmd == CMD_START,
                        f"{entry.cmd!r} before any worker started",
                    )
                    if entry.world_size > 0:
                        n_workers = entry.world_size
                        self.n_workers = n_workers
                        # shard geometry follows (it is pinned at the
                        # first lease; a resize AFTER leases started
                        # would change micro-shard byte ranges under
                        # live holders, so only the count updates here)
                        self.shards.n_workers = n_workers
                    tree_map, parent_map, ring_map = get_link_map(n_workers)
                    todo_nodes = list(range(n_workers))
                    broker = _BrokerPool(
                        self._events, wait_conn, tree_map, parent_map,
                        ring_map,
                    )
                else:
                    check_proto(
                        entry.world_size in (-1, n_workers),
                        f"world_size {entry.world_size} != {n_workers}",
                    )
                if entry.cmd == CMD_RECOVER:
                    check_proto(
                        0 <= entry.rank < n_workers,
                        f"recover with invalid rank {entry.rank}",
                    )
                rank = entry.decide_rank(job_map)
                check_proto(
                    rank < n_workers, f"rank {rank} out of range"
                )
                # one assignment per jobid at a time: the memo is only
                # recorded on session completion, so without this a
                # jobid could broker two ranks concurrently
                check_proto(
                    entry.jobid == "NULL"
                    or entry.jobid not in inflight.values(),
                    f"jobid {entry.jobid!r} already has an assignment "
                    "in flight",
                )
                if rank != -1:
                    # consistency with the jobid→rank memo: a client naming
                    # an in-range rank must not contradict (or hijack) a
                    # rank the memo says belongs to another job id
                    check_proto(
                        job_map.get(entry.jobid, rank) == rank,
                        f"jobid {entry.jobid!r} previously held rank "
                        f"{job_map.get(entry.jobid)}, not {rank}",
                    )
                    owner = next(
                        (j for j, r in job_map.items() if r == rank), None
                    )
                    check_proto(
                        owner is None or owner == entry.jobid,
                        f"rank {rank} belongs to jobid {owner!r}, "
                        f"not {entry.jobid!r}",
                    )
                    # an IN-FLIGHT session owns its rank just as a
                    # completed one does
                    check_proto(
                        rank not in inflight,
                        f"rank {rank} assignment already in flight "
                        f"(jobid {inflight.get(rank)!r})",
                    )
                if rank == -1:
                    check_proto(bool(todo_nodes), "no free rank left")
                    pending.append(entry)
                else:
                    # direct assignment (recover / explicit rank / jobid
                    # memo): reserve the rank and broker asynchronously
                    logger.debug("%s signal from %d", entry.cmd, entry.rank)
                    submit(entry, rank)
                # batch assignment fires when every free rank has a waiting
                # worker — re-checked after BOTH branches because the else
                # branch can shrink todo_nodes (reference accept_slaves,
                # tracker.py:293-311). Sorted by host for locality.
                if pending and len(pending) == len(todo_nodes):
                    pending.sort(key=lambda e: e.host)
                    batch, pending = pending, []
                    for peer in batch:
                        submit(peer, todo_nodes[0])
            except ProtocolError as e:
                logger.warning(
                    "protocol error from %s: %s — dropping connection",
                    entry.host, e,
                )
                entry.sock.close()
            except (ConnectionError, OSError) as e:
                logger.warning(
                    "connection to %s died mid-exchange: %s", entry.host, e
                )
                entry.sock.close()
        logger.info("@tracker all nodes finished the job")
        self.end_time = time.time()
        if self.start_time is not None:
            logger.info(
                "@tracker %.3f secs between node start and job finish",
                self.end_time - self.start_time,
            )
        self._finish_metrics_report()

    def _finish_metrics_report(self) -> None:
        """End-of-job telemetry dump: the aggregated per-rank + cluster
        report is kept on ``self.metrics_report`` and, when
        ``DMLC_METRICS_REPORT`` names a path, written there as JSON. A
        job that used the shard service gets its lease shape under
        ``"shards"``, and a journaled tracker its replay under
        ``"recovery"``."""
        shard_summary = (
            self.shards.summary() if self.shards.n_shards is not None else None
        )
        if (self.metrics.updates == 0 and shard_summary is None
                and self._journal is None):
            return
        try:
            self.metrics_report = (
                self.metrics.report() if self.metrics.updates else {}
            )
            if shard_summary is not None:
                self.metrics_report["shards"] = shard_summary
            if self._journal is not None:
                # did this tracker generation replay a journal, and what
                # did the replay restore? (tools journal has the dump)
                self.metrics_report["recovery"] = (
                    dict(self.recovery_summary)
                    if self.recovery_summary is not None
                    else {"journal_dir": self._journal.dir, "recovered": False}
                )
                self.metrics_report["recovery"]["journal_seq"] = self._journal.seq
        except Exception:
            # the job's completion does not ride on its telemetry
            logger.exception("telemetry report aggregation failed")
            return
        path = os.environ.get("DMLC_METRICS_REPORT")
        if path:
            try:
                with open(path, "w") as f:
                    json.dump(self.metrics_report, f)
                logger.info("@tracker telemetry report written to %s", path)
            except OSError as e:
                logger.warning("telemetry report write failed: %s", e)

    def start(self, n_workers: Optional[int] = None) -> None:
        # the submit process IS the tracker: name it on the merged
        # timeline (workers carry worker<N> from DMLC_ROLE/DMLC_TASK_ID)
        _tracing.set_process_label("tracker")
        _tracing.instant("dmlc:tracker_start", n_workers=self.n_workers)
        # loopback telemetry endpoint (GET /metrics = Prometheus text,
        # /metrics.json = full report); DMLC_METRICS_HTTP=0 disables,
        # DMLC_METRICS_PORT pins the port (default: ephemeral)
        if os.environ.get("DMLC_METRICS_HTTP", "1") not in ("0", "false"):
            try:
                port = int(os.environ.get("DMLC_METRICS_PORT", "0"))
                self._metrics_server, self.metrics_port = serve_metrics(
                    self.metrics, port=port
                )
                logger.info(
                    "telemetry endpoint on 127.0.0.1:%d/metrics",
                    self.metrics_port,
                )
            except (OSError, ValueError) as e:
                logger.warning("telemetry endpoint disabled: %s", e)
        if _timeseries.sampling_enabled():
            self._ts_ring.start()
        # closed-loop autoscale (DMLC_AUTOSCALE=min:max, submit
        # --autoscale): the controller reads the windowed cluster view
        # this aggregator keeps and publishes its status as the report's
        # "autoscale" section. A malformed spec leaves a fixed fleet,
        # never a dead tracker.
        try:
            as_cfg = _autoscale.AutoscaleConfig.from_env()
        except ValueError as e:
            logger.warning("autoscale disabled: %s", e)
            as_cfg = None
        if as_cfg is not None:
            if not _timeseries.sampling_enabled():
                logger.warning(
                    "autoscale needs time-series sampling (DMLC_TS is "
                    "off): the controller will hold on no_signal")
            self.autoscaler = _autoscale.AutoscaleController(
                self.metrics, as_cfg, journal=self._journal,
                recovered=self._recovered_autoscale,
            ).start()
            self.metrics.extra_sections["autoscale"] = self.autoscaler.status
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="rabit-accept",
        )
        self._accept_thread.start()
        self.thread = threading.Thread(
            target=self._accept_workers,
            args=(n_workers or self.n_workers,),
            daemon=True,
            name="rabit-tracker",
        )
        self.thread.start()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the rendezvous state thread to finish the job: True
        once it has, False when ``timeout`` seconds pass first (None
        waits without limit, as the JAX tracker's ``join`` does)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.thread is not None and self.thread.is_alive():
            if deadline is not None and time.monotonic() >= deadline:
                return False
            self.thread.join(0.1)
        return True

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def close(self) -> None:
        # shutdown() first: on Linux, close() alone does not wake the
        # accept thread blocked on this socket, and it would outlive us
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(5)
        if self.autoscaler is not None:
            self.autoscaler.stop()
            self.autoscaler = None
        self._ts_ring.stop()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            # shutdown() only stops the serve loop: close the listening
            # socket too, or a relaunch on a pinned port hits EADDRINUSE
            self._metrics_server.server_close()
            self._metrics_server = None
        # the state thread blocks on its event queue, not on accept():
        # closing the socket alone does not terminate it
        self._events.put(("stop", None, None, None))
        # deregister the shard service and the death watch (supervisor
        # hook targets), unless a newer tracker replaced them
        if _shardsvc.active_service() is self.shards:
            _shardsvc.set_active(None)
        if _collective.active_watch() is self.watch:
            _collective.set_active_watch(None)
        self.watch.close()
        if self._journal is not None:
            self._journal.close()


class PSTracker:
    """Parameter-server bootstrap: launches the scheduler locally with
    DMLC_ROLE=scheduler + root URI/port; workers/servers connect to the
    root directly, no rendezvous (reference PSTracker,
    tracker.py:336-386)."""

    def __init__(
        self,
        host_ip: str,
        cmd: Optional[str],
        port: int = 9091,
        port_end: int = 9999,
        envs: Optional[Dict[str, object]] = None,
    ) -> None:
        self.cmd = cmd
        self.thread: Optional[threading.Thread] = None
        if cmd is None:
            return
        self.host_ip = host_ip
        self.port = find_free_port(host_ip, port, port_end)
        if self.port is None:
            raise Error(f"no free PS root port in [{port},{port_end})")
        env = os.environ.copy()
        env["DMLC_ROLE"] = "scheduler"
        env["DMLC_PS_ROOT_URI"] = str(host_ip)
        env["DMLC_PS_ROOT_PORT"] = str(self.port)
        for k, v in (envs or {}).items():
            env[k] = str(v)

        def run() -> None:
            subprocess.check_call(
                self.cmd, env=env, shell=True, executable="/bin/bash"
            )

        self.thread = threading.Thread(target=run, daemon=True, name="ps-sched")
        self.thread.start()

    def worker_envs(self) -> Dict[str, object]:
        if self.cmd is None:
            return {}
        return {
            "DMLC_PS_ROOT_URI": self.host_ip,
            "DMLC_PS_ROOT_PORT": self.port,
        }

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the scheduler process: False when ``timeout`` passes
        first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.thread is not None and self.thread.is_alive():
            if deadline is not None and time.monotonic() >= deadline:
                return False
            self.thread.join(0.1)
        return True

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()


def worker_env(n_workers: int, n_servers: int) -> Dict[str, object]:
    """Base env every launched process receives (reference submit,
    tracker.py:413-415)."""
    return {
        "DMLC_NUM_WORKER": n_workers,
        "DMLC_NUM_SERVER": n_servers,
    }


def submit(
    n_workers: int,
    n_servers: int,
    fun_submit: Callable[[int, int, Dict[str, object]], None],
    host_ip: str = "auto",
    pscmd: Optional[str] = None,
    dry_run: bool = False,
    abort_check: Optional[Callable[[], Optional[BaseException]]] = None,
) -> None:
    """Start the right tracker, hand worker envs to the cluster-specific
    launcher, wait for completion (reference tracker.submit,
    tracker.py:410-433).

    ``dry_run`` skips the tracker entirely (no rendezvous to wait on) and
    hands fun_submit placeholder tracker envs so backends can print their
    launch commands.

    ``abort_check`` (from backends running a Supervisor) is polled while
    waiting on the rendezvous; a non-None error aborts the wait and
    re-raises instead of hanging on workers that will never report
    shutdown (the reference job simply wedges here)."""
    if n_servers == 0:
        pscmd = None
    envs = worker_env(n_workers, n_servers)
    if dry_run:
        envs.update(
            {"DMLC_TRACKER_URI": get_host_ip(host_ip), "DMLC_TRACKER_PORT": 9091}
        )
        fun_submit(n_workers, n_servers, envs)
        return
    ip = get_host_ip(host_ip)
    if n_servers == 0:
        rabit = RabitTracker(host_ip=ip, n_workers=n_workers)
        try:
            envs.update(rabit.worker_envs())
            rabit.start(n_workers)
            if rabit.alive():
                fun_submit(n_workers, n_servers, envs)
            while rabit.alive():
                time.sleep(0.1)
                if abort_check is not None:
                    err = abort_check()
                    if err is not None:
                        if (isinstance(err, RendezvousNeverCompleted)
                                and rabit.shards.all_complete()):
                            # the payload spoke the shard-lease protocol
                            # AND every live ledger is fully accounted: a
                            # shard-only job has no rendezvous to
                            # complete, so this is the clean finish.
                            # Shard chatter alone is not enough: workers
                            # that exited 0 mid-epoch keep the verdict
                            logger.info(
                                "job finished via the shard service without "
                                "a rabit rendezvous: %s",
                                rabit.shards.summary(),
                            )
                            break
                        raise err
        finally:
            rabit.close()
            # the state thread writes the end-of-job report after close()
            rabit.join(timeout=10)
    else:
        ps = PSTracker(host_ip=ip, cmd=pscmd, envs=envs)
        envs.update(ps.worker_envs())
        # the tasks launch whether or not the scheduler is still running
        # (reference tracker.py:410-433): a scheduler that exits at once
        # must not race the job out of its workers
        fun_submit(n_workers, n_servers, envs)
        while ps.alive():
            time.sleep(0.1)
            if abort_check is not None:
                err = abort_check()
                if err is not None:
                    raise err


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone tracker process (``python -m
    dmlc_core_tpu_torch.tracker.tracker``): the supervised form the local
    backend launches for ``--tracker-journal``. The tracker runs outside
    the submit process, so a crash (or a SIGKILL) takes down only the
    control plane; the supervisor relaunches this entry on the SAME
    pinned port with the SAME journal directory, the replay restores the
    ledger and the ranks, and the workers ride ``connect_worker_retry``
    through the outage. The endpoint is published through
    ``--endpoint-file`` (atomic rename); the process serves until
    SIGTERM or job completion."""
    import argparse
    import signal

    p = argparse.ArgumentParser(description="standalone rabit tracker")
    p.add_argument("--host-ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9091)
    p.add_argument("--port-end", type=int, default=9999)
    p.add_argument("--num-workers", type=int, required=True)
    p.add_argument("--journal", default=None,
                   help="journal directory (crash recovery state)")
    p.add_argument("--endpoint-file", default=None,
                   help="publish {host, port} JSON here once listening")
    args = p.parse_args(argv)
    tracker = RabitTracker(
        args.host_ip, args.num_workers,
        port=args.port, port_end=args.port_end, journal_dir=args.journal,
    )
    tracker.start(args.num_workers)
    if args.endpoint_file:
        tmp = f"{args.endpoint_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"host": tracker.host_ip, "port": tracker.port}, f)
        os.replace(tmp, args.endpoint_file)
    # serve until told to stop or until the state thread finished a
    # complete job (a shard-only job has no rendezvous completion: the
    # launcher SIGTERMs this process at job end)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_a: stop.set())
    try:
        while not stop.is_set() and tracker.alive():
            stop.wait(0.2)
    except KeyboardInterrupt:
        pass
    tracker.close()
    # the state thread writes the end-of-job report (DMLC_METRICS_REPORT)
    # after close(): let it land before the process exits
    tracker.join(timeout=10)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
