"""Worker-side rendezvous client: the rabit bootstrap (the port of
``RabitWorker`` from ``dmlc_core_tpu/tracker/client.py``).

Connect to the tracker, receive rank + tree/ring neighbors, wire real
TCP links to peers, and report shutdown/log/heartbeat messages. The
links carry the collective engine's frames (``collective.py``).

Env bootstrap mirrors the worker contract: DMLC_TRACKER_URI/PORT, and
DMLC_TASK_ID as the job id for rank recovery.

Every tracker RPC carries the flight recorder's trace context, so a
merged timeline draws the arrow from the worker's wait to the tracker's
handling. ``heartbeat`` ships the registry snapshot and the time-series
ring's new samples and estimates this host's clock offset, in the JAX
package's wire form. Left out: the shard-lease identity
(``DMLC_SHARD_RANK``), which belongs to the shard service
(``ROADMAP.md`` §1 item 4b).
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import Any, Dict, List, Optional, Tuple

from ..io.retry import _env_float
from ..telemetry import timeseries as _timeseries
from ..telemetry import tracing as _tracing
from .protocol import (
    CMD_METRICS,
    CMD_PRINT,
    CMD_RECOVER,
    CMD_SHUTDOWN,
    CMD_START,
    FramedSocket,
    connect_peer,
    connect_worker_retry,
    make_listener,
)

__all__ = ["RabitWorker"]


class RabitWorker:
    """One worker's view of the rendezvous.

    Peer links get explicit timeouts: dials and the incoming-link
    identify recv are capped by ``DMLC_PEER_CONNECT_TIMEOUT`` (30 s
    default) so a half-dead peer can never wedge the wiring, and wired
    links are handed over in blocking mode (consumers, the collective
    engine, manage their own IO deadlines). ``shutdown()``/``close()``
    are idempotent."""

    def __init__(
        self,
        tracker_uri: Optional[str] = None,
        tracker_port: Optional[int] = None,
        jobid: Optional[str] = None,
    ) -> None:
        self.tracker_uri = tracker_uri or os.environ["DMLC_TRACKER_URI"]
        self.tracker_port = int(
            tracker_port
            if tracker_port is not None
            else os.environ["DMLC_TRACKER_PORT"]
        )
        self.jobid = (
            jobid
            if jobid is not None
            else os.environ.get("DMLC_TASK_ID", "NULL")
        )
        self.rank = -1
        self.parent = -1
        self.world_size = -1
        self.tree_neighbors: List[int] = []
        self.ring_prev = -1
        self.ring_next = -1
        self.links: Dict[int, socket.socket] = {}
        self._listener: Optional[socket.socket] = None
        self.connect_timeout = _env_float("DMLC_PEER_CONNECT_TIMEOUT", 30.0)
        self._shut = False
        self._ts_seq = 0  # newest time-series sample seq already shipped

    def _connect_tracker(
        self, cmd: str, rank: int, world: int,
        retry_secs: Optional[float] = None,
    ) -> FramedSocket:
        # every tracker RPC this worker makes rides the reconnect-with-
        # backoff dial, so a tracker restart window is survived
        return connect_worker_retry(
            self.tracker_uri, self.tracker_port, rank, world, self.jobid, cmd,
            trace_ctx=_tracing.rpc_context(), retry_secs=retry_secs,
        )

    # -- rendezvous ----------------------------------------------------------
    def start(self, world_size: int = -1, recover_rank: int = -1) -> int:
        """Rendezvous with the tracker; wires peer links. Returns rank.

        ``recover_rank`` >= 0 re-registers after a restart (cmd=recover),
        reclaiming the previous rank (reference tracker.py:290-292).
        Re-entrant: a survivor re-joining after a peer death calls
        ``start(recover_rank=self.rank)`` with its live links intact;
        only the missing ones are re-brokered (rabit recover contract).
        """
        if self._listener is not None:
            # re-entry (recover / retry after a failed start): the old
            # accept socket is stale, peers are told the NEW port
            self._listener.close()
        self._listener = make_listener("", 0)
        self._shut = False
        my_port = self._listener.getsockname()[1]

        cmd = CMD_RECOVER if recover_rank >= 0 else CMD_START
        fs = self._connect_tracker(cmd, recover_rank, world_size)
        self.rank = fs.recv_int()
        # every rendezvoused worker samples its registry on the default
        # time-series ring (DMLC_TS_INTERVAL, default 2 s; DMLC_TS=off
        # disables): heartbeats ship the new samples, so the tracker's
        # /metrics.json?window= has per-rank windowed rates
        if _timeseries.sampling_enabled():
            _timeseries.ensure_default()
        self.parent = fs.recv_int()
        self.world_size = fs.recv_int()
        n_tree = fs.recv_int()
        self.tree_neighbors = [fs.recv_int() for _ in range(n_tree)]
        self.ring_prev = fs.recv_int()
        self.ring_next = fs.recv_int()

        # brokering loop: stays on this connection until every outgoing
        # link succeeds (the tracker re-enters its loop whenever nerr != 0,
        # reference assign_rank tracker.py:104-135)
        expected = set(self.tree_neighbors)
        if self.ring_prev not in (-1, self.rank):
            expected.add(self.ring_prev)
        if self.ring_next not in (-1, self.rank):
            expected.add(self.ring_next)
        while True:
            # only report links in the current neighbor set (the tracker
            # checks goodset ⊆ nnset)
            good = sorted(set(self.links) & expected)
            fs.send_int(len(good))
            for r in good:
                fs.send_int(r)
            n_conn = fs.recv_int()
            n_wait = fs.recv_int()
            to_connect: List[Tuple[str, int, int]] = []
            for _ in range(n_conn):
                host = fs.recv_str()
                port = fs.recv_int()
                peer_rank = fs.recv_int()
                to_connect.append((host, port, peer_rank))
            n_err = 0
            for host, port, peer_rank in to_connect:
                try:
                    # the dial AND the identifying send ride one explicit
                    # deadline: a half-dead peer fails this round of
                    # brokering instead of wedging it
                    peer = connect_peer(
                        host, port, self.rank, timeout=self.connect_timeout
                    )
                    self.links[peer_rank] = peer
                except OSError:
                    n_err += 1
            fs.send_int(n_err)
            if n_err == 0:
                break
        fs.send_int(my_port)
        fs.close()
        self._await_peer_links(n_wait)
        return self.rank

    def _await_peer_links(self, n_wait: int) -> None:
        """Accept ``n_wait`` incoming peer links under one shared
        deadline ($DMLC_LINK_WAIT_TIMEOUT seconds total, default 300;
        <= 0 waits forever). A peer that never dials in, or connects
        without identifying, fails this worker loudly so a supervisor can
        retry/abort. The deadline spans accept() AND the identifying
        recv; on failure the listener and this round's accepted links
        are closed, so a caller may retry start() cleanly."""
        total = _env_float("DMLC_LINK_WAIT_TIMEOUT", 300.0)
        deadline = None if total <= 0 else time.monotonic() + total
        accepted: List[socket.socket] = []
        try:
            for _ in range(n_wait):
                if deadline is not None:
                    self._listener.settimeout(
                        max(0.001, deadline - time.monotonic())
                    )
                peer, _addr = self._listener.accept()
                accepted.append(peer)
                if deadline is not None:
                    peer.settimeout(max(0.001, deadline - time.monotonic()))
                peer_rank = FramedSocket(peer).recv_int()
                peer.settimeout(None)
                self.links[peer_rank] = peer
        except (socket.timeout, TimeoutError):
            for p in accepted:
                p.close()
                self.links = {
                    r: s for r, s in self.links.items() if s is not p
                }
            self._listener.close()
            raise RuntimeError(
                f"rank {self.rank}: timed out after {total:.0f}s waiting "
                f"for incoming peer link(s) ({n_wait} expected); if this "
                "worker was relaunched, surviving peers must re-rendezvous "
                "(start(recover_rank=...)) for links to re-wire; raise "
                "$DMLC_LINK_WAIT_TIMEOUT for slow-starting clusters"
            ) from None

    # -- control messages ----------------------------------------------------
    def log(self, msg: str) -> None:
        """Relay a message through the tracker (cmd=print,
        reference tracker.py:269-271)."""
        fs = self._connect_tracker(CMD_PRINT, self.rank, -1)
        fs.send_str(msg)
        fs.close()

    def heartbeat(self, metrics: Optional[Dict[str, Any]] = None) -> None:
        """Piggyback a telemetry snapshot on a tracker heartbeat
        (cmd=metrics). ``metrics`` defaults to the process-global
        registry snapshot: one call ships every counter, gauge and
        histogram this worker accumulated; the tracker aggregates per
        rank and cluster-wide and serves them on its /metrics endpoint.

        With the default snapshot the payload also carries the default
        time-series ring's NEW samples under ``timeseries`` (shedding the
        oldest when the frame would pass ``FramedSocket.MAX_STR``), and
        the tracker's wall-stamp reply is bracketed to estimate this
        host's clock offset (RTT midpoint → ``tracing.set_clock_offset``).
        A heartbeat never raises into the caller on a tracker outage
        (short retry budget ``DMLC_HEARTBEAT_RETRY_SECS``, default 2 s):
        its samples are re-shipped next time.

        Requires a completed ``start()``: without a rank the tracker
        would drop the frame, so fail loudly at the caller instead."""
        if self.rank < 0:
            raise RuntimeError(
                "heartbeat() before start(): this worker has no rank yet, "
                "so the tracker would discard its metrics"
            )
        ring = None
        if metrics is None:
            from ..telemetry import default_registry

            metrics = default_registry().snapshot()
            ring = _timeseries.default_ring(create=False)
        shipped_seq = None
        if ring is not None:
            ring.sample()  # the series always reaches "now"
            new = ring.samples(since=self._ts_seq)
            if new:
                metrics = dict(metrics)
                metrics["timeseries"] = new
                shipped_seq = new[-1]["seq"]
        data = json.dumps(metrics, separators=(",", ":"))
        # the string framing bounds payloads at MAX_STR: shed the OLDEST
        # samples (already out of any live window) before the tracker
        # would call the frame hostile and drop it
        budget = FramedSocket.MAX_STR - (128 << 10)
        while len(data) > budget and len(metrics.get("timeseries", ())) > 1:
            keep = metrics["timeseries"]
            metrics["timeseries"] = keep[(len(keep) + 1) // 2:]
            data = json.dumps(metrics, separators=(",", ":"))
        if len(data) > budget and "timeseries" in metrics:
            # one sample alone is too large: ship the bare snapshot and
            # keep the samples for the next attempt
            metrics = {k: v for k, v in metrics.items() if k != "timeseries"}
            data = json.dumps(metrics, separators=(",", ":"))
            shipped_seq = None
        with _tracing.span("dmlc:heartbeat", rank=self.rank):
            try:
                fs = self._connect_tracker(
                    CMD_METRICS, self.rank, -1,
                    retry_secs=_env_float("DMLC_HEARTBEAT_RETRY_SECS", 2.0),
                )
            except (ConnectionError, OSError, TimeoutError):
                return  # tracker down: re-shipped next tick
            try:
                fs.send_str(data)
                # bracket only the tracker's read-tail + reply, not the
                # upload, so the midpoint is not biased by the payload
                t0 = time.time_ns()  # noqa: L008 (RTT bracket for the clock offset, not a duration)
                try:
                    reply = json.loads(fs.recv_str())
                    t1 = time.time_ns()  # noqa: L008 (RTT bracket, see above)
                    wall = reply.get("wall_ns")
                    if isinstance(wall, (int, float)):
                        _tracing.set_clock_offset((t0 + t1) / 2.0 - float(wall))
                except (ConnectionError, OSError, ValueError):
                    pass  # a tracker that replies nothing: no estimate
            except (ConnectionError, OSError, TimeoutError):
                return
            finally:
                fs.close()
        if shipped_seq is not None:
            self._ts_seq = shipped_seq

    def shutdown(self) -> None:
        """Signal completion (cmd=shutdown, reference tracker.py:272-277).
        Idempotent: the tracker treats a duplicate shutdown from the same
        rank as a protocol violation, so a second call sends nothing."""
        if self._shut:
            return
        self._shut = True
        fs = self._connect_tracker(CMD_SHUTDOWN, self.rank, -1)
        fs.close()
        self.close()

    def close(self) -> None:
        """Close peer links + the accept socket. Idempotent."""
        links, self.links = self.links, {}
        for s in links.values():
            try:
                s.close()
            except OSError:
                pass
        if self._listener is not None:
            self._listener.close()
            self._listener = None
