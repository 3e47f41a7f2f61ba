"""Wire framing for the rendezvous protocol (the port of
``dmlc_core_tpu/tracker/protocol.py``, byte for byte the same frames).

Native-endian int32 frames and length-prefixed UTF-8 strings, the magic
0xff99 handshake, and the command set: the rabit rendezvous commands
{start, recover, shutdown, print}, ``metrics`` (a worker heartbeat with
one JSON payload), ``watch`` (a persistent connection the tracker pushes
peer-death notices down) and the four shard-service commands
(``shardsvc.py``: one JSON request frame, one JSON response frame).

The trace context a caller piggybacks on the handshake's cmd string
(``pack_cmd``, from ``telemetry.tracing.rpc_context()``) stays an
opaque string here; the tracker decodes it (``tracing.handler_span``).

This module is the only place the command strings are spelled out.
"""

from __future__ import annotations

import os
import socket
import struct
from typing import Optional

from ..io.retry import RetryPolicy, is_transient
from ..telemetry import tracing as _tracing

MAGIC = 0xFF99

#: the reference rendezvous set (tracker.py accept loop)
CMD_START = "start"
CMD_RECOVER = "recover"
CMD_SHUTDOWN = "shutdown"
CMD_PRINT = "print"
#: worker → tracker telemetry heartbeat (cmd string on the handshake)
CMD_METRICS = "metrics"
#: the dynamic shard service's lease protocol (shardsvc.py)
CMD_SHARD_LEASE = "shard_lease"
CMD_SHARD_RENEW = "shard_renew"
CMD_SHARD_DONE = "shard_done"
CMD_SHARD_RELEASE = "shard_release"
#: collective peer-death watch (tracker/collective.py): the connection
#: STAYS OPEN — the tracker pushes one JSON line per task failure the
#: supervisor reports, so a surviving worker learns a peer died the
#: instant the supervisor does (observer hook), not when a link
#: timeout fires
CMD_WATCH = "watch"

#: the shard service's commands: one JSON request frame, one response
SHARD_CMDS = frozenset(
    {CMD_SHARD_LEASE, CMD_SHARD_RENEW, CMD_SHARD_DONE, CMD_SHARD_RELEASE}
)

#: every command the tracker understands
RENDEZVOUS_CMDS = frozenset(
    {CMD_START, CMD_RECOVER, CMD_SHUTDOWN, CMD_PRINT, CMD_METRICS, CMD_WATCH}
) | SHARD_CMDS

__all__ = [
    "CMD_START",
    "CMD_RECOVER",
    "CMD_SHUTDOWN",
    "CMD_PRINT",
    "CMD_METRICS",
    "CMD_SHARD_LEASE",
    "CMD_SHARD_RENEW",
    "CMD_SHARD_DONE",
    "CMD_SHARD_RELEASE",
    "CMD_WATCH",
    "SHARD_CMDS",
    "RENDEZVOUS_CMDS",
    "MAGIC",
    "FramedSocket",
    "connect_worker",
    "connect_worker_retry",
    "default_tracker_retry_secs",
    "connect_peer",
    "make_listener",
    "bind_first_free",
    "find_free_port",
    "pack_cmd",
    "unpack_cmd",
]

#: separator between a cmd and its piggybacked trace context on the
#: handshake's cmd string (ASCII unit separator: can never appear in a
#: command name). The context is opaque here: this module only carries it.
_CTX_SEP = "\x1f"


def pack_cmd(cmd: str, trace_ctx=None) -> str:
    """Attach an opaque trace context to a cmd string (None = bare
    cmd — the reference-compatible form)."""
    if not trace_ctx:
        return cmd
    return f"{cmd}{_CTX_SEP}{trace_ctx}"


def unpack_cmd(raw: str):
    """(cmd, trace_ctx-or-None) from a received cmd string. A bare
    reference-client cmd passes through unchanged."""
    cmd, sep, ctx = raw.partition(_CTX_SEP)
    return cmd, (ctx if sep else None)


class FramedSocket:
    """recv/send of int32 and length-prefixed UTF-8 strings."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock

    def recv_all(self, nbytes: int) -> bytes:
        chunks = []
        nread = 0
        while nread < nbytes:
            chunk = self.sock.recv(min(nbytes - nread, 65536))
            if not chunk:
                raise ConnectionError("peer closed during recv")
            chunks.append(chunk)
            nread += len(chunk)
        return b"".join(chunks)

    def recv_int(self) -> int:
        return struct.unpack("<i", self.recv_all(4))[0]

    def send_int(self, value: int) -> None:
        self.sock.sendall(struct.pack("<i", value))

    #: strings on this protocol are hostnames/jobids/log lines — anything
    #: beyond this is a hostile or corrupt frame, not a real message
    MAX_STR = 1 << 20

    def recv_str(self) -> str:
        n = self.recv_int()
        if not 0 <= n <= self.MAX_STR:
            raise ConnectionError(f"invalid string length {n} on the wire")
        return self.recv_all(n).decode()

    def send_str(self, value: str) -> None:
        data = value.encode()
        self.send_int(len(data))
        self.sock.sendall(data)

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


def make_listener(
    host: str = "", port: int = 0, backlog: int = 16
) -> socket.socket:
    """Bound+listening TCP socket. One of the sanctioned socket
    construction sites: every listener in tracker/ (the worker's
    peer-link accept socket, test fakes) is built here so socket options
    and error handling cannot drift per call site."""
    sock = socket.socket()
    try:
        sock.bind((host, port))
        sock.listen(backlog)
    except BaseException:
        sock.close()
        raise
    return sock


def bind_first_free(
    host_ip: str, port: int, port_end: int, backlog: int = 256
) -> "tuple[socket.socket, int]":
    """Listener bound to the first free port in ``[port, port_end)``
    for ``host_ip``'s address family (the tracker's reference port-scan
    bind, tracker.py:144-149). Raises ``OSError`` when the whole range
    is taken."""
    family = socket.getaddrinfo(host_ip, None)[0][0]
    for p in range(port, port_end):
        # a fresh socket a port: two trackers may both bind a port before
        # either listens (SO_REUSEADDR), and the loser's listen fails with
        # EADDRINUSE on a socket that is bound already, which a second
        # bind refuses (EINVAL)
        sock = socket.socket(family, socket.SOCK_STREAM)
        # a supervised tracker relaunches on the SAME pinned port moments
        # after its predecessor was SIGKILLed: without SO_REUSEADDR the
        # predecessor's TIME_WAIT remnants would make the rebind flaky
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            sock.bind((host_ip, p))
            sock.listen(backlog)
            return sock, p
        except OSError as e:
            sock.close()
            if e.errno in (98, 48):  # EADDRINUSE (linux, mac)
                continue
            raise
    raise OSError(f"no free tracker port in [{port},{port_end})")


def find_free_port(host_ip: str, port: int, port_end: int):
    """First bindable port in ``[port, port_end)`` (probe-and-release —
    the PSTracker root-port pick), or ``None`` when the range is full."""
    family = socket.getaddrinfo(host_ip, None)[0][0]
    for p in range(port, port_end):
        with socket.socket(family, socket.SOCK_STREAM) as probe:
            try:
                probe.bind(("", p))
                return p
            except OSError:
                continue
    return None


def connect_peer(
    host: str, port: int, my_rank: int, timeout: float = 30.0
) -> socket.socket:
    """Dial a peer worker's accept socket and identify (one int32: our
    rank — the frame ``RabitWorker._await_peer_links`` reads). The dial
    AND the identifying send share ``timeout``; the wired socket is
    returned in BLOCKING mode (link consumers — the collective engine —
    set their own IO deadlines per operation)."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        FramedSocket(sock).send_int(my_rank)
        sock.settimeout(None)
        return sock
    except BaseException:
        sock.close()
        raise


def connect_worker(
    host: str,
    port: int,
    rank: int,
    world_size: int,
    jobid: str,
    cmd: str,
    timeout: float = 30.0,
    trace_ctx=None,
) -> FramedSocket:
    """Dial the tracker and complete the client-side preamble every
    worker connection shares — magic exchange, then rank / world_size /
    jobid / cmd (the frame order WorkerEntry reads). THE one handshake
    site, so a protocol preamble change cannot drift between callers.
    ``trace_ctx`` (an opaque string) piggybacks on the cmd string."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        fs = FramedSocket(sock)
        fs.send_int(MAGIC)
        got = fs.recv_int()
        if got != MAGIC:
            raise ConnectionError(f"tracker sent bad magic {got:#x}")
        fs.send_int(rank)
        fs.send_int(world_size)
        fs.send_str(str(jobid))
        fs.send_str(pack_cmd(cmd, trace_ctx))
        return fs
    except BaseException:
        sock.close()
        raise


def default_tracker_retry_secs() -> float:
    """``DMLC_TRACKER_RETRY_SECS`` (default 60): cumulative backoff
    budget a client spends redialing an absent tracker before giving
    up; 0 disables reconnection (one attempt, fail fast)."""
    try:
        return max(
            0.0, float(os.environ.get("DMLC_TRACKER_RETRY_SECS", "60"))
        )
    except ValueError:
        return 60.0


def connect_worker_retry(
    host: str,
    port: int,
    rank: int,
    world_size: int,
    jobid: str,
    cmd: str,
    timeout: float = 30.0,
    trace_ctx=None,
    retry_secs: Optional[float] = None,
) -> FramedSocket:
    """``connect_worker`` that survives a tracker crash window: on a
    transient dial/handshake failure (``io.retry.is_transient`` — the
    refused/reset/timeout shapes a dead-or-restarting tracker
    produces) it backs off with decorrelated jitter and redials until
    ``retry_secs`` (default ``DMLC_TRACKER_RETRY_SECS``) of cumulative
    backoff is spent, then re-raises the last error. The jitter is the
    herd-breaker: a fleet whose tracker just relaunched redials spread
    over the backoff envelope instead of in one synchronized wave. Every
    retry emits a ``dmlc:tracker_reconnect`` trace instant."""
    budget = (
        default_tracker_retry_secs() if retry_secs is None else retry_secs
    )
    policy = RetryPolicy(
        max_attempts=1 << 30,  # the cumulative budget is the only cap
        base_secs=0.05,
        cap_secs=2.0,
        budget_secs=max(0.0, budget),
    )
    attempt = 0
    while True:
        try:
            return connect_worker(
                host, port, rank, world_size, jobid, cmd, timeout, trace_ctx
            )
        except (OSError, ConnectionError) as e:
            if budget <= 0 or not is_transient(e):
                raise
            attempt += 1
            _tracing.instant(
                "dmlc:tracker_reconnect",
                cmd=cmd, rank=rank, attempt=attempt, error=type(e).__name__,
            )
            policy.pause(cause=e, what=f"tracker dial cmd={cmd}")
