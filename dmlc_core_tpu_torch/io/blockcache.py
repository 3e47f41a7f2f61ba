"""Host-level shared decoded-block cache: decode once per host, serve
every colocated process (the port of ``dmlc_core_tpu/io/blockcache.py``,
with the same control-plane frames, segment names, env knobs and metric
names, so a daemon of either package serves clients of both).

Each process keeps a bytes-bounded LRU of decoded blocks
(``io/codec.py``), but N trainers on one host over the same compressed
corpus would fetch and decode every block N times. One daemon a host
owns a shared decoded-block store and serves it to any number of client
processes.

- **Data plane: named shared memory.** Every cached block lives in one
  POSIX shared-memory segment (``io.shm.ShmSegment``), so a hit maps the
  decoded bytes and the socket never carries a payload.
  ``BlockCacheClient.get_view`` hands out the leased mapping itself;
  ``get`` copies out of it (no decode, no remote fetch).
- **Control plane: a UNIX-domain socket with length-prefixed JSON
  frames** (4-byte LE length + UTF-8 JSON). Ops: ``lookup`` and
  ``lookup_many`` (grant leases), ``release``, ``publish`` (adopt a
  segment the client wrote), ``stats``, ``flush``, ``ping``.
- **Content addressing.** Keys are the splitter's block identities (the
  file set's paths, sizes, mtimes and etags, the block layout's digest
  and the block's offset) flattened to a sha1 hex string
  (``codec.wire_block_key``), so two processes over the same file set
  agree on identity and an in-place rewrite never serves stale bytes.
- **Leases gate eviction.** ``lookup`` grants a lease; LRU eviction and
  ``flush`` skip leased entries, so a mapped view is never unlinked under
  a reader. A dropped connection releases its leases.
- **Publish races resolve to one winner.** Both racers decode and
  publish; the first segment is adopted, the loser is told ``duplicate``
  and unlinks its copy, and its next lookup hits.
- **Admission and per-tenant quotas.** A block larger than the tenant's
  budget is rejected; a full tenant evicts its own LRU unleased entries
  first, so one job cannot flush another's working set.

The shared tier is best-effort: a client makes ONE connect attempt a
process and caches a failure (``default_client``), and any socket error
marks it dead. Every caller treats a dead or absent daemon as a miss, so
``codec.DecodeContext`` then decodes in process, and no read fails.

Env knobs: ``DMLC_BLOCK_CACHE`` (``off``/``0`` disables the client
tier), ``DMLC_BLOCK_CACHE_SOCK`` (socket path; default
``$TMPDIR/dmlc-blockcache-<uid>.sock``), ``DMLC_BLOCK_CACHE_MB`` (the
daemon's budget, default 1024), ``DMLC_BLOCK_CACHE_TENANT_MB`` (per-tenant
quota, default the whole budget), ``DMLC_BLOCK_CACHE_TENANT`` (the
client's tenant label, default ``$DMLC_JOB_ID`` then ``default``).

Telemetry: ``io.blockcache.{hits,misses,publishes,evictions,leases,
bytes,bytes_published,bytes_from_cache}``, labelled ``tenant=...``. The
daemon ticks the authoritative set on its own registry (served on
``/metrics`` when ``metrics_port`` is given); each client mirrors its own
hits, misses, publishes and bytes served from the cache.

CLI: ``python -m dmlc_core_tpu_torch.tools cached serve|stats|flush``;
``submit --block-cache`` starts one daemon for a local job
(``tracker/backends/local.py``).
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import socket
import struct
import tempfile
import threading
import weakref
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from ..telemetry import default_registry as _default_registry
from ..telemetry import tracing as _tracing
from ..utils.env import get_env
from ..utils.logging import Error, check
from .shm import ShmSegment as _ShmSegment

__all__ = [
    "BlockCacheClient",
    "BlockCacheDaemon",
    "LeasedView",
    "default_client",
    "default_sock_path",
    "reset_default_client",
]

logger = logging.getLogger("dmlc_core_tpu_torch.io.blockcache")

#: segment names are (pid, ordinal) — the ordinal is PROCESS-global so
#: two clients in one process can never mint the same name
_NAME_SEQ = itertools.count(1)

#: control frames are metadata only (payload rides shared memory) —
#: anything larger is a corrupt or hostile peer, not a real message
MAX_FRAME = 1 << 20

_REG = _default_registry()


def _tick(name: str, tenant: str, n: float = 1) -> None:
    _REG.counter(f"io.blockcache.{name}", labels={"tenant": tenant}).inc(n)


def _gauge(name: str, tenant: str):
    return _REG.gauge(f"io.blockcache.{name}", labels={"tenant": tenant})


def default_sock_path() -> str:
    """Rendezvous point for one daemon per (host, uid):
    ``DMLC_BLOCK_CACHE_SOCK`` wins, else a uid-scoped name under the
    system temp dir — colocated processes of one user meet at the same
    daemon with zero launcher plumbing."""
    env = os.environ.get("DMLC_BLOCK_CACHE_SOCK", "")
    if env:
        return env
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(
        tempfile.gettempdir(), f"dmlc-blockcache-{uid}.sock"
    )


def default_tenant() -> str:
    """Quota/telemetry identity of this process's cache traffic."""
    return (
        os.environ.get("DMLC_BLOCK_CACHE_TENANT")
        or os.environ.get("DMLC_JOB_ID")
        or "default"
    )


# -- wire framing -------------------------------------------------------------
def _send_frame(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    sock.sendall(struct.pack("<I", len(data)) + data)


def _recv_all(sock: socket.socket, nbytes: int) -> bytes:
    chunks = []
    nread = 0
    while nread < nbytes:
        chunk = sock.recv(min(nbytes - nread, 65536))
        if not chunk:
            raise ConnectionError("peer closed during recv")
        chunks.append(chunk)
        nread += len(chunk)
    return b"".join(chunks)


def _recv_frame(sock: socket.socket) -> dict:
    (n,) = struct.unpack("<I", _recv_all(sock, 4))
    if n > MAX_FRAME:
        raise ConnectionError(f"oversized control frame ({n} bytes)")
    return json.loads(_recv_all(sock, n).decode())


# -- daemon -------------------------------------------------------------------
class _Entry:
    __slots__ = ("shm", "size", "tenant", "leases")

    def __init__(self, shm: _ShmSegment, size: int, tenant: str) -> None:
        self.shm = shm
        self.size = size
        self.tenant = tenant
        self.leases = 0


class BlockCacheDaemon:
    """The per-host cache service: one shared decoded-block store, any
    number of client processes.

    ``start()`` binds the UNIX socket and serves on daemon threads;
    ``close()`` stops the service and unlinks every owned segment.
    ``serve_forever()`` blocks (the CLI's foreground mode). Thread-safe
    throughout — one lock guards the store; shm reads/writes happen in
    the clients, never under it.
    """

    def __init__(
        self,
        sock_path: Optional[str] = None,
        max_bytes: Optional[int] = None,
        tenant_max_bytes: Optional[int] = None,
        metrics_port: int = 0,
    ) -> None:
        self.sock_path = sock_path or default_sock_path()
        self.max_bytes = (
            max_bytes
            if max_bytes is not None
            else get_env("DMLC_BLOCK_CACHE_MB", 1024) * (1 << 20)
        )
        self.tenant_max_bytes = (
            tenant_max_bytes
            if tenant_max_bytes is not None
            else get_env("DMLC_BLOCK_CACHE_TENANT_MB", 0) * (1 << 20)
        ) or self.max_bytes
        check(self.max_bytes > 0, "block cache budget must be positive")
        self.metrics_port = metrics_port
        self._lock = threading.Lock()
        self._store: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0
        self._tenant_bytes: Dict[str, int] = {}
        self._leases: Dict[int, str] = {}  # lease id -> key
        self._lease_seq = itertools.count(1)
        self._sock: Optional[socket.socket] = None
        self._accept_thread: Optional[threading.Thread] = None
        self._metrics_server = None
        self._conns: set = set()  # live client sockets (severed on close)
        self._closed = threading.Event()
        self.hits = 0
        self.misses = 0
        self.publishes = 0
        self.evictions = 0
        self.rejected = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "BlockCacheDaemon":
        check(self._sock is None, "daemon already started")
        if os.path.exists(self.sock_path):
            # stale socket files survive a SIGKILL'd daemon; a LIVE one
            # answers a connect — refuse to fight it for the path
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.settimeout(0.5)
                probe.connect(self.sock_path)
            except OSError:
                os.unlink(self.sock_path)
            else:
                probe.close()
                raise Error(
                    f"a block-cache daemon is already serving "
                    f"{self.sock_path!r}"
                )
            finally:
                probe.close()
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.sock_path)
        srv.listen(64)
        self._sock = srv
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="blockcache-accept"
        )
        self._accept_thread.start()
        if self.metrics_port:
            self._metrics_server = _serve_daemon_metrics(
                self, self.metrics_port
            )
        logger.info(
            "block-cache daemon serving %s (budget %d MB)",
            self.sock_path, self.max_bytes >> 20,
        )
        return self

    def serve_forever(self) -> None:
        """Block until ``close()`` (foreground CLI mode)."""
        if self._sock is None:
            self.start()
        self._closed.wait()

    def close(self) -> None:
        """Stop serving and unlink every owned segment. Idempotent."""
        if self._closed.is_set():
            return
        self._closed.set()
        if self._sock is not None:
            # a close alone leaves accept() blocked on Linux: the
            # shutdown wakes it, so the accept thread ends here
            for end in (lambda: self._sock.shutdown(socket.SHUT_RDWR), self._sock.close):
                try:
                    end()
                except OSError:
                    pass
        if (self._accept_thread is not None
                and self._accept_thread is not threading.current_thread()):
            self._accept_thread.join(5.0)
        # sever live client connections too — a closed daemon must look
        # exactly like a killed one (clients mark themselves dead and
        # fall back in-process), not like an eternally-missing store
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        if self._metrics_server is not None:
            try:
                self._metrics_server.shutdown()
                self._metrics_server.server_close()
            except Exception:
                pass
        try:
            os.unlink(self.sock_path)
        except OSError:
            pass
        with self._lock:
            for key in list(self._store):
                self._drop(key, unlink=True)

    # -- store (call under self._lock) ---------------------------------------
    def _drop(self, key: str, unlink: bool) -> None:
        e = self._store.pop(key)
        self._bytes -= e.size
        self._tenant_bytes[e.tenant] = (
            self._tenant_bytes.get(e.tenant, 0) - e.size
        )
        _gauge("bytes", e.tenant).set(
            max(self._tenant_bytes.get(e.tenant, 0), 0)
        )
        try:
            e.shm.close()
        except (OSError, BufferError):
            pass
        if unlink:
            try:
                e.shm.unlink()
            except OSError:
                pass

    def _evict_one(self, tenant: Optional[str]) -> bool:
        """Evict the LRU UNLEASED entry (of ``tenant`` when given);
        False when everything eligible is leased — a mapped view is
        never unlinked under a reader."""
        for key, e in self._store.items():
            if e.leases == 0 and (tenant is None or e.tenant == tenant):
                t = e.tenant
                size = e.size
                self._drop(key, unlink=True)
                self.evictions += 1
                _tick("evictions", t)
                # instants, not spans: an eviction is a moment on the
                # daemon timeline, and WHEN they cluster is the story
                _tracing.instant(
                    "dmlc:blockcache_evict", tenant=t, bytes=size
                )
                return True
        return False

    def _admit(self, tenant: str, size: int) -> bool:
        if size > self.max_bytes or size > self.tenant_max_bytes:
            return False  # admission: larger than any budget it rides
        while self._bytes + size > self.max_bytes:
            if not self._evict_one(None):
                return False
        while self._tenant_bytes.get(tenant, 0) + size > (
            self.tenant_max_bytes
        ):
            if not self._evict_one(tenant):
                return False
        return True

    # -- request handlers ----------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # closed
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
                name="blockcache-conn",
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        held: set = set()  # lease ids granted to THIS connection
        with self._lock:
            self._conns.add(conn)
        try:
            while True:
                try:
                    req = _recv_frame(conn)
                except (ConnectionError, OSError, ValueError):
                    return
                try:
                    resp = self._handle(req, held)
                except Exception as e:  # one bad request, not the daemon
                    logger.exception("block-cache request failed")
                    resp = {"ok": False, "error": str(e)}
                if resp is None or req.get("oneway"):
                    # no reply to a one-way request EVEN on error: an
                    # unexpected frame would be consumed as the reply
                    # to the peer's next request, desyncing the stream
                    continue
                try:
                    _send_frame(conn, resp)
                except OSError:
                    return
        finally:
            # a dropped connection releases its leases — a crashed
            # reader must not wedge eviction forever
            with self._lock:
                self._conns.discard(conn)
                for lease in held:
                    self._release_lease(lease)
            try:
                conn.close()
            except OSError:
                pass

    def _release_lease(self, lease: int) -> None:
        key = self._leases.pop(lease, None)
        if key is None:
            return
        e = self._store.get(key)
        if e is not None and e.leases > 0:
            e.leases -= 1
            _gauge("leases", e.tenant).inc(-1)

    def _lookup_one(self, key: str, tenant: str, held: set) -> dict:
        """Single-key lookup under self._lock; grants a lease on hit."""
        e = self._store.get(key)
        if e is None:
            self.misses += 1
            _tick("misses", tenant)
            return {"hit": False}
        self._store.move_to_end(key)
        lease = next(self._lease_seq)
        e.leases += 1
        self._leases[lease] = key
        held.add(lease)
        self.hits += 1
        _tick("hits", tenant)
        _gauge("leases", e.tenant).inc(1)
        return {
            "hit": True, "shm": e.shm.name, "size": e.size, "lease": lease,
        }

    def _handle(self, req: dict, held: set) -> Optional[dict]:
        # per-op HANDLER span on the daemon's connection thread: the
        # merged timeline shows lookup/publish/flush service time next
        # to the client windows waiting on them (op names are a bounded
        # set), with a flow arrow from the requesting span (the "tc"
        # trace context the client piggybacks on the control frame)
        with _tracing.handler_span(
            f"dmlc:blockcache_{req.get('op')}", req.get("tc")
        ):
            return self._handle_inner(req, held)

    def _handle_inner(self, req: dict, held: set) -> Optional[dict]:
        op = req.get("op")
        tenant = str(req.get("tenant") or "default")
        if op == "ping":
            return {"ok": True, "pid": os.getpid()}
        if op == "lookup":
            with self._lock:
                out = self._lookup_one(str(req.get("key")), tenant, held)
            out["ok"] = True
            return out
        if op == "lookup_many":
            # one round trip serves a whole window/batch of blocks —
            # per-block RTTs would eat the decode win on small blocks
            keys = [str(k) for k in req.get("keys", ())]
            with self._lock:
                results = [
                    self._lookup_one(k, tenant, held) for k in keys
                ]
            return {"ok": True, "results": results}
        if op == "release":
            leases = req.get("leases")
            if leases is None:
                leases = [req.get("lease", 0)]
            with self._lock:
                for lease in leases:
                    lease = int(lease)
                    if lease not in held:
                        # only the granting connection may release: a
                        # buggy/hostile peer guessing small sequential
                        # ids must not void ANOTHER reader's
                        # never-unlinked-under-a-reader protection
                        continue
                    self._release_lease(lease)
                    held.discard(lease)
            # releases are fire-and-forget (oneway): the reply would be
            # a pure RTT tax on every cache hit
            return None if req.get("oneway") else {"ok": True}
        if op == "publish":
            key = str(req.get("key"))
            size = int(req.get("size", 0))
            name = str(req.get("shm"))
            with self._lock:
                if key in self._store:
                    # the race's loser: a copy already serves this key
                    self._store.move_to_end(key)
                    return {"ok": True, "adopted": False,
                            "reason": "duplicate"}
                if not self._admit(tenant, size):
                    self.rejected += 1
                    return {"ok": True, "adopted": False, "reason": "quota"}
                try:
                    shm = _ShmSegment(name)
                except (OSError, ValueError) as e:
                    return {"ok": False, "error": f"cannot adopt: {e}"}
                self._store[key] = _Entry(shm, size, tenant)
                self._bytes += size
                self._tenant_bytes[tenant] = (
                    self._tenant_bytes.get(tenant, 0) + size
                )
                self.publishes += 1
                _tick("publishes", tenant)
                _tick("bytes_published", tenant, size)
                _gauge("bytes", tenant).set(self._tenant_bytes[tenant])
                return {"ok": True, "adopted": True}
        if op == "stats":
            return {"ok": True, "stats": self.stats()}
        if op == "flush":
            with self._lock:
                n = 0
                while self._evict_one(None):
                    n += 1
            return {"ok": True, "evicted": n}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def stats(self) -> dict:
        with self._lock:
            tenants = {}
            leased = 0
            for e in self._store.values():
                t = tenants.setdefault(
                    e.tenant, {"entries": 0, "bytes": 0, "leases": 0}
                )
                t["entries"] += 1
                t["bytes"] += e.size
                t["leases"] += e.leases
                leased += e.leases
            return {
                "pid": os.getpid(),
                "sock": self.sock_path,
                "entries": len(self._store),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "tenant_max_bytes": self.tenant_max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "publishes": self.publishes,
                "evictions": self.evictions,
                "rejected": self.rejected,
                "active_leases": leased,
                "tenants": tenants,
            }


def _serve_daemon_metrics(daemon: "BlockCacheDaemon", port: int):
    """Daemon self-metrics: the process registry (io.blockcache.* per
    tenant) rendered as Prometheus text on a loopback ``/metrics``
    (the shared single-process exporter, telemetry/export.py)."""
    from ..telemetry.export import serve_metrics_http

    return serve_metrics_http(
        port, registry=_REG, json_provider=daemon.stats,
        name="blockcache-metrics-http",
    )


# -- client -------------------------------------------------------------------
class LeasedView:
    """A leased zero-copy view of one cached block: the mapped shared
    memory itself, valid until ``close()`` (or collection, through
    ``weakref.finalize``). While the lease is held the daemon does not
    evict or unlink the segment."""

    def __init__(self, client: "BlockCacheClient", shm, size: int,
                 lease: int) -> None:
        self._shm = shm
        self._size = size
        self._closed = False
        self._finalizer = weakref.finalize(
            self, LeasedView._cleanup, client, shm, lease
        )

    @staticmethod
    def _cleanup(client: "BlockCacheClient", shm, lease: int) -> None:
        try:
            shm.close()
        except (OSError, BufferError):
            pass
        client._release(lease)

    @property
    def view(self) -> memoryview:
        check(not self._closed, "LeasedView is closed")
        return self._shm.buf[: self._size]

    def tobytes(self) -> bytes:
        return bytes(self.view)

    def __len__(self) -> int:
        return self._size

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._finalizer()


class BlockCacheClient:
    """One process's connection to the host daemon.

    Every method degrades to a miss/no-op on ANY failure: the first
    socket error marks the client dead (``alive`` False) and later
    calls return immediately, so a daemon killed mid-run costs nothing
    but the shared tier. Thread-safe — the readahead threads of many
    splits share one connection behind a lock.
    """

    def __init__(self, sock_path: Optional[str] = None,
                 tenant: Optional[str] = None,
                 timeout: float = 5.0) -> None:
        self.sock_path = sock_path or default_sock_path()
        self.tenant = tenant or default_tenant()
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None
        self._dead = False
        self.hits = 0
        self.misses = 0
        self.publishes = 0

    @property
    def alive(self) -> bool:
        return not self._dead

    def connect(self) -> bool:
        """One attempt; False (and dead) on failure."""
        with self._lock:
            return self._connect_locked()

    def _connect_locked(self) -> bool:
        if self._sock is not None:
            return True
        if self._dead:
            return False
        try:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.settimeout(self._timeout)
            s.connect(self.sock_path)
            self._sock = s
            return True
        except OSError:
            self._dead = True
            return False

    def _request_ex(
        self, obj: dict, oneway: bool = False
    ) -> Tuple[Optional[dict], bool]:
        """(raw reply | None on transport failure, delivered).
        ``delivered`` is whether the full request frame went out — when
        False the daemon cannot have acted on it (a partial frame drops
        the connection), which is what lets publish() distinguish
        'declined/never seen' (safe to unlink) from 'reply lost'
        (daemon may hold the segment). Error replies come back as-is —
        the caller decides; ``_request`` filters them to None."""
        with self._lock:
            if not self._connect_locked():
                return None, False
            sent = False
            try:
                # causal link: the daemon's per-op handler span binds
                # to whatever span encloses this request (a window
                # loader's miss path, a lookup batch)
                tc = _tracing.rpc_context()
                if tc:
                    obj = {**obj, "tc": tc}
                _send_frame(self._sock, obj)
                sent = True
                if oneway:
                    # sent == succeeded for oneway; shaped like a real
                    # reply so _request's ok-filter treats it as one
                    return {"ok": True}, True
                resp = _recv_frame(self._sock)
            except (OSError, ConnectionError, ValueError):
                self._mark_dead_locked()
                return None, sent
        return resp, True

    def _request(
        self, obj: dict, oneway: bool = False
    ) -> Optional[dict]:
        resp, _delivered = self._request_ex(obj, oneway)
        if resp is not None and not resp.get("ok"):
            logger.debug("block-cache request failed: %s", resp)
            return None
        return resp

    def _mark_dead_locked(self) -> None:
        self._dead = True
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None

    def _release(self, *leases: Optional[int]) -> None:
        live = [int(x) for x in leases if x]
        if live:
            # fire-and-forget: a release reply would tax every hit with
            # a second round trip for a boolean nobody reads
            self._request(
                {"op": "release", "leases": live, "oneway": True},
                oneway=True,
            )

    def _lookup(self, key: str) -> Optional[Tuple[object, int, int]]:
        """(shm, size, lease) for a hit; None otherwise. The lease is
        already held, so the segment cannot vanish before mapping."""
        r = self._request(
            {"op": "lookup", "key": key, "tenant": self.tenant}
        )
        if r is None:
            return None
        if not r.get("hit"):
            self.misses += 1
            _tick("misses", self.tenant)
            return None
        try:
            shm = _ShmSegment(r["shm"])
        except (OSError, ValueError):
            self._release(r.get("lease"))
            self.misses += 1
            _tick("misses", self.tenant)
            return None
        self.hits += 1
        _tick("hits", self.tenant)
        _tick("bytes_from_cache", self.tenant, int(r["size"]))
        return shm, int(r["size"]), int(r["lease"])

    def get(self, key: str) -> Optional[bytes]:
        """Block bytes for ``key``, or None. Copies out of the mapped
        view (no socket copy, no decode) and releases the lease."""
        return self.get_many([key]).get(key)

    #: keys per lookup_many frame — bounds the reply against MAX_FRAME
    _BATCH = 512

    def get_many(self, keys) -> Dict[str, bytes]:
        """Bytes for every cached key among ``keys`` in ONE control
        round trip per ``_BATCH`` (plus a oneway lease release) — the
        bulk-hit path the window loader and batched sequential reads
        ride; per-block round trips would eat the decode win on
        small blocks."""
        keys = list(keys)
        out: Dict[str, bytes] = {}
        for at in range(0, len(keys), self._BATCH):
            chunk = keys[at: at + self._BATCH]
            r = self._request({
                "op": "lookup_many", "keys": chunk, "tenant": self.tenant,
            })
            if r is None:
                self.misses += len(chunk)
                _tick("misses", self.tenant, len(chunk))
                continue  # dead client: later chunks return instantly
            leases = []  # every granted lease, released win or lose
            hit_n = 0
            miss_n = 0
            nbytes = 0
            for key, res in zip(chunk, r.get("results", ())):
                if not res.get("hit"):
                    self.misses += 1
                    miss_n += 1
                    continue
                leases.append(res.get("lease"))
                try:
                    shm = _ShmSegment(res["shm"])
                except (OSError, ValueError):
                    # leased but unmappable (e.g. a racing teardown):
                    # this key yielded no data — it is a MISS in every
                    # counter, and the caller will decode it
                    self.misses += 1
                    miss_n += 1
                    continue
                try:
                    size = int(res["size"])
                    out[key] = bytes(shm.buf[:size])
                    nbytes += size
                    self.hits += 1
                    hit_n += 1
                finally:
                    try:
                        shm.close()
                    except (OSError, BufferError):
                        pass
            if miss_n:
                _tick("misses", self.tenant, miss_n)
            if hit_n:
                _tick("hits", self.tenant, hit_n)
                _tick("bytes_from_cache", self.tenant, nbytes)
            self._release(*leases)
        return out

    def get_view(self, key: str) -> Optional[LeasedView]:
        """Zero-copy leased view of the block, or None; the caller owns
        the lease until ``close()``."""
        got = self._lookup(key)
        if got is None:
            return None
        shm, size, lease = got
        return LeasedView(self, shm, size, lease)

    def publish(self, key: str, data) -> bool:
        """Offer decoded bytes to the host tier: write them into a
        fresh segment and ask the daemon to adopt it. False when the
        daemon is absent, another publisher won the race (its copy now
        serves the key), or admission/quota rejected it — the losing
        segment is unlinked either way."""
        if self._dead:
            return False
        size = len(data)
        if size == 0:
            return False
        try:
            shm = _ShmSegment(
                f"dmlcblk-{os.getpid()}-{next(_NAME_SEQ)}",
                create=True, size=size,
            )
        except (OSError, ValueError):
            return False
        # tri-state: True = adopted, False = safe to unlink (daemon
        # explicitly declined, or the request never reached it), None =
        # outcome UNKNOWN — the full request went out but the reply was
        # lost. Unlinking on unknown would tear down a segment the
        # daemon may have adopted, poisoning that key host-wide (every
        # lookup hits a name no one can map, every re-publish is
        # rejected as duplicate), so the unknown case leaks the segment
        # instead — bounded by the one in-flight publish of a dying
        # connection, and empty whenever the daemon DID adopt.
        adopted: Optional[bool] = False
        try:
            shm.buf[:size] = (
                data
                if isinstance(data, (bytes, bytearray, memoryview))
                else bytes(data)
            )
            r, delivered = self._request_ex({
                "op": "publish", "key": key, "tenant": self.tenant,
                "shm": shm.name, "size": size,
            })
            if r is not None:
                # ANY reply — adopted, declined, or an error — means
                # the daemon does not hold the segment unless it said
                # adopted:true
                adopted = bool(r.get("adopted"))
            elif delivered:
                adopted = None  # reply lost: daemon may hold the name
        finally:
            try:
                shm.close()
            except (OSError, BufferError):  # pragma: no cover
                pass
            if adopted is False:
                try:
                    shm.unlink()
                except OSError:  # pragma: no cover
                    pass
        if adopted:
            self.publishes += 1
            _tick("publishes", self.tenant)
        return bool(adopted)

    def stats(self) -> Optional[dict]:
        r = self._request({"op": "stats"})
        return r["stats"] if r else None

    def flush(self) -> Optional[int]:
        r = self._request({"op": "flush"})
        return int(r["evicted"]) if r else None

    def ping(self) -> bool:
        return self._request({"op": "ping"}) is not None


# -- per-process default client (one attempt, cached outcome) -----------------
_DEFAULT: Optional[BlockCacheClient] = None
_DEFAULT_RESOLVED = False
_DEFAULT_LOCK = threading.Lock()


def default_client() -> Optional[BlockCacheClient]:
    """The process-wide shared-tier client, or None when disabled
    (``DMLC_BLOCK_CACHE=off``) or no daemon answered the ONE connect
    attempt (negative result cached — a missing daemon costs one
    connect() per process, ever). A client that dies later keeps
    returning with ``alive`` False; callers treat it as a miss."""
    global _DEFAULT, _DEFAULT_RESOLVED
    if _DEFAULT_RESOLVED:
        return _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT_RESOLVED:
            return _DEFAULT
        mode = os.environ.get("DMLC_BLOCK_CACHE", "auto").strip().lower()
        if mode in ("off", "0", "false", "no", "disabled"):
            _DEFAULT = None
        else:
            client = BlockCacheClient()
            _DEFAULT = client if client.connect() else None
        _DEFAULT_RESOLVED = True
        return _DEFAULT


def reset_default_client() -> None:
    """Forget the cached connect outcome (tests; a daemon started after
    this process first looked for one)."""
    global _DEFAULT, _DEFAULT_RESOLVED
    with _DEFAULT_LOCK:
        if _DEFAULT is not None:
            _DEFAULT.close()
        _DEFAULT = None
        _DEFAULT_RESOLVED = False
