"""dsserve client: the ``dsserve://`` staging producer (the port of
``dmlc_core_tpu/dsserve/client.py``).

``DsServeBatches`` satisfies the staging producer contract (iterable of
Batch + ``close()`` + ``io_stats()``), so the trainer composes it with
``StagingPipeline`` exactly like a local fused producer — except the
host side does nothing but receive frames into slot buffers and hand
them to the dispatch ring: fetch, decode, gather-parse and pack all
happened on the dsserve tier.

URI shape: ``dsserve://host:port,host:port/<dataset-uri>`` — the part
after the endpoint list is the dataset URI the SERVERS read (query
sugar included), e.g. ``dsserve://10.0.0.5:7070/data/criteo.rec?index=
/data/criteo.idx&shuffle=record&seed=3``.

Striping + failover (docs/dsserve.md):

- **lease mode** (default whenever ``DMLC_TRACKER_URI`` is set): every
  endpoint leases micro-shards from the tracker's shard service, so
  striping is dynamic work-sharing — a slow server simply streams
  fewer shards. The CLIENT commits ``shard_done``: a shard's slots are
  buffered per connection until its SHARD_FIN arrives, then committed
  and delivered on ``recorded`` (dropped on ``duplicate``) — delivery
  and exactly-once accounting are one decision, so a server killed
  mid-stream (its partial shard dropped with the connection, its lease
  TTL-reclaimed, the shard re-served in full by a survivor) can never
  duplicate or lose rows.
- **static mode** (no tracker): endpoint *i* streams stripe
  ``(part=i, nparts=n_endpoints)``; slots deliver immediately. A
  transient connection drop re-dials the same endpoint with
  ``start_seq`` = slots already delivered — the reopen-and-seek resume
  of ``RetryingReadStream``, exact because the stream is deterministic.

Reconnects ride ``RetryPolicy`` (io/retry.py) with the transient
classifier and its consecutive-stall attempt cap; waiting on the
shared receive queue is the ``dsserve_recv_wait`` stall stage
(``dsserve.recv_wait_seconds``).

Where the port departs: the pooled receive buffer is picked once a
frame's header names the payload's size, so the very first slot of a
process lands in a page-aligned pooled bank too (the JAX client
receives it into a fresh, unaligned allocation, which the staging
pipeline then copies); and a client drained under a CUDA pipeline's
``batcher.host_pinning`` installs that pinning at its first iteration
(``set_host_pinning``): pool banks are then carved from page-locked
memory and each mapped shm segment is page-locked once, when it is
first mapped, and released before it is unmapped.
"""

from __future__ import annotations

import json
import os
import queue
import socket
import threading
import time
import weakref
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..io.retry import RetryPolicy, is_transient
from ..io.shm import ShmSegment, shm_available, shm_transport_enabled
from ..io.split import fileset_signature
from ..io.uri import URISpec
from ..staging.batcher import Batch, BatchSpec, current_host_pinning
from ..telemetry import default_registry as _default_registry
from ..telemetry import tracing as _tracing
from ..utils.logging import Error, check
from ..utils.profiler import annotate
from . import wire

__all__ = ["DsServeBatches", "parse_dsserve_uri"]

_REG = _default_registry()
_RECV_WAIT = _REG.histogram(
    "dsserve.recv_wait_seconds",
    help="trainer-side wait for the next remote slot (secs)",
)
_RECONNECTS = _REG.counter(
    "dsserve.reconnects", help="client stream reconnect attempts"
)
_SHM_SLOTS = _REG.counter(
    "dsserve.shm_slots",
    help="slots received via the same-host shared-memory transport",
)
_TCP_SLOTS = _REG.counter(
    "dsserve.tcp_slots", help="slots received as TCP payload bytes"
)
_HELD_BYTES = _REG.gauge(
    "dsserve.held_bytes",
    help="peak lease-mode slot bytes buffered awaiting SHARD_FIN commit",
)

#: pooled recv buffers (and server shm slots) start on a page boundary
#: so an accelerator adoption path sees DMA-friendly alignment
_PAGE = 4096


def _hold_budget_bytes() -> int:
    """``DMLC_DSSERVE_HOLD_MB`` (default 256): cap on lease-mode slot
    bytes buffered client-side awaiting their SHARD_FIN commits, summed
    across endpoints. Backpressure, never drop: a stream over budget
    simply stops reading until another stream's commit frees bytes —
    TCP flow control (or the shm ring running out of free slots)
    propagates the stall to the server. The cap is a soft floor of one
    in-flight shard: the LARGEST holder always keeps reading, so two
    half-buffered shards can never deadlock each other. ``<= 0``
    disables the budget."""
    try:
        mb = float(os.environ.get("DMLC_DSSERVE_HOLD_MB", "256"))
    except ValueError:
        mb = 256.0
    return int(mb * (1 << 20)) if mb > 0 else 0


class _SlotPool:
    """Reusable page-aligned receive buffers — the recv-into path.

    ``get()`` hands out an aligned uint8 array carved over a pooled
    bank; a ``weakref.finalize`` on that array re-banks the memory when
    the LAST view over it dies. numpy collapses every sub-view's
    ``.base`` to the carved array itself (its own base is the bank's
    buffer, not an ndarray, so collapsing stops there), which makes the
    finalizer exact: it cannot fire while read_batch sections, a
    lease-buffered batch, or an in-flight staging transfer (whose
    source the staging pipeline keeps until the copy's event completes)
    still alias the bytes.

    Shared process-wide (module ``_POOL``): the bank size is the
    largest packed slot any stream has carried, so per-epoch client
    instances inherit warm banks instead of re-learning the slot size.
    Banks are ``bytearray``s, or page-locked host memory once a pinning
    is installed (``set_bank_allocator``); a bank carved before a change
    of size or of allocator retires when its last view dies."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._free: List = []
        self._cap = 0
        self._gen = 0  # bumped when the bank size or allocator changes
        self._alloc = bytearray
        self.banks = 0  # live banks ever carved (diagnostic)

    def _retire_free(self) -> None:
        self._gen += 1
        self.banks -= len(self._free)
        self._free.clear()

    def ensure(self, nbytes: int) -> None:
        """Grow the bank size to fit ``nbytes`` payloads. Undersized
        banks are dropped from the free list here and retire for good
        when their outstanding views die (their finalizers re-bank
        only banks of the CURRENT size)."""
        need = int(nbytes)
        with self._lock:
            if need > self._cap:
                self._cap = need
                self._retire_free()

    def set_bank_allocator(self, alloc) -> None:
        """``alloc(nbytes)`` → a writable buffer for each new bank
        (``bytearray`` by default); banks of the old allocator retire."""
        with self._lock:
            if alloc is not self._alloc:
                self._alloc = alloc
                self._retire_free()

    def take(self, nbytes: int) -> Optional[np.ndarray]:
        """``ensure(nbytes)`` then ``get()``: the frame reader's buffer
        for a payload whose size the header just named."""
        self.ensure(nbytes)
        return self.get()

    def get(self) -> Optional[np.ndarray]:
        """One aligned bank-sized buffer, or None before the first
        ``ensure()`` sized the pool."""
        with self._lock:
            if not self._cap:
                return None
            cap, gen = self._cap, self._gen
            mem = self._free.pop() if self._free else None
            if mem is None:
                mem = self._alloc(cap + _PAGE)
                self.banks += 1
        view = memoryview(mem)
        off = (-np.frombuffer(view, dtype=np.uint8).ctypes.data) % _PAGE
        # over the memoryview, not an array: ``out``'s base is then no
        # ndarray, so every sub-view's ``.base`` collapses to ``out``
        out = np.frombuffer(view, dtype=np.uint8, count=cap, offset=off)
        weakref.finalize(out, self._recycle, mem, gen)
        return out

    def _recycle(self, mem, gen: int) -> None:
        with self._lock:
            if gen == self._gen:
                self._free.append(mem)
            else:
                self.banks -= 1  # pool grew (or re-pinned) past this bank


#: process-wide pool — every DsServeBatches (one per epoch) shares it
_POOL = _SlotPool()

#: the host-memory pinning an adopting CUDA pipeline installed (None: none)
_PINNING = None
_PIN_LOCK = threading.Lock()
#: shm mappings whose views were still alive when their stream ended
_LINGER: List["_ShmMap"] = []


def set_host_pinning(pinning) -> None:
    """Install the page-locking an adopting CUDA staging pipeline asks
    for (process-wide, like the pool): ``pinning.bank(nbytes)`` returns
    a page-locked writable uint8 array for each new pool bank;
    ``pinning.register(addr, nbytes)`` page-locks a mapped shm segment,
    once, when it is first mapped, and ``pinning.unregister(addr)``
    releases it before the segment is unmapped. A failed registration
    raises: there is no pageable fallback."""
    global _PINNING
    with _PIN_LOCK:
        if pinning is _PINNING:
            return
        _PINNING = pinning
    _POOL.set_bank_allocator(bytearray if pinning is None else pinning.bank)


class HostPinningFailed(RuntimeError):
    """Page-locking a mapped shm segment failed. Not a transport fault:
    the endpoint does not degrade to TCP but fails, since an adopting
    CUDA pipeline has no pageable fallback."""


class _ShmMap:
    """One mapped shm segment of a stream and its page-locking: the
    registration is released before the mapping goes, and a mapping is
    closed only once no payload view over it (an in-flight copy's source
    included) is alive — until then it lingers, retried later."""

    __slots__ = ("seg", "addr", "pinning", "live", "_lock")

    def __init__(self, name: str) -> None:
        self.seg = ShmSegment(name)
        self.addr = 0
        self.pinning = None
        self.live = 0  # payload views handed out and not yet dead
        self._lock = threading.Lock()
        with _PIN_LOCK:
            pinning = _PINNING
        if pinning is not None and len(self.seg.buf):
            self.addr = int(np.frombuffer(
                self.seg.buf, dtype=np.uint8, count=1).ctypes.data)
            try:
                pinning.register(self.addr, len(self.seg.buf))
            except Exception as e:
                self.seg.close()
                raise HostPinningFailed(
                    f"dsserve: page-locking shm segment {name!r} failed: {e}"
                ) from e
            self.pinning = pinning

    def view(self, nbytes: int, sock, send_lock) -> np.ndarray:
        """A uint8 view of the slot; when its last alias dies the
        segment is acked back to the server's ring."""
        with self._lock:
            self.live += 1
        payload = np.frombuffer(self.seg.buf, dtype=np.uint8, count=nbytes)
        weakref.finalize(payload, self._view_died, sock, send_lock)
        return payload

    def _view_died(self, sock, send_lock) -> None:
        with self._lock:
            self.live -= 1
        _send_ack(sock, send_lock, self.seg.name)

    def try_close(self) -> bool:
        with self._lock:
            if self.live:
                return False
        # no view is alive, so no copy reads the segment any more
        if self.pinning is not None:
            try:
                self.pinning.unregister(self.addr)
            except Exception as e:
                raise HostPinningFailed(
                    f"dsserve: releasing shm segment {self.seg.name!r} "
                    f"failed: {e}") from e
            self.pinning = None
        try:
            self.seg.close()
        except BufferError:
            return False  # a dying view's export; closed on a retry
        return True


def _close_lingering() -> None:
    """Retry closing the mappings a finished stream left behind."""
    with _PIN_LOCK:
        todo = list(_LINGER)
        _LINGER.clear()
    keep = [m for m in todo if not m.try_close()]
    if keep:
        with _PIN_LOCK:
            _LINGER.extend(keep)


def _send_ack(sock, lock: threading.Lock, name: str) -> None:
    """finalize hook: the last view over a shm slot died — hand the
    segment back to the server's ring. Runs on whatever thread dropped
    the final reference, so the frame write is serialized by the
    per-connection send lock; a dead socket is fine (the server frees
    every segment at stream teardown anyway)."""
    try:
        with lock:
            wire.send_frame(sock, wire.KIND_OK, {"ack": name})
    except Exception:
        pass


def parse_dsserve_uri(uri: str) -> Tuple[List[Tuple[str, int]], str]:
    """``dsserve://h1:p1,h2:p2/<dataset-uri>`` → (endpoints, inner URI).

    The inner URI is whatever the servers should open: a bare path
    becomes absolute (``/data/x.rec``); a nested scheme
    (``dsserve://h:p/s3://...``) passes through untouched."""
    check(uri.startswith("dsserve://"), f"not a dsserve URI: {uri!r}")
    rest = uri[len("dsserve://"):]
    netloc, sep, inner = rest.partition("/")
    check(bool(sep) and bool(inner), f"dsserve URI has no dataset: {uri!r}")
    endpoints: List[Tuple[str, int]] = []
    for ep in netloc.split(","):
        host, colon, port = ep.rpartition(":")
        check(
            bool(colon) and port.isdigit() and bool(host),
            f"bad dsserve endpoint {ep!r} (need host:port)",
        )
        endpoints.append((host, int(port)))
    if "://" not in inner:
        inner = "/" + inner
    return endpoints, inner


class _CommitRefused(Error):
    """The tracker refused a shard_done (stale fileset signature, aged
    epoch). Retrying the STREAM cannot fix a protocol refusal — the
    endpoint goes terminal immediately instead of burning reconnect
    cycles re-streaming whole micro-shards (the same loud-stop the
    DynamicShardSource takes on a refused done)."""


class _EndpointState:
    __slots__ = (
        "slots", "bytes", "reconnects", "dead", "finished", "sock",
        "delivered", "shm_ok", "shm_slots", "tcp_slots",
    )

    def __init__(self) -> None:
        self.slots = 0
        self.bytes = 0
        self.reconnects = 0
        self.dead = False
        self.finished = False
        self.sock = None
        # static-mode resume point: slots already handed downstream on
        # this endpoint's stripe. Lives HERE (not a _drain_stream
        # local) so a connection dropping mid-stream cannot roll the
        # reconnect HELLO's start_seq back and re-deliver slots.
        self.delivered = 0
        # shm eligibility persists ACROSS reconnects: once a segment
        # fails (unlinked under us, probe mismatch) the endpoint stays
        # on TCP for the rest of this stream's life — the degrade is
        # one reconnect, never a flap loop
        self.shm_ok = True
        self.shm_slots = 0
        self.tcp_slots = 0


class DsServeBatches:
    """Remote packed-slot Batch stream over one or more dsserve servers.

    ``spec`` must match what the servers will produce (it is shipped in
    the HELLO and drives producer construction server-side). ``mode``
    defaults to ``lease`` when a tracker address is in the environment,
    else ``static``. One instance is one epoch (``epoch`` ctor arg) —
    the per-epoch construction mirror of the local producer path.

    Hooks (settable attributes, the DynamicShardSource idiom):
    ``on_slot(shard, seq, payload)`` fires per DELIVERED slot,
    ``on_shard_done(shard, status)`` after this client's commit is
    acked (``recorded`` | ``duplicate``) — tests and bench hash
    per-shard payload bytes from these for end-to-end identity.
    """

    #: producer-contract hint (staging/pipeline.py): delivered batches
    #: sit in stable page-aligned buffers (pooled recv banks or shm
    #: segments) that stay alive until every view dies, so the pipeline
    #: may skip its dispatch_pack copy and copy ``batch.packed`` to the
    #: device directly — the received slot IS the staging slot
    adopt_slots = True

    def __init__(
        self,
        uri: str,
        spec: BatchSpec,
        epoch: int = 0,
        format: str = "auto",
        mode: Optional[str] = None,
        prefetch: int = 8,
        connect_timeout: float = 10.0,
        rank: Optional[int] = None,
    ) -> None:
        self.endpoints, self.inner_uri = parse_dsserve_uri(uri)
        self.spec = spec
        self.epoch = int(epoch)
        self.format = format
        if mode is None:
            mode = (
                "lease" if os.environ.get("DMLC_TRACKER_URI") else "static"
            )
        check(mode in ("lease", "static"), f"bad dsserve mode {mode!r}")
        self.mode = mode
        self._connect_timeout = connect_timeout
        ispec = URISpec(self.inner_uri, 0, 1)
        index_uri = str(ispec.args["index"]) if "index" in ispec.args else ""
        fmt = str(
            ispec.args.get("format", format if format != "auto" else "rowrec")
        )
        # the type string must resolve exactly as io_split.create()
        # resolves it (an ?index= promotes recordio to indexed_recordio
        # there BEFORE signing), so dsserve consumers and
        # dynamic-shard workers sharing one tracker sign the same
        # dataset identically and neither is refused
        if fmt == "rowrec":
            src_type = "indexed_recordio" if index_uri else "recordio"
        else:
            src_type = "text"
        self.fileset = fileset_signature(ispec.uri, index_uri, src_type)
        self._lease_client = None
        if mode == "lease":
            from ..tracker.shardsvc import ShardLeaseClient

            try:
                self._lease_client = ShardLeaseClient(rank=rank)
            except KeyError as e:
                raise Error(
                    "dsserve lease mode needs a tracker: set "
                    f"DMLC_TRACKER_URI/DMLC_TRACKER_PORT (missing {e})"
                ) from None
        self._out: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._kill = threading.Event()
        self._commit_lock = threading.Lock()
        # lease-mode hold accounting (DMLC_DSSERVE_HOLD_MB): bytes of
        # slots buffered awaiting commit, total and per endpoint
        self._hold_budget = _hold_budget_bytes()
        self._held = 0
        self._held_by: Dict[int, int] = {}
        self._held_cv = threading.Condition()
        self._eps = [_EndpointState() for _ in self.endpoints]
        self.shards_recorded = 0
        self.shards_duplicate = 0
        self.recv_wait_secs = 0.0
        self.on_slot = None
        self.on_shard_done = None
        self._threads: List[threading.Thread] = []
        self._eps_lock = threading.Lock()
        for i in range(len(self.endpoints)):
            t = threading.Thread(
                target=self._run_endpoint,
                args=(i,),
                daemon=True,
                name=f"dsserve-recv-{i}",
            )
            self._threads.append(t)
            t.start()
        # elastic-tier discovery (lease mode only): the launcher
        # maintains an endpoints file that the autoscale controller's
        # scale-ups rewrite; polling it lets a mid-epoch spawn start
        # streaming THIS epoch instead of idling until the next one
        self._disco_thread: Optional[threading.Thread] = None
        self._disco_path = os.environ.get("DMLC_DSSERVE_FILE", "")
        if mode == "lease" and self._disco_path:
            t = threading.Thread(
                target=self._discover_loop,
                daemon=True,
                name="dsserve-discover",
            )
            self._disco_thread = t
            t.start()

    # -- elastic discovery ---------------------------------------------------
    def _discover_loop(self) -> None:
        """Poll ``DMLC_DSSERVE_FILE`` (atomically rewritten by the tier
        on every scale-up/retire) and dial every endpoint not already
        streamed. Membership only ever GROWS here: a retired server
        ends its own streams with a retired EPOCH_END, and the ledger
        re-serves anything it released — removal needs no client-side
        action (docs/autoscale.md)."""
        while True:
            try:
                with open(self._disco_path) as f:
                    eps = json.load(f).get("endpoints", [])
            except (OSError, ValueError):
                eps = []  # mid-rewrite or not yet written; next poll
            if isinstance(eps, list):
                for ep in eps:
                    host, colon, port = str(ep).rpartition(":")
                    if colon and host and port.isdigit():
                        self._add_endpoint(host, int(port))
            # scan-first ordering: an epoch constructed AFTER a scale-up
            # dials the grown fleet immediately, not a poll later
            if self._kill.wait(0.5):
                return

    def _add_endpoint(self, host: str, port: int) -> None:
        with self._eps_lock:
            if (host, port) in self.endpoints:
                return
            i = len(self.endpoints)
            # append order matters: __iter__'s end condition re-reads
            # len(self.endpoints), so the state slot must exist before
            # the list grows past it
            self._eps.append(_EndpointState())
            self.endpoints.append((host, port))
        t = threading.Thread(
            target=self._run_endpoint,
            args=(i,),
            daemon=True,
            name=f"dsserve-recv-{i}",
        )
        self._threads.append(t)
        t.start()

    # -- connection machinery ------------------------------------------------
    def _hello(self, i: int, start_seq: int) -> Dict:
        s = self.spec
        meta: Dict = {
            "uri": self.inner_uri,
            "format": self.format,
            "epoch": self.epoch,
            "mode": self.mode,
            "fileset": self.fileset,
            "spec": {
                "batch_size": s.batch_size,
                "layout": s.layout,
                "max_nnz": s.max_nnz,
                "num_features": s.num_features,
                "overflow": s.overflow,
                "index_dtype": str(s.index_dtype),
                "value_dtype": str(s.value_dtype),
            },
        }
        if self.mode == "static":
            meta["part"] = i
            meta["nparts"] = len(self.endpoints)
            meta["start_seq"] = start_seq
        if (
            self._eps[i].shm_ok
            and shm_transport_enabled()
            and shm_available()
        ):
            # same-host offer: the server compares host + uid against
            # its own before offering a probe segment, and a stream
            # that never offers is plain TCP (absent keys are how old
            # clients and hand-rolled test HELLOs opt out)
            meta["shm"] = True
            meta["host"] = socket.gethostname()
            meta["uid"] = os.getuid() if hasattr(os, "getuid") else -1
        return meta

    def _confirm_shm(self, i: int, sock, ok_meta: Dict) -> None:
        """Second leg of the shm handshake: map the server's probe
        segment, verify the magic it wrote, answer with the verdict.
        Both sides prove they share a shm namespace — a hostname
        collision across containers fails the read here, harmlessly,
        and the stream runs TCP."""
        st = self._eps[i]
        ok = False
        try:
            seg = ShmSegment(str(ok_meta["shm_probe"]))
            try:
                magic = wire.SHM_MAGIC
                ok = bytes(seg.buf[: len(magic)]) == magic
            finally:
                seg.close()
        except (OSError, ValueError, KeyError):
            ok = False
        if not ok:
            st.shm_ok = False  # stop offering on reconnects
        wire.send_frame(sock, wire.KIND_OK, {"shm": bool(ok)})

    def _connect(self, i: int, start_seq: int):
        host, port = self.endpoints[i]
        sock = socket.create_connection(
            (host, port), timeout=self._connect_timeout
        )
        try:
            hello = self._hello(i, start_seq)
            # causal link: the server's stream-setup handler span binds
            # to this client's connect (telemetry/tracing.py flows)
            tc = _tracing.rpc_context()
            if tc:
                hello["tc"] = tc
            wire.send_frame(sock, wire.KIND_HELLO, hello)
            kind, meta, _p, _s, _e = wire.recv_frame(sock)
            if kind == wire.KIND_ERROR:
                raise Error(
                    f"dsserve server {host}:{port} refused the stream: "
                    f"{meta.get('error')}"
                )
            if kind != wire.KIND_OK:
                raise Error(f"dsserve: expected OK, got frame kind {kind}")
            if "shm_probe" in meta:
                self._confirm_shm(i, sock, meta)
            sock.settimeout(None)
            return sock
        except BaseException:
            sock.close()
            raise

    def _put(self, item) -> bool:
        """Bounded put that stays responsive to close()."""
        while not self._kill.is_set():
            try:
                self._out.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- lease-mode hold budget (DMLC_DSSERVE_HOLD_MB) -----------------------
    def _hold_add(self, i: int, n: int) -> None:
        with self._held_cv:
            self._held += n
            self._held_by[i] = self._held_by.get(i, 0) + n
            _HELD_BYTES.set_max(self._held)

    def _hold_release(self, i: int, n: int) -> None:
        if n <= 0:
            return
        with self._held_cv:
            self._held -= n
            self._held_by[i] = self._held_by.get(i, 0) - n
            self._held_cv.notify_all()

    def _hold_wait(self, i: int) -> None:
        """Park this stream while the hold budget is blown AND some
        other endpoint holds more than we do. The largest holder never
        waits — it is the stream a commit is nearest on — so progress
        is guaranteed and the budget degrades to a soft floor of one
        in-flight shard rather than a deadlock of mutually-parked
        half-buffered shards."""
        if not self._hold_budget:
            return
        with self._held_cv:
            while (
                not self._kill.is_set()
                and self._held > self._hold_budget
                and self._held_by.get(i, 0)
                < max(self._held_by.values() or (0,))
            ):
                self._held_cv.wait(0.1)

    def _commit_shard(self, shard: int, pending: List) -> None:
        """The exactly-once decision point: this client's ``shard_done``
        is the cluster-wide commit; deliver on ``recorded``, drop on
        ``duplicate`` (another stream already delivered this shard)."""
        if self._kill.is_set():
            return  # never commit work the consumer abandoned
        status = "recorded"
        complete = False
        # pending may legitimately be EMPTY: an oversplit beyond the
        # file's record count makes some micro-shards zero-row, and
        # they must still be committed or the epoch ledger never
        # completes (the DynamicShardSource commits them the same way)
        # commit AND delivery under one lock: (a) two connections
        # finishing the same (stolen) shard resolve through the tracker
        # one at a time so exactly one delivers; (b) when the ledger
        # answers epoch_complete, every previously recorded shard's
        # batches are already queued — the epoch-done sentinel below is
        # therefore ordered after ALL deliveries, and the main iterator
        # can finish on it instead of waiting out the servers' next
        # lease poll (the EPOCH_END frames trail by a backoff cycle)
        with self._commit_lock:
            if self._lease_client is not None:
                resp = self._lease_client.done(
                    self.epoch, shard, self.fileset
                )
                status = resp.get("status", "error")
                if status not in ("recorded", "duplicate"):
                    raise _CommitRefused(
                        f"tracker refused shard_done for micro-shard "
                        f"{shard} (epoch {self.epoch}): "
                        f"{resp.get('error', resp)}"
                    )
                complete = bool(resp.get("epoch_complete"))
            if status == "recorded":
                self.shards_recorded += 1
                for batch, seq, tc in pending:
                    if self.on_slot is not None:
                        self.on_slot(shard, seq, batch.packed)
                    if not self._put(("batch", batch, tc)):
                        return
            else:
                self.shards_duplicate += 1
        if self.on_shard_done is not None:
            self.on_shard_done(shard, status)
        if complete:
            self._put(("epoch_done",))

    def _run_endpoint(self, i: int) -> None:
        st = self._eps[i]
        policy = RetryPolicy()
        stalls = 0  # consecutive failed connect/stream cycles
        try:
            while not self._kill.is_set():
                try:
                    sock = self._connect(i, st.delivered)
                except Exception as e:
                    if not (is_transient(e) or isinstance(e, OSError)):
                        raise
                    stalls += 1
                    st.reconnects += 1
                    _RECONNECTS.inc()
                    if stalls >= policy.max_attempts:
                        raise
                    policy.pause(cause=e, what=f"dsserve connect #{i}")
                    continue
                st.sock = sock
                slots_before = st.slots
                try:
                    self._drain_stream(i, sock)
                    return  # EPOCH_END
                except (OSError, ConnectionError, Error) as e:
                    if self._kill.is_set():
                        return
                    if isinstance(e, _CommitRefused) or not (
                        is_transient(e) or isinstance(e, Error)
                    ):
                        raise
                    if st.slots > slots_before:
                        # real progress this cycle — like
                        # RetryingReadStream, the cap bounds STUCK
                        # retries, not total faults healed (a blanket
                        # reset on a mere successful HELLO would make
                        # the cap unreachable for a server that dies
                        # deterministically after accepting)
                        stalls = 0
                    # partial-shard state died with the connection (a
                    # crc mismatch or reset makes the stream unusable
                    # from that byte on); lease mode re-serves via the
                    # ledger, static mode resumes at the delivered count
                    stalls += 1
                    st.reconnects += 1
                    _RECONNECTS.inc()
                    if stalls >= policy.max_attempts:
                        raise
                    policy.pause(cause=e, what=f"dsserve stream #{i}")
                finally:
                    st.sock = None
                    try:
                        sock.close()
                    except OSError:
                        pass
        except Exception as e:  # terminal for this endpoint
            st.dead = True
            self._put(("err", e, i))
        finally:
            if not st.dead:
                st.finished = True
                self._put(("end", i))

    def _shm_payload(
        self, i: int, sock, send_lock, segs: Dict[str, "_ShmMap"],
        desc: Dict,
    ) -> np.ndarray:
        """A shm slot descriptor → zero-copy uint8 view over the named
        segment. The finalize on the view sends the segment-reuse ack
        when the last alias dies (read_batch sections collapse their
        ``.base`` to this array). ANY failure marks the endpoint
        TCP-only and raises a transient ``Error`` — the reconnect
        HELLO then negotiates plain TCP and the ledger (lease mode) or
        start_seq (static) re-serves what the drop stranded: the
        silent-degrade contract. A failed page-locking is no transport
        fault: ``HostPinningFailed`` fails the endpoint."""
        st = self._eps[i]
        try:
            name = str(desc["seg"])
            nbytes = int(desc["nbytes"])
        except (KeyError, TypeError, ValueError) as e:
            raise Error(f"dsserve: bad shm slot descriptor: {e}") from e
        try:
            m = segs.get(name)
            if m is None:
                _close_lingering()
                m = _ShmMap(name)
                segs[name] = m
            seg = m.seg
            if not 0 <= nbytes <= len(seg.buf):
                raise Error(
                    f"dsserve: shm slot claims {nbytes} bytes but segment "
                    f"{name!r} holds {len(seg.buf)}"
                )
        except (OSError, ValueError, Error) as e:
            st.shm_ok = False
            raise Error(
                f"dsserve: shm transport failed ({e}); degrading this "
                "endpoint to TCP"
            ) from e
        return m.view(nbytes, sock, send_lock)

    def _drain_stream(self, i: int, sock) -> None:
        """Pump one connection until EPOCH_END. Lease-mode slots buffer
        per shard until SHARD_FIN commits them (a FIN with zero slots
        is a legitimately EMPTY micro-shard and is committed too);
        static-mode slots deliver immediately (their stripe is
        exclusively this endpoint's, the delivered count is the resume
        point).

        Slot payloads land zero-copy: TCP frames ``recv_into`` a pooled
        page-aligned bank (``_SlotPool``), shm frames map the server's
        segment in place — either way ``read_batch`` aliases the bytes
        where they already are and nothing is memcpy'd client-side."""
        st = self._eps[i]
        pending: List = []
        pending_shard: Optional[int] = None
        held = 0  # bytes in `pending`, re-released on commit or death
        segs: Dict[str, _ShmMap] = {}
        send_lock = threading.Lock()  # serializes finalize-thread acks
        try:
            while not self._kill.is_set():
                self._hold_wait(i)
                # the pooled bank is picked once the header names the
                # payload's size; the payload view is its only keep-alive
                kind, meta, payload, seq, _epoch = wire.read_frame_into(
                    sock, _POOL.take
                )
                if kind == wire.KIND_SLOT:
                    shm_desc = meta.get("shm")
                    if shm_desc is not None:
                        payload = self._shm_payload(
                            i, sock, send_lock, segs, shm_desc
                        )
                        st.shm_slots += 1
                        _SHM_SLOTS.inc()
                    else:
                        st.tcp_slots += 1
                        _TCP_SLOTS.inc()
                    batch = wire.read_batch(meta, payload)
                    shard = int(meta.get("shard", -1))
                    st.slots += 1
                    st.bytes += payload.nbytes
                    if self.mode == "lease":
                        if pending_shard is None:
                            pending_shard = shard
                        elif shard != pending_shard:
                            raise Error(
                                f"dsserve: interleaved shards on one "
                                f"stream ({pending_shard} then {shard})"
                            )
                        pending.append((batch, seq, meta.get("tc")))
                        self._hold_add(i, payload.nbytes)
                        held += payload.nbytes
                    else:
                        if self.on_slot is not None:
                            self.on_slot(shard, seq, batch.packed)
                        if not self._put(("batch", batch, meta.get("tc"))):
                            return
                        st.delivered += 1
                    del batch, payload
                elif kind == wire.KIND_SHARD_FIN:
                    shard = int(meta.get("shard", -1))
                    if self.mode == "lease":
                        if (
                            pending_shard is not None
                            and shard != pending_shard
                        ):
                            raise Error(
                                f"dsserve: SHARD_FIN for {shard} while "
                                f"shard {pending_shard} is in flight"
                            )
                        self._commit_shard(shard, pending)
                        self._hold_release(i, held)
                        held = 0
                    pending = []
                    pending_shard = None
                elif kind == wire.KIND_EPOCH_END:
                    return
                elif kind == wire.KIND_ERROR:
                    raise Error(
                        f"dsserve server error: {meta.get('error', meta)!r}"
                    )
                else:
                    raise Error(f"dsserve: unexpected frame kind {kind}")
        finally:
            # stranded pending bytes die with the connection (the
            # ledger re-serves the shard) — free their budget now
            del pending
            self._hold_release(i, held)
            # a mapping with live views (queued batches, an in-flight
            # copy's source) lingers until a later retry finds none
            late = [m for m in segs.values() if not m.try_close()]
            if late:
                with _PIN_LOCK:
                    _LINGER.extend(late)

    # -- producer contract ---------------------------------------------------
    def __iter__(self) -> Iterator[Batch]:
        """Interleave delivered slots from every endpoint; ends when
        every endpoint thread reported end-of-epoch or terminal
        failure. Lease mode tolerates dead endpoints as long as at
        least one stream saw EPOCH_END (the ledger re-served the dead
        stream's shards — that IS the failover); static mode cannot
        (a stripe has exactly one home without a ledger)."""
        check(
            not getattr(self, "_iterated", False),
            "DsServeBatches is a one-epoch stream: construct a new "
            "instance (epoch=N) for the next epoch",
        )
        self._iterated = True
        # drained by a CUDA pipeline that copies directly: page-lock what
        # the pool carves and the shm segments mapped from now on
        pinning = current_host_pinning()
        if pinning is not None:
            set_host_pinning(pinning)
        ended = 0
        errors: List = []
        while ended < len(self.endpoints):
            t0 = time.perf_counter()
            with annotate("dmlc:dsserve_recv_wait"):
                item = self._out.get()
                if item[0] == "batch" and len(item) > 2:
                    # land the server's slot flow INSIDE the wait span:
                    # the merged timeline shows which remote stream
                    # produced the slot this consumer was starved for
                    _tracing.handler_flow(item[2])
            dt = time.perf_counter() - t0
            self.recv_wait_secs += dt
            _RECV_WAIT.observe(dt)
            if item[0] == "batch":
                yield item[1]
            elif item[0] == "epoch_done":
                # the ledger is fully accounted and (by the commit-lock
                # ordering) every delivered batch precedes this
                # sentinel — don't wait out the streams' EPOCH_END
                # frames; close() reaps the receiver threads
                return
            elif item[0] == "end":
                ended += 1
            else:  # ("err", exc, idx)
                ended += 1
                errors.append(item[1])
        if errors:
            finished = sum(1 for s in self._eps if s.finished)
            if finished == 0:
                raise Error(
                    f"every dsserve endpoint failed: {errors[0]}"
                ) from errors[0]
            if self.mode == "static":
                raise Error(
                    "dsserve static stripe lost (no failover without a "
                    f"tracker): {errors[0]}"
                ) from errors[0]

    def io_stats(self) -> Dict[str, object]:
        return {
            "mode": f"dsserve:{self.mode}",
            "endpoints": len(self.endpoints),
            "endpoints_dead": sum(1 for s in self._eps if s.dead),
            "slots": sum(s.slots for s in self._eps),
            "bytes_recv": sum(s.bytes for s in self._eps),
            "reconnects": sum(s.reconnects for s in self._eps),
            "shards_recorded": self.shards_recorded,
            "shards_duplicate": self.shards_duplicate,
            "recv_wait_secs": round(self.recv_wait_secs, 4),
            "shm_slots": sum(s.shm_slots for s in self._eps),
            "tcp_slots": sum(s.tcp_slots for s in self._eps),
            "recv_alloc_bytes": wire.recv_alloc_bytes(),
            "pool_banks": _POOL.banks,
        }

    def close(self) -> None:
        self._kill.set()
        # break receivers out of a blocking recv (a parked stream —
        # e.g. its server waiting out a lease backoff — never notices
        # the kill flag otherwise)
        for st in self._eps:
            sock = st.sock
            if sock is not None:
                try:
                    sock.close()
                except OSError:
                    pass
        # unblock any receiver parked in a bounded put
        while True:
            try:
                self._out.get_nowait()
            except queue.Empty:
                break
        for t in self._threads:
            t.join(timeout=2.0)
        if self._disco_thread is not None:
            self._disco_thread.join(timeout=2.0)
            self._disco_thread = None
        _close_lingering()
