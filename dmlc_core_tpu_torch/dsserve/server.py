"""dsserve server: a standalone preprocessing worker streaming packed slots
(the port of ``dmlc_core_tpu/dsserve/server.py``; its producers are the
port's own ``staging/fused.py`` ``ell_batches`` / ``dense_batches``).

One :class:`DsServeServer` process runs the repo's existing
fetch→decode→gather-parse→pack pipeline (staging/fused.py producers —
the same code the trainer would run locally) and serves the finished
packed slots to connected trainers over the wire framing
(dsserve/wire.py). Per client stream:

- **lease mode** (a tracker is running): the server is a plain
  leaseholder — it pulls micro-shard leases from the tracker's shard
  service (``ShardLeaseClient``), opens the standard per-shard producer
  (bit-identical shard content: a micro-shard IS ``(part_index=i,
  num_parts=M)`` of the static planner), streams each produced slot,
  and marks the shard's stream complete with a SHARD_FIN frame. It
  never calls ``shard_done`` — the CLIENT commits, so delivery and
  exactly-once accounting are the same decision and a server killed
  after streaming-but-before-commit costs nothing but a lease TTL
  (docs/dsserve.md "commit protocol").
- **static mode** (no tracker): the HELLO pins ``(part, nparts)`` and
  an optional ``start_seq`` — the reopen-and-seek resume point: the
  deterministic producer is re-run and the first ``start_seq`` slots
  are skipped, the streaming analogue of ``RetryingReadStream``'s
  reopen-at-offset.

Production overlaps the socket send through a bounded ThreadedIter
(``DMLC_DSSERVE_QUEUE`` slots ahead), observable as the
``dsserve.queue_depth`` gauge; ``dsserve.{slots_served,bytes,clients}``
count the serving side (docs/observability.md).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
from typing import Dict, Optional

import numpy as np

from ..concurrency.threaded_iter import ThreadedIter
from ..io.codec import available_codecs, get_codec
from ..io.shm import ShmSegment, shm_available, shm_transport_enabled
from ..staging.batcher import BatchSpec
from ..telemetry import default_registry as _default_registry
from ..telemetry import tracing as _tracing
from ..tracker.protocol import make_listener
from ..utils.logging import Error
from ..utils.profiler import annotate
from . import wire

__all__ = ["DsServeServer", "default_queue_depth"]

logger = logging.getLogger("dmlc_core_tpu_torch.dsserve")

_REG = _default_registry()
_SLOTS = _REG.counter(
    "dsserve.slots_served", help="packed slots streamed to clients"
)
_BYTES = _REG.counter(
    "dsserve.bytes", help="packed payload bytes streamed to clients"
)
_CLIENTS = _REG.gauge(
    "dsserve.clients", help="live client stream connections"
)
_QDEPTH = _REG.gauge(
    "dsserve.queue_depth", help="produced-but-unsent slots (all streams)"
)


def default_queue_depth() -> int:
    """``DMLC_DSSERVE_QUEUE`` (default 4): slots produced ahead of the
    socket send per stream. Bounded well inside the producer ring
    (``ring_slots`` ≥ depth + 3) so a slot is never recycled while it
    sits unsent."""
    try:
        return max(1, int(os.environ.get("DMLC_DSSERVE_QUEUE", "4")))
    except ValueError:
        return 4


def default_send_timeout() -> float:
    """``DMLC_DSSERVE_SEND_TIMEOUT`` seconds (default 300): how long a
    slot send may block before the stream is failed loudly. TCP never
    errors against a live-but-paused peer (SIGSTOP'd trainer, full
    receive buffer), so without a deadline a stalled client wedges the
    stream thread, its producer and its buffered slots forever on a
    long-lived shared tier — the RabitWorker link-deadline idiom
    applied to the serving side. Teardown releases the stream's leases,
    so a failed stream costs the stalled client a reconnect, never the
    epoch."""
    try:
        return max(
            1.0, float(os.environ.get("DMLC_DSSERVE_SEND_TIMEOUT", "300"))
        )
    except ValueError:
        return 300.0


_PAGE = 4096  # shm ring slots are page-multiples (client adoption path)

#: spanfetch's AIMD bandwidth-sample window: the wire compressor
#: re-evaluates its compress/plain decision on the same cadence
_REEVAL_WINDOW = 8


def _shm_ring_slots() -> int:
    """``DMLC_DSSERVE_SHM_SLOTS`` (default 8): single-slot shm segments
    per stream. Bounds same-host memory at ring × slot bytes; when the
    client buffers more unacked slots than the ring holds, overflow
    slots travel inline over TCP — backpressure by fallback, never a
    deadlock."""
    try:
        return max(1, int(os.environ.get("DMLC_DSSERVE_SHM_SLOTS", "8")))
    except ValueError:
        return 8


def _shm_break_after() -> int:
    """``DMLC_DSSERVE_SHM_BREAK_AFTER`` (default 0 = off): chaos knob —
    after N shm slots on a stream, every further shm descriptor names a
    segment that was never created, so the client's ``shm_open``
    ENOENTs and the degrade-to-TCP path is exercised deterministically
    (the shm analogue of DMLC_DSSERVE_KILL_AFTER_SLOTS)."""
    try:
        return max(
            0, int(os.environ.get("DMLC_DSSERVE_SHM_BREAK_AFTER", "0") or 0)
        )
    except ValueError:
        return 0


class _ShmRing:
    """Per-stream ring of single-slot POSIX shm segments.

    Each in-flight slot occupies ONE whole segment: the client tracks
    slot liveness with a single finalizer per mapped segment and acks
    it (an OK frame naming the segment) when the last view dies; only
    an acked segment is rewritten. Segments are cut lazily at the first
    send of each size generation — a bigger slot retires the free list
    and starts a new generation under fresh names, so a stale
    descriptor can never alias resized memory. ``slot_for`` never
    blocks: a ring with no free segment returns None and the caller
    ships that slot inline over TCP, which is what makes a client
    buffering more than ring-many slots safe rather than deadlocked.

    Teardown unlinks every segment; a client still holding views keeps
    its private mappings alive (POSIX semantics) and simply never
    re-opens the names."""

    def __init__(self, limit: int, break_after: int) -> None:
        self._lock = threading.Lock()
        self._free: list = []
        self._busy: Dict[str, ShmSegment] = {}
        self._segsize = 0
        self._limit = max(1, limit)
        self._made = 0
        # decimal pid + random suffix: unique across live processes AND
        # across restarts of the same pid slot (crashed owners leak
        # their names until cleanup; fresh names never collide with
        # them)
        self._prefix = (
            f"dmlc-dss-{os.getpid()}-{int.from_bytes(os.urandom(4), 'big')}"
        )
        self.break_after = break_after
        self.shm_sent = 0
        self.tcp_fallbacks = 0

    def _next_name(self) -> str:
        self._made += 1
        return f"{self._prefix}-{self._made}"

    def make_probe(self) -> ShmSegment:
        """Handshake probe: a one-page segment carrying SHM_MAGIC the
        client must read back. Caller closes + unlinks it once the
        confirmation frame lands."""
        with self._lock:
            name = self._next_name()
        seg = ShmSegment(name, create=True, size=_PAGE)
        seg.buf[: len(wire.SHM_MAGIC)] = wire.SHM_MAGIC
        return seg

    def slot_for(self, payload) -> Optional[str]:
        """Copy ``payload`` into a free segment and return its name;
        None = ring exhausted, send this slot over TCP."""
        view = memoryview(payload).cast("B")
        n = len(view)
        with self._lock:
            if self.break_after and self.shm_sent >= self.break_after:
                self.shm_sent += 1
                return self._next_name()  # never created: client ENOENTs
            need = -(-max(n, 1) // _PAGE) * _PAGE
            if need > self._segsize:
                for seg in self._free:
                    self._retire(seg)
                self._free = []
                self._segsize = need
            if self._free:
                seg = self._free.pop()
            elif len(self._busy) < self._limit:
                try:
                    seg = ShmSegment(
                        self._next_name(), create=True, size=self._segsize
                    )
                except (OSError, ValueError):
                    self.tcp_fallbacks += 1
                    return None
            else:
                self.tcp_fallbacks += 1
                return None
            self._busy[seg.name] = seg
        seg.buf[:n] = view
        self.shm_sent += 1
        return seg.name

    def release(self, name: str) -> None:
        """Client ack: the segment may be rewritten (or retired, if the
        ring's size generation moved past it)."""
        with self._lock:
            seg = self._busy.pop(name, None)
            if seg is None:
                return
            if len(seg.buf) == self._segsize:
                self._free.append(seg)
            else:
                self._retire(seg)

    @staticmethod
    def _retire(seg: ShmSegment) -> None:
        try:
            seg.close()
            seg.unlink()
        except (OSError, BufferError):
            pass

    def close(self) -> None:
        with self._lock:
            for seg in self._free:
                self._retire(seg)
            for seg in self._busy.values():
                self._retire(seg)
            self._free = []
            self._busy = {}


class _SendThrottle:
    """``DMLC_DSSERVE_WIRE_BPS`` (default 0 = off): deterministic
    egress pacing — sleeps after each send so the stream's average wire
    rate tracks the configured bytes/sec. A bench instrument: it turns
    loopback into a reproducible slow link so the adaptive wire
    compressor's low-bandwidth win is measurable, and because the pace
    is charged on bytes ACTUALLY sent, compressed slots genuinely
    clear the link sooner."""

    def __init__(self) -> None:
        try:
            self.bps = float(
                os.environ.get("DMLC_DSSERVE_WIRE_BPS", "0") or 0
            )
        except ValueError:
            self.bps = 0.0
        self._debt = 0.0
        self._last = time.monotonic()

    def pace(self, nbytes: int) -> None:
        if self.bps <= 0 or nbytes <= 0:
            return
        now = time.monotonic()
        self._debt = (
            max(0.0, self._debt - (now - self._last)) + nbytes / self.bps
        )
        self._last = now
        if self._debt > 0.001:
            time.sleep(self._debt)


class _WireCompressor:
    """Per-connection adaptive SLOT compression (io/codec.py codecs).

    ``DMLC_DSSERVE_WIRE_CODEC``: ``off`` disables, a codec name pins
    the codec, ``auto`` (default) picks zstd when installed, else zlib
    — in every enabled mode the COMPRESS/plain decision stays measured
    and per-connection. The decision: compress while

        n/codec_bps + (n × ratio)/wire_bps  <  0.97 × n/wire_bps

    i.e. codec time plus the smaller send beats the plain send with 3%
    hysteresis, using a wire-bandwidth EWMA over the bytes each send
    actually put on the wire. Re-evaluated every ``_REEVAL_WINDOW``
    sends — spanfetch's AIMD sampling cadence — so a link that speeds
    up (or a payload mix that stops compressing) flips the stream back
    to plain within a window, no knob change.

    Codec throughput and payload ratio are properties of the CPU and
    the slot mix, not the connection, so their estimates live in a
    process-wide table (``_shared``): while a stream compresses, every
    real compression refreshes them for free; while every stream ships
    plain, one ``_PROBE_CAP``-capped probe per ``_PROBE_TTL`` seconds
    keeps them from going stale. A fresh connection therefore pays at
    most one small probe EVER before its first decision (at send
    ``_REEVAL_WINDOW``, once the wire EWMA has samples) — short
    streams on a fast wire ride plain at plain's cost, which is what
    keeps the high-bandwidth path inside its 3% regression budget."""

    #: probe compressions run on at most this payload prefix: the cost
    #: of estimating on a stream that will DECLINE must stay trivial
    _PROBE_CAP = 128 * 1024
    #: while no stream compresses, re-probe (refresh ratio/throughput)
    #: at most this often per process
    _PROBE_TTL = 5.0
    #: codec name -> (codec_bps, ratio, measured_at) across connections
    _shared: Dict[str, tuple] = {}

    def __init__(self) -> None:
        name = (
            os.environ.get("DMLC_DSSERVE_WIRE_CODEC", "auto")
            .strip()
            .lower()
        )
        self._codec = None
        if name not in ("", "off", "0", "none", "raw"):
            try:
                if name == "auto":
                    pick = (
                        "zstd" if "zstd" in available_codecs() else "zlib"
                    )
                    self._codec = get_codec(pick)
                else:
                    self._codec = get_codec(name)
            except Error:
                self._codec = None  # unknown/unavailable: plain wire
        self._wire_bps = 0.0
        self._codec_bps = 0.0
        self._ratio = 1.0
        self._sends = 0
        self._on = False
        self.compressed_sends = 0

    def observe_send(self, nbytes: int, secs: float) -> None:
        """EWMA over wire throughput as actually experienced (pacing
        included) — compressed sends count their WIRE bytes, so the
        estimate stays live in either regime."""
        if secs <= 0 or nbytes <= 0:
            return
        bps = nbytes / secs
        self._wire_bps = (
            bps
            if self._wire_bps == 0.0
            else 0.8 * self._wire_bps + 0.2 * bps
        )

    def _decide(self, n: int) -> None:
        if self._wire_bps <= 0 or self._codec_bps <= 0:
            self._on = False
            return
        plain = n / self._wire_bps
        with_codec = n / self._codec_bps + (n * self._ratio) / self._wire_bps
        self._on = self._ratio < 1.0 and with_codec < 0.97 * plain

    def maybe_compress(self, payload):
        """payload → (wire_payload, meta_extra, flags). Re-decides on
        the window cadence from the connection's wire EWMA plus the
        shared codec estimates (probing only when those are missing or
        stale), then applies the standing decision — a compressed send
        doubles as a full-payload estimate refresh."""
        if self._codec is None:
            return payload, None, 0
        n = payload.nbytes
        idx = self._sends
        self._sends += 1
        if n <= 0:
            return payload, None, 0
        # decision cadence: send 0 of a fresh connection has no wire
        # samples yet, so the first window always ships plain and just
        # measures — by send _REEVAL_WINDOW the EWMA is live
        if idx % _REEVAL_WINDOW == 0 and idx > 0:
            stats = _WireCompressor._shared.get(self._codec.name)
            now = time.monotonic()
            if stats is None or (
                not self._on and now - stats[2] > self._PROBE_TTL
            ):
                # capped probe: the head-of-slot prefix skews the ratio
                # estimate toward whichever section leads, but the 3%
                # hysteresis plus the free full-payload refresh once
                # compressing bounds what a biased estimate can cost
                probe = bytes(memoryview(payload[: self._PROBE_CAP]))
                t0 = time.monotonic()
                clen = len(self._codec.compress(probe))
                dt = max(time.monotonic() - t0, 1e-9)
                stats = (len(probe) / dt, clen / max(len(probe), 1), now)
                _WireCompressor._shared[self._codec.name] = stats
            self._codec_bps, self._ratio = stats[0], stats[1]
            self._decide(n)
        if not self._on:
            return payload, None, 0
        t0 = time.monotonic()
        comp = self._codec.compress(bytes(memoryview(payload)))
        dt = max(time.monotonic() - t0, 1e-9)
        prev = _WireCompressor._shared.get(self._codec.name)
        bps, ratio = n / dt, len(comp) / n
        if prev is not None:
            bps = 0.8 * prev[0] + 0.2 * bps
            ratio = 0.8 * prev[1] + 0.2 * ratio
        _WireCompressor._shared[self._codec.name] = (
            bps, ratio, time.monotonic()
        )
        if len(comp) >= n:
            return payload, None, 0  # incompressible slot: send plain
        self.compressed_sends += 1
        return (
            comp,
            {"codec": self._codec.name, "raw_len": n},
            wire.FLAG_COMPRESSED,
        )


class _DataPlane:
    """One stream's slot-transport state: shm ring (None = TCP only),
    adaptive wire compressor, bench pacing throttle."""

    __slots__ = ("ring", "comp", "throttle")

    def __init__(
        self,
        ring: Optional[_ShmRing],
        comp: _WireCompressor,
        throttle: _SendThrottle,
    ) -> None:
        self.ring = ring
        self.comp = comp
        self.throttle = throttle


def _uri_with_epoch(uri: str, epoch: int) -> str:
    """Thread the stream's epoch into the dataset URI sugar (indexed
    sources resolve ``?epoch=E`` to the epoch's deterministic shuffle
    permutation; sequential sources are epoch-invariant)."""
    if epoch <= 0 or "index=" not in uri:
        return uri
    head, sep, frag = uri.partition("#")
    head += ("&" if "?" in head else "?") + f"epoch={int(epoch)}"
    return head + sep + frag


class _StreamConfig:
    """Validated HELLO payload → producer construction arguments."""

    def __init__(self, meta: Dict) -> None:
        try:
            self.uri = str(meta["uri"])
            spec = dict(meta["spec"])
            self.layout = str(spec.get("layout", "ell"))
            self.spec = BatchSpec(
                batch_size=int(spec["batch_size"]),
                layout=self.layout,
                max_nnz=spec.get("max_nnz"),
                num_features=spec.get("num_features"),
                overflow=str(spec.get("overflow", "truncate")),
                index_dtype=np.dtype(spec.get("index_dtype", "int32")),
                value_dtype=np.dtype(spec.get("value_dtype", "float32")),
            )
            self.format = str(meta.get("format", "auto"))
            self.epoch = int(meta.get("epoch", 0))
            self.mode = str(meta.get("mode", "static"))
            self.part = int(meta.get("part", 0))
            self.nparts = int(meta.get("nparts", 1))
            self.start_seq = int(meta.get("start_seq", 0))
            self.fileset = meta.get("fileset")
            # same-host shm offer (absent keys = a client that cannot
            # or will not map shm; the stream is plain TCP)
            self.shm = bool(meta.get("shm", False))
            self.client_host = str(meta.get("host", ""))
            self.client_uid = int(meta.get("uid", -2))
        except (KeyError, TypeError, ValueError) as e:
            raise Error(f"dsserve: bad HELLO config: {e}") from e
        if self.mode not in ("lease", "static"):
            raise Error(f"dsserve: unknown stream mode {self.mode!r}")
        if self.mode == "static" and not (
            0 <= self.part < self.nparts and self.start_seq >= 0
        ):
            raise Error(
                f"dsserve: bad static stripe ({self.part}, {self.nparts}, "
                f"start_seq={self.start_seq})"
            )

    def make_producer(self, part: int, nparts: int):
        """The standard local producer for one (micro-)shard — exactly
        what the trainer would build, so slot bytes are bit-identical
        by construction (epoch rides the URI sugar). A local dataset
        OSError (typo'd path in the HELLO URI) becomes a checked Error
        so it takes the ERROR-frame path to the client instead of the
        client-disconnected log branch — the trainer must see "no such
        file", not an opaque connection reset."""
        from ..staging import fused

        uri = _uri_with_epoch(self.uri, self.epoch)
        try:
            if self.layout == "dense":
                return fused.dense_batches(
                    uri, self.spec, part, nparts, format=self.format
                )
            return fused.ell_batches(
                uri, self.spec, part, nparts, format=self.format
            )
        except OSError as e:
            raise Error(
                f"dsserve: cannot open dataset {self.uri!r}: {e}"
            ) from e


class DsServeServer:
    """One preprocessing worker: TCP listener + one thread per client
    stream. ``start()`` serves in the background (in-process tests /
    diag); ``serve_forever()`` is the CLI foreground mode; ``close()``
    tears the listener and waits briefly for stream threads."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        rank: Optional[int] = None,
        queue_depth: Optional[int] = None,
    ) -> None:
        self._sock = make_listener(host, port)
        self.host = host
        self.port = int(self._sock.getsockname()[1])
        # lease identity: the launcher's task id for the tier
        # (dmlc-submit --dsserve exports DMLC_TASK_ID per server); any
        # rank >= 0 may lease — the ledger's elastic-join contract
        if rank is None:
            try:
                rank = int(os.environ.get("DMLC_TASK_ID", "0"))
            except ValueError:
                rank = 0
        self.rank = rank
        self._queue_depth = (
            queue_depth if queue_depth else default_queue_depth()
        )
        # seeded-chaos hook (the io/faults.py + collective kill_seq
        # idiom): SIGKILL this process after N streamed slots — always
        # mid-shard for any N not on a shard boundary, so the chaos
        # drill strands an in-flight lease deterministically
        try:
            self._kill_after = int(
                os.environ.get("DMLC_DSSERVE_KILL_AFTER_SLOTS", "0") or 0
            )
        except ValueError:
            self._kill_after = 0
        self._closed = threading.Event()
        self._retiring = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._streams: list = []
        self._depth_lock = threading.Lock()
        self._depth = 0
        # serving-side shape (mirrored by the registry series)
        self.slots_served = 0
        self.bytes_served = 0
        self.shards_streamed = 0
        self.shm_slots_sent = 0

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "DsServeServer":
        t = threading.Thread(
            target=self._accept_loop, daemon=True, name="dsserve-accept"
        )
        self._accept_thread = t
        t.start()
        return self

    def serve_forever(self) -> None:
        self._accept_loop()

    def retire(self) -> None:
        """Graceful retire (autoscale scale-down; the tier's SIGTERM):
        stop accepting streams and stop taking NEW leases — each live
        stream finishes the shard it is producing, FINs it, sends a
        retired EPOCH_END, and its teardown releases every lease it
        still holds. The fleet shrinks without a single shard waiting
        out its lease TTL; survivors (and the ledger's ``epoch_done``
        sentinel) cover the rest of the epoch (docs/autoscale.md).
        Signal-handler safe: just sets a flag the loops poll."""
        if not self._retiring.is_set():
            self._retiring.set()
            _tracing.instant(
                "dmlc:dsserve_retire", rank=self.rank, port=self.port
            )

    @property
    def retiring(self) -> bool:
        return self._retiring.is_set()

    def close(self) -> None:
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for t in list(self._streams):
            t.join(timeout=2.0)
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None

    # -- accept + stream -----------------------------------------------------
    def _accept_loop(self) -> None:
        # a timed accept keeps close() prompt: closing a listening
        # socket from another thread does not reliably unblock a
        # blocked accept(), so the loop polls the closed flag instead
        self._sock.settimeout(0.25)
        while not self._closed.is_set():
            if self._retiring.is_set():
                # no new streams; wait for the live ones to drain their
                # current shard and EPOCH_END out, then return — which
                # lets serve_forever() (the CLI) exit zero
                if not any(s.is_alive() for s in self._streams):
                    return
                time.sleep(0.1)
                continue
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed
            conn.settimeout(None)
            t = threading.Thread(
                target=self._serve_client,
                args=(conn, addr),
                daemon=True,
                name="dsserve-stream",
            )
            # prune finished streams so a long-lived server's roster
            # doesn't grow one entry per connection forever
            self._streams = [s for s in self._streams if s.is_alive()]
            self._streams.append(t)
            t.start()

    def _tick_depth(self, d: int) -> None:
        with self._depth_lock:
            self._depth += d
            _QDEPTH.set(self._depth)

    def _shm_eligible(self, cfg: _StreamConfig) -> bool:
        """Offer shm only when BOTH sides opted in and the HELLO's
        host + uid match this process — the cheap pre-filter; the probe
        round-trip is the actual proof of a shared namespace."""
        if not (cfg.shm and shm_transport_enabled() and shm_available()):
            return False
        if cfg.client_host != socket.gethostname():
            return False
        uid = os.getuid() if hasattr(os, "getuid") else -1
        return cfg.client_uid == uid

    def _negotiate_shm(self, conn, cfg: _StreamConfig, ok_meta: Dict):
        """Run the OK + probe handshake; returns the stream's _ShmRing
        (None = plain TCP). The probe segment proves the client maps
        THIS server's shm namespace: the OK carries the probe name, the
        client reads the magic back and confirms in its own OK frame.
        Any hiccup — create failure, refused or garbled confirmation —
        falls back to TCP without failing the stream."""
        ring = None
        probe = None
        if self._shm_eligible(cfg):
            try:
                ring = _ShmRing(_shm_ring_slots(), _shm_break_after())
                probe = ring.make_probe()
                ok_meta["shm_probe"] = probe.name
            except (OSError, ValueError):
                ring = None
                probe = None
        wire.send_frame(conn, wire.KIND_OK, ok_meta)
        if ring is None:
            return None
        confirmed = False
        try:
            kind, m2, _p, _s, _e = wire.recv_frame(conn)
            confirmed = kind == wire.KIND_OK and bool(
                isinstance(m2, dict) and m2.get("shm")
            )
        except (OSError, ConnectionError, Error):
            raise  # a dead handshake socket fails the stream normally
        finally:
            try:
                probe.close()
                probe.unlink()
            except (OSError, BufferError):
                pass
        if not confirmed:
            ring.close()
            return None
        return ring

    def _ack_loop(self, conn, ring: _ShmRing) -> None:
        """Per-stream shm ack reader — the ONLY post-handshake recv on
        the connection: each client OK frame names a segment whose last
        view died, freeing its ring slot for rewrite. Exits with the
        socket; segments never acked are reclaimed by ring.close()."""
        while True:
            try:
                kind, meta, _p, _s, _e = wire.recv_frame(conn)
            except socket.timeout:
                continue  # idle stream: keep listening for late acks
            except (OSError, ConnectionError, Error):
                return
            if kind == wire.KIND_OK and "ack" in meta:
                ring.release(str(meta["ack"]))

    def _serve_client(self, conn, addr) -> None:
        _CLIENTS.inc()
        ring = None
        ack_thread = None
        # lease mode: (keep alive, give back) for the shards whose FIN
        # went out, run once the client has closed its end (see
        # _stream_leased)
        after_close: list = []
        try:
            conn.settimeout(30.0)
            kind, meta, _payload, _seq, _ep = wire.recv_frame(conn)
            if kind != wire.KIND_HELLO:
                raise Error(f"dsserve: expected HELLO, got frame kind {kind}")
            # stream setup under a handler span carrying the client's
            # trace context (HELLO meta "tc"): the merged timeline
            # binds it to the trainer's connect
            with _tracing.handler_span(
                "dmlc:dsserve_hello", meta.get("tc"), peer=str(addr)
            ):
                cfg = _StreamConfig(meta)
                # a deadline, not None: a stalled (not disconnected)
                # client must fail the stream loudly instead of
                # wedging it forever
                conn.settimeout(default_send_timeout())
                ring = self._negotiate_shm(
                    conn, cfg,
                    {"mode": cfg.mode, "rank": self.rank, "pid": os.getpid()},
                )
            if ring is not None:
                ack_thread = threading.Thread(
                    target=self._ack_loop,
                    args=(conn, ring),
                    daemon=True,
                    name="dsserve-shm-ack",
                )
                ack_thread.start()
            plane = _DataPlane(ring, _WireCompressor(), _SendThrottle())
            if cfg.mode == "lease":
                self._stream_leased(conn, cfg, plane, after_close)
            else:
                self._stream_static(conn, cfg, plane)
        except (Error, ValueError, KeyError) as e:
            logger.warning("dsserve stream from %s failed: %s", addr, e)
            try:
                conn.settimeout(5.0)
                wire.send_frame(conn, wire.KIND_ERROR, {"error": str(e)})
            except (OSError, Error):
                pass
        except (OSError, ConnectionError) as e:
            # client went away mid-stream: normal during failover/close
            logger.info("dsserve client %s disconnected: %s", addr, e)
        finally:
            _CLIENTS.dec()
            # teardown ORDER is the correctness: descriptors for
            # segments the client has not mapped yet may still sit in
            # its socket buffer after this side finishes a fast stream
            # — unlinking now would ENOENT every one of them. The ack
            # loop exits exactly when the client's socket dies (EOF
            # after it consumed the whole stream, or reset), so joining
            # it FIRST makes every name safe to unlink: mapped segments
            # survive via the client's private mappings, unmapped ones
            # can no longer be asked for. The send-timeout bound keeps
            # a wedged client from pinning the ring forever (it then
            # degrades to TCP through the reconnect path, exactly-once
            # intact).
            if after_close:
                self._await_close(conn, ack_thread, [k for k, _ in after_close])
            elif ack_thread is not None:
                ack_thread.join(timeout=default_send_timeout())
            try:
                conn.close()
            except OSError:
                pass
            if ring is not None:
                ring.close()
            for _keep, give_back in after_close:
                give_back()

    @staticmethod
    def _await_close(conn, ack_thread, keep_alive) -> None:
        """Wait, at most the send timeout, until the client closes a
        finished stream: it has then committed every shard it got a FIN
        for, since it commits each FIN before it reads the next frame.
        The shm ack reader ends at that close; without one, read the
        connection to its end. ``keep_alive`` renews the leases
        meanwhile, so none expires under a slow commit."""
        deadline = time.monotonic() + default_send_timeout()
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                return
            step = min(left, 0.25)
            if ack_thread is not None:
                ack_thread.join(timeout=step)
                if not ack_thread.is_alive():
                    return
            else:
                try:
                    conn.settimeout(step)
                    wire.recv_frame(conn)
                except socket.timeout:
                    pass
                except (OSError, ConnectionError, Error):
                    return
            for renew in keep_alive:
                renew()

    def _send_slots(
        self, conn, producer, shard: int, epoch: int, seq0: int,
        plane: _DataPlane, skip: int = 0,
    ) -> int:
        """Stream one producer's batches as SLOT frames; returns the
        next seq (the static-mode path). Production runs
        ``queue_depth`` slots ahead of the socket send on a
        ThreadedIter (decode/parse overlaps the network write);
        ``skip`` drops the first N batches without sending — the
        deterministic resume seek."""
        ring = getattr(producer, "ring_slots", None)
        depth = self._queue_depth
        if ring is not None:
            # a yielded batch is valid until ring_slots - 1 further
            # batches exist; in flight here = queue + producer hand +
            # the one being sent
            depth = max(1, min(depth, int(ring) - 3))

        produced = [0]

        def _counted():
            for b in producer:
                produced[0] += 1
                self._tick_depth(1)
                yield b

        it: ThreadedIter = ThreadedIter(
            _counted, max_capacity=depth, name="dsserve-produce"
        )
        seq = seq0
        taken = 0
        skipped = 0
        try:
            while True:
                batch = it.next()
                if batch is None:
                    return seq
                self._tick_depth(-1)
                taken += 1
                if skipped < skip:
                    skipped += 1
                    seq += 1
                    continue
                seq = self._send_one(conn, batch, shard, epoch, seq, plane)
        finally:
            it.destroy(timeout=1.0)
            # rewind the gauge by the discarded produced-but-untaken
            # slots (see the leased path's teardown note)
            self._tick_depth(taken - produced[0])

    def _send_one(
        self, conn, batch, shard: int, epoch: int, seq: int,
        plane: _DataPlane,
    ) -> int:
        meta = wire.slot_meta(batch, shard)
        # each slot carries the server's flow id: the trainer lands it
        # inside its dsserve_recv_wait span, so a starved consumer's
        # timeline points at the stream (and span) that fed it
        tc = _tracing.rpc_context()
        if tc:
            meta["tc"] = tc
        raw_n = batch.packed.nbytes
        payload = batch.packed
        flags = 0
        if plane.ring is not None:
            name = plane.ring.slot_for(payload)
            if name is not None:
                # the slot bytes are already in the segment — the wire
                # carries only the descriptor (no crc: there is no wire
                # medium under the payload to tear)
                meta["shm"] = {"seg": name, "nbytes": raw_n}
                payload = None
                self.shm_slots_sent += 1
        if payload is not None:
            payload, extra, flags = plane.comp.maybe_compress(payload)
            if extra:
                meta.update(extra)
        t0 = time.monotonic()
        sent = wire.send_frame(
            conn, wire.KIND_SLOT, meta, payload, seq=seq, epoch=epoch,
            flags=flags,
        )
        if payload is not None:
            # pace BEFORE the bandwidth observation so the EWMA sees
            # the throttled (bench) link, not the raw loopback burst
            plane.throttle.pace(sent)
            plane.comp.observe_send(sent, time.monotonic() - t0)
        self.slots_served += 1
        self.bytes_served += raw_n
        _SLOTS.inc()
        _BYTES.inc(raw_n)
        if self._kill_after and self.slots_served >= self._kill_after:
            os._exit(9)  # chaos drill: die mid-stream, no cleanup
        return seq + 1

    def _stream_static(
        self, conn, cfg: _StreamConfig, plane: _DataPlane
    ) -> None:
        """Tracker-less stripe: the deterministic whole-stripe stream,
        resumable at any slot via HELLO.start_seq."""
        producer = cfg.make_producer(cfg.part, cfg.nparts)
        try:
            with _tracing.span(
                "dmlc:dsserve_stream_shard", shard=cfg.part, mode="static"
            ):
                seq = self._send_slots(
                    conn, producer, cfg.part, cfg.epoch, 0, plane,
                    skip=cfg.start_seq,
                )
            self.shards_streamed += 1
            wire.send_frame(
                conn, wire.KIND_SHARD_FIN,
                {"shard": cfg.part, "slots": seq},
                epoch=cfg.epoch,
            )
            wire.send_frame(
                conn, wire.KIND_EPOCH_END, {"slots": seq}, epoch=cfg.epoch
            )
        finally:
            producer.close()

    def _stream_leased(
        self, conn, cfg: _StreamConfig, plane: _DataPlane, after_close: list
    ) -> None:
        """Shard-service leaseholder loop: lease → produce → stream → SHARD_FIN
        until the epoch's ledger drains. The client commits dones; this
        side only keeps its leases renewed while it streams, and at the
        end gives back what it leased: at once the shards it never
        finished, and through ``after_close`` (kept renewed until the
        client has closed the connection, then released) those whose FIN
        it sent, so a release can never overtake the client's commit of
        a FIN'd shard and hand it to another server (a shard streamed and
        committed twice).

        The lease loop, producer construction AND parsing all run on
        ONE producer-ahead thread chained through a single bounded
        ThreadedIter, so the next shard's lease round-trip, splitter
        construction and first-window decode overlap the socket sends
        of the previous shard's slots — without this, every shard
        boundary is a serial bubble on the serving core."""
        from ..tracker.shardsvc import ShardLeaseClient

        try:
            lease_client = ShardLeaseClient(rank=self.rank)
        except KeyError as e:
            raise Error(
                "dsserve lease mode needs a tracker: set DMLC_TRACKER_URI/"
                f"DMLC_TRACKER_PORT (missing {e})"
            ) from None
        epoch = cfg.epoch
        # every shard this stream ever leased (granted on the producer
        # thread; GIL-atomic set ops). Teardown releases them ALL —
        # including FIN'd-but-uncommitted ones: the commit belongs to
        # the client, so a client that died between receiving FIN and
        # its shard_done leaves a lease this server's rank-wide renews
        # (another stream of the same rank) would otherwise keep alive
        # forever. Releasing an already-committed shard is a ledger
        # no-op, so the clean end of an epoch costs only cheap RPCs.
        leased: set = set()
        finned: set = set()  # the shards whose SHARD_FIN was sent
        state = {"ttl": 30.0, "last_renew": 0.0}
        produced = [0]  # producer-thread slot ticks (gauge rewind)
        # queue + producer hand + the slot being sent must stay under
        # the producer's ring_slots - 1 (a yielded batch is only valid
        # until that many further batches exist); producers are built
        # inside the generator, so the bound is enforced there per
        # producer — loudly, never by silently corrupting slot bytes
        capacity = min(self._queue_depth, 7)

        def _check_ring(producer) -> None:
            ring = getattr(producer, "ring_slots", None)
            if ring is not None and int(ring) - 3 < capacity:
                raise Error(
                    f"dsserve stream queue ({capacity}) does not fit the "
                    f"producer ring ({ring} slots): lower "
                    "DMLC_DSSERVE_QUEUE or deepen the producer ring"
                )

        def _produce():
            while True:
                if self._retiring.is_set():
                    # retire boundary: the shard that was producing has
                    # fully yielded (this check sits between shards), so
                    # the client gets its FIN and can commit; everything
                    # still leased is released by the stream teardown
                    yield ("epoch_end", True)
                    return
                resp = lease_client.lease(epoch, cfg.fileset)
                status = resp.get("status")
                if status == "lease":
                    shard = int(resp["shard"])
                    num_shards = int(resp["num_shards"])
                    leased.add(shard)
                    state["ttl"] = float(resp.get("ttl", 30.0))
                    state["last_renew"] = time.monotonic()
                    producer = cfg.make_producer(shard, num_shards)
                    _check_ring(producer)
                    try:
                        with _tracing.span(
                            "dmlc:dsserve_stream_shard", shard=shard,
                            epoch=epoch,
                        ):
                            for batch in producer:
                                produced[0] += 1
                                self._tick_depth(1)
                                yield ("slot", shard, batch)
                    finally:
                        producer.close()
                    yield ("fin", shard, num_shards)
                elif status == "wait":
                    # cap below the worker-side 1.0s: an idle stream's
                    # poll cadence gates how fast a reclaimed shard is
                    # picked up and how fast end-of-epoch is noticed
                    backoff = float(resp.get("backoff", 0.1))
                    with annotate("dmlc:shard_lease_wait"):
                        time.sleep(min(0.25, max(0.01, backoff)))
                elif status == "done":
                    yield ("epoch_end",)
                    return
                else:
                    raise Error(
                        "dsserve: shard lease failed: "
                        f"{resp.get('error', resp)!r}"
                    )

        it: ThreadedIter = ThreadedIter(
            _produce, max_capacity=capacity, name="dsserve-produce"
        )
        seq = 0
        sent = 0
        try:
            while True:
                item = it.next()
                if item is None:
                    return
                kind = item[0]
                if kind == "slot":
                    _k, shard, batch = item
                    self._tick_depth(-1)
                    sent += 1
                    seq = self._send_one(
                        conn, batch, shard, epoch, seq, plane
                    )
                    self._maybe_renew(lease_client, epoch, state)
                elif kind == "fin":
                    _k, shard, num_shards = item
                    self.shards_streamed += 1
                    finned.add(shard)
                    wire.send_frame(
                        conn, wire.KIND_SHARD_FIN,
                        {"shard": shard, "num_shards": num_shards},
                        seq=seq, epoch=epoch,
                    )
                else:  # epoch_end
                    meta = {"slots": seq}
                    if len(item) > 1 and item[1]:
                        meta["retired"] = True
                    wire.send_frame(
                        conn, wire.KIND_EPOCH_END, meta, epoch=epoch,
                    )
                    return
        finally:
            it.destroy(timeout=1.0)
            # rewind the queue-depth gauge by the produced-but-unsent
            # slots the teardown just discarded, or every failover
            # would ratchet the gauge permanently upward (one late
            # in-hand tick from an orphaned producer can leave ±1,
            # never unbounded drift)
            self._tick_depth(sent - produced[0])
            # every lease this stream took goes back to the queue NOW
            # — including FIN'd shards whose commit never landed (dead
            # client): rank-wide renews from sibling streams would
            # otherwise keep an abandoned lease alive forever, and
            # releasing a committed shard is a no-op
            # a refused dial gets a SHORT reconnect budget (tracker
            # mid-relaunch) — a dropped release costs a whole lease TTL
            # of queue-time, but stream teardown must not hang out the
            # full crash-recovery window per shard
            def release(shards) -> None:
                for shard in sorted(shards):
                    try:
                        lease_client.release(
                            epoch, shard, cfg.fileset, retry_secs=5.0
                        )
                    except (OSError, ConnectionError):
                        pass

            # a FIN'd shard goes back only after the client's commit
            # had its chance: released first, it would be re-served
            # while that commit is still in flight
            release(leased - finned)
            if finned:
                after_close.append((
                    lambda: self._maybe_renew(lease_client, epoch, state),
                    lambda: release(finned)))

    @staticmethod
    def _maybe_renew(lease_client, epoch: int, state: Dict) -> None:
        now = time.monotonic()
        if now - state["last_renew"] >= state["ttl"] / 3.0:
            state["last_renew"] = now
            try:
                # short budget: the serve loop must keep streaming the
                # in-hand shard through a tracker outage
                lease_client.renew(epoch, retry_secs=2.0)
            except (OSError, ConnectionError):
                pass  # next cadence retries; the TTL covers the gap

    # -- introspection -------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "slots_served": self.slots_served,
            "bytes_served": self.bytes_served,
            "shards_streamed": self.shards_streamed,
            "shm_slots_sent": self.shm_slots_sent,
            "queue_depth": self._depth,
            "rank": self.rank,
            "port": self.port,
        }


def write_port_file(path: str, host: str, port: int) -> None:
    """Atomic readiness signal for launchers (``dmlc-submit --dsserve``
    polls for this file): one JSON line naming the bound endpoint."""
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"host": host, "port": int(port)}, f)
    os.replace(tmp, path)
