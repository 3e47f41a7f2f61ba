"""Batched point reads over an indexed RecordIO shard (the port of
``dmlc_core_tpu/io/lookup.py``, whole, with its wire frames and metric
names, so a server of either package answers a client of the other).

- **Key resolution** goes through the splitter's cached index (one parse
  per file and mtime, shared across handles): its key column is kept in
  record order, and a batch of keys resolves to record positions in one
  ``searchsorted``. A missing key is an explicit ``None``, never an
  exception and never another record.
- **Blocks come from the caches first**: the batch's distinct blocks go
  through the two-level ``codec.DecodeContext`` (the in-process LRU, then
  the host's block-cache daemon in one ``get_many``). A dead or absent
  daemon degrades to the first level silently.
- **The rest are coalesced reads**: the missing blocks' spans merge at
  ``merge_gap`` and take the splitter's one miss path (``_fetch_blocks``:
  the span fetcher on non-local files, the mapping locally), and every
  decoded block is published back through the daemon.
- **Records leave the decoded blocks by a frame walk**: one native
  ``walk_record_spans`` call a block (or its plain numpy version); only a
  multipart chain (a payload holding the aligned magic word) is joined in
  Python.

``RecordLookup`` is the handle; ``LookupServer`` / ``LookupClient`` are
the ``tools serve`` daemon and its client: a request loop of 4-byte
little-endian lengths and compact JSON, a lookup's record payloads
following its JSON header as one raw blob, with p50/p99 latency and
request counts on the registry (``io.lookup.*``, ``/metrics``) and a
``lookup_wait`` stall stage on the flight recorder.

``RecordLookup.warm`` prefetches the blocks covering a key set, hottest
first, and publishes them through the daemon's own admission control and
tenant quotas. Importing this module loads no torch.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..telemetry import default_registry as _default_registry
from ..telemetry import tracing as _tracing
from ..utils.logging import Error, check
from . import codec as _codec
from . import recordio as _recordio
from . import split as _split
from .blockcache import MAX_FRAME, _recv_all, _recv_frame

__all__ = ["LookupClient", "LookupServer", "RecordLookup"]

logger = logging.getLogger("dmlc_core_tpu_torch.io.lookup")

_REG = _default_registry()
_BATCHES = _REG.counter("io.lookup.batches", help="batched lookup() calls served")
_KEYS = _REG.counter("io.lookup.keys", help="keys resolved by lookup()")
_HITS = _REG.counter("io.lookup.hits", help="keys that resolved to a record")
_NEGATIVES = _REG.counter("io.lookup.negatives",
                          help="keys absent from the index (None results)")
_BYTES = _REG.counter("io.lookup.bytes", help="record payload bytes returned by lookup()")
_BLOCK_HITS = _REG.counter("io.lookup.block_hits", help="blocks served from the L1/L2 caches")
_BLOCK_MISSES = _REG.counter("io.lookup.block_misses",
                             help="blocks fetched+decoded on the miss path")
_WARMED = _REG.counter("io.lookup.warm_blocks", help="blocks prefetched by warm()")
_BATCH_SECONDS = _REG.histogram("io.lookup.batch_seconds",
                                help="library-level lookup() wall time")
_REQUEST_SECONDS = _REG.histogram(
    "io.lookup.request_seconds",
    help="serve-daemon per-request wall time (p50/p99 on /metrics)")
_CLIENTS = _REG.gauge("io.lookup.clients", help="serve-daemon connections currently open")

_LENGTH_MASK = np.uint32((1 << 29) - 1)


# -- the frame walk: index slices -> payload bytes ----------------------------
def _walk_plain(buf: np.ndarray, starts: np.ndarray, sizes: np.ndarray):
    """The plain version of ``native.walk_record_spans``: one vectorized
    pass over every slice's 8 header bytes → (payload offsets, lengths,
    bad slices); -2 marks a multipart chain."""
    words = buf[starts[:, None] + np.arange(8)].view("<u4")
    magic_ok = words[:, 0] == np.uint32(_recordio.KMAGIC)
    lrec = words[:, 1]
    cflag = lrec >> np.uint32(29)
    plen = (lrec & _LENGTH_MASK).astype(np.int64)
    single = magic_ok & (cflag == 0)
    fits = (8 + ((plen + 3) & ~np.int64(3))) <= sizes
    bad = (~magic_ok) | (magic_ok & (cflag > 1)) | (single & ~fits)
    offs = np.where(single, starts + 8, np.int64(-2))
    lens = np.where(single, plen, np.int64(0))
    return offs, lens, int(bad.sum())


def _extract_payloads(buf: np.ndarray, starts: np.ndarray, sizes: np.ndarray,
                      what: str, plain: bool = False) -> List[bytes]:
    """The payloads of the framed records at slices ``(starts[i],
    sizes[i])`` of ``buf`` (uint8): one native frame walk (``plain``: its
    numpy version) resolves every single-frame record, and a multipart
    chain is joined by the chunk reader. A slice with no valid record
    head means the index and the data disagree: it raises, never answers
    another record."""
    n = len(starts)
    if n == 0:
        return []
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    sizes = np.ascontiguousarray(sizes, dtype=np.int64)
    check(int(starts.min(initial=0)) >= 0
          and int((starts + sizes).max(initial=0)) <= len(buf)
          and bool((sizes >= 8).all()),
          f"{what}: record slices fall outside the decoded bytes (corrupt index or data)")
    if plain:
        offs, lens, nbad = _walk_plain(buf, starts, sizes)
    else:
        from ..data import native  # data imports io

        offs, lens, _nm, nbad = native.walk_record_spans(np.ascontiguousarray(buf),
                                                         starts, sizes)
    check(nbad == 0, f"{what}: {nbad} record slices hold no valid record frame "
          "(index and data disagree)")
    out: List[bytes] = []
    for i in range(n):
        o = int(offs[i])
        if o >= 0:
            out.append(bytes(buf[o:o + int(lens[i])]))
            continue
        s = int(starts[i])
        rec = _recordio.RecordIOChunkReader(memoryview(buf[s:s + int(sizes[i])]),
                                            0, 1).next_record()
        check(rec is not None,
              f"{what}: truncated multi-part record (index and data disagree)")
        out.append(bytes(rec))
    return out


class RecordLookup:
    """Batched point reads over one indexed ``.rec`` shard, any codec.

    ``lookup(keys)`` → ``[bytes | None, ...]`` in the keys' order; a key
    absent from the index is ``None``, a corrupt block raises ``Error``.
    The bytes are the same whether a block came from the in-process
    cache, the host daemon or a fresh read, and across codecs (decoded
    blocks hold v1 frames). Thread-safe: batches serialise on a lock."""

    def __init__(self, uri: str, index_uri: Optional[str] = None,
                 decode_ctx: Optional[_codec.DecodeContext] = None,
                 merge_gap: int = 65536) -> None:
        self.uri = uri
        self.index_uri = index_uri or uri + ".idx"
        self.merge_gap = merge_gap
        # the splitter is the substrate: the file table, the cached index,
        # the block cache's identity, the span reader and fetcher and the
        # coalesced miss path; lookup adds keys and payloads
        self._sp = _split.IndexedRecordIOSplitter(uri, self.index_uri, 0, 1, shuffle=False,
                                                  merge_gap=merge_gap, decode_ctx=decode_ctx)
        keys = self._sp._index_keys
        check(keys is not None and len(keys) == len(self._sp._index_offs),
              f"index file {self.index_uri!r} carries no usable key column")
        # sorted keys for one searchsorted a batch, per handle (the parsed
        # index itself is shared through the process-wide cache)
        self._key_order = np.argsort(keys, kind="stable")
        self._keys_sorted = keys[self._key_order]
        self._lock = threading.Lock()
        self._codec_memo: Optional[str] = None
        self.lookups = 0
        self.keys_resolved = 0
        self.negatives = 0
        self.bytes_out = 0
        self.block_cache_hits = 0
        self.block_cache_misses = 0

    # -- introspection --------------------------------------------------------
    @property
    def n_records(self) -> int:
        return len(self._keys_sorted)

    @property
    def compressed(self) -> bool:
        return bool(self._sp._compressed)

    def describe(self) -> dict:
        """The key count and block geometry (``tools info <uri>``), under
        the handle's lock: the codec probe shares the span reader with
        lookups in flight."""
        with self._lock:
            sp = self._sp
            out = {
                "records": int(len(sp._index_offs)),
                "keys": int(len(self._keys_sorted)),
                "key_dtype": str(self._keys_sorted.dtype),
                "total_bytes": int(sp.file_offset[-1]),
                "compressed": bool(sp._compressed),
            }
            if sp._compressed:
                bs = sp._block_sizes
                out.update(
                    blocks=int(len(bs)),
                    block_bytes={"min": int(bs.min()), "mean": int(bs.mean()),
                                 "max": int(bs.max())},
                    records_per_block=round(len(sp._index_offs) / len(bs), 1),
                    codec=self._codec_name())
            else:
                out["codec"] = "none"
            return out

    def _codec_name(self) -> str:
        """The first block's codec (28 bytes: the frame and block
        headers; probed once a handle); 'unknown' rather than a failed
        info call."""
        if self._codec_memo is None:
            self._codec_memo = self._probe_codec()
        return self._codec_memo

    def _probe_codec(self) -> str:
        sp = self._sp
        try:
            head = bytes(sp._get_span_reader().read(int(sp._block_offs[0]), 28))
            magic, _lrec = struct.unpack("<II", head[:8])
            if magic != _recordio.KMAGIC:
                return "unknown"
            return _codec.get_codec(int(head[8])).name
        except Exception:
            return "unknown"

    # -- key resolution -------------------------------------------------------
    @staticmethod
    def _int_key(k) -> int:
        """Exact integer keys: ints and integer strings (the wire form);
        a float would truncate to another key's record, a bool read key
        0 or 1."""
        if isinstance(k, bool):
            raise TypeError(f"non-integer key {k!r}")
        if isinstance(k, (int, np.integer)):
            return int(k)
        if isinstance(k, (str, bytes)):
            return int(k)  # ValueError on '3.7': no truncation
        raise TypeError(f"non-integer key {k!r}")

    @staticmethod
    def _str_key(k) -> str:
        """Exact string keys: str, bytes decoded as utf-8 (the index is
        text), ints rendered exactly; anything else would never match
        and pass for an honest negative."""
        if isinstance(k, str):
            return k
        if isinstance(k, bytes):
            return k.decode()
        if isinstance(k, (int, np.integer)) and not isinstance(k, bool):
            return str(int(k))
        raise TypeError(f"non-string key {k!r}")

    def _as_key_array(self, keys: Sequence) -> np.ndarray:
        if self._keys_sorted.dtype == np.int64:
            try:
                return np.asarray([self._int_key(k) for k in keys], dtype=np.int64)
            except (ValueError, TypeError, OverflowError):
                raise Error(f"lookup keys must be integers for this index "
                            f"({self.index_uri!r} has integer keys)") from None
        try:
            return np.asarray([self._str_key(k) for k in keys])
        except (TypeError, UnicodeDecodeError):
            raise Error(f"lookup keys must be strings for this index "
                        f"({self.index_uri!r} has string keys)") from None

    def _resolve(self, keys: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        """(hit mask of the queries, record positions of the hits): one
        searchsorted over the sorted keys."""
        q = self._as_key_array(keys)
        if len(q) == 0:
            return np.zeros(0, dtype=bool), np.zeros(0, dtype=np.int64)
        n = len(self._keys_sorted)
        pos = np.searchsorted(self._keys_sorted, q)
        pos_c = np.minimum(pos, max(n - 1, 0))
        hit = ((pos < n) & (self._keys_sorted[pos_c] == q) if n
               else np.zeros(len(q), dtype=bool))
        return hit, self._key_order[pos_c[hit]].astype(np.int64)

    # -- the batched read -----------------------------------------------------
    def lookup(self, keys: Sequence) -> List[Optional[bytes]]:
        """The payload of each key, ``None`` for a key absent from the
        index, in the keys' order (a repeated key gets its record each
        time)."""
        t0 = time.perf_counter()
        with self._lock:
            out = self._lookup_locked(keys)
        _BATCH_SECONDS.observe(time.perf_counter() - t0)
        return out

    def _lookup_locked(self, keys: Sequence) -> List[Optional[bytes]]:
        hit, recs = self._resolve(keys)
        results: List[Optional[bytes]] = [None] * len(hit)
        n_hit = int(hit.sum())
        self.lookups += 1
        self.keys_resolved += len(hit)
        self.negatives += len(hit) - n_hit
        _BATCHES.inc()
        _KEYS.inc(len(hit))
        _HITS.inc(n_hit)
        _NEGATIVES.inc(len(hit) - n_hit)
        if n_hit == 0:
            return results
        # repeated records collapse before any read is planned
        recs_u, inv = np.unique(recs, return_inverse=True)
        payloads_u = (self._read_compressed(recs_u) if self._sp._compressed
                      else self._read_v1(recs_u))
        nbytes = 0
        for j, i in enumerate(np.nonzero(hit)[0].tolist()):
            p = payloads_u[int(inv[j])]
            results[i] = p
            nbytes += len(p)
        self.bytes_out += nbytes
        _BYTES.inc(nbytes)
        return results

    def _read_compressed(self, recs: np.ndarray) -> List[bytes]:
        """The payloads of distinct records of a block shard: the batch's
        distinct blocks from the decode context in one batched lookup,
        the misses on the splitter's coalesced miss path, one frame walk
        a block."""
        sp = self._sp
        bids = sp._rec_block[recs]
        keymap = {int(b): sp._block_key(int(b)) for b in np.unique(bids).tolist()}
        found = sp._decode_ctx.get_blocks(list(keymap.values()))
        blocks: Dict[int, bytes] = {}
        missing: List[int] = []
        for b, k in keymap.items():
            raw = found.get(k)
            if raw is None:
                missing.append(b)
            else:
                blocks[b] = raw
        self.block_cache_hits += len(blocks)
        self.block_cache_misses += len(missing)
        sp.decode_cache_hits += len(blocks)
        sp.decode_cache_misses += len(missing)
        _BLOCK_HITS.inc(len(blocks))
        if missing:
            _BLOCK_MISSES.inc(len(missing))
            # one region on the timeline for a cold batch's fetch and decode
            with _tracing.span("dmlc:lookup_block_fetch", blocks=len(missing)):
                blocks.update(sp._fetch_blocks(sorted(missing)))
        out: List[bytes] = [b""] * len(recs)
        order = np.argsort(bids, kind="stable")
        ob = bids[order]
        i = 0
        while i < len(order):
            b = int(ob[i])
            j = i
            while j < len(order) and int(ob[j]) == b:
                j += 1
            sel = order[i:j]
            raw = blocks[b]
            starts = sp._rec_inoff[recs[sel]]
            nxt = sp._rec_next[recs[sel]]
            ends = np.where(nxt >= 0, nxt, len(raw))
            payloads = _extract_payloads(np.frombuffer(raw, dtype=np.uint8), starts,
                                         ends - starts, f"lookup {self.uri!r}")
            for k, p in zip(sel.tolist(), payloads):
                out[int(k)] = p
            i = j
        return out

    def _read_v1(self, recs: np.ndarray) -> List[bytes]:
        """The payloads of distinct records of an uncompressed shard: the
        records' byte ranges coalesce into spans at ``merge_gap`` and
        read through the splitter's spans (the mapping locally, the span
        fetcher otherwise); one frame walk over the span buffer."""
        sp = self._sp
        offs = sp._index_offs[recs]
        sizes = sp._index_sizes[recs]
        order, s_starts, s_ends = _split._plan_span_bounds(offs, sizes, self.merge_gap)
        span_begin = offs[order][s_starts]
        run_end = np.maximum.accumulate(offs[order] + sizes[order])
        span_len = run_end[s_ends - 1] - span_begin
        buf = sp._read_spans(span_begin, span_len)
        span_of = np.repeat(np.arange(len(s_starts)), s_ends - s_starts)
        base = np.concatenate(([0], np.cumsum(span_len)[:-1]))
        rel = offs[order] - span_begin[span_of] + base[span_of]
        sorted_payloads = _extract_payloads(np.ascontiguousarray(buf), rel, sizes[order],
                                            f"lookup {self.uri!r}")
        out: List[bytes] = [b""] * len(recs)
        for j, k in enumerate(order.tolist()):
            out[int(k)] = sorted_payloads[j]
        return out

    # -- warming --------------------------------------------------------------
    def warm(self, keys: Optional[Sequence] = None,
             max_blocks: Optional[int] = None) -> int:
        """Prefetch the decoded blocks covering ``keys`` (None: the whole
        shard), those covering the most keys first, at most
        ``max_blocks``; they publish through the daemon's admission
        control and tenant quotas. Returns the blocks read and decoded
        (cached ones cost nothing); an uncompressed shard has no decoded
        blocks: 0."""
        if not self._sp._compressed:
            return 0
        with self._lock:
            sp = self._sp
            if keys is None:
                bids = sp._rec_block
            else:
                _hit, recs = self._resolve(keys)
                if len(recs) == 0:
                    return 0
                bids = sp._rec_block[recs]
            uniq, counts = np.unique(bids, return_counts=True)
            hot = uniq[np.argsort(-counts, kind="stable")]
            if max_blocks is not None:
                hot = hot[:max(int(max_blocks), 0)]
            keymap = {int(b): sp._block_key(int(b)) for b in hot.tolist()}
            found = sp._decode_ctx.get_blocks(list(keymap.values()))
            missing = sorted(b for b, k in keymap.items() if k not in found)
            if missing:
                with _tracing.span("dmlc:lookup_warm", blocks=len(missing)):
                    sp._fetch_blocks(missing)
                _WARMED.inc(len(missing))
            return len(missing)

    def io_stats(self) -> Dict[str, object]:
        base = self._sp.io_stats()
        base.update(lookups=self.lookups, keys_resolved=self.keys_resolved,
                    negatives=self.negatives, lookup_bytes=self.bytes_out,
                    block_cache_hits=self.block_cache_hits,
                    block_cache_misses=self.block_cache_misses)
        return base

    def close(self) -> None:
        self._sp.close()


# -- wire framing (the block cache's, with a raw payload blob) ----------------
def _send_frame(sock: socket.socket, obj: dict, payload: bytes = b"") -> None:
    data = json.dumps(obj, separators=(",", ":")).encode()
    # refused at the sender: the receiver drops an oversized frame's
    # connection, which would look like a dead daemon; only the JSON
    # header is capped, not the record payloads
    if len(data) > MAX_FRAME:
        raise Error(f"lookup control frame of {len(data)} bytes exceeds the "
                    f"{MAX_FRAME}-byte cap — split the key batch")
    sock.sendall(struct.pack("<I", len(data)) + data + payload)


class LookupServer:
    """The ``tools serve`` daemon: batched point reads over one indexed
    shard on a TCP request loop.

    One request frame in, one response frame out: a 4-byte little-endian
    length and compact JSON. A ``lookup`` answer's header holds ``sizes``
    (-1 for a missing key) and the payloads follow it as one raw blob in
    the keys' order. Ops: ``lookup`` (keys), ``warm`` (keys, max_blocks),
    ``stats``, ``ping``. Each request ticks ``io.lookup.requests{op}`` and
    observes ``io.lookup.request_seconds``; ``metrics_port`` serves the
    registry on ``/metrics``."""

    #: the ops, and so the names of the handler spans (a hostile op name
    #: must not mint span or metric names without bound)
    _OPS = frozenset({"ping", "lookup", "warm", "stats"})

    def __init__(self, handle: RecordLookup, host: str = "127.0.0.1", port: int = 0,
                 metrics_port: int = 0) -> None:
        self.handle = handle
        self.host = host
        self._sock = socket.create_server((host, port), backlog=64)
        self.port = self._sock.getsockname()[1]
        self._closed = threading.Event()
        self._conns: set = set()
        self._conn_threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self.requests = 0
        self._accept_thread: Optional[threading.Thread] = threading.Thread(
            target=self._accept_loop, daemon=True, name="lookup-accept")
        self._accept_thread.start()
        self._metrics_server = None
        if metrics_port:
            from ..telemetry.export import serve_metrics_http

            self._metrics_server = serve_metrics_http(
                metrics_port, registry=_REG, json_provider=self.stats,
                name="lookup-metrics-http")
        logger.info("lookup daemon serving %s:%d over %s", host, self.port, handle.uri)

    def serve_forever(self) -> None:
        """Block until ``close()`` (the command line's foreground mode)."""
        self._closed.wait()

    def close(self) -> None:
        """Stop accepting, close every connection and the ``/metrics``
        server, and join the threads (2 s each)."""
        if self._closed.is_set():
            return
        self._closed.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
            self._accept_thread = None
        with self._lock:
            conns = list(self._conns)
            threads = list(self._conn_threads)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        for t in threads:
            t.join(timeout=2.0)
        if self._metrics_server is not None:
            try:
                self._metrics_server.shutdown()
                self._metrics_server.server_close()
            except Exception:
                pass

    def _accept_loop(self) -> None:
        # a timed accept keeps close() prompt: closing a listening socket
        # from another thread does not reliably wake a blocked accept()
        self._sock.settimeout(0.25)
        while not self._closed.is_set():
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # closed
            conn.settimeout(None)
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True,
                                 name="lookup-conn")
            with self._lock:
                self._conn_threads = [x for x in self._conn_threads if x.is_alive()]
                self._conn_threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        with self._lock:
            self._conns.add(conn)
        _CLIENTS.inc(1)
        try:
            while True:
                try:
                    req = _recv_frame(conn)
                except (ConnectionError, OSError, ValueError):
                    return
                t0 = time.perf_counter()
                op = str(req.get("op"))
                try:
                    resp, payload = self._handle(op, req)
                except Error as e:  # a checked refusal: answer, keep the connection
                    resp, payload = {"ok": False, "error": str(e)}, b""
                except Exception as e:  # one bad request, not the daemon
                    logger.exception("lookup request failed")
                    resp, payload = {"ok": False, "error": repr(e)}, b""
                self.requests += 1
                _REG.counter("io.lookup.requests",
                             labels={"op": op if op in self._OPS else "unknown"}).inc()
                try:
                    _send_frame(conn, resp, payload)
                except Error as e:
                    # the answer's header outgrew the frame cap: a compact
                    # refusal, so the client sees an error, not a dead daemon
                    try:
                        _send_frame(conn, {"ok": False, "error": str(e)})
                    except (Error, OSError):
                        return
                except OSError:
                    return
                _REQUEST_SECONDS.observe(time.perf_counter() - t0)
        finally:
            with self._lock:
                self._conns.discard(conn)
            _CLIENTS.inc(-1)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, op: str, req: dict) -> Tuple[dict, bytes]:
        span = f"dmlc:lookup_{op if op in self._OPS else 'unknown'}"
        # the handler span takes the client's trace context: the flow
        # arrow from the caller's lookup_wait lands here
        with _tracing.handler_span(span, req.get("tc")):
            if op == "ping":
                return {"ok": True, "pid": os.getpid()}, b""
            if op == "lookup":
                keys = req.get("keys", [])
                # a JSON string would iterate into single-character keys
                check(isinstance(keys, (list, tuple)),
                      f"lookup keys must be a JSON array, got {type(keys).__name__}")
                vals = self.handle.lookup(keys)
                sizes = [-1 if v is None else len(v) for v in vals]
                return ({"ok": True, "sizes": sizes},
                        b"".join(v for v in vals if v is not None))
            if op == "warm":
                keys = req.get("keys")
                check(keys is None or isinstance(keys, (list, tuple)),
                      f"warm keys must be a JSON array, got {type(keys).__name__}")
                n = self.handle.warm(keys, req.get("max_blocks"))
                return {"ok": True, "warmed_blocks": n}, b""
            if op == "stats":
                return {"ok": True, "stats": self.stats()}, b""
            return {"ok": False, "error": f"unknown op {op!r}"}, b""

    def stats(self) -> dict:
        """Requests, qps and uptime of this server; p50/p99 of the
        process-wide ``io.lookup.request_seconds`` histogram (a process
        with several servers reads them blended)."""
        h = self.handle
        uptime = time.perf_counter() - self._t0
        hist = _REG.snapshot().get("histograms", {}).get("io.lookup.request_seconds", {})
        return {
            "pid": os.getpid(),
            "host": self.host,
            "port": self.port,
            "uri": h.uri,
            "uptime_secs": round(uptime, 3),
            "requests": self.requests,
            "qps": round(self.requests / max(uptime, 1e-9), 2),
            "p50_ms": round(hist.get("p50", 0.0) * 1e3, 3),
            "p99_ms": round(hist.get("p99", 0.0) * 1e3, 3),
            "lookups": h.lookups,
            "keys_resolved": h.keys_resolved,
            "negatives": h.negatives,
            "bytes": h.bytes_out,
            "block_cache_hits": h.block_cache_hits,
            "block_cache_misses": h.block_cache_misses,
            "shard": h.describe(),
        }


def _wire_keys(keys: Sequence) -> list:
    """The keys as JSON, as strict as the handle: ints and strings pass,
    bytes decode; anything else would never match and pass for a
    negative."""
    out = []
    for k in keys:
        if isinstance(k, (int, np.integer)):
            out.append(int(k))
        elif isinstance(k, str):
            out.append(k)
        elif isinstance(k, bytes):
            try:
                out.append(k.decode())
            except UnicodeDecodeError:
                raise Error(f"undecodable bytes lookup key {k!r}") from None
        else:
            raise Error(f"lookup keys must be ints or strings, got {k!r}")
    return out


class LookupClient:
    """One connection to a ``LookupServer``; the wait for an answer is the
    ``lookup_wait`` stall stage of the flight recorder. Thread-safe, one
    request in flight a connection."""

    def __init__(self, host: str, port: int, timeout: float = 30.0) -> None:
        self.host = host
        self.port = int(port)
        self._timeout = timeout
        self._lock = threading.Lock()
        self._sock: Optional[socket.socket] = None

    def _connect_locked(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.create_connection((self.host, self.port),
                                                  timeout=self._timeout)
        return self._sock

    def _request(self, obj: dict, want_payload: bool = False) -> Tuple[dict, bytes]:
        with self._lock:
            sock = self._connect_locked()
            try:
                # the send is inside the wait span, so the request's flow
                # start lands in it
                with _tracing.span("dmlc:lookup_wait"):
                    tc = _tracing.rpc_context()
                    if tc:
                        obj = {**obj, "tc": tc}
                    _send_frame(sock, obj)
                    resp = _recv_frame(sock)
                    payload = b""
                    if want_payload and resp.get("ok"):
                        total = sum(s for s in resp.get("sizes", ()) if s > 0)
                        if total:
                            payload = _recv_all(sock, total)
            except (OSError, ConnectionError, ValueError) as e:
                self._close_locked()
                raise Error(f"lookup daemon {self.host}:{self.port} unreachable: {e}") from e
        if not resp.get("ok"):
            raise Error(f"lookup daemon {self.host}:{self.port} refused "
                        f"{obj.get('op')!r}: {resp.get('error')}")
        return resp, payload

    def lookup(self, keys: Sequence) -> List[Optional[bytes]]:
        keys = _wire_keys(keys)
        resp, payload = self._request({"op": "lookup", "keys": keys}, want_payload=True)
        sizes = resp.get("sizes", [])
        check(len(sizes) == len(keys), "lookup daemon answered the wrong key count")
        out: List[Optional[bytes]] = []
        at = 0
        for s in sizes:
            if s < 0:
                out.append(None)
            else:
                out.append(payload[at:at + s])
                at += s
        check(at == len(payload), "lookup daemon payload length disagrees with its sizes")
        return out

    def warm(self, keys: Optional[Sequence] = None,
             max_blocks: Optional[int] = None) -> int:
        req: dict = {"op": "warm", "max_blocks": max_blocks}
        if keys is not None:
            req["keys"] = _wire_keys(keys)
        resp, _ = self._request(req)
        return int(resp.get("warmed_blocks", 0))

    def stats(self) -> dict:
        return self._request({"op": "stats"})[0]["stats"]

    def ping(self) -> bool:
        try:
            self._request({"op": "ping"})
            return True
        except Error:
            return False

    def _close_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._close_locked()
