"""Compression codecs for compressed-block RecordIO (the port of
``dmlc_core_tpu/io/codec.py``).

This module is the port's only compression site (lint rule L009 bans
zlib, gzip, zstandard and lz4 imports anywhere else): a codec registry
with level control and streaming helpers, the compressed-block wire
header (codec id, raw length, crc32 of the decoded bytes), a decode pool
sized from the usable-CPU count, and a bytes-bounded LRU of decoded
blocks, so a windowed shuffle and later epochs decode each block once.

Codecs: ``raw`` (id 0), ``zlib`` (1) and ``gzip`` (2) ride the standard
library and are always there; ``zstd`` (3) and ``lz4`` (4) sit behind
import guards. ``get_codec`` raises a checked ``Error`` naming a missing
package, and ``available_codecs()`` lists only what this host decodes.

Block wire format (the payload of a cflag-4 RecordIO frame)::

    codec_id  u8     registry id (0 raw, 1 zlib, 2 gzip, 3 zstd, 4 lz4)
    version   u8     block-header version, 1
    reserved  u16    zero
    n_records u32    records framed inside the decoded bytes
    raw_len   u32    decoded byte count
    crc32     u32    crc32 of the DECODED bytes
    <compressed bytes>

Environment: ``DMLC_DECODE_CACHE_MB`` (the decoded-block LRU's budget,
default 256) and ``DMLC_DECODE_THREADS`` (the decode pool's size, default
the usable-CPU count). Telemetry, under the JAX package's names: the
``io.codec.bytes_raw``/``bytes_compressed``/``cache_hits``/
``cache_misses`` counters, the ``io.codec.decode_seconds`` histogram and
one ``dmlc:decode_block`` span per decode. ``DecodeContext`` puts the
host's shared block-cache daemon (``io/blockcache.py``) behind the LRU.
"""

from __future__ import annotations

import hashlib
import struct
import threading
import time as _time
import zlib as _zlib
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

from ..telemetry import default_registry as _default_registry
from ..telemetry import tracing as _tracing
from ..utils.cpus import available_cpus
from ..utils.env import get_env
from ..utils.logging import Error, check

__all__ = [
    "BLOCK_HEADER",
    "Codec",
    "DecodeContext",
    "DecodedBlockCache",
    "available_codecs",
    "crc32",
    "decode_block",
    "decode_blocks",
    "decode_threads",
    "default_decode_cache",
    "default_decode_context",
    "default_decode_pool",
    "encode_block",
    "get_codec",
    "register_codec",
    "shutdown_decode_pool",
    "submit_decode",
    "wire_block_key",
]

# codec_id, version, reserved, n_records, raw_len, crc32
BLOCK_HEADER = struct.Struct("<BBHIII")
BLOCK_VERSION = 1

_REG = _default_registry()
_BYTES_RAW = _REG.counter(
    "io.codec.bytes_raw", help="uncompressed bytes through the codec layer"
)
_BYTES_COMPRESSED = _REG.counter(
    "io.codec.bytes_compressed", help="compressed bytes through the codec layer"
)
_DECODE_SECONDS = _REG.histogram(
    "io.codec.decode_seconds", help="per-block decompress wall time"
)
_CACHE_HITS = _REG.counter("io.codec.cache_hits", help="decoded-block cache hits")
_CACHE_MISSES = _REG.counter(
    "io.codec.cache_misses", help="decoded-block cache misses"
)


def crc32(data) -> int:
    """crc32 content checksum, masked to u32 for the block header."""
    return _zlib.crc32(data) & 0xFFFFFFFF


class Codec:
    """One compression algorithm: name, wire id, whole-buffer
    (de)compression and streaming helpers. Codec errors surface as
    checked ``Error``s, never as the backend's own exceptions."""

    name = "?"
    codec_id = -1
    default_level: Optional[int] = None

    def _compress(self, data: bytes, level: Optional[int]) -> bytes:
        raise NotImplementedError

    def _decompress(self, data: bytes, raw_len: Optional[int]) -> bytes:
        raise NotImplementedError

    def compress(self, data: bytes, level: Optional[int] = None) -> bytes:
        try:
            return self._compress(bytes(data), level)
        except Exception as e:  # each backend raises its own kinds
            raise Error(f"codec {self.name!r}: compress failed: {e}") from e

    def decompress(self, data: bytes, raw_len: Optional[int] = None) -> bytes:
        try:
            return self._decompress(bytes(data), raw_len)
        except Exception as e:
            raise Error(f"codec {self.name!r}: decompress failed: {e}") from e

    def compress_stream(self, chunks: Iterable[bytes],
                        level: Optional[int] = None) -> Iterator[bytes]:
        """Compress a chunk iterator; this base buffers the whole input
        (zlib and gzip stream for real)."""
        buf = b"".join(chunks)
        if buf:
            yield self.compress(buf, level)

    def decompress_stream(self, chunks: Iterable[bytes]) -> Iterator[bytes]:
        buf = b"".join(chunks)
        if buf:
            yield self.decompress(buf)


class RawCodec(Codec):
    """Identity (id 0): block framing and crc without compression."""

    name = "raw"
    codec_id = 0

    def _compress(self, data: bytes, level: Optional[int]) -> bytes:
        return data

    def _decompress(self, data: bytes, raw_len: Optional[int]) -> bytes:
        return data

    def compress_stream(self, chunks, level=None):
        for c in chunks:
            if c:
                yield bytes(c)

    def decompress_stream(self, chunks):
        for c in chunks:
            if c:
                yield bytes(c)


class ZlibCodec(Codec):
    name = "zlib"
    codec_id = 1
    default_level = 6
    _wbits = 15  # the zlib wrapper

    def _compressor(self, level: Optional[int]):
        return _zlib.compressobj(self.default_level if level is None else level,
                                 _zlib.DEFLATED, self._wbits)

    def _compress(self, data: bytes, level: Optional[int]) -> bytes:
        co = self._compressor(level)
        return co.compress(data) + co.flush()

    def _decompress(self, data: bytes, raw_len: Optional[int]) -> bytes:
        return _zlib.decompress(data, self._wbits)

    def compress_stream(self, chunks, level=None):
        co = self._compressor(level)
        for c in chunks:
            out = co.compress(bytes(c))
            if out:
                yield out
        out = co.flush()
        if out:
            yield out

    def decompress_stream(self, chunks):
        do = _zlib.decompressobj(self._wbits)
        for c in chunks:
            out = do.decompress(bytes(c))
            if out:
                yield out
        out = do.flush()
        if out:
            yield out


class GzipCodec(ZlibCodec):
    """The same deflate stream with the gzip wrapper (wbits 16+15): a
    block's payload is a valid .gz member."""

    name = "gzip"
    codec_id = 2
    _wbits = 16 + 15


class ZstdCodec(Codec):
    name = "zstd"
    codec_id = 3
    default_level = 3

    def __init__(self, mod) -> None:
        self._mod = mod

    def _compress(self, data: bytes, level: Optional[int]) -> bytes:
        level = self.default_level if level is None else level
        return self._mod.ZstdCompressor(level=level).compress(data)

    def _decompress(self, data: bytes, raw_len: Optional[int]) -> bytes:
        dctx = self._mod.ZstdDecompressor()
        if raw_len is not None:
            return dctx.decompress(data, max_output_size=raw_len)
        return dctx.decompress(data)


class Lz4Codec(Codec):
    name = "lz4"
    codec_id = 4
    default_level = 0

    def __init__(self, mod) -> None:
        self._mod = mod  # lz4.frame

    def _compress(self, data: bytes, level: Optional[int]) -> bytes:
        level = self.default_level if level is None else level
        return self._mod.compress(data, compression_level=level)

    def _decompress(self, data: bytes, raw_len: Optional[int]) -> bytes:
        return self._mod.decompress(data)


_CODECS: Dict[str, Codec] = {}
_BY_ID: Dict[int, Codec] = {}
_MISSING: Dict[str, str] = {}  # name -> why its guarded import failed


def register_codec(codec: Codec) -> None:
    _CODECS[codec.name] = codec
    _BY_ID[codec.codec_id] = codec


register_codec(RawCodec())
register_codec(ZlibCodec())
register_codec(GzipCodec())

try:  # optional, never a hard dependency
    import zstandard as _zstd_mod

    register_codec(ZstdCodec(_zstd_mod))
except ImportError:
    _MISSING["zstd"] = "python package 'zstandard' is not installed"

try:
    import lz4.frame as _lz4_frame

    register_codec(Lz4Codec(_lz4_frame))
except ImportError:
    _MISSING["lz4"] = "python package 'lz4' is not installed"


def available_codecs() -> List[str]:
    """Names of the codecs this process encodes and decodes, id order."""
    return [c.name for c in sorted(_CODECS.values(), key=lambda c: c.codec_id)]


def get_codec(name: Union[str, int, Codec]) -> Codec:
    """A codec by name, wire id or instance; a checked ``Error`` for an
    unknown name or id and for a guarded codec whose package is missing
    (a compressed file fails loudly on a host that cannot decode it)."""
    if isinstance(name, Codec):
        return name
    if isinstance(name, int):
        codec = _BY_ID.get(name)
        if codec is None:
            known = {c.codec_id: c.name for c in _CODECS.values()}
            missing = [f"{k} ({v})" for k, v in sorted(_MISSING.items())]
            raise Error(
                f"unknown or unavailable codec id {name} (available: "
                f"{known}{'; missing: ' + ', '.join(missing) if missing else ''})")
        return codec
    key = str(name).lower()
    codec = _CODECS.get(key)
    if codec is None:
        if key in _MISSING:
            raise Error(f"codec {key!r} unavailable: {_MISSING[key]}")
        raise Error(f"unknown codec {name!r} (available: {available_codecs()})")
    return codec


# -- block encode/decode ------------------------------------------------------
def encode_block(raw: bytes, n_records: int, codec: Union[str, Codec],
                 level: Optional[int] = None) -> bytes:
    """Framed record bytes → block blob (header + compressed bytes)."""
    c = get_codec(codec)
    comp = c.compress(raw, level)
    _BYTES_RAW.inc(len(raw))
    _BYTES_COMPRESSED.inc(len(comp))
    return BLOCK_HEADER.pack(c.codec_id, BLOCK_VERSION, 0, n_records, len(raw),
                             crc32(raw)) + comp


def decode_block(blob) -> Tuple[bytes, int]:
    """Block blob → (framed record bytes, n_records), after checking the
    version, the declared raw length and the crc32; any mismatch raises a
    checked ``Error`` (a corrupt block never decodes to records)."""
    blob = bytes(blob)
    check(len(blob) >= BLOCK_HEADER.size,
          f"compressed block shorter than its {BLOCK_HEADER.size}-byte header")
    codec_id, version, _res, n_records, raw_len, want_crc = BLOCK_HEADER.unpack_from(blob)
    check(version == BLOCK_VERSION,
          f"unsupported compressed-block version {version} "
          f"(this reader supports {BLOCK_VERSION})")
    codec = get_codec(codec_id)
    # one flight-recorder span per decode-pool job: the timeline shows
    # each decode worker's occupancy beside the reader waiting on it
    t0 = _time.perf_counter()
    with _tracing.span("dmlc:decode_block", codec=codec.name, raw_len=raw_len):
        raw = codec.decompress(blob[BLOCK_HEADER.size:], raw_len)
    _DECODE_SECONDS.observe(_time.perf_counter() - t0)
    check(len(raw) == raw_len,
          f"compressed block decoded to {len(raw)} bytes, header says "
          f"{raw_len} (truncated or corrupt block)")
    got_crc = crc32(raw)
    check(got_crc == want_crc,
          f"compressed block crc mismatch: got {got_crc:#010x}, header says "
          f"{want_crc:#010x} (corrupt block)")
    _BYTES_RAW.inc(raw_len)
    _BYTES_COMPRESSED.inc(len(blob) - BLOCK_HEADER.size)
    return raw, n_records


# -- the decode pool ----------------------------------------------------------
def decode_threads() -> int:
    """Decode pool size: ``DMLC_DECODE_THREADS`` when positive, else the
    usable-CPU count (the stdlib codecs release the GIL while they run)."""
    env = get_env("DMLC_DECODE_THREADS", 0)
    return env if env > 0 else available_cpus()


_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def default_decode_pool() -> ThreadPoolExecutor:
    """The process-global decode pool, started at first use and shared by
    every reader, so concurrent splits do not multiply threads."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=decode_threads(),
                                       thread_name_prefix="codec-decode")
        return _POOL


def shutdown_decode_pool() -> None:
    """End the decode pool's threads, after the decodes already queued;
    the next decode starts a new pool. Waits for running decodes only,
    each bounded by its block's size."""
    global _POOL
    with _POOL_LOCK:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.shutdown(wait=True)


def decode_blocks(blobs: List[bytes]) -> List[Tuple[bytes, int]]:
    """Decode many blobs, in order, on the pool when there are several;
    a worker's error re-raises here."""
    if len(blobs) <= 1 or decode_threads() <= 1:
        return [decode_block(b) for b in blobs]
    return list(default_decode_pool().map(decode_block, blobs))


def submit_decode(blob) -> Future:
    """One block's decode on the pool, as a Future; with a one-thread
    pool the decode runs here and the Future comes back resolved."""
    if decode_threads() <= 1:
        f: Future = Future()
        try:
            f.set_result(decode_block(blob))
        except Exception as e:  # surfaces at .result(), as a pool job's would
            f.set_exception(e)
        return f
    return default_decode_pool().submit(decode_block, blob)


# -- the decoded-block LRU ----------------------------------------------------
class DecodedBlockCache:
    """Bytes-bounded LRU of decoded blocks, keyed by the caller (the
    indexed splitter's key holds the file set's paths, sizes and
    mtimes, a digest of the block layout and the block's offset).
    Thread-safe: the window read-ahead fills it while the consumer
    reads. An entry larger than the whole budget is not kept."""

    def __init__(self, max_bytes: int) -> None:
        check(max_bytes >= 0, f"cache budget {max_bytes} must be >= 0")
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._items: "OrderedDict[object, bytes]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, key) -> Optional[bytes]:
        with self._lock:
            data = self._items.get(key)
            if data is None:
                self.misses += 1
                _CACHE_MISSES.inc()
                return None
            self._items.move_to_end(key)
            self.hits += 1
            _CACHE_HITS.inc()
            return data

    def put(self, key, data: bytes) -> None:
        n = len(data)
        with self._lock:
            old = self._items.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
            if n > self.max_bytes:
                return
            self._items[key] = data
            self._bytes += n
            while self._bytes > self.max_bytes and self._items:
                _k, evicted = self._items.popitem(last=False)
                self._bytes -= len(evicted)

    def clear(self) -> None:
        with self._lock:
            self._items.clear()
            self._bytes = 0

    @property
    def nbytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._items)


_CACHE: Optional[DecodedBlockCache] = None
_CACHE_LOCK = threading.Lock()


def default_decode_cache() -> DecodedBlockCache:
    """The process-global decoded-block cache, ``DMLC_DECODE_CACHE_MB``
    (default 256) MiB, sized at first use."""
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            _CACHE = DecodedBlockCache(get_env("DMLC_DECODE_CACHE_MB", 256) * (1 << 20))
        return _CACHE


def wire_block_key(key: object) -> str:
    """A structured block identity flattened to the string the host
    daemon keys on: the sha1 of its ``repr``. The identity is built from
    plain strings, ints and tuples (the splitter's file-set signature,
    layout digest and block offset), whose ``repr`` is the same in every
    process and in both packages, where the seeded ``hash()`` is not."""
    if isinstance(key, str):
        return key
    return hashlib.sha1(repr(key).encode()).hexdigest()


class DecodeContext:
    """The one seam every block decode goes through: the in-process LRU
    (L1, ``cache``, default the process-global one), then the host's
    shared block-cache daemon (L2), then a decode on the pool.

    ``shared="auto"`` (the default) resolves the process's daemon client
    at first use (one connect attempt, a failure cached:
    ``blockcache.default_client``); ``shared=None`` pins the context to
    L1; any object with ``get``, ``get_many`` and ``publish`` is used as
    given. L2 is best-effort: a dead or absent daemon is a miss, and the
    block is decoded here."""

    _AUTO = "auto"

    def __init__(self, cache: Optional[DecodedBlockCache] = None,
                 shared: object = "auto") -> None:
        self._cache = cache
        self._shared = shared

    def cache(self) -> DecodedBlockCache:
        return self._cache if self._cache is not None else default_decode_cache()

    def shared(self):
        """The L2 client, or None (disabled, or no daemon)."""
        if isinstance(self._shared, str) and self._shared == self._AUTO:
            from .blockcache import default_client

            return default_client()
        return self._shared

    def get_block(self, key: object) -> Optional[bytes]:
        """L1, then L2; an L2 hit is kept in L1."""
        return self.get_blocks([key]).get(key)

    def get_blocks(self, keys) -> Dict[object, bytes]:
        """The cached blocks among ``keys``: L1 for each, then ONE L2
        round trip for all the L1 misses; the caller decodes the rest."""
        cache = self.cache()
        out: Dict[object, bytes] = {}
        missing = []
        for key in keys:
            data = cache.get(key)
            if data is not None:
                out[key] = data
            else:
                missing.append(key)
        shared = self.shared() if missing else None
        if shared is not None:
            by_wire = {wire_block_key(k): k for k in missing}
            try:
                got = shared.get_many(list(by_wire))
            except Exception:  # the shared tier is best-effort
                got = {}
            for wire, data in got.items():
                key = by_wire[wire]
                cache.put(key, data)
                out[key] = data
        return out

    def put_block(self, key: object, raw: bytes) -> None:
        """Keep decoded bytes in L1 and offer them to L2 (a lost publish
        race or an absent daemon is a silent no-op)."""
        self.cache().put(key, raw)
        shared = self.shared()
        if shared is not None:
            try:
                shared.publish(wire_block_key(key), raw)
            except Exception:  # the shared tier is best-effort
                pass

    def decode_block(self, blob) -> Tuple[bytes, int]:
        return decode_block(blob)

    def decode_blocks(self, blobs: List[bytes]) -> List[Tuple[bytes, int]]:
        return decode_blocks(blobs)

    def submit_decode(self, blob) -> Future:
        return submit_decode(blob)


_CTX: Optional[DecodeContext] = None
_CTX_LOCK = threading.Lock()


def default_decode_context() -> DecodeContext:
    """The process-global decode context (L1 the default LRU, L2 the
    host's daemon when one answers)."""
    global _CTX
    with _CTX_LOCK:
        if _CTX is None:
            _CTX = DecodeContext()
        return _CTX
