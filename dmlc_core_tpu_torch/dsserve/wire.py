"""dsserve wire format: length-prefixed slot frames (the port of
``dmlc_core_tpu/dsserve/wire.py``; a frame is byte-for-byte the JAX
package's for the same meta and payload, so either package's server
feeds either package's client).

One frame = a fixed 32-byte header, a compact-JSON meta blob, and an
optional raw payload (the packed-slot bytes, staged verbatim):

    magic u32 | kind u8 | flags u8 | reserved u16 | seq i64 | epoch i32
    | meta_len u32 | payload_len u32 | crc32(payload) u32

riding the repo's length-prefixed framing idiom (tracker/protocol.py's
int+string frames; io/blockcache.py's 4-byte-LE JSON control plane) at
binary-payload scale. The header — and therefore every ``struct``
pack/unpack of it — lives HERE and only here (lint L015, the
L006-L014 single-site pattern): a second hand-rolled frame site could
drift field order or endianness and corrupt every slot after it.

Slot payloads are the exact ``alloc_packed_slot`` buffers the staging
pipeline DMAs (staging/batcher.py): the SLOT meta carries the batch's
``packed_layout`` descriptor — (name, offset, nbytes, shape, dtype)
per section — plus ``n_valid`` and the serving micro-shard, so
:func:`read_batch` rebuilds bit-identical numpy views over the
received buffer with zero copies. ``crc32`` (payload only; the header
is length-guarded) rejects torn frames at the receiver, where the
client treats the connection as faulted and re-enters its
reconnect/retry path (io/retry.py transient classification).
"""

from __future__ import annotations

import binascii
import json
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from ..io.codec import get_codec
from ..staging.batcher import Batch, packed_layout
from ..telemetry import default_registry as _default_registry
from ..utils.logging import Error

__all__ = [
    "FLAG_COMPRESSED",
    "HDR_BYTES",
    "KIND_EPOCH_END",
    "KIND_ERROR",
    "KIND_HELLO",
    "KIND_OK",
    "KIND_SHARD_FIN",
    "KIND_SLOT",
    "MAX_META",
    "MAX_PAYLOAD",
    "SHM_MAGIC",
    "read_batch",
    "read_frame_into",
    "recv_alloc_bytes",
    "recv_frame",
    "send_frame",
    "slot_meta",
]

MAGIC = 0x44535631  # "DSV1"

#: header: magic u32, kind u8, flags u8, reserved u16, seq i64,
#: epoch i32, meta_len u32, payload_len u32, crc32 u32 — 32 bytes
_HDR = struct.Struct("<IBBHqiIII")
HDR_BYTES = _HDR.size

KIND_HELLO = 1      # client → server: ONE JSON stream-config frame
KIND_OK = 2         # server → client: HELLO accepted (server info)
KIND_SLOT = 3       # server → client: one packed batch slot
KIND_SHARD_FIN = 4  # server → client: micro-shard fully streamed —
#                     the CLIENT commits shard_done (docs/dsserve.md)
KIND_EPOCH_END = 5  # server → client: the epoch's ledger drained
KIND_ERROR = 6      # either direction: JSON {"error": ...}

#: meta is config/layout JSON — anything bigger is hostile or corrupt
MAX_META = 1 << 20
#: one packed slot; mirrors the collective engine's 2 GiB frame cap
MAX_PAYLOAD = (1 << 31) - 1

#: header ``flags`` bit 0: the payload is codec-compressed; meta then
#: carries ``codec`` (registry name) + ``raw_len`` (decoded bytes) and
#: the crc covers the WIRE bytes (checked before the decode spends CPU)
FLAG_COMPRESSED = 0x1

#: written at the head of the server's shm PROBE segment; the client
#: proving it can map and read these bytes back (then confirming in an
#: OK frame) is what upgrades a stream to the same-host transport —
#: protocol constant, so it lives with the frame format
SHM_MAGIC = b"DSSHM1\r\n"

_REG = _default_registry()
#: receive-side data-plane accounting (docs/observability.md): wire
#: bytes as sent vs raw slot bytes after decode — their ratio is the
#: live compression win — and payload-path allocations, which stay 0
#: while every slot lands in a pooled recv buffer
_BYTES_WIRE = _REG.counter(
    "dsserve.bytes_wire", help="dsserve SLOT payload bytes on the wire"
)
_BYTES_RAW = _REG.counter(
    "dsserve.bytes_raw", help="dsserve SLOT payload bytes after decode"
)
_RECV_ALLOC = _REG.counter(
    "dsserve.recv_alloc_bytes",
    help="dsserve payload bytes received into fresh allocations "
    "(0 on the pooled recv-into fast path)",
)


def _recv_exact_into(sock, view: memoryview, region: str) -> None:
    """Fill ``view`` from the socket. EOF mid-fill raises the checked
    truncation ``Error`` naming the frame region — a peer that dies
    between frames closes cleanly at a header boundary; one that dies
    INSIDE a frame leaves bytes the stream can never resynchronize
    past, and every caller must treat the connection as faulted."""
    got = 0
    n = len(view)
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise Error(
                f"dsserve: truncated frame {region} "
                f"(peer closed after {got} of {n} bytes)"
            )
        got += r


def _recv_header(sock, view: memoryview) -> bool:
    """Fill the 32-byte header view; False on a CLEAN close (EOF before
    the first byte — the one EOF that is not a truncation)."""
    r = sock.recv_into(view, HDR_BYTES)
    if r == 0:
        return False
    if r < HDR_BYTES:
        _recv_exact_into(sock, view[r:], "header")
    return True


def _recv_exact(sock, n: int, region: str) -> bytearray:
    buf = bytearray(n)
    _recv_exact_into(sock, memoryview(buf), region)
    return buf


def send_frame(
    sock,
    kind: int,
    meta: Optional[Dict] = None,
    payload=None,
    seq: int = 0,
    epoch: int = 0,
    flags: int = 0,
) -> int:
    """Write one frame; returns payload bytes sent. ``payload`` is any
    buffer-protocol object (numpy uint8 views included) sent without an
    intermediate copy; the small header+meta pair is joined into one
    ``sendall`` so a slot costs two syscalls, not three."""
    mb = (
        json.dumps(meta, separators=(",", ":")).encode()
        if meta is not None
        else b""
    )
    if len(mb) > MAX_META:
        raise Error(f"dsserve meta too large ({len(mb)} bytes)")
    pv = memoryview(payload).cast("B") if payload is not None else None
    plen = len(pv) if pv is not None else 0
    if plen > MAX_PAYLOAD:
        raise Error(f"dsserve payload too large ({plen} bytes)")
    crc = binascii.crc32(pv) & 0xFFFFFFFF if pv is not None else 0
    hdr = _HDR.pack(
        MAGIC, kind, flags, 0, int(seq), int(epoch), len(mb), plen, crc
    )
    sock.sendall(hdr + mb)
    if pv is not None and plen:
        sock.sendall(pv)
    return plen


def _read_frame(
    sock, buf=None
) -> Tuple[int, Dict, Optional[np.ndarray], int, int]:
    """The one frame reader (recv_frame and read_frame_into both land
    here). With ``buf`` (any writable buffer-protocol object) the
    payload arrives via ``recv_into`` directly in ``buf``'s first bytes
    and the returned payload is a zero-copy uint8 view over it; without
    (or when the slot outgrows it) a fresh array is allocated and
    ticked on ``dsserve.recv_alloc_bytes``. Compressed payloads
    (FLAG_COMPRESSED) are crc-checked on the wire bytes, decoded
    through io/codec.py, and land decoded in ``buf`` — bit-identical
    to the uncompressed path. Bad magic, hostile lengths, crc
    mismatches and mid-frame EOFs raise ``Error`` (the connection is
    unusable from that byte on — callers drop it and re-enter their
    reconnect path)."""
    hdr = bytearray(HDR_BYTES)
    if not _recv_header(sock, memoryview(hdr)):
        raise ConnectionError("dsserve peer closed")
    magic, kind, flags, _rsv, seq, epoch, mlen, plen, crc = _HDR.unpack(
        bytes(hdr)
    )
    if magic != MAGIC:
        raise Error(f"dsserve: bad frame magic {magic:#x}")
    if mlen > MAX_META or plen > MAX_PAYLOAD:
        raise Error(
            f"dsserve: hostile frame lengths (meta={mlen}, payload={plen})"
        )
    meta: Dict = {}
    if mlen:
        try:
            meta = json.loads(bytes(_recv_exact(sock, mlen, "meta")))
        except ValueError as e:
            raise Error(f"dsserve: undecodable frame meta: {e}") from e
        if not isinstance(meta, dict):
            raise Error("dsserve: frame meta must be a JSON object")
    payload = None
    if callable(buf) and not flags & FLAG_COMPRESSED:
        # the caller picks the buffer once the header names the size
        # (the client's pool sizes itself before the first payload
        # lands); a compressed payload's is picked after its decode
        buf = buf(plen) if plen else None
    if plen:
        if flags & FLAG_COMPRESSED:
            payload = _recv_compressed(sock, meta, plen, crc, buf)
        else:
            payload = _recv_payload_into(sock, plen, buf)
            got = binascii.crc32(memoryview(payload)) & 0xFFFFFFFF
            if got != crc:
                raise Error(
                    f"dsserve: slot crc mismatch "
                    f"(got {got:#x}, want {crc:#x})"
                )
        if kind == KIND_SLOT:
            _BYTES_WIRE.inc(plen)
            _BYTES_RAW.inc(payload.nbytes)
    return kind, meta, payload, seq, epoch


def _recv_payload_into(sock, plen: int, buf) -> np.ndarray:
    """plen wire bytes → a uint8 array: ``buf``'s head when it fits
    (zero allocations), else a fresh array (ticked)."""
    if buf is not None:
        view = memoryview(buf).cast("B")
        if len(view) >= plen:
            _recv_exact_into(sock, view[:plen], "payload")
            if isinstance(buf, np.ndarray):
                # slice, don't re-wrap: the view's .base collapses to
                # ``buf`` itself, so a pool tracking buf's liveness
                # (weakref.finalize) sees every downstream alias
                return buf[:plen]
            return np.frombuffer(buf, dtype=np.uint8, count=plen)
    _RECV_ALLOC.inc(plen)
    out = np.empty(plen, dtype=np.uint8)
    _recv_exact_into(sock, memoryview(out), "payload")
    return out


def _recv_compressed(sock, meta: Dict, plen: int, crc: int, buf):
    """Receive + decode a FLAG_COMPRESSED payload. The compressed wire
    bytes and the codec's decode output are both unavoidable
    allocations (ticked honestly) — the pooled buffer still saves the
    final resting copy when the decoded slot fits."""
    try:
        codec = get_codec(str(meta["codec"]))
        raw_len = int(meta["raw_len"])
    except (KeyError, TypeError, ValueError, Error) as e:
        raise Error(f"dsserve: bad compressed-slot meta: {e}") from e
    if raw_len < 0 or raw_len > MAX_PAYLOAD:
        raise Error(f"dsserve: hostile raw_len {raw_len}")
    wire_bytes = _recv_exact(sock, plen, "payload")
    got = binascii.crc32(memoryview(wire_bytes)) & 0xFFFFFFFF
    if got != crc:
        raise Error(
            f"dsserve: slot crc mismatch (got {got:#x}, want {crc:#x})"
        )
    _RECV_ALLOC.inc(plen + raw_len)
    raw = codec.decompress(wire_bytes, raw_len)
    if len(raw) != raw_len:
        raise Error(
            f"dsserve: compressed slot decoded to {len(raw)} bytes, "
            f"meta promised {raw_len}"
        )
    if callable(buf):
        buf = buf(raw_len)
    if buf is not None:
        view = memoryview(buf).cast("B")
        if len(view) >= raw_len:
            view[:raw_len] = raw
            if isinstance(buf, np.ndarray):
                return buf[:raw_len]  # see _recv_payload_into
            return np.frombuffer(buf, dtype=np.uint8, count=raw_len)
    return np.frombuffer(bytearray(raw), dtype=np.uint8)


def recv_alloc_bytes() -> int:
    """Process-wide fresh-allocation bytes on the payload receive path
    — the bench/regression assertion surface: the delta over a drain
    stays 0 while every slot lands in a pooled recv buffer."""
    return int(_RECV_ALLOC.value())


def recv_frame(sock) -> Tuple[int, Dict, Optional[np.ndarray], int, int]:
    """Read one frame → (kind, meta, payload, seq, epoch); the payload
    lands in a freshly allocated uint8 array. Control-frame and
    test-path reader — the hot slot path is :func:`read_frame_into`."""
    return _read_frame(sock, None)


def read_frame_into(
    sock, buf
) -> Tuple[int, Dict, Optional[np.ndarray], int, int]:
    """Read one frame with the payload landing directly in ``buf`` (a
    writable buffer-protocol object, typically a pooled page-aligned
    slot) via ``recv_into`` — the zero-copy receive path: no payload
    allocation, and the returned payload is a uint8 view over ``buf``
    the caller's ``read_batch`` sections alias in place. Falls back to
    a fresh allocation (ticked on ``dsserve.recv_alloc_bytes``) when
    ``buf`` is too small for the slot. ``buf`` may also be a callable
    taking the payload's decoded size and returning the buffer (or
    None), called once the header is read."""
    return _read_frame(sock, buf)


# -- packed-slot (de)serialization --------------------------------------------


def slot_meta(batch: Batch, shard: int) -> Dict:
    """SLOT meta for a producer batch: the ``packed_layout`` descriptor
    + ``n_valid`` + serving micro-shard. Raises when the batch has no
    usable packed layout — every repo producer (fused rings and the
    generic FixedShapeBatcher alike) emits single-buffer batches, so a
    non-packed batch here is a producer bug, not a fallback case."""
    layout = packed_layout(batch)
    if layout is None:
        raise Error(
            "dsserve can only serve packed single-buffer batches "
            "(Batch.packed with contiguous section views)"
        )
    return {
        "shard": int(shard),
        "n_valid": int(batch.n_valid),
        "sections": [
            [name, int(off), int(nb), list(shape), dtype]
            for name, off, nb, shape, dtype in layout
        ],
    }


def read_batch(meta: Dict, payload: np.ndarray) -> Batch:
    """Rebuild a Batch over the received payload buffer: zero-copy
    views per the SLOT meta's section descriptors — byte-for-byte the
    producer's ``alloc_packed_slot`` layout, so the staging pipeline's
    packed single-DMA / packed-shard paths engage exactly as they
    would for a local producer."""
    fields: Dict[str, np.ndarray] = {}
    try:
        n_valid = int(meta["n_valid"])
        for name, off, nb, shape, dtype in meta["sections"]:
            if off < 0 or off + nb > payload.nbytes:
                raise Error(
                    f"dsserve: section {name!r} [{off},{off + nb}) outside "
                    f"the {payload.nbytes}-byte slot payload"
                )
            fields[str(name)] = (
                payload[off : off + nb].view(np.dtype(dtype)).reshape(shape)
            )
    except (KeyError, TypeError, ValueError) as e:
        raise Error(f"dsserve: malformed slot meta: {e}") from e
    for req in ("labels", "weights"):
        if req not in fields:
            raise Error(f"dsserve: slot meta missing section {req!r}")
    return Batch(
        labels=fields["labels"],
        weights=fields["weights"],
        n_valid=n_valid,
        indices=fields.get("indices"),
        values=fields.get("values"),
        nnz=fields.get("nnz"),
        x=fields.get("x"),
        packed=payload,
    )
