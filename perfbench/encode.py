"""Frozen encoders for the benchmark's input files: rowrec RecordIO
frames, the ``key<TAB>offset`` index, libsvm and csv text.

These are the benchmark's own copies, written from the formats' specs
(dmlc-core ``recordio.h``/``recordio.cc`` framing with the aligned-magic
escape; the rowrec payload ``label f32, weight f32, nnz u32, indices
u32[nnz], values f32[nnz]``), so a bug in the program's writer cannot
hide a bug in its reader. Text is built with numpy byte matrices, not
per-value Python formatting, so a run's set-up stays short.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np

KMAGIC = 0xCED7230A
_MAGIC = struct.pack("<I", KMAGIC)


def lrec(cflag: int, length: int) -> int:
    """The frame's second word: cflag in the top 3 bits, the length below."""
    return ((cflag & 7) << 29) | length


def frame(payload: bytes) -> bytes:
    """One record framed with the aligned-magic escape: a payload word
    equal to the magic ends a part (cflag 1 first, 2 middle, 3 last) and
    is dropped, since the reader puts it back between parts."""
    words = np.frombuffer(payload[: len(payload) & ~3], dtype="<u4")
    cuts = (np.nonzero(words == KMAGIC)[0] * 4).tolist()
    out: List[bytes] = []
    start = 0
    for pos in cuts:
        out += [_MAGIC, struct.pack("<I", lrec(1 if start == 0 else 2, pos - start)),
                payload[start:pos]]
        start = pos + 4
    tail = len(payload) - start
    out += [_MAGIC, struct.pack("<I", lrec(3 if cuts else 0, tail)), payload[start:],
            b"\0" * ((4 - tail % 4) % 4)]
    return b"".join(out)


def rowrec_block(labels: np.ndarray, idx: np.ndarray, val: np.ndarray
                 ) -> Tuple[bytes, np.ndarray]:
    """Rows of ``K`` entries each (idx [n,K] < 2^32, val f32 [n,K],
    labels [n], weight 1) → (the framed records, each record's length
    in bytes). Records whose payload holds the magic word take the
    escaped framing; the rest are packed in one numpy pass."""
    n, k = idx.shape
    words = np.empty((n, 3 + 2 * k), dtype="<u4")
    words[:, 0] = np.asarray(labels, dtype="<f4").view("<u4")
    words[:, 1] = np.float32(1.0).view(np.uint32)
    words[:, 2] = k
    words[:, 3:3 + k] = idx.astype("<u4")
    words[:, 3 + k:] = np.asarray(val, dtype="<f4").view("<u4")
    plain = ~np.any(words == KMAGIC, axis=1)
    framed = np.empty((n, 2 + words.shape[1]), dtype="<u4")
    framed[:, 0] = KMAGIC
    framed[:, 1] = lrec(0, 4 * words.shape[1])
    framed[:, 2:] = words
    if plain.all():
        return framed.tobytes(), np.full(n, framed.shape[1] * 4, dtype=np.int64)
    parts = [framed[i].tobytes() if plain[i] else frame(words[i].tobytes())
             for i in range(n)]
    return b"".join(parts), np.array([len(p) for p in parts], dtype=np.int64)


def index_text(offsets: np.ndarray) -> bytes:
    """The index an indexed split reads: ``<ordinal>\\t<offset>\\n`` a record."""
    n = len(offsets)
    return lines([uint_field(np.arange(n, dtype=np.int64)), const(n, b"\t"),
                  uint_field(offsets), const(n, b"\n")])[0]


# -- text built from byte matrices ------------------------------------------
# A field is (bytes uint8 [n, w], keep bool [n, w]); a line is its fields'
# kept bytes in order, so variable widths need no per-value Python.

def const(n: int, text: bytes):
    """The same bytes on every row."""
    row = np.frombuffer(text, dtype=np.uint8)
    return np.broadcast_to(row, (n, len(row))), np.ones((n, len(row)), dtype=bool)


def uint_field(x: np.ndarray):
    """Non-negative integers in decimal, without leading zeros."""
    x = np.asarray(x, dtype=np.int64)
    pow10 = 10 ** np.arange(18, -1, -1, dtype=np.int64)
    digits = (x[:, None] // pow10) % 10
    nd = np.maximum(1, np.sum(x[:, None] >= pow10, axis=1))
    keep = np.arange(19)[None, :] >= (19 - nd)[:, None]
    return (digits + 48).astype(np.uint8), keep


def sci18_field(k: np.ndarray, frac_bits: int):
    """``%.18e`` of the values ``k / 2**frac_bits`` (int64 k), exactly as C
    prints them: such a value is ``k·5^f / 10^f``, so its 19 significant
    digits are those of the integer ``|k|·5^f`` padded with zeros (it
    has at most 18 for |k| < 2^20 and f = 16), and nothing rounds."""
    k = np.asarray(k, dtype=np.int64)
    n = len(k)
    mag = (np.abs(k) * (5 ** frac_bits)).astype(np.uint64)
    pow10 = 10 ** np.arange(18, -1, -1, dtype=np.uint64)
    nd = np.sum(mag[:, None] >= pow10, axis=1)  # 0 for a zero
    # the 19 mantissa digits: |k|·5^f shifted left to 19 digits (< 2^64)
    m = mag * pow10[np.where(nd > 0, nd - 1, 18)]
    out = np.empty((n, 25), dtype=np.uint8)
    for j in (20, 19, 18, 17, 16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 1):
        out[:, j] = (m % np.uint64(10)).astype(np.uint8) + 48
        m //= np.uint64(10)
    exp = np.where(nd > 0, nd - 1 - frac_bits, 0)
    out[:, 0] = ord("-")
    out[:, 2] = ord(".")
    out[:, 21] = ord("e")
    out[:, 22] = np.where(exp < 0, ord("-"), ord("+"))
    out[:, 23] = np.abs(exp) // 10 + 48
    out[:, 24] = np.abs(exp) % 10 + 48
    keep = np.ones((n, 25), dtype=bool)
    keep[:, 0] = k < 0
    return out, keep


def lines(fields: Sequence) -> Tuple[bytes, np.ndarray]:
    """Fields side by side → (the text, each line's length in bytes)."""
    mat = np.concatenate([np.asarray(f[0]) for f in fields], axis=1)
    keep = np.concatenate([f[1] for f in fields], axis=1)
    return mat[keep].tobytes(), keep.sum(axis=1).astype(np.int64)
