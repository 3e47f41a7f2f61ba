"""rowrec: binary sparse-row payloads inside RecordIO frames.

Per-record payload (little-endian), the field set of dmlc's Row:

    label   f32
    weight  f32
    nnz     u32
    indices u32[nnz]
    values  f32[nnz]

Float payload bytes can equal the RecordIO magic, so multipart chains do
occur; the framing in io/recordio.py escapes and reassembles them.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterable, List, Optional

import numpy as np

from ..io.recordio import IndexedRecordIOWriter, RecordIOChunkReader, RecordIOWriter
from ..io.split import RecordIOSplitter
from ..utils.logging import check
from .parser import Parser
from .row_block import RowBlock

__all__ = [
    "RowRecParser",
    "decode_record",
    "decode_records",
    "encode_rows",
    "write_rowrec",
]

_HEAD = struct.Struct("<ffI")  # label, weight, nnz


def encode_rows(block: RowBlock) -> List[bytes]:
    """RowBlock → one payload per row."""
    idx = block.index.astype("<u4", copy=False)
    val = (
        np.ones(block.nnz, dtype="<f4")
        if block.value is None
        else block.value.astype("<f4", copy=False)
    )
    weights = (
        np.ones(block.size, dtype=np.float32)
        if block.weight is None
        else block.weight
    )
    out: List[bytes] = []
    for i in range(block.size):
        b, e = int(block.offset[i]), int(block.offset[i + 1])
        out.append(
            _HEAD.pack(float(block.label[i]), float(weights[i]), e - b)
            + idx[b:e].tobytes()
            + val[b:e].tobytes()
        )
    return out


def decode_record(payload) -> tuple:
    """One payload → (label, weight, indices u32, values f32)."""
    mv = memoryview(payload)
    check(len(mv) >= 12, "rowrec payload shorter than its header")
    label, weight, n = _HEAD.unpack_from(mv, 0)
    check(len(mv) >= 12 + 8 * n, "rowrec payload shorter than declared nnz")
    idx = np.frombuffer(mv, dtype="<u4", count=n, offset=12)
    val = np.frombuffer(mv, dtype="<f4", count=n, offset=12 + 4 * n)
    return label, weight, idx, val


def decode_records(records: Iterable) -> RowBlock:
    """Record payloads → one RowBlock."""
    labels: List[float] = []
    weights: List[float] = []
    offsets: List[int] = [0]
    idx_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []
    for rec in records:
        label, weight, idx, val = decode_record(rec)
        labels.append(label)
        weights.append(weight)
        offsets.append(offsets[-1] + len(idx))
        idx_parts.append(idx)
        val_parts.append(val)
    return RowBlock(
        offset=np.asarray(offsets, dtype=np.int64),
        label=np.asarray(labels, dtype=np.float32),
        index=(
            np.concatenate(idx_parts).astype(np.uint32, copy=False)
            if idx_parts else np.empty(0, dtype=np.uint32)
        ),
        value=(
            np.concatenate(val_parts).astype(np.float32, copy=False)
            if val_parts else np.empty(0, dtype=np.float32)
        ),
        weight=np.asarray(weights, dtype=np.float32),
    )


def write_rowrec(stream: BinaryIO, blocks: Iterable[RowBlock],
                 index_stream: Optional[BinaryIO] = None, codec=None,
                 level: Optional[int] = None) -> int:
    """Write RowBlocks as rowrec RecordIO frames; returns rows written.
    With ``index_stream``, also write the index that ``?index=`` reads
    (``IndexedRecordIOWriter``); with ``codec`` (an ``io/codec.py``
    name), the rows go into compressed blocks and the index holds
    ``block:in`` pairs. The bytes of both equal dmlc_core_tpu's
    ``write_rowrec`` for the same arguments."""
    writer = (RecordIOWriter(stream, codec=codec, level=level) if index_stream is None
              else IndexedRecordIOWriter(stream, index_stream, codec=codec, level=level))
    n = 0
    for blk in blocks:
        for payload in encode_rows(blk):
            writer.write_record(payload)
            n += 1
    writer.flush_block()
    return n


class RowRecParser(Parser):
    """Part ``part_index`` of ``num_parts`` of a local .rec file, or the
    chunks of a split of one (``io.split.create``) → one RowBlock per
    chunk of whole records, decoded record by record (the plain version
    the native rowrec producer is held to)."""

    def __init__(
        self, source, part_index: int = 0, num_parts: int = 1
    ) -> None:
        self._source = (RecordIOSplitter(source, part_index, num_parts)
                        if isinstance(source, str) else source)

    def parse_next(self) -> Optional[List[RowBlock]]:
        chunk = self._source.next_chunk()
        if chunk is None:
            return None
        return [decode_records(RecordIOChunkReader(chunk))]

    def close(self) -> None:
        self._source.close()
