"""RowBlock: a batch of sparse rows in CSR layout (dmlc data.h:175-236),
and ``Row``, the view of one of its rows (data.h:74-162, 364-382).

Arrays (numpy, contiguous):
  offset : int64[size+1]  CSR row offsets
  label  : float32[size]
  index  : uint32/uint64[nnz]
  value  : float32[nnz] | None  (None = all 1.0, binary features)
  weight : float32[size] | None (None = all 1.0)
  qid    : int64[size] | None   (libsvm query ids)
  field  : int64[nnz] | None    (libfm field ids)
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..io import serializer
from ..io.stream import Stream
from ..utils.logging import check, check_eq

__all__ = ["INDEX_T", "REAL_T", "Row", "RowBlock", "RowBlockContainer"]

# reference data.h:26-32: real_t = float; feature ids of parsed text blocks
REAL_T = np.float32
INDEX_T = np.uint64


class Row:
    """One sparse row: views into its RowBlock's arrays (reference
    data.h:74-162)."""

    __slots__ = ("label", "weight", "qid", "field", "index", "value")

    def __init__(self, label, weight, qid, field, index, value) -> None:
        self.label = label
        self.weight = weight
        self.qid = qid
        self.field = field
        self.index = index
        self.value = value

    def __len__(self) -> int:
        return len(self.index)

    def get_value(self, i: int):
        """value[i], or 1 when the row has no values (data.h:120-127)."""
        return REAL_T(1.0) if self.value is None else self.value[i]

    def sdot(self, weight: np.ndarray) -> float:
        """The row's dot product with a dense weight vector (SDot,
        data.h:137-152)."""
        idx = np.asarray(self.index, dtype=np.int64)
        if self.value is None:
            return float(weight[idx].sum())
        return float(weight[idx] @ self.value)

    def __repr__(self) -> str:
        return f"Row(label={self.label}, nnz={len(self)})"


class RowBlock:
    __slots__ = ("offset", "label", "index", "value", "weight", "qid", "field")

    def __init__(
        self,
        offset: np.ndarray,
        label: np.ndarray,
        index: np.ndarray,
        value: Optional[np.ndarray] = None,
        weight: Optional[np.ndarray] = None,
        qid: Optional[np.ndarray] = None,
        field: Optional[np.ndarray] = None,
    ) -> None:
        self.offset = np.ascontiguousarray(offset, dtype=np.int64)
        self.label = np.ascontiguousarray(label)
        self.index = np.ascontiguousarray(index)
        self.value = None if value is None else np.ascontiguousarray(value)
        self.weight = None if weight is None else np.ascontiguousarray(weight)
        self.qid = None if qid is None else np.ascontiguousarray(qid)
        self.field = None if field is None else np.ascontiguousarray(field)
        check_eq(int(self.offset[0]), 0, "offset must start at 0")
        check_eq(len(self.label), self.size, "label size mismatch")
        check_eq(int(self.offset[-1]), len(self.index), "offset/index mismatch")
        if self.value is not None:
            check_eq(len(self.value), self.nnz, "value size mismatch")
        if self.weight is not None:
            check_eq(len(self.weight), self.size, "weight size mismatch")
        if self.qid is not None:
            check_eq(len(self.qid), self.size, "qid size mismatch")
        if self.field is not None:
            check_eq(len(self.field), self.nnz, "field size mismatch")

    @property
    def size(self) -> int:
        return len(self.offset) - 1

    def __len__(self) -> int:
        return self.size

    @property
    def nnz(self) -> int:
        return len(self.index)

    def get_weight(self, i: int):
        """weight[i], or 1 when the block has no weights."""
        return REAL_T(1.0) if self.weight is None else self.weight[i]

    def __getitem__(self, i: int) -> Row:
        """Row ``i`` as views into this block (data.h:364-382)."""
        check(0 <= i < self.size, f"row index {i} out of range")
        lo, hi = int(self.offset[i]), int(self.offset[i + 1])
        return Row(label=self.label[i], weight=self.get_weight(i),
                   qid=None if self.qid is None else self.qid[i],
                   field=None if self.field is None else self.field[lo:hi],
                   index=self.index[lo:hi],
                   value=None if self.value is None else self.value[lo:hi])

    def __iter__(self) -> Iterator[Row]:
        for i in range(self.size):
            yield self[i]

    def slice(self, begin: int, end: int) -> "RowBlock":
        """Zero-copy sub-block with rebased offsets (data.h:384-394)."""
        check(0 <= begin <= end <= self.size, "invalid slice range")
        lo, hi = int(self.offset[begin]), int(self.offset[end])
        return RowBlock(
            offset=self.offset[begin : end + 1] - lo,
            label=self.label[begin:end],
            index=self.index[lo:hi],
            value=None if self.value is None else self.value[lo:hi],
            weight=None if self.weight is None else self.weight[begin:end],
            qid=None if self.qid is None else self.qid[begin:end],
            field=None if self.field is None else self.field[lo:hi],
        )

    def mem_cost_bytes(self) -> int:
        """The arrays' bytes (reference MemCostBytes, data.h:203-214)."""
        cost = self.offset.nbytes + self.label.nbytes + self.index.nbytes
        for a in (self.weight, self.qid, self.field, self.value):
            if a is not None:
                cost += a.nbytes
        return cost

    def max_index(self) -> int:
        return int(self.index.max()) if len(self.index) else 0

    def save(self, stream: Stream) -> None:
        """One page of ``DiskRowIter``'s cache: a presence mask, then the
        arrays as dtype-tagged ``serializer`` frames (the JAX package's
        bytes; reference RowBlockContainer::Save, row_block.h:189-200)."""
        mask = ((1 if self.weight is not None else 0) | (2 if self.qid is not None else 0)
                | (4 if self.field is not None else 0) | (8 if self.value is not None else 0))
        serializer.write_scalar(stream, mask, "uint32")
        for a in (self.offset, self.label, self.index, self.weight, self.qid, self.field,
                  self.value):
            if a is not None:
                serializer.write_ndarray(stream, a)

    @staticmethod
    def load(stream: Stream) -> Optional["RowBlock"]:
        """The inverse of ``save``; None at a clean end of the stream."""
        mask = serializer.try_read_scalar(stream, "uint32")
        if mask is None:
            return None
        offset, label, index = (serializer.read_ndarray(stream) for _ in range(3))
        weight, qid, field, value = (serializer.read_ndarray(stream) if mask & bit else None
                                     for bit in (1, 2, 4, 8))
        return RowBlock(offset=offset, label=label, index=index, value=value,
                        weight=weight, qid=qid, field=field)

    @staticmethod
    def concat(blocks: Sequence["RowBlock"]) -> "RowBlock":
        """One block holding ``blocks`` back to back."""
        check(len(blocks) > 0, "cannot concat zero blocks")
        if len(blocks) == 1:
            return blocks[0]
        offsets = [blocks[0].offset]
        base = int(blocks[0].offset[-1])
        for b in blocks[1:]:
            offsets.append(b.offset[1:] + base)
            base += int(b.offset[-1])

        def cat(name: str, fill):
            parts = [getattr(b, name) for b in blocks]
            if all(p is None for p in parts):
                return None
            per_row = name in ("weight", "qid")
            return np.concatenate([
                np.full(b.size if per_row else b.nnz, fill)
                if p is None else p
                for b, p in zip(blocks, parts)
            ])

        return RowBlock(
            offset=np.concatenate(offsets),
            label=np.concatenate([b.label for b in blocks]),
            index=np.concatenate([b.index for b in blocks]),
            value=cat("value", np.float32(1.0)),
            weight=cat("weight", np.float32(1.0)),
            qid=cat("qid", np.int64(0)),
            field=cat("field", np.int64(0)),
        )


class RowBlockContainer:
    """A growing RowBlock (reference src/data/row_block.h:28-218): whole
    blocks (``push_block``) and single rows (``push_row``) kept as pushed,
    concatenated once by ``to_block``."""

    def __init__(self, index_dtype=INDEX_T) -> None:
        self.index_dtype = index_dtype
        self.clear()

    def clear(self) -> None:
        self._blocks: List[RowBlock] = []
        self._rows: List[Tuple] = []
        self.max_index = 0
        self.max_field = 0

    @property
    def size(self) -> int:
        return sum(b.size for b in self._blocks) + len(self._rows)

    def mem_cost_bytes(self) -> int:
        return (sum(b.mem_cost_bytes() for b in self._blocks)
                + sum(48 + len(r[4]) * 12 for r in self._rows))

    def push_row(self, label: float, index: Sequence[int],
                 value: Optional[Sequence[float]] = None, weight: float = 1.0,
                 qid: int = 0, field: Optional[Sequence[int]] = None) -> None:
        """One row (reference Push(Row), row_block.h:89-120)."""
        idx = np.asarray(index, dtype=self.index_dtype)
        if value is not None:
            check_eq(len(value), len(idx), "push_row: value/index length mismatch")
        if field is not None:
            check_eq(len(field), len(idx), "push_row: field/index length mismatch")
        if len(idx):
            self.max_index = max(self.max_index, int(idx.max()))
        if field is not None and len(field):
            self.max_field = max(self.max_field, int(max(field)))
        self._rows.append((label, weight, qid, field, idx, value))

    def push_block(self, block: RowBlock) -> None:
        """A whole block (reference Push(RowBlock), row_block.h:122-166)."""
        self._flush_rows()
        self._blocks.append(block)
        if block.nnz:
            self.max_index = max(self.max_index, block.max_index())
        if block.field is not None and len(block.field):
            self.max_field = max(self.max_field, int(block.field.max()))

    def _flush_rows(self) -> None:
        """The pushed rows as one block; a weight of all 1 and a qid of
        all 0 are left out, as the JAX container leaves them out."""
        if not self._rows:
            return
        rows, self._rows = self._rows, []
        offset = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum([len(r[4]) for r in rows], out=offset[1:])
        weight = np.array([r[1] for r in rows], dtype=REAL_T)
        qid = np.array([r[2] for r in rows], dtype=np.int64)
        value = field = None
        if any(r[5] is not None for r in rows):
            value = np.concatenate([
                np.asarray(np.ones(len(r[4]), dtype=REAL_T) if r[5] is None else r[5],
                           dtype=REAL_T) for r in rows])
        if any(r[3] is not None for r in rows):
            field = np.concatenate([
                np.asarray(np.zeros(len(r[4]), np.int64) if r[3] is None else r[3],
                           dtype=np.int64) for r in rows])
        self._blocks.append(RowBlock(
            offset=offset, label=np.array([r[0] for r in rows], dtype=REAL_T),
            index=np.concatenate([r[4] for r in rows]).astype(self.index_dtype, copy=False),
            value=value, weight=None if np.all(weight == 1.0) else weight,
            qid=None if np.all(qid == 0) else qid, field=field))

    def to_block(self) -> RowBlock:
        """One CSR block of everything pushed (reference GetBlock,
        row_block.h:169-188)."""
        self._flush_rows()
        if not self._blocks:
            return RowBlock(offset=np.zeros(1, dtype=np.int64),
                            label=np.empty(0, dtype=REAL_T),
                            index=np.empty(0, dtype=self.index_dtype))
        return RowBlock.concat(self._blocks)

    def save(self, stream: Stream) -> None:
        self.to_block().save(stream)

    def load(self, stream: Stream) -> bool:
        """The next saved block in place of the contents; False at the
        end of the stream."""
        blk = RowBlock.load(stream)
        if blk is None:
            return False
        self.clear()
        self.push_block(blk)
        return True
