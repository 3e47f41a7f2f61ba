"""RowBlock: a batch of sparse rows in CSR layout (dmlc data.h:175-236).

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

from typing import List, Optional, Sequence

import numpy as np

from ..io import serializer
from ..io.stream import Stream
from ..utils.logging import check, check_eq

__all__ = ["INDEX_T", "RowBlock", "RowBlockContainer"]

# feature ids of parsed text blocks (the JAX package's INDEX_T)
INDEX_T = np.uint64


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
    """Whole blocks gathered into one (the block half of the JAX
    package's ``RowBlockContainer``, reference row_block.h:28-218), as the
    row iterators fill their pages."""

    def __init__(self, index_dtype=INDEX_T) -> None:
        self.index_dtype = index_dtype
        self.clear()

    def clear(self) -> None:
        self._blocks: List[RowBlock] = []
        self.max_index = 0

    @property
    def size(self) -> int:
        return sum(b.size for b in self._blocks)

    def mem_cost_bytes(self) -> int:
        return sum(b.mem_cost_bytes() for b in self._blocks)

    def push_block(self, block: RowBlock) -> None:
        self._blocks.append(block)
        if block.nnz:
            self.max_index = max(self.max_index, block.max_index())

    def to_block(self) -> RowBlock:
        """One CSR block of everything pushed (reference GetBlock)."""
        if not self._blocks:
            return RowBlock(offset=np.zeros(1, dtype=np.int64),
                            label=np.empty(0, dtype=np.float32),
                            index=np.empty(0, dtype=self.index_dtype))
        return RowBlock.concat(self._blocks)

    def save(self, stream: Stream) -> None:
        self.to_block().save(stream)
