"""Dense CSV parser (the port of ``dmlc_core_tpu/data/csv_parser.py``;
reference src/data/csv_parser.h). Every column but the label and weight
columns becomes a dense feature with running index 0..k-1; an empty or
non-numeric cell parses as its longest numeric prefix, else 0.
``label_column`` -1 gives label 0.0; ``weight_column`` applies to float32
only; ``dtype`` is float32, int32 or int64 (csv_parser.h:95-111).

``parse_block`` runs the native CSR parse for float32 (the plain parse
for the integer dtypes); ``parse_block_plain`` is the grammar in Python.
The options (``args`` or keywords) go through ``CSVParserParam``.
"""

from __future__ import annotations

import re
from typing import Mapping, Optional

import numpy as np

from ..params.parameter import Parameter, field
from ..utils.logging import Error, check, check_eq
from . import native
from .row_block import INDEX_T, RowBlock
from .strtonum import I64_MAX, I64_MIN
from .text_parser import TextParserBase

__all__ = ["CSVParser", "CSVParserParam"]

_DTYPES = {"float32": np.float32, "int32": np.int32, "int64": np.int64}

_FLOAT_PREFIX = re.compile(
    rb"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf(inity)?|nan)",
    re.IGNORECASE,
)
_INT_PREFIX = re.compile(rb"([+-]?)(0[xX][0-9a-fA-F]+|[0-9]+)")


def _clamp_i64(v: int) -> int:
    return min(max(v, I64_MIN), I64_MAX)


def _parse_cell(cell: bytes, is_float: bool):
    """C strtof / strtoll(base 0) prefix semantics (csv_parser.h:98-106):
    the longest numeric prefix, 0 if none; underscores never accepted;
    integer overflow clamps like strtoll."""
    if is_float:
        if b"_" not in cell:
            try:
                return float(cell)
            except ValueError:
                pass
        m = _FLOAT_PREFIX.match(cell.strip())
        return float(m.group(0)) if m else 0.0
    if b"_" not in cell:
        try:
            return _clamp_i64(int(cell, 0))
        except ValueError:
            pass
    m = _INT_PREFIX.match(cell.strip())
    if not m:
        return 0
    sign, digits = m.group(1), m.group(2)
    if digits[:2].lower() == b"0x":
        val = int(digits, 16)
    elif digits.startswith(b"0") and len(digits) > 1:
        val = int(re.match(rb"0[0-7]*", digits).group(0), 8)
    else:
        val = int(digits)
    return _clamp_i64(-val if sign == b"-" else val)


class CSVParserParam(Parameter):
    """Reference CSVParserParam (csv_parser.h:23-39)."""

    format = field(str, default="csv", help="File format.")
    label_column = field(
        int, default=-1,
        help="Column index (0-based) that will put into label.",
    )
    delimiter = field(
        str, default=",", help="Delimiter used in the csv file."
    )
    weight_column = field(
        int, default=-1,
        help="Column index that will put into instance weights.",
    )
    dtype = field(
        str, default="float32", enum={k: k for k in _DTYPES},
        help="Value dtype (reference DType dispatch, data.cc:138-210).",
    )


class CSVParser(TextParserBase):
    def __init__(
        self,
        source,
        args: Optional[Mapping[str, object]] = None,
        nthread: Optional[int] = None,
        index_dtype=INDEX_T,
        **params,
    ) -> None:
        self.param = CSVParserParam()
        self.param.init({**(args or {}), **params}, allow_unknown=True)
        check_eq(self.param.format, "csv", "format mismatch")
        check(
            self.param.label_column != self.param.weight_column
            or self.param.label_column < 0,
            "Must have distinct columns for labels and instance weights",
        )
        check_eq(len(self.param.delimiter), 1, "delimiter must be one char")
        super().__init__(source, nthread)
        self.dtype = _DTYPES[self.param.dtype]
        self.index_dtype = index_dtype

    def parse_block(self, data: bytes) -> RowBlock:
        if self.param.dtype != "float32":
            return self.parse_block_plain(data)
        offset, label, weight, index, value = native.parse_csv(
            data, ord(self.param.delimiter), self.param.label_column,
            self.param.weight_column)
        return RowBlock(offset=offset, label=label,
                        index=index.astype(self.index_dtype, copy=False),
                        value=value, weight=weight)

    def parse_block_plain(self, data: bytes) -> RowBlock:
        delim = self.param.delimiter.encode()
        lcol, wcol = self.param.label_column, self.param.weight_column
        is_float = self.dtype == np.float32
        labels, weights, index, values = [], [], [], []
        offset = [0]
        any_weight = False
        for line in data.splitlines():
            if not line:
                continue
            label, weight, k = 0.0, None, 0
            for col, cell in enumerate(line.split(delim)):
                v = _parse_cell(cell, is_float)
                if col == lcol:
                    label = v
                elif is_float and col == wcol:
                    weight = v
                    any_weight = True
                else:
                    values.append(v)
                    index.append(k)
                    k += 1
            if k == 0:
                # csv_parser.h:123-126: fatal whenever a line has no feature
                raise Error(
                    f"Delimiter {self.param.delimiter!r} is not found in "
                    "the line. Expected it to separate fields."
                )
            labels.append(label)
            weights.append(weight)
            offset.append(len(index))
        return RowBlock(
            offset=np.asarray(offset, dtype=np.int64),
            label=np.asarray(labels, dtype=np.float32),
            index=np.asarray(index, dtype=self.index_dtype),
            value=np.asarray(values, dtype=self.dtype),
            weight=(np.asarray([1.0 if w is None else w for w in weights],
                               dtype=np.float32) if any_weight else None),
        )
