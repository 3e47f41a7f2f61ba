"""LibFM text parser (the port of ``dmlc_core_tpu/data/libfm_parser.py``;
reference src/data/libfm_parser.h). Line grammar::

    label[:weight] field:index[:value] field:index[:value] ...

Tokens with fewer than two numbers are skipped (reference ParseTriple
r<=1, libfm_parser.h:109-113). ``indexing_mode`` as in libsvm, but
detection (<0) needs BOTH all field ids and all feature ids > 0
(libfm_parser.h:132-144).

``parse_block`` runs the native CSR parse; ``parse_block_plain`` is the
same grammar in Python. The options (``args`` or keywords) go through
``LibFMParserParam``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from ..params.parameter import Parameter, field
from ..utils.logging import check_eq
from . import native
from .row_block import INDEX_T, RowBlock
from .strtonum import parse_pair, parse_triple
from .text_parser import TextParserBase

__all__ = ["LibFMParser", "LibFMParserParam"]


class LibFMParserParam(Parameter):
    """Reference LibFMParserParam (libfm_parser.h:24-39)."""

    format = field(str, default="libfm", help="File format")
    indexing_mode = field(
        int,
        default=0,
        help=(
            "If >0, treat all field and feature indices as 1-based. "
            "If =0, 0-based. If <0, auto-detect."
        ),
    )


class LibFMParser(TextParserBase):
    def __init__(
        self,
        source,
        args: Optional[Mapping[str, object]] = None,
        nthread: Optional[int] = None,
        index_dtype=INDEX_T,
        **params,
    ) -> None:
        self.param = LibFMParserParam()
        self.param.init({**(args or {}), **params}, allow_unknown=True)
        check_eq(self.param.format, "libfm", "format mismatch")
        super().__init__(source, nthread)
        self.index_dtype = index_dtype

    def parse_block(self, data: bytes) -> RowBlock:
        offset, label, weight, fields, index, value = native.parse_libfm(
            data, self.param.indexing_mode)
        return RowBlock(offset=offset, label=label,
                        index=index.astype(self.index_dtype, copy=False),
                        value=value, weight=weight, field=fields)

    def parse_block_plain(self, data: bytes) -> RowBlock:
        labels, weights, fields, index, values = [], [], [], [], []
        offset = [0]
        any_value = False
        for line in data.splitlines():
            toks = line.split()
            if not toks:
                continue
            lw = parse_pair(toks[0])
            if lw is None:
                continue
            label, weight = lw
            for t in toks[1:]:
                triple = parse_triple(t)
                if triple is None:
                    continue
                fid, feat, val = triple
                fields.append(fid)
                index.append(feat)
                values.append(val)
                any_value = any_value or val is not None
            labels.append(label)
            weights.append(weight)
            offset.append(len(index))
        field_arr = np.asarray(fields, dtype=np.int64)
        idx_arr = np.asarray(index, dtype=np.int64)
        mode = self.param.indexing_mode
        if mode > 0 or (mode < 0 and len(idx_arr) and idx_arr.min() > 0
                        and len(field_arr) and field_arr.min() > 0):
            idx_arr = idx_arr - 1
            field_arr = field_arr - 1
        return RowBlock(
            offset=np.asarray(offset, dtype=np.int64),
            label=np.asarray(labels, dtype=np.float32),
            index=idx_arr.astype(self.index_dtype, copy=False),
            value=(np.asarray([1.0 if v is None else v for v in values],
                              dtype=np.float32) if any_value else None),
            weight=(np.asarray([1.0 if w is None else w for w in weights],
                               dtype=np.float32)
                    if any(w is not None for w in weights) else None),
            field=field_arr,
        )
