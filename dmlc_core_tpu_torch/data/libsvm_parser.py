"""LibSVM text parser (the port of ``dmlc_core_tpu/data/libsvm_parser.py``;
reference src/data/libsvm_parser.h). Line grammar::

    label[:weight] [qid:n] index[:value] index[:value] ...  [# comment]

- ``#`` starts a comment; blank and comment-only lines are skipped.
- A feature without ``:value`` is binary (value 1.0); a block mixing
  valued and unvalued features gets 1.0 for the unvalued ones.
- ``indexing_mode``: >0 forces 1-based, 0 forces 0-based, <0 detects per
  block (all ids > 0 means 1-based, as sklearn.load_svmlight_file).

``parse_block`` runs the native CSR parse; ``parse_block_plain`` is the
same grammar in Python, the semantic definition the tests hold it to. The
options (``args`` or keywords) go through ``LibSVMParserParam``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from ..params.parameter import Parameter, field
from ..utils.logging import check_eq
from . import native
from .row_block import INDEX_T, RowBlock
from .strtonum import parse_float_token, parse_int_token, parse_pair
from .text_parser import TextParserBase

__all__ = ["LibSVMParser", "LibSVMParserParam"]


class LibSVMParserParam(Parameter):
    """Reference LibSVMParserParam (libsvm_parser.h:24-39)."""

    format = field(str, default="libsvm", help="File format")
    indexing_mode = field(
        int,
        default=0,
        help=(
            "If >0, treat all feature indices as 1-based. If =0, 0-based. "
            "If <0, auto-detect (all ids > 0 means 1-based)."
        ),
    )


class LibSVMParser(TextParserBase):
    def __init__(
        self,
        source,
        args: Optional[Mapping[str, object]] = None,
        nthread: Optional[int] = None,
        index_dtype=INDEX_T,
        **params,
    ) -> None:
        self.param = LibSVMParserParam()
        self.param.init({**(args or {}), **params}, allow_unknown=True)
        check_eq(self.param.format, "libsvm", "format mismatch")
        super().__init__(source, nthread)
        self.index_dtype = index_dtype

    def parse_block(self, data: bytes) -> RowBlock:
        offset, label, weight, qid, index, value = native.parse_libsvm(
            data, self.param.indexing_mode)
        return RowBlock(offset=offset, label=label,
                        index=index.astype(self.index_dtype, copy=False),
                        value=value, weight=weight, qid=qid)

    def parse_block_plain(self, data: bytes) -> RowBlock:
        labels, weights, qids, index, values = [], [], [], [], []
        offset = [0]
        any_value = False
        for line in data.splitlines():
            hash_pos = line.find(b"#")
            if hash_pos >= 0:
                line = line[:hash_pos]
            toks = line.split()
            if not toks:
                continue
            lw = parse_pair(toks[0])
            if lw is None:
                continue
            label, weight = lw
            start = 1
            qid = None
            if len(toks) > 1 and toks[1].startswith(b"qid:"):
                # garbage or overflow qid → 0, parsing goes on (reference atoll)
                qid = parse_int_token(toks[1][4:]) or 0
                start = 2
            row_vals = []
            for t in toks[start:]:
                c = t.find(b":")
                if c < 0:
                    feat, val = parse_int_token(t), None
                else:
                    feat = parse_int_token(t[:c])
                    val = parse_float_token(t[c + 1:])
                    if val is None:
                        feat = None
                if feat is None:
                    continue  # malformed token: reference ParsePair r<1 skip
                index.append(feat)
                row_vals.append(val)
            if any(v is not None for v in row_vals):
                any_value = True
            values.extend(row_vals)
            labels.append(label)
            weights.append(weight)
            qids.append(qid)
            offset.append(len(index))
        idx_arr = np.asarray(index, dtype=np.int64)
        min_feat = int(idx_arr.min()) if len(idx_arr) else None
        mode = self.param.indexing_mode
        if mode > 0 or (mode < 0 and min_feat is not None and min_feat > 0):
            idx_arr = idx_arr - 1
        return RowBlock(
            offset=np.asarray(offset, dtype=np.int64),
            label=np.asarray(labels, dtype=np.float32),
            index=idx_arr.astype(self.index_dtype, copy=False),
            value=(np.asarray([1.0 if v is None else v for v in values],
                              dtype=np.float32) if any_value else None),
            weight=(np.asarray([1.0 if w is None else w for w in weights],
                               dtype=np.float32)
                    if any(w is not None for w in weights) else None),
            qid=(np.asarray([0 if q is None else q for q in qids], np.int64)
                 if any(q is not None for q in qids) else None),
        )
