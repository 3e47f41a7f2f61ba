"""The one traffic generator: a configuration's rows from the seed, and
a traffic mix's file of them.

A configuration's ``rows`` group names the schema: ``sparse_fields``
(integer fields then categorical fields, each row one id a field, value
1, as the winning Criteo solution's preprocessing makes them: an integer
field's count ``v`` follows a power law and becomes the bucket ``v`` for
``v <= 2`` and ``floor(ln(v)^2)`` above; a categorical field's value
follows a Zipf law truncated to the field's cardinality, and a value
that the published rows would hold fewer than ``rare_min_count`` times
becomes the field's one rare value; each (field, value) is hashed into
``[0, D)``) or ``dense_table`` (a table of ``num_features`` float
columns, label first). A traffic mix names the encoding (``rowrec``,
``libsvm``, ``csv``), the batch size and the file's size. The file is
one generated block of ``block_rows`` rows written ``file_rows /
block_rows`` times, repeat ``r`` rotated by ``r * rotate_rows`` rows, so
the parts a producer's threads start at hold different rows. ``Layout``
says which block row sits at each file row and where each row starts:
the plain reference works out the batches from it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from . import encode

# the splitmix64 finaliser's constants (Steele et al., 2014)
_MIX1, _MIX2, _GOLDEN = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB, 0x9E3779B97F4A7C15
FRAC_BITS = 16  # dense_table values are multiples of 2^-16


@dataclass
class Rows:
    """One block of generated rows. Sparse: ``idx`` int64 [n,K] and
    ``val`` f32 [n,K]. Dense: ``x`` f32 [n,F] (``x_num`` the values
    times 2^16). ``labels`` f32 [n] in {0, 1}."""

    labels: np.ndarray
    idx: Optional[np.ndarray] = None
    val: Optional[np.ndarray] = None
    x: Optional[np.ndarray] = None
    x_num: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return len(self.labels)


def zipf_ranks(rng: np.random.Generator, n: int, cardinality: int, s: float) -> np.ndarray:
    """``n`` ranks in [1, cardinality] with P(r) ~ r^-s: the inverse CDF of
    the continuous power law on [1, cardinality + 1), floored."""
    u = rng.random(n)
    a = 1.0 - s
    r = np.floor((1.0 + u * ((cardinality + 1.0) ** a - 1.0)) ** (1.0 / a))
    return np.clip(r, 1, cardinality).astype(np.int64)


def hash_ids(field: int, ranks: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """(field, rank) hashed into [lo, hi) with splitmix64."""
    with np.errstate(over="ignore"):
        z = (np.uint64(field) << np.uint64(40)) ^ ranks.astype(np.uint64)
        z = z + np.uint64(_GOLDEN)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(_MIX1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(_MIX2)
        z = z ^ (z >> np.uint64(31))
    return (lo + (z % np.uint64(hi - lo))).astype(np.int64)


def rare_rank(cardinality: int, s: float, rows: int, min_count: int) -> int:
    """The last rank that ``rows`` draws of ``zipf_ranks``'s law hold at
    least ``min_count`` times in expectation: the rank ``r`` where
    ``rows * (F(r + 1) - F(r)) = min_count``, with ``F`` the law's CDF."""
    a = 1.0 - s
    span = (cardinality + 1.0) ** a - 1.0

    def count(r: int) -> float:
        return rows * (((r + 1.0) ** a - r ** a) / span)

    lo, hi = 1, cardinality
    if count(lo) < min_count:
        return 0
    while lo < hi:  # count() falls with the rank
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if count(mid) >= min_count else (lo, mid - 1)
    return lo


def log_bucket(v: np.ndarray) -> np.ndarray:
    """An integer field's count as the winning Criteo solution buckets it:
    ``v`` itself up to 2, ``floor(ln(v)^2)`` above."""
    big = np.log(np.maximum(v, 1).astype(np.float64)) ** 2
    return np.where(v > 2, np.floor(big).astype(np.int64), v)


def sparse_fields(rng: np.random.Generator, n: int, cfg: Dict) -> Rows:
    r = cfg["rows"]
    ni, cards = r["integer_fields"], r["cardinalities"]
    d = cfg["num_features"]
    k = ni + len(cards)
    idx = np.empty((n, k), dtype=np.int64)
    val = np.ones((n, k), dtype=np.float32)
    for f in range(ni):
        counts = zipf_ranks(rng, n, r["integer_max"], r["integer_exponent"]) - 1
        idx[:, f] = hash_ids(f, log_bucket(counts), 0, d)
    for f, c in enumerate(cards):
        s = r["zipf_exponent"]
        ranks = zipf_ranks(rng, n, c, s)
        ranks[ranks > rare_rank(c, s, cfg["published_train_rows"], r["rare_min_count"])] = 0
        idx[:, ni + f] = hash_ids(ni + f, ranks, 0, d)
    planted = rng.standard_normal(d).astype(np.float32)
    score = (planted[idx] * val).sum(axis=1)
    cut = np.quantile(score, 1.0 - r["positive_rate"])
    return Rows(labels=(score > cut).astype(np.float32), idx=idx, val=val)


def dense_table(rng: np.random.Generator, n: int, cfg: Dict) -> Rows:
    r = cfg["rows"]
    f = cfg["num_features"]
    pos = np.zeros(f, dtype=bool)
    pos[r["positive_columns"]] = True
    v = np.where(pos, np.exp(0.5 * rng.standard_normal((n, f))),
                 rng.standard_normal((n, f)))
    x_num = np.rint(v * (1 << FRAC_BITS)).astype(np.int64)
    x = (x_num / float(1 << FRAC_BITS)).astype(np.float32)  # exact
    planted = rng.standard_normal(f)
    labels = ((x - x.mean(axis=0)) @ planted > 0).astype(np.float32)
    return Rows(labels=labels, x=x, x_num=x_num)


ROW_KINDS = {"sparse_fields": sparse_fields, "dense_table": dense_table}


def make_rows(seed: int, n: int, cfg: Dict) -> Rows:
    rng = np.random.default_rng([seed, 0x5EED])
    return ROW_KINDS[cfg["rows"]["kind"]](rng, n, cfg)


def encode_rows(rows: Rows, traffic: Dict):
    """(the block's bytes, each row's length) in the traffic's encoding."""
    enc = traffic["encoding"]
    n = len(rows)
    if enc == "rowrec":
        return encode.rowrec_block(rows.labels, rows.idx, rows.val)
    if enc == "libsvm":
        # 1-based ids with value 1, as the LIBSVM site writes the file
        fields = [encode.uint_field(rows.labels.astype(np.int64))]
        for j in range(rows.idx.shape[1]):
            fields += [encode.const(n, b" "), encode.uint_field(rows.idx[:, j] + 1),
                       encode.const(n, b":1")]
        return encode.lines(fields + [encode.const(n, b"\n")])
    if enc == "csv":
        fields = [encode.sci18_field(rows.labels.astype(np.int64) << FRAC_BITS, FRAC_BITS)]
        for j in range(rows.x.shape[1]):
            fields += [encode.const(n, b","), encode.sci18_field(rows.x_num[:, j], FRAC_BITS)]
        return encode.lines(fields + [encode.const(n, b"\n")])
    raise ValueError(f"unknown encoding {enc!r}")


@dataclass
class Layout:
    """Where each row of the file lies: file row ``j`` is block row
    ``order(j)`` and starts at byte ``starts[j]`` (``starts[-1]`` is the
    file's size)."""

    block_rows: int
    repeats: int
    rotate_rows: int
    starts: np.ndarray

    def order(self, j: np.ndarray) -> np.ndarray:
        j = np.asarray(j, dtype=np.int64)
        return (j % self.block_rows + (j // self.block_rows) * self.rotate_rows) % self.block_rows

    @property
    def rows(self) -> int:
        return self.block_rows * self.repeats


def layout_of(lengths: np.ndarray, traffic: Dict) -> Layout:
    """The layout of the file ``write_file`` makes of a block whose rows
    are ``lengths`` bytes long."""
    n = len(lengths)
    repeats = traffic["file_rows"] // n
    rot = traffic["rotate_rows"]
    size = int(lengths.sum())
    starts = np.empty(n * repeats + 1, dtype=np.int64)
    for r in range(repeats):
        rolled = np.roll(lengths, -((r * rot) % n))
        starts[r * n:(r + 1) * n] = r * size + np.concatenate([[0], np.cumsum(rolled[:-1])])
    starts[-1] = repeats * size
    return Layout(n, repeats, rot, starts)


def write_file(path: str, block: bytes, lengths: np.ndarray, traffic: Dict) -> Layout:
    """The block written ``file_rows / block_rows`` times, each repeat
    rotated, with the index beside it (``path + '.idx'``) when the
    traffic reads one."""
    layout = layout_of(lengths, traffic)
    n = len(lengths)
    offs = np.concatenate([[0], np.cumsum(lengths)])
    mv = memoryview(block)
    with open(path, "wb") as f:
        for r in range(layout.repeats):
            s = (r * layout.rotate_rows) % n
            f.write(mv[offs[s]:])
            f.write(mv[:offs[s]])
        # on disk before the window, so its writeback runs in set-up
        f.flush()
        os.fsync(f.fileno())
    if traffic.get("index"):
        with open(path + ".idx", "wb") as f:
            f.write(encode.index_text(layout.starts[:-1]))
    return layout


def make_input(seed: int, cfg: Dict, traffic: Dict, directory: str):
    """Generate the cell's rows and file: (rows, layout, path)."""
    rows = make_rows(seed, traffic["block_rows"], cfg)
    block, lengths = encode_rows(rows, traffic)
    path = os.path.join(directory, "data." + traffic["encoding"])
    return rows, write_file(path, block, lengths, traffic), path
