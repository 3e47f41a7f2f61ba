"""The csv producer's split parse: ``dmlc_parse_csv_dense_split`` splits
the rows of one call over several threads, each row in the place the
one-thread ``dmlc_parse_csv_dense`` gives it. Every return and every
output byte must equal the JAX package's one-thread call's, and the
port's own; through ``dense_batches`` the batches must equal the JAX
package's and those of the port's one-thread parse, with and without an
``nthread`` fan-out."""

import json
import threading
from pathlib import Path

import numpy as np
import pytest

from dmlc_core_tpu.data import native as jax_native
from dmlc_core_tpu.staging import BatchSpec as JaxSpec
from dmlc_core_tpu.staging import dense_batches as jax_dense_batches
from dmlc_core_tpu_torch.data import native
from dmlc_core_tpu_torch.staging import fused
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import (
    FusedDenseCSVBatches,
    ShardedFusedBatches,
    dense_batches,
)
from dmlc_core_tpu_torch.telemetry import default_registry
from dmlc_core_tpu_torch.utils import cpus
from dmlc_core_tpu_torch.utils.logging import Error
from perfbench import gen

REPO = Path(__file__).resolve().parent.parent
WORKERS = [2, 3, 4, 7]
SPLIT_ROWS = "staging.parse_split_rows"


def higgs_csv(n: int, seed: int) -> bytes:
    """``n`` rows of ``%.18e`` HIGGS csv from the benchmark's generator
    (label in column 0, 28 feature columns)."""
    cfg = json.loads((REPO / "perfbench" / "configs" / "higgs_lr.json").read_text())
    block, _ = gen.encode_rows(gen.make_rows(seed, n, cfg), {"encoding": "csv"})
    return bytes(block)


def with_endings(data: bytes, endings) -> bytes:
    lines = data.split(b"\n")[:-1]
    return b"".join(line + endings[i % len(endings)] for i, line in enumerate(lines))


def short_rows(n: int, seed: int, cols: int = 6) -> bytes:
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((n, cols))
    return b"".join((",".join(f"{v:.6f}" for v in row) + "\n").encode() for row in vals)


HIGGS = higgs_csv(300, seed=2**33 + 5)
# (bytes, label_column, weight_column, D)
CASES = {
    "higgs": (HIGGS, 0, -1, 28),
    "higgs_weight": (HIGGS, 0, 5, 27),
    "higgs_truncated": (HIGGS, 0, -1, 10),
    "crlf": (with_endings(HIGGS, [b"\r\n"]), 0, -1, 28),
    "lone_cr": (with_endings(HIGGS, [b"\r"]), 0, 3, 28),
    "mixed_endings": (with_endings(short_rows(200, 1), [b"\n", b"\r\n", b"\r"]), -1, -1, 6),
    "empty_and_blank": (with_endings(short_rows(200, 2),
                                     [b"\n", b"\n\n", b"\r\n\r\n", b"\n \n", b"\n\t\n"]),
                        -1, -1, 6),
    "no_final_newline": (short_rows(150, 3).rstrip(b"\n"), 0, -1, 5),
    "junk_cells": (b"1,abc,3\n,,\n2,1e999,-1e-999\n+4,0x10,.5\n" * 40, -1, 2, 3),
}
BAD = {
    "label_only_line": (short_rows(100, 4) + b"7\n" + short_rows(100, 5), 0, -1, 5),
    "blank_line_label_column": (with_endings(short_rows(120, 6), [b"\n", b"\n \n"]),
                                0, -1, 5),
}


def buffers(rows: int, d: int, vdtype):
    """Dirty slot buffers, as a reused ring slot holds them."""
    x = np.full((rows, d), 7, dtype=vdtype)
    return x, np.full(rows, -3, np.float32), np.full(rows, -5, np.float32)


def run(fn, data, offset, label, weight, d, capacity, row_start, vdtype, cr_hint=-1, **kw):
    x, labels, weights = buffers(capacity, d, vdtype)
    got = fn(data, offset, ord(","), label, weight, x, labels, weights, row_start, cr_hint,
             **kw)
    return got, (x, labels, weights)


def capacities(n_rows: int, row_start: int):
    return sorted({row_start + c for c in (1, 2, 5, n_rows // 3, n_rows - 1, n_rows,
                                           n_rows + 7) if c >= 1})


def witnesses(data, offset, label, weight, d, capacity, row_start, vdtype, cr_hint=-1):
    """The JAX package's one-thread call, checked equal to the port's."""
    want = run(jax_native.parse_csv_dense, data, offset, label, weight, d, capacity,
               row_start, vdtype, cr_hint)
    port = run(native.parse_csv_dense, data, offset, label, weight, d, capacity,
               row_start, vdtype, cr_hint)
    assert want[0] == port[0]
    for w, p in zip(want[1], port[1]):
        assert w.tobytes() == p.tobytes()
    return want


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_equals_the_one_thread_call(case, workers):
    data, label, weight, d = CASES[case]
    n_rows, _, _, has_cr, _ = jax_native.parse_csv_dense(data, 0, ord(","), label, weight,
                                                         *buffers(10**4, d, np.float32), 0)
    assert n_rows > 10
    for vdtype in (np.float32, np.float16):
        for row_start in (0, 3):
            for capacity in capacities(n_rows, row_start):
                # a chunk's first call probes for '\r'; a resumed one has the hint
                for offset, cr_hint in ((0, -1), (len(data) // 2, -1),
                                        (len(data) // 3, has_cr)):
                    want, want_bufs = witnesses(data, offset, label, weight, d, capacity,
                                                row_start, vdtype, cr_hint)
                    got, got_bufs = run(native.parse_csv_dense_split, data, offset, label,
                                        weight, d, capacity, row_start, vdtype, cr_hint,
                                        workers=workers, min_rows=1)
                    assert got[:5] == want, (vdtype, row_start, capacity, offset, cr_hint)
                    assert got[5] == max(1, min(workers, want[0]))
                    for g, w in zip(got_bufs, want_bufs):
                        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("case", sorted(BAD))
def test_a_line_without_a_row_gives_the_one_thread_counts(case, workers):
    data, label, weight, d = BAD[case]
    for capacity in (50, 150, 400):
        want, (wx, wl, ww) = witnesses(data, 0, label, weight, d, capacity, 2, np.float32)
        got, (gx, gl, gw) = run(native.parse_csv_dense_split, data, 0, label, weight, d,
                                capacity, 2, np.float32, workers=workers, min_rows=1)
        assert got[:5] == want
        # the rows written are the same; the slots after them may differ
        end = 2 + want[0]
        assert gx[:end].tobytes() == wx[:end].tobytes()
        assert gl[:end].tobytes() == wl[:end].tobytes()
        assert gw[:end].tobytes() == ww[:end].tobytes()
        if capacity == 400:
            assert want[4] > 0


BIG = higgs_csv(3 * native.SPLIT_MIN_ROWS, seed=2**40 + 9)


@pytest.mark.parametrize("case", [
    ("lf", b"\n", 0, -1, 28, np.float32), ("crlf_f16", b"\r\n", 0, -1, 28, np.float16),
    ("lone_cr_weight", b"\r", 0, 7, 27, np.float32), ("truncated", b"\n", 0, -1, 9, np.float16),
], ids=lambda c: c[0])
def test_the_default_floor_splits_and_matches_jax(case):
    """At the producer's own row floor: a call of 3 x SPLIT_MIN_ROWS rows
    runs on 3 threads and writes the JAX package's bytes."""
    _, ending, label, weight, d, vdtype = case
    data = with_endings(BIG, [ending])
    rows = 3 * native.SPLIT_MIN_ROWS
    for capacity, row_start in ((rows, 0), (rows + 5, 5), (rows + 100, 0), (rows - 7, 1)):
        want, want_bufs = witnesses(data, 0, label, weight, d, capacity, row_start, vdtype)
        got, got_bufs = run(native.parse_csv_dense_split, data, 0, label, weight, d,
                            capacity, row_start, vdtype, workers=4)
        assert got[:5] == want
        assert got[5] == max(1, min(4, want[0] // native.SPLIT_MIN_ROWS))
        assert got[5] > 1
        for g, w in zip(got_bufs, want_bufs):
            assert g.tobytes() == w.tobytes()


def test_too_few_rows_parse_on_the_calling_thread():
    data, label, weight, d = CASES["higgs"]
    got, _ = run(native.parse_csv_dense_split, data, 0, label, weight, d, 1000, 0,
                 np.float32, workers=4, min_rows=151)
    assert got[0] == 300 and got[5] == 1
    got, _ = run(native.parse_csv_dense_split, data, 0, label, weight, d, 1000, 0,
                 np.float32, workers=4, min_rows=150)
    assert got[5] == 2
    got, _ = run(native.parse_csv_dense_split, data, 0, label, weight, d, 1000, 0,
                 np.float32, workers=1, min_rows=1)
    assert got[5] == 1


def test_many_more_workers_than_cores_under_concurrent_calls():
    """32 workers a call, from four threads at once: each call's rows
    still land where one thread puts them."""
    data, label, weight, d = CASES["mixed_endings"]
    want, want_bufs = run(native.parse_csv_dense, data, 0, label, weight, d, 250, 1,
                          np.float32)
    failures = []

    def hammer():
        for _ in range(25):
            got, bufs = run(native.parse_csv_dense_split, data, 0, label, weight, d, 250,
                            1, np.float32, workers=32, min_rows=1)
            if got[:5] != want or any(g.tobytes() != w.tobytes()
                                      for g, w in zip(bufs, want_bufs)):
                failures.append(got)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not failures


# -- through the producer ------------------------------------------------------
def snapshot(stream):
    """Copies of the yielded batches (ring slots are reused) and the
    producer's counters; the stream is closed."""
    out = [(b.n_valid, b.packed.copy()) for b in stream]
    counters = (stream.truncated_nnz, stream.rows_out, stream.bad_lines)
    stream.close()
    return out, counters


def assert_same(got, want):
    (gb, gc), (wb, wc) = got, want
    assert len(gb) == len(wb) > 1
    for (gn, gp), (wn, wp) in zip(gb, wb):
        assert gn == wn
        np.testing.assert_array_equal(gp, wp)
    assert gc == wc


def jax_batches(uri, spec, **kw):
    """The JAX package's batches of ``uri``, as ``snapshot`` gives the
    batches."""
    jspec = JaxSpec(batch_size=spec.batch_size, layout="dense",
                    num_features=spec.num_features, value_dtype=np.dtype(spec.value_dtype))
    stream = jax_dense_batches(uri, jspec, **kw)
    out = [(b.n_valid, b.packed.copy()) for b in stream]
    stream.close()
    return out


def assert_same_batches(got, want):
    assert len(got) == len(want) > 1
    for (gn, gp), (wn, wp) in zip(got, want):
        assert gn == wn
        np.testing.assert_array_equal(gp, wp)


def split_rows() -> float:
    return default_registry().counter_values(names=(SPLIT_ROWS,))[SPLIT_ROWS]


def usable_cpus(monkeypatch, n: int) -> None:
    monkeypatch.setattr(fused, "available_cpus", lambda: n)
    monkeypatch.setattr(cpus, "available_cpus", lambda: n)


@pytest.fixture
def eight_cpus(monkeypatch):
    """A host of 8 usable CPUs, no thread override."""
    usable_cpus(monkeypatch, 8)
    monkeypatch.delenv("DMLC_PARSE_THREADS", raising=False)
    monkeypatch.delenv("DMLC_TPU_PARSER_THREADS", raising=False)
    return monkeypatch


def csv_file(tmp_path, n):
    p = tmp_path / "big.csv"
    p.write_bytes(with_endings(short_rows(n, 11), [b"\n"] * 7 + [b"\r\n"]))
    return f"{p}?format=csv&label_column=0"


SPEC = BatchSpec(batch_size=8192, layout="dense", num_features=5)


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
def test_dense_batches_split_yields_the_one_thread_batches(tmp_path, eight_cpus, vdtype):
    uri = csv_file(tmp_path, 20480)  # calls of 8192, 8192 and 4096 rows
    spec = BatchSpec(batch_size=8192, layout="dense", num_features=5, value_dtype=vdtype)
    before = split_rows()
    src = dense_batches(uri, spec)
    assert isinstance(src, FusedDenseCSVBatches) and src.parse_workers == 4
    got = snapshot(src)
    assert split_rows() - before == 20480  # every call was split
    eight_cpus.setenv("DMLC_PARSE_THREADS", "1")
    before = split_rows()
    one = dense_batches(uri, spec)
    assert isinstance(one, FusedDenseCSVBatches) and one.parse_workers == 1
    want = snapshot(one)
    assert split_rows() == before
    assert_same(got, want)
    assert got[1][1] == 20480
    assert_same_batches(got[0], jax_batches(uri, spec))


def test_nthread_fan_out_keeps_its_batches(tmp_path, eight_cpus):
    """``nthread=2`` keeps its two sub-shards and their interleave; each
    sub-producer splits its calls over half the one producer's threads."""
    uri = csv_file(tmp_path, 26384)  # a sub-shard's calls: 8192 rows, then ~5000
    src = dense_batches(uri, SPEC, nthread=2)
    assert isinstance(src, ShardedFusedBatches)
    assert [p.parse_workers for p in src._producers] == [2, 2]
    before = split_rows()
    got = snapshot(src)
    assert split_rows() - before == 26384
    eight_cpus.setenv("DMLC_PARSE_THREADS", "1")
    one = dense_batches(uri, SPEC, nthread=2)
    assert [p.parse_workers for p in one._producers] == [1, 1]
    assert_same(got, snapshot(one))
    assert_same_batches(got[0], jax_batches(uri, SPEC, nthread=2))


@pytest.mark.parametrize("n_cpus,env,nthread,want", [
    (8, None, None, [4]), (1, None, None, [1]), (3, None, None, [1]), (16, None, None, [8]),
    (8, "3", None, [3]), (8, "1", None, [1]), (8, None, 3, [1, 1, 1]), (8, "6", 2, [3, 3]),
])
def test_parse_workers_follow_the_cpus_and_the_override(tmp_path, eight_cpus, n_cpus, env,
                                                        nthread, want):
    usable_cpus(eight_cpus, n_cpus)
    if env is not None:
        eight_cpus.setenv("DMLC_PARSE_THREADS", env)
    src = dense_batches(csv_file(tmp_path, n=50), SPEC, nthread=nthread)
    producers = src._producers if nthread else [src]
    assert [p.parse_workers for p in producers] == want
    src.close()


def test_a_line_without_a_delimiter_raises_through_the_split(tmp_path, eight_cpus):
    p = tmp_path / "bad.csv"
    p.write_bytes(short_rows(6000, 12) + b"7\n" + short_rows(6000, 13))
    uri = f"{p}?format=csv&label_column=0"
    outcomes = []
    for env in (None, "1"):
        if env:
            eight_cpus.setenv("DMLC_PARSE_THREADS", env)
        src = dense_batches(uri, SPEC)
        batches = []
        with pytest.raises(Error, match="Delimiter not found in the line"):
            for b in src:
                batches.append(b.packed.copy())
        outcomes.append((len(batches), src.bad_lines, src.rows_out))
        src.close()
    assert outcomes[0] == outcomes[1] and outcomes[0][1] == 1
