"""The port's retry and fault layer against the JAX package's
(dmlc_core_tpu_torch/io/retry.py, io/faults.py, mem:// in
io/filesystem.py): the cases of tests/test_faults.py on the port, then
both packages on the same inputs. A golden RecordIO file read through
seeded resets, 5xx and short reads must come back byte-identical to the
clean read, on the sequential and the windowed-shuffle paths, with the
healed retries in io_stats(); one fault:// spec over one file fires the
same faults in both packages; shuffled splits over fault:// are bit-equal
across the packages; the FM trained from fault:// chaos on the CPU
matches the JAX FM on the clean file.
"""

import random

import numpy as np
import pytest
import torch

from dmlc_core_tpu.io import retry as jax_retry
from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu.io.faults import wrap_uri as jax_wrap_uri
from dmlc_core_tpu.io.filesystem import MemoryFileSystem as JaxMemoryFileSystem
from dmlc_core_tpu.io.stream import Stream as JaxStream
from dmlc_core_tpu_torch.io import codec as io_codec
from dmlc_core_tpu_torch.io import retry
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.io.faults import FaultSpec, unwrap_uri, wrap_uri
from dmlc_core_tpu_torch.io.filesystem import FileSystem, MemoryFileSystem
from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
from dmlc_core_tpu_torch.io.retry import (
    HttpError,
    RetryingReadStream,
    RetryPolicy,
    is_transient,
)
from dmlc_core_tpu_torch.io.stream import FileStream, MemoryStream, Stream
from dmlc_core_tpu_torch.utils.logging import Error
from test_split_gather import make_indexed_rec, records_of


@pytest.fixture(autouse=True)
def _fast_backoff(monkeypatch):
    """Policies read env at construction: run every retry at test speed."""
    monkeypatch.setenv("DMLC_RETRY_BASE_SECS", "0.001")
    monkeypatch.setenv("DMLC_RETRY_CAP_SECS", "0.01")


def drain_records(split):
    out = []
    while True:
        rec = split.next_record()
        if rec is None:
            return out
        out.append(bytes(rec))


# -- classifier ---------------------------------------------------------------


def test_transient_classifier():
    import http.client
    import urllib.error

    assert is_transient(HttpError("m", status=500))
    assert is_transient(HttpError("m", status=503))
    assert is_transient(HttpError("m", status=429))
    assert is_transient(HttpError("m", status=408))
    assert not is_transient(HttpError("m", status=404))
    assert not is_transient(HttpError("m", status=403))
    assert is_transient(urllib.error.URLError(ConnectionResetError()))
    assert is_transient(urllib.error.URLError(TimeoutError()))
    assert not is_transient(urllib.error.URLError("bad url"))
    assert is_transient(http.client.IncompleteRead(b"xx"))
    assert is_transient(ConnectionResetError())
    assert is_transient(BrokenPipeError())
    assert is_transient(TimeoutError())
    assert not is_transient(ValueError("nope"))
    assert not is_transient(KeyError("nope"))


# -- RetryPolicy --------------------------------------------------------------


def test_policy_retries_then_succeeds():
    sleeps = []
    p = RetryPolicy(max_attempts=4, base_secs=0.01, cap_secs=0.05, budget_secs=10,
                    sleep=sleeps.append, rng=random.Random(7))
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionResetError("boom")
        return "ok"

    assert p.run(flaky) == "ok"
    assert p.retries == 2 and len(sleeps) == 2
    # decorrelated jitter stays within [base, cap]
    assert all(0.01 <= s <= 0.05 for s in sleeps)


def test_policy_exhaustion_reraises_last_error():
    p = RetryPolicy(max_attempts=3, base_secs=0.001, budget_secs=10, sleep=lambda d: None)
    boom = ConnectionResetError("the last one")
    with pytest.raises(ConnectionResetError, match="the last one"):
        p.run(lambda: (_ for _ in ()).throw(boom))
    assert p.retries == 2  # attempts-1 retries, then re-raise


def test_policy_nontransient_raises_immediately():
    p = RetryPolicy(max_attempts=5, sleep=lambda d: None)
    calls = []

    def bad():
        calls.append(1)
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        p.run(bad)
    assert len(calls) == 1 and p.retries == 0


def test_policy_budget_bounds_total_backoff():
    """The cumulative budget caps the SUM of sleeps across operations;
    the would-be over-budget retry re-raises the cause."""
    sleeps = []
    p = RetryPolicy(max_attempts=100, base_secs=0.04, cap_secs=0.05, budget_secs=0.1,
                    sleep=sleeps.append, rng=random.Random(3))
    with pytest.raises(ConnectionResetError):
        p.run(lambda: (_ for _ in ()).throw(ConnectionResetError("x")))
    assert sum(sleeps) <= 0.1
    assert p.backoff_secs <= 0.1


def test_policy_counters_feed_global_stats():
    before = retry.stats()
    p = RetryPolicy(max_attempts=2, base_secs=0.001, sleep=lambda d: None)
    with pytest.raises(ConnectionResetError):
        p.run(lambda: (_ for _ in ()).throw(ConnectionResetError()))
    d = retry.stats_delta(before)
    assert d["retries"] == 1 and d["backoff_secs"] > 0


# -- RetryingReadStream -------------------------------------------------------


class _ExplodingStream(MemoryStream):
    """Seekable stream raising at given GLOBAL read ordinals (the counter
    is shared across reopens, like a schedule)."""

    def __init__(self, data, explode_at, counter):
        super().__init__(data)
        self.explode_at = explode_at
        self.counter = counter

    def read(self, n=-1):
        self.counter[0] += 1
        if self.counter[0] in self.explode_at:
            raise ConnectionResetError("mid-read reset")
        return super().read(min(n, 10) if n > 0 else 10)


def test_retrying_read_stream_resumes_at_offset():
    data = bytes(range(200))
    streams = []
    counter = [0]

    def open_fn():
        s = _ExplodingStream(data, explode_at={3, 7}, counter=counter)
        streams.append(s)
        return s

    r = RetryingReadStream(open_fn, policy=RetryPolicy(sleep=lambda d: None))
    assert r.read(-1) == data, "a healed read must be byte-identical"
    assert len(streams) == 3  # two resets, two reopens
    r.close()


def test_retrying_read_stream_open_failures_then_success():
    attempts = []

    def open_fn():
        attempts.append(1)
        if len(attempts) < 3:
            raise HttpError("GET x -> HTTP 503: busy", status=503)
        return MemoryStream(b"hello")

    r = RetryingReadStream(open_fn, policy=RetryPolicy(max_attempts=4, sleep=lambda d: None))
    assert r.read(-1) == b"hello"


# -- fault:// unit behaviour ----------------------------------------------------


def test_fault_spec_rejects_unknown_options():
    with pytest.raises(Error, match="unknown fault"):
        FaultSpec({"tyop": "1"})
    with pytest.raises(Error, match="not an integer"):
        FaultSpec({"resets": "many"})


def test_wrap_uri_forms():
    assert wrap_uri("/d/x.rec", "resets=2,seed=7") == "fault://resets=2,seed=7/d/x.rec"
    assert wrap_uri("file:///d/x.rec", "resets=1") == "fault://resets=1/d/x.rec"
    assert wrap_uri("/d/x.rec", "") == "/d/x.rec"
    with pytest.raises(Error, match="only wraps local paths"):
        wrap_uri("s3://b/k", "resets=1")
    # the split's fileset signature takes the wrapper off by this rule
    for uri in ("fault://resets=2,seed=7/d/x.rec", "fault://inner=mem,seed=1/b/k",
                "/d/x.rec", "fault://x"):
        from dmlc_core_tpu.io.faults import unwrap_uri as jax_unwrap

        assert unwrap_uri(uri) == jax_unwrap(uri)
    assert io_split.unwrap_uri is unwrap_uri


def test_fault_passthrough_and_stat_list(tmp_path):
    p = tmp_path / "plain.bin"
    p.write_bytes(b"abcdef" * 100)
    uri = f"fault://seed=1{p}"
    fs = FileSystem.get_instance(uri)
    info = fs.get_path_info(uri)
    assert info.size == 600 and info.type == "file"
    listing = fs.list_directory(f"fault://seed=1{tmp_path}")
    assert any(f.path == uri for f in listing)
    s = fs.open(uri, "r")
    assert s.read(-1) == b"abcdef" * 100
    s.close()


def test_fault_open_errors_then_success(tmp_path):
    p = tmp_path / "o.bin"
    p.write_bytes(b"payload")
    before = retry.stats()
    s = Stream.create(f"fault:///{str(p).lstrip('/')}?errors=2&seed=3", "r")
    assert s.read(-1) == b"payload"
    s.close()
    d = retry.stats_delta(before)
    assert d["faults_injected"] == 2 and d["retries"] == 2


def test_fault_exhausts_policy_past_attempt_cap(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_RETRY_ATTEMPTS", "2")
    p = tmp_path / "o2.bin"
    p.write_bytes(b"payload")
    with pytest.raises(HttpError, match="HTTP 503"):
        Stream.create(f"fault://errors=5,seed=3{p}", "r").read(1)


def test_fault_truncated_write_raises(tmp_path):
    p = tmp_path / "w.bin"
    w = Stream.create(f"fault://wresets=1,seed=5{p}", "w")
    w.write(b"A" * 100)
    with pytest.raises(ConnectionResetError):
        for _ in range(50):
            w.write(b"B" * 100)
    # the truncation landed a partial object: the crash shape the
    # atomic checkpoint write must keep away from final keys
    assert 0 < len(p.read_bytes()) < 5100


def test_fault_mem_inner_roundtrip():
    MemoryFileSystem._store["mem://bkt/obj"] = b"mem-bytes"
    try:
        s = Stream.create("fault://inner=mem,seed=2/bkt/obj", "r")
        assert s.read(-1) == b"mem-bytes"
        s.close()
    finally:
        MemoryFileSystem.reset()


def test_mem_filesystem_matches_jax():
    """``mem://`` in both packages: the same listing, stat and delete
    answers over the same keys, and writes read back."""
    keys = {"mem://b/a.bin": b"12345", "mem://b/d/x": b"x", "mem://b/d/y": b"yy"}
    try:
        for store in (MemoryFileSystem._store, JaxMemoryFileSystem._store):
            store.update(keys)
        fs, jfs = FileSystem.get_instance("mem://b"), None
        from dmlc_core_tpu.io.filesystem import FileSystem as JaxFileSystem

        jfs = JaxFileSystem.get_instance("mem://b")
        for uri in ("mem://b", "mem://b/d"):
            assert [tuple(i) for i in fs.list_directory(uri)] == \
                [tuple(i) for i in jfs.list_directory(uri)]
        for uri in ("mem://b/a.bin", "mem://b/d"):
            assert tuple(fs.get_path_info(uri)) == tuple(jfs.get_path_info(uri))
        with Stream.create("mem://b/new", "w") as w:
            w.write(b"new-bytes")
        with Stream.create("mem://b/new", "a") as w:
            w.write(b"+")
        assert Stream.create("mem://b/new").read() == b"new-bytes+"
        fs.copy("mem://b/new", "mem://b/cp")
        fs.rename("mem://b/cp", "mem://b/mv")
        assert not fs.exists("mem://b/cp") and fs.exists("mem://b/mv")
        with pytest.raises(Error, match="recursive"):
            fs.delete("mem://b/d")
        fs.delete("mem://b/d", recursive=True)
        assert not fs.exists("mem://b/d")
        assert Stream.create("mem://b/missing", allow_null=True) is None
    finally:
        MemoryFileSystem.reset()
        JaxMemoryFileSystem.reset()


# -- checkpoint crash consistency over fault:// ---------------------------------


def test_write_atomic_crash_never_exposes_final_key(tmp_path):
    """A truncated write mid-save leaves the FINAL uri absent (only .tmp
    debris): the crash-consistency contract of ``_write_atomic`` over a
    non-local filesystem."""
    from dmlc_core_tpu_torch.checkpoint import _write_atomic, load_pytree

    base = f"fault://wresets=1,seed=11{tmp_path}/ck.bin"
    tree = {"w": np.zeros(4096, dtype=np.float64)}  # big enough to split
    with pytest.raises(ConnectionResetError):
        _write_atomic(base, tree)
    assert not (tmp_path / "ck.bin").exists()
    # a clean save through the same (now fault-free) path commits
    _write_atomic(f"fault://seed=11{tmp_path}/ck.bin", {"w": np.arange(8)})
    out = load_pytree(str(tmp_path / "ck.bin"))
    np.testing.assert_array_equal(out["w"], np.arange(8))
    assert not (tmp_path / "ck.bin.tmp").exists(), "tmp debris after commit"


# -- chaos round-trip acceptance ------------------------------------------------


@pytest.fixture
def golden_rec(tmp_path):
    """A golden RecordIO file of random payloads and its count index."""
    rng = np.random.default_rng(3)
    recs = [rng.integers(0, 255, int(rng.integers(20, 200)), dtype=np.uint8).tobytes()
            for _ in range(400)]
    path = str(tmp_path / "golden.rec")
    idx = path + ".idx"
    with FileStream(path, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi)
        for i, r in enumerate(recs):
            w.write_record(r, i)
    return path, idx, recs


CHAOS = "resets=3,short=4,errors=2,seed=7"


def test_chaos_sequential_read_byte_identical(golden_rec):
    path, _idx, recs = golden_rec
    s = io_split.create(path, type="recordio", threaded=False)
    clean = drain_records(s)
    s.close()
    assert clean == recs

    before = retry.stats()
    s = io_split.create(wrap_uri(path, CHAOS), type="recordio", threaded=False)
    chaos = drain_records(s)
    stats = s.io_stats()
    s.close()
    assert chaos == recs, "the chaos read diverged from the clean read"
    assert stats["retries"] > 0
    assert stats["faults_injected"] > 0
    assert stats["backoff_secs"] > 0
    assert retry.stats_delta(before)["retries"] == stats["retries"]


def test_chaos_windowed_shuffle_byte_identical(golden_rec):
    """The same seeded permutation comes back record for record through
    injected resets, 5xx and short reads, order included."""
    path, idx, _recs = golden_rec
    sugar = f"?index={idx}&shuffle=window&window=64&merge_gap=4096&seed=5"
    s = io_split.create(path + sugar, type="recordio", threaded=False)
    clean = drain_records(s)
    s.close()
    assert len(clean) == 400

    s = io_split.create(wrap_uri(path, CHAOS) + sugar, type="recordio", threaded=False)
    chaos = drain_records(s)
    stats = s.io_stats()
    s.close()
    assert chaos == clean, "the chaos windowed read diverged (rows or order)"
    assert stats["mode"] == "window"
    assert stats["retries"] > 0
    assert stats["faults_injected"] > 0


@pytest.mark.parametrize("codec", (None, "zlib"))
@pytest.mark.parametrize("mode", ("record", "batch", "window"))
def test_chaos_parallel_fetch_byte_identical(mode, codec, tmp_path):
    """The concurrent span fetcher under fault:// resets, latency spikes
    and short reads heals to the clean serial order and bytes in all
    three shuffle modes, on v1 and zlib files, with retries > 0."""
    records = records_of(110, tag="pf")
    p, idx = make_indexed_rec(str(tmp_path), records, codec=codec)
    sugar = dict(shuffle=mode, seed=8, window=24, merge_gap=0, batch_size=8)
    clean = io_split.IndexedRecordIOSplitter(p, idx, 0, 1, **sugar)
    want = drain_records(clean)
    clean.close()
    chaos_uri = wrap_uri(p, "resets=2,short=2,latency_ms=2,spikes=3,errors=1,seed=17")
    chaotic = io_split.IndexedRecordIOSplitter(chaos_uri, idx, 0, 1, **sugar)
    got = drain_records(chaotic)
    stats = chaotic.io_stats()
    chaotic.close()
    assert got == want, (mode, codec)
    assert stats["faults_injected"] > 0, (mode, codec)
    assert stats["retries"] > 0, (mode, codec)
    # v1 windows plan scattered spans, which the fetcher carries; a
    # zlib window's missing blocks here are one contiguous span
    if codec is None and io_split._spanfetch.fetch_threads() > 1:
        assert stats["fetch_spans"] > 0, (mode, codec)


def test_chaos_parallel_equals_serial_baseline(tmp_path, monkeypatch):
    """The DMLC_FETCH_THREADS=1 serial baseline and the concurrent fetch
    give the same bytes under the same chaos spec."""
    records = records_of(90, tag="sb")
    p, idx = make_indexed_rec(str(tmp_path), records, codec="zlib")
    uri = wrap_uri(p, "resets=1,short=2,seed=23")
    kw = dict(shuffle="window", seed=4, window=16, merge_gap=0)

    def private_ctx():
        # a per-drain decode context: the process-wide decoded-block
        # LRU would serve the second drain from memory
        return io_codec.DecodeContext(cache=io_codec.DecodedBlockCache(64 << 20))

    monkeypatch.setenv("DMLC_FETCH_THREADS", "1")
    serial = io_split.IndexedRecordIOSplitter(uri, idx, 0, 1, decode_ctx=private_ctx(), **kw)
    want = drain_records(serial)
    serial.close()
    monkeypatch.setenv("DMLC_FETCH_THREADS", "6")
    parallel = io_split.IndexedRecordIOSplitter(uri, idx, 0, 1, decode_ctx=private_ctx(), **kw)
    got = drain_records(parallel)
    stats = parallel.io_stats()
    parallel.close()
    assert got == want
    assert stats["fetch_spans"] > 0


def test_chaos_query_form_equivalent(golden_rec):
    """The query grammar drives the same schedule for direct opens
    (Stream.create passes the whole URI to the filesystem)."""
    path, _idx, _recs = golden_rec
    clean = open(path, "rb").read()
    before = retry.stats()
    s = Stream.create(f"fault://{path}?resets=2&seed=9", "r")
    assert s.read(-1) == clean
    s.close()
    assert retry.stats_delta(before)["faults_injected"] == 2


def _rowrec_file(tmp_path, n=256, k=4, seed=5):
    from dmlc_core_tpu_torch.data.row_block import RowBlock
    from dmlc_core_tpu_torch.data.rowrec import write_rowrec

    rng = np.random.default_rng(seed)
    blk = RowBlock(
        offset=np.arange(0, (n + 1) * k, k, dtype=np.int64),
        label=rng.normal(size=n).astype(np.float32),
        index=rng.integers(0, 50, n * k).astype(np.uint32),
        value=rng.normal(size=n * k).astype(np.float32),
    )
    rec = str(tmp_path / "rows.rec")
    with FileStream(rec, "w") as f:
        write_rowrec(f, [blk])
    return rec


def test_chaos_through_ell_batches_io_stats(tmp_path):
    """io_stats end to end: a rowrec file staged through the fused
    producer over fault:// shows the retry counters at the stream."""
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    rec = _rowrec_file(tmp_path)
    spec = BatchSpec(batch_size=64, layout="ell", max_nnz=4)
    stream = ell_batches(rec, spec)
    clean = [np.array(b.values) for b in stream]
    stream.close()
    # cap=512: enough read ordinals over the ~13 KB file for the
    # scheduled events to land before EOF
    stream = ell_batches(wrap_uri(rec, "resets=2,short=2,seed=13,cap=512"), spec)
    chaos = [np.array(b.values) for b in stream]
    stats = stream.io_stats()
    stream.close()
    assert len(chaos) == len(clean)
    for a, b in zip(clean, chaos):
        np.testing.assert_array_equal(a, b)
    assert stats is not None and stats["retries"] > 0


# -- both packages on the same inputs -------------------------------------------


@pytest.mark.parametrize("spec", [
    "resets=3,short=4,errors=2,seed=7,cap=512",
    "resets=1,latency_ms=1,spikes=5,seed=2,cap=300",
    "short=6,seed=41",
])
def test_one_spec_fires_the_same_faults_in_both_packages(golden_rec, spec):
    """One fault:// spec over one file: the same bytes, read in the same
    calls, and the same ``faults_injected`` and ``retries`` in both
    packages (the schedule is keyed by the same seed, path and open
    ordinal, and fires at the same read ordinals)."""
    path, _idx, _recs = golden_rec
    uri = jax_wrap_uri(path, spec)
    assert uri == wrap_uri(path, spec)

    def read_all(create, mod):
        before = mod.stats()
        s = create(uri, "r")
        parts = []
        while True:
            b = s.read(1000)
            if not b:
                break
            parts.append(bytes(b))
        s.close()
        return parts, mod.stats_delta(before)

    got, gstats = read_all(Stream.create, retry)
    want, wstats = read_all(JaxStream.create, jax_retry)
    assert got == want
    assert b"".join(got) == open(path, "rb").read()
    assert gstats["faults_injected"] == wstats["faults_injected"] > 0
    assert gstats["retries"] == wstats["retries"]


@pytest.mark.parametrize("codec", (None, "zlib"))
@pytest.mark.parametrize("mode", ("0", "record", "batch", "window"))
def test_shuffled_split_over_fault_uri_equals_jax(tmp_path, mode, codec):
    """A shuffled split over a fault:// file gives the records, in order,
    of the JAX package's split over the same URI (chaos healed on both
    sides), over three epochs."""
    records = records_of(150, tag="x")
    p, idx = make_indexed_rec(str(tmp_path), records, codec=codec)
    uri = (wrap_uri(p, "resets=2,short=3,errors=1,seed=19")
           + f"?index={idx}&shuffle={mode}&seed=6&window=32&batch_size=8&merge_gap=0")

    def drain(split, epochs=3):
        out = []
        for _ in range(epochs):
            split.before_first()
            out.append(drain_records(split))
        split.close()
        return out

    got = drain(io_split.create(uri, type="recordio", threaded=False))
    want = drain(jax_split.create(uri, type="recordio", threaded=False))
    assert got == want
    assert sorted(got[0]) == sorted(records)


def test_fm_from_fault_chaos_matches_jax_fm_on_clean_file(tmp_path):
    """The FM trained on the CPU from fault:// chaos (shuffle=batch over
    an indexed rowrec file) matches the JAX FM trained on the clean file,
    within test_torch_models.py's tolerance (1e-4 of max |param|)."""
    from dmlc_core_tpu.data.rowrec import encode_row
    from dmlc_core_tpu.models import FactorizationMachine as JaxFM
    from dmlc_core_tpu.staging import BatchSpec as JaxSpec
    from dmlc_core_tpu.staging import ell_batches as jax_ell_batches
    from dmlc_core_tpu_torch.convert import params_from_jax, params_to_numpy
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.staging.batcher import BatchSpec
    from dmlc_core_tpu_torch.staging.fused import ell_batches

    n, k, d, e, b = 384, 6, 97, 4, 32
    rec, idx = str(tmp_path / "fm.rec"), str(tmp_path / "fm.idx")
    rng = np.random.default_rng(11)
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi)
        for i in range(n):
            w.write_record(encode_row(float(i % 2), rng.integers(0, d, k, dtype=np.int64),
                                      rng.normal(size=k).astype(np.float32)), i)
    query = f"?index={idx}&shuffle=batch&batch_size={b}&seed=3"
    keys = ("indices", "values", "nnz", "labels", "weights")
    jsrc = jax_ell_batches(rec + query, JaxSpec(batch_size=b, layout="ell", max_nnz=k))
    clean = [{key: np.array(getattr(x, key)) for key in keys} for x in jsrc]
    jsrc.close()
    src = ell_batches(wrap_uri(rec, "resets=2,short=2,errors=2,seed=7,cap=1024") + query,
                      BatchSpec(batch_size=b, layout="ell", max_nnz=k))
    chaos = [{key: np.array(getattr(x, key)) for key in keys} for x in src]
    stats = src.io_stats()
    src.close()
    assert stats["faults_injected"] > 0 and stats["retries"] > 0
    assert len(chaos) == len(clean) == n // b
    for got, want in zip(chaos, clean):
        for key in keys:
            np.testing.assert_array_equal(got[key], want[key])

    prng = np.random.default_rng(4)
    params = {"w": prng.normal(size=d).astype(np.float32) * 0.3, "b": np.float32(0.1),
              "v": prng.normal(size=(d, e)).astype(np.float32) * 0.3}
    jmodel = JaxFM(d, embed_dim=e)
    jparams = params
    for batch in clean:
        jparams, _ = jmodel.sgd_step(jparams, batch)
    model = FactorizationMachine(d, e, device="cpu")
    model.load_state_dict(params_from_jax(params, "cpu"))
    for batch in chaos:
        model.sgd_step({key: torch.from_numpy(v) for key, v in batch.items()})
    got = params_to_numpy(model.state_dict())
    for key in got:
        want = np.asarray(jparams[key], np.float32)
        tol = 1e-4 * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(np.asarray(got[key], np.float32) - want).max()) <= tol, key
