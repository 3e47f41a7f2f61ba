"""The port's concurrent span fetcher (dmlc_core_tpu_torch/io/spanfetch.py)
against the JAX package's: the cases of tests/test_spanfetch.py on the
port, then both packages on the same spans.

Parallel reads change WHEN bytes arrive, never what they are:
``fetch_into`` assembles the exact serial buffer, ``fetch_iter`` delivers
every span once in completion order, the in-flight byte budget only
throttles, contiguous plans collapse to one connection, and the splitter
engages the fetcher for non-local sources only (``DMLC_FETCH_THREADS=1``
pins the serial baseline).

``test_reopen_counter_feeds_io_stats`` ticks the reopen counter through
``count_stream_reopen``, the hook ``cloudfs.HttpReadStream`` calls; the
JAX case ``test_http_seek_counts_reopen`` has its port copy, with both
packages' streams on one seek pattern, in tests/test_torch_cloudfs.py.
"""

import numpy as np
import pytest

from dmlc_core_tpu.io import spanfetch as jax_spanfetch
from dmlc_core_tpu.io.filesystem import FileSystem as JaxFileSystem
from dmlc_core_tpu_torch.io import spanfetch
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.io.filesystem import FileSystem
from dmlc_core_tpu_torch.io.spanfetch import SpanFetcher
from dmlc_core_tpu_torch.telemetry import default_registry
from dmlc_core_tpu_torch.utils.logging import Error
from test_split_gather import make_indexed_rec, records_of


def _make_file(tmp_path, n_bytes=1 << 16, name="spans.bin", seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 255, n_bytes, dtype=np.uint8).tobytes()
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(data)
    return p, data


def _fetcher_for(uri, threads=4, inflight=None, fs_cls=FileSystem, cls=SpanFetcher):
    fs = fs_cls.get_instance(uri)
    info = fs.get_path_info(uri)
    return cls([info], [0, info.size], fs, threads=threads, inflight_bytes=inflight), info.size


def _scattered_spans(total, n=37, size=700, seed=3):
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.choice(total - size, size=n, replace=False)).tolist()
    # keep spans disjoint and not byte-adjacent
    spans = []
    last_end = -1
    for s in starts:
        if s > last_end:
            spans.append((int(s), size))
            last_end = s + size
    return spans


def drain_records(split):
    out = []
    while True:
        rec = split.next_record()
        if rec is None:
            return out
        out.append(bytes(rec))


def test_fetch_into_assembles_exact_bytes(tmp_path):
    p, data = _make_file(tmp_path)
    # fault:// with no faults: a non-local seekable backend over the file
    f, total = _fetcher_for(f"fault://seed=1{p}")
    spans = _scattered_spans(total)
    sizes = [n for _b, n in spans]
    out = np.empty(sum(sizes), dtype=np.uint8)
    bases = [0]
    for n in sizes[:-1]:
        bases.append(bases[-1] + n)
    f.fetch_into(spans, memoryview(out), bases)
    f.close()
    assert out.tobytes() == b"".join(data[b:b + n] for b, n in spans)
    assert f.spans == len(spans)
    assert f.bytes == sum(sizes)
    assert f.concurrency_peak >= 2  # the ramp went parallel


def test_fetch_iter_delivers_every_span_once(tmp_path):
    p, data = _make_file(tmp_path)
    f, total = _fetcher_for(f"fault://seed=2{p}")
    spans = _scattered_spans(total, n=23)
    seen = {}
    for si, view in f.fetch_iter(spans):
        assert si not in seen
        seen[si] = bytes(view)
    f.close()
    assert sorted(seen) == list(range(len(spans)))
    for si, (b, n) in enumerate(spans):
        assert seen[si] == data[b:b + n], si


def test_tiny_inflight_budget_still_completes(tmp_path):
    """A budget smaller than any span degrades to one span at a time: it
    never drops or deadlocks."""
    p, data = _make_file(tmp_path)
    f, total = _fetcher_for(f"fault://seed=3{p}", inflight=1)
    spans = _scattered_spans(total, n=9)
    got = {si: bytes(v) for si, v in f.fetch_iter(spans)}
    f.close()
    assert len(got) == len(spans)
    assert f.concurrency_peak == 1  # the budget serialised the flight
    for si, (b, n) in enumerate(spans):
        assert got[si] == data[b:b + n]


def test_contiguous_spans_collapse_to_one_connection(tmp_path):
    p, data = _make_file(tmp_path, n_bytes=8192)
    f, total = _fetcher_for(f"fault://seed=4{p}")
    spans = [(i * 1024, 1024) for i in range(8)]  # byte-adjacent
    got = {si: bytes(v) for si, v in f.fetch_iter(spans)}
    f.close()
    assert b"".join(got[i] for i in range(8)) == data
    assert f.concurrency_peak == 1  # one sequential stream


def test_span_past_eof_raises_checked_error(tmp_path):
    p, _data = _make_file(tmp_path, n_bytes=4096)
    f, total = _fetcher_for(f"fault://seed=5{p}")
    with pytest.raises(Error, match="span read truncated"):
        for _ in f.fetch_iter([(0, 1024), (total - 512, 1024)]):
            pass
    f.close()


def test_fetch_telemetry_series_tick(tmp_path):
    reg = default_registry()
    spans_before = reg.counter("io.fetch.spans").value()
    bytes_before = reg.counter("io.fetch.bytes").value()
    wait_before = reg.histogram("io.fetch.span_wait_seconds").snapshot()["count"]
    p, _data = _make_file(tmp_path)
    f, total = _fetcher_for(f"fault://seed=6{p}")
    spans = _scattered_spans(total, n=19)
    for _ in f.fetch_iter(spans):
        pass
    f.close()
    assert reg.counter("io.fetch.spans").value() - spans_before == len(spans)
    assert reg.counter("io.fetch.bytes").value() - bytes_before == sum(n for _b, n in spans)
    # each completion on the parallel path observed one consumer wait
    assert reg.histogram("io.fetch.span_wait_seconds").snapshot()["count"] > wait_before
    assert reg.gauge("io.fetch.concurrency_peak").value() >= 1


def test_reopen_counter_feeds_io_stats(tmp_path):
    """``count_stream_reopen`` ticks ``io.fetch.reopens``, and a split
    reports the reopens since its construction."""
    p, idx = make_indexed_rec(str(tmp_path), records_of(20))
    s = io_split.IndexedRecordIOSplitter(p, idx, 0, 1)
    before = spanfetch.reopens_total()
    spanfetch.count_stream_reopen()
    spanfetch.count_stream_reopen(2)
    assert spanfetch.reopens_total() - before == 3
    assert s.io_stats()["reopens"] >= 3
    s.close()


def test_splitter_engages_fetcher_for_remote_only(tmp_path, monkeypatch):
    monkeypatch.delenv("DMLC_FETCH_THREADS", raising=False)
    p, idx = make_indexed_rec(str(tmp_path), records_of(60))
    local = io_split.IndexedRecordIOSplitter(p, idx, 0, 1, shuffle="window", window=16, seed=2)
    assert local._get_fetcher() is None  # local: the mmap span reader
    local.close()
    remote = io_split.IndexedRecordIOSplitter(f"fault://seed=8{p}", idx, 0, 1,
                                              shuffle="window", window=16, seed=2)
    assert remote._get_fetcher() is not None
    remote.close()
    # DMLC_FETCH_THREADS=1 pins the serial baseline even off-host
    monkeypatch.setenv("DMLC_FETCH_THREADS", "1")
    serial = io_split.IndexedRecordIOSplitter(f"fault://seed=8{p}", idx, 0, 1,
                                              shuffle="window", window=16, seed=2)
    assert serial._get_fetcher() is None
    serial.close()


def test_fetch_threads_env_and_default(monkeypatch):
    monkeypatch.setenv("DMLC_FETCH_THREADS", "7")
    assert spanfetch.fetch_threads() == 7
    monkeypatch.delenv("DMLC_FETCH_THREADS")
    n = spanfetch.fetch_threads()
    assert 2 <= n <= 16
    assert n == jax_spanfetch.fetch_threads()  # the same cgroup-aware rule
    monkeypatch.setenv("DMLC_FETCH_INFLIGHT_MB", "3")
    assert spanfetch.inflight_budget_bytes() == 3 << 20


def test_remote_window_io_stats_carry_fetch_shape(tmp_path, monkeypatch):
    """A non-local windowed drain reports the fetch shape beside the span
    and seek counters, and drains the local drain's bytes."""
    monkeypatch.setenv("DMLC_FETCH_THREADS", "4")
    p, idx = make_indexed_rec(str(tmp_path), records_of(120))
    ref = io_split.IndexedRecordIOSplitter(p, idx, 0, 1, shuffle="window", window=24,
                                           merge_gap=0, seed=9)
    want = drain_records(ref)
    ref.close()
    s = io_split.IndexedRecordIOSplitter(f"fault://seed=9{p}", idx, 0, 1, shuffle="window",
                                         window=24, merge_gap=0, seed=9)
    got = drain_records(s)
    stats = s.io_stats()
    s.close()
    assert got == want
    assert stats["fetch_spans"] > 0
    assert stats["fetch_bytes"] > 0
    assert stats["fetch_concurrency_peak"] >= 1
    assert stats["reopens"] == 0  # no HTTP streams in this drain


# -- both packages on the same spans ----------------------------------------------


def test_iter_file_segments_matches_jax():
    offs = [0, 100, 100, 350, 1000]
    for offset, size in ((0, 1000), (90, 30), (99, 2), (340, 700), (999, 5), (1000, 4)):
        assert list(spanfetch.iter_file_segments(offs, 4, offset, size)) == \
            list(jax_spanfetch.iter_file_segments(offs, 4, offset, size))


@pytest.mark.parametrize("threads,inflight", [(1, None), (4, None), (6, 1)])
def test_fetch_into_equals_jax_fetcher(tmp_path, threads, inflight):
    """The same spans over the same fault:// file: the port's and the JAX
    fetcher's buffers are byte-equal, and both serial fetches hold one
    connection."""
    p, data = _make_file(tmp_path, seed=5)
    uri = f"fault://seed=7{p}"
    spans = _scattered_spans(len(data), n=29, size=513, seed=9)
    bases = list(np.concatenate(([0], np.cumsum([n for _b, n in spans])[:-1])))
    outs = []
    for fs_cls, cls in ((FileSystem, SpanFetcher), (JaxFileSystem, jax_spanfetch.SpanFetcher)):
        f, _total = _fetcher_for(uri, threads, inflight, fs_cls, cls)
        out = np.empty(sum(n for _b, n in spans), dtype=np.uint8)
        f.fetch_into(spans, memoryview(out), [int(b) for b in bases])
        f.close()
        outs.append((out.tobytes(), f.spans, f.bytes))
        if threads == 1 or inflight == 1:
            assert f.concurrency_peak == 1
    assert outs[0] == outs[1]
    assert outs[0][0] == b"".join(data[b:b + n] for b, n in spans)
