"""The port's point reads (dmlc_core_tpu_torch/io/lookup.py) against the
JAX package's: a port case for each case of tests/test_lookup.py (key
resolution over the cached index, blocks through the two-level decode
context, the frame walk, the serve daemon, the degradation matrix), then
both packages on the same shards:

- ``RecordLookup`` answers the same bytes and the same ``describe()``
  in both packages, for v1 and zlib shards and for int and string keys;
- a JAX ``LookupServer`` answers a port ``LookupClient`` and a port
  server a JAX client, with the same bytes and the same refusals.

Every server is closed (its accept thread joined) and every daemon
closed in a ``finally``."""

import json
import os
import struct

import numpy as np
import pytest

from dmlc_core_tpu.io.lookup import LookupClient as JaxClient
from dmlc_core_tpu.io.lookup import LookupServer as JaxServer
from dmlc_core_tpu.io.lookup import RecordLookup as JaxLookup
from dmlc_core_tpu_torch.io import blockcache
from dmlc_core_tpu_torch.io import codec as io_codec
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.io.blockcache import BlockCacheClient, BlockCacheDaemon
from dmlc_core_tpu_torch.io.lookup import (
    LookupClient,
    LookupServer,
    RecordLookup,
    _extract_payloads,
)
from dmlc_core_tpu_torch.io.recordio import KMAGIC, IndexedRecordIOWriter
from dmlc_core_tpu_torch.io.stream import FileStream
from dmlc_core_tpu_torch.tools import main as tools_main
from dmlc_core_tpu_torch.utils.logging import Error

N_RECORDS = 400
KEYSET = [0, 3, 231, 10**9, 3 * (N_RECORDS - 1), 300, 303, 306]


@pytest.fixture(autouse=True)
def _no_ambient_daemon(monkeypatch, tmp_path):
    """The default decode context of both packages looks for a block-cache
    daemon on a socket of this test's own."""
    from dmlc_core_tpu.io import blockcache as jax_blockcache

    monkeypatch.setenv("DMLC_BLOCK_CACHE_SOCK", str(tmp_path / "default.sock"))
    blockcache.reset_default_client()
    jax_blockcache.reset_default_client()
    yield
    blockcache.reset_default_client()
    jax_blockcache.reset_default_client()


def _payload(i: int) -> bytes:
    if i == 77:
        # an aligned magic word in the payload: a multipart chain
        return struct.pack("<I", KMAGIC) + b"chain" + struct.pack("<I", KMAGIC)
    return (b"%06d:" % i) + bytes([i % 251]) * (i % 53)


def _write_corpus(path, codec=None, n=N_RECORDS, key_fn=None, block_bytes=1024):
    with FileStream(path, "w") as f, FileStream(path + ".idx", "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec=codec, block_bytes=block_bytes)
        for i in range(n):
            w.write_record(_payload(i), key=i * 3 if key_fn is None else key_fn(i))
        w.flush()
    return path


def _l1_ctx():
    """An L1-only decode context of this test's own: no process-global
    cache, no daemon."""
    return io_codec.DecodeContext(cache=io_codec.DecodedBlockCache(64 << 20), shared=None)


def _string_keys(path):
    """Rewrite ``path``'s index with string keys ``user-NNN``."""
    lines = open(path + ".idx").read().splitlines()
    with open(path + ".idx", "w") as f:
        for line in lines:
            k, off = line.split("\t")
            f.write(f"user-{int(k):03d}\t{off}\n")


def _close_server(srv):
    srv.close()
    t = srv._accept_thread
    if t is not None:
        t.join(5)
        assert not t.is_alive()


@pytest.fixture(params=["none", "zlib"])
def corpus(request, tmp_path):
    codec = None if request.param == "none" else request.param
    return _write_corpus(str(tmp_path / f"c_{request.param}.rec"), codec)


# -- the core semantics ---------------------------------------------------------


def test_lookup_roundtrip_negatives_and_duplicates(corpus):
    h = RecordLookup(corpus, decode_ctx=_l1_ctx())
    try:
        vals = h.lookup([0, 3, 231, 10**9, 231, -5, 3 * (N_RECORDS - 1)])
        assert vals[0] == _payload(0)
        assert vals[1] == _payload(1)
        assert vals[2] == _payload(77)  # the multipart record
        assert vals[3] is None and vals[5] is None
        assert vals[4] == vals[2]
        assert vals[6] == _payload(N_RECORDS - 1)
        assert h.lookup([]) == []
        stats = h.io_stats()
        assert stats["negatives"] == 2
        assert stats["keys_resolved"] == 7
    finally:
        h.close()


def test_cross_codec_parity(tmp_path):
    """v1, zlib and raw shards answer the same bytes for the same keys."""
    keys = [0, 3, 231, 999, 3 * (N_RECORDS - 1), 42 * 3]
    answers = []
    for name, codec in (("v1", None), ("zl", "zlib"), ("raw", "raw")):
        h = RecordLookup(_write_corpus(str(tmp_path / f"{name}.rec"), codec),
                         decode_ctx=_l1_ctx())
        try:
            answers.append(h.lookup(keys))
        finally:
            h.close()
    assert answers[0] == answers[1] == answers[2]


def test_corrupt_block_is_checked_error_not_none(tmp_path):
    path = _write_corpus(str(tmp_path / "corrupt.rec"), "zlib")
    with open(path, "r+b") as f:
        size = os.path.getsize(path)
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    h = RecordLookup(path, decode_ctx=_l1_ctx())
    try:
        with pytest.raises(Error):
            h.lookup(list(range(0, 3 * N_RECORDS, 3)))
    finally:
        h.close()


def test_string_keys_resolve(tmp_path):
    path = str(tmp_path / "s.rec")
    with FileStream(path, "w") as f, FileStream(path + ".idx", "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec="zlib", block_bytes=512)
        for i in range(50):
            w.write_record(b"val%03d" % i, key=i)
        w.flush()
    _string_keys(path)
    h = RecordLookup(path, decode_ctx=_l1_ctx())
    try:
        assert h.lookup(["user-007", "user-000", "nope"]) == [b"val007", b"val000", None]
    finally:
        h.close()


def test_float_key_rejected_not_truncated(tmp_path):
    path = _write_corpus(str(tmp_path / "fk.rec"), None, n=20)
    h = RecordLookup(path, decode_ctx=_l1_ctx())
    try:
        with pytest.raises(Error, match="must be integers"):
            h.lookup([3.7])
        assert h.lookup(["3"]) == [_payload(1)]  # the exact wire form passes
    finally:
        h.close()


def test_string_index_rejects_unrepresentable_keys(tmp_path):
    path = str(tmp_path / "sk.rec")
    with FileStream(path, "w") as f, FileStream(path + ".idx", "w") as fi:
        w = IndexedRecordIOWriter(f, fi)
        for i in range(10):
            w.write_record(b"val%d" % i, key=i)
        w.flush()
    lines = open(path + ".idx").read().splitlines()
    with open(path + ".idx", "w") as f:
        for line in lines:
            k, off = line.split("\t")
            f.write(f"user{k}\t{off}\n")
    h = RecordLookup(path, decode_ctx=_l1_ctx())
    try:
        assert h.lookup([b"user3", "user4"]) == [b"val3", b"val4"]
        with pytest.raises(Error, match="must be strings"):
            h.lookup([3.7])
    finally:
        h.close()


def test_oversized_key_batch_is_checked_error(tmp_path):
    path = _write_corpus(str(tmp_path / "big.rec"), None, n=20)
    h = RecordLookup(path, decode_ctx=_l1_ctx())
    srv = LookupServer(h, port=0)
    try:
        c = LookupClient("127.0.0.1", srv.port)
        with pytest.raises(Error, match="frame cap|exceeds the"):
            c.lookup(list(range(10**9, 10**9 + 200_000)))
        assert c.lookup([0]) == [_payload(0)]  # nothing was sent
        c.close()
    finally:
        _close_server(srv)
        h.close()


def test_duplicate_sidecar_key_fails_loudly(tmp_path):
    path = _write_corpus(str(tmp_path / "dup.rec"), "zlib", key_fn=lambda i: min(i, 7))
    with pytest.raises(Error, match="duplicate key"):
        RecordLookup(path)


def test_odd_index_token_count_fails_loudly(tmp_path):
    path = _write_corpus(str(tmp_path / "odd.rec"), None)
    with open(path + ".idx", "a") as f:
        f.write("stray\n")
    with pytest.raises(Error, match="odd token count"):
        RecordLookup(path)


def test_epoch_reader_unaffected_by_key_retention(tmp_path):
    """The epoch path ignores keys: an indexed drain of the shard gives
    every record in file order, and the splitter keeps the key column."""
    path = _write_corpus(str(tmp_path / "epoch.rec"), "zlib")
    sp = io_split.IndexedRecordIOSplitter(path, path + ".idx", 0, 1)
    try:
        got = [bytes(r) for r in iter(sp.next_record, None)]
        keys = sp._index_keys
    finally:
        sp.close()
    assert got == [_payload(i) for i in range(N_RECORDS)]
    np.testing.assert_array_equal(keys, np.arange(N_RECORDS) * 3)


def test_extract_payloads_native_matches_fallback(tmp_path):
    path = _write_corpus(str(tmp_path / "par.rec"), None, n=64)
    data = np.frombuffer(open(path, "rb").read(), dtype=np.uint8)
    offs = np.asarray([int(line.split()[1]) for line in open(path + ".idx")],
                      dtype=np.int64)
    sizes = np.concatenate((np.diff(offs), [len(data) - offs[-1]]))
    native_out = _extract_payloads(data, offs, sizes, "parity")
    plain_out = _extract_payloads(data, offs, sizes, "parity", plain=True)
    assert native_out == plain_out == [_payload(i) for i in range(64)]
    bad = offs.copy()
    bad[3] += 4  # a slice that starts inside a frame
    for plain in (False, True):
        with pytest.raises(Error, match="no valid record frame"):
            _extract_payloads(data, bad, sizes, "parity", plain=plain)


def test_index_cache_eviction_counter(tmp_path, monkeypatch):
    from dmlc_core_tpu_torch.telemetry import default_registry

    # room for one parsed index, not two (each ~1.4 KB)
    monkeypatch.setattr(io_split, "_index_cache_budget", lambda: 2048)
    ctr = default_registry().counter("io.split.index_cache_evictions")
    before = ctr.value()
    for i in range(3):
        h = RecordLookup(_write_corpus(str(tmp_path / f"m{i}.rec"), None, n=60),
                         decode_ctx=_l1_ctx())
        try:
            assert h.lookup([0]) == [_payload(0)]
        finally:
            h.close()
    assert ctr.value() > before
    with io_split._INDEX_CACHE_LOCK:
        assert len(io_split._INDEX_CACHE) <= 1


# -- the degradation matrix -----------------------------------------------------


@pytest.mark.blockcache
def test_bit_identity_across_cache_tiers(tmp_path):
    """The same bytes with the daemon on, the daemon dead and L1 alone,
    for v1 and zlib."""
    for codec in (None, "zlib"):
        tag = codec or "v1"
        path = _write_corpus(str(tmp_path / f"mtx_{tag}.rec"), codec)
        answers = {}
        h = RecordLookup(path, decode_ctx=_l1_ctx())
        answers["l1"] = h.lookup(KEYSET)
        h.close()
        d = BlockCacheDaemon(str(tmp_path / f"bc_{tag}.sock"), max_bytes=64 << 20).start()
        try:
            ctx = io_codec.DecodeContext(cache=io_codec.DecodedBlockCache(64 << 20),
                                         shared=BlockCacheClient(d.sock_path))
            h = RecordLookup(path, decode_ctx=ctx)
            answers["daemon"] = h.lookup(KEYSET)
            d.close()  # dead mid-handle: a fresh L1 re-reads, misses silently
            ctx2 = io_codec.DecodeContext(cache=io_codec.DecodedBlockCache(64 << 20),
                                          shared=BlockCacheClient(d.sock_path))
            h2 = RecordLookup(path, decode_ctx=ctx2)
            answers["dead"] = h2.lookup(KEYSET)
            h.close()
            h2.close()
        finally:
            d.close()
        assert answers["l1"] == answers["daemon"] == answers["dead"]
        assert answers["l1"][3] is None


@pytest.mark.blockcache
def test_warm_publishes_through_daemon(tmp_path):
    """warm() publishes the hot blocks; a fresh L1 on the same daemon then
    answers the key set without reading the file."""
    path = _write_corpus(str(tmp_path / "warm.rec"), "zlib")
    d = BlockCacheDaemon(str(tmp_path / "warm.sock"), max_bytes=64 << 20).start()
    try:
        def handle():
            return RecordLookup(path, decode_ctx=io_codec.DecodeContext(
                cache=io_codec.DecodedBlockCache(64 << 20),
                shared=BlockCacheClient(d.sock_path)))

        h_a = handle()
        assert h_a.warm(KEYSET) > 0
        assert h_a.warm(KEYSET) == 0  # already resident
        h_a.close()
        h_b = handle()
        assert h_b.lookup(KEYSET)[0] == _payload(0)
        assert h_b.io_stats()["spans"] == 0  # no read: all from the daemon
        h_b.close()
    finally:
        d.close()


# -- the serve daemon -----------------------------------------------------------


def test_serve_daemon_end_to_end(tmp_path):
    path = _write_corpus(str(tmp_path / "srv.rec"), "zlib")
    h = RecordLookup(path, decode_ctx=_l1_ctx())
    srv = LookupServer(h, port=0)
    try:
        c = LookupClient("127.0.0.1", srv.port)
        assert c.ping()
        vals = c.lookup(KEYSET)
        assert vals[0] == _payload(0) and vals[2] == _payload(77) and vals[3] is None
        assert c.warm(max_blocks=4) >= 0
        c2 = LookupClient("127.0.0.1", srv.port)
        assert c2.lookup([0]) == [_payload(0)]
        st = c.stats()
        assert st["requests"] >= 4 and st["qps"] > 0
        assert "p99_ms" in st and "p50_ms" in st
        assert st["shard"]["records"] == N_RECORDS
        assert st["negatives"] >= 1
        c2.close()
        c.close()
    finally:
        _close_server(srv)
        h.close()


def test_serve_daemon_reports_corrupt_as_error(tmp_path):
    path = _write_corpus(str(tmp_path / "srvbad.rec"), "zlib")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\xff\xff\xff\xff")
    h = RecordLookup(path, decode_ctx=_l1_ctx())
    srv = LookupServer(h, port=0)
    try:
        c = LookupClient("127.0.0.1", srv.port)
        with pytest.raises(Error, match="refused"):
            c.lookup(list(range(0, 3 * N_RECORDS, 3)))
        assert c.ping()  # the connection survives a refusal
        c.close()
    finally:
        _close_server(srv)
        h.close()


def test_malformed_key_shapes_refused_not_iterated(tmp_path):
    path = _write_corpus(str(tmp_path / "shape.rec"), None, n=20)
    h = RecordLookup(path, decode_ctx=_l1_ctx())
    srv = LookupServer(h, port=0)
    try:
        with pytest.raises(Error, match="must be integers"):
            h.lookup([True])
        c = LookupClient("127.0.0.1", srv.port)
        with pytest.raises(Error, match="must be a JSON array"):
            c._request({"op": "lookup", "keys": "12"})
        with pytest.raises(Error, match="must be a JSON array"):
            c._request({"op": "warm", "keys": "12"})
        assert c.ping()
        c.close()
    finally:
        _close_server(srv)
        h.close()


def test_serve_daemon_unknown_op_refused(tmp_path):
    path = _write_corpus(str(tmp_path / "srvun.rec"), None, n=20)
    h = RecordLookup(path, decode_ctx=_l1_ctx())
    srv = LookupServer(h, port=0)
    try:
        c = LookupClient("127.0.0.1", srv.port)
        with pytest.raises(Error, match="unknown op"):
            c._request({"op": "evil"})
        c.close()
    finally:
        _close_server(srv)
        h.close()


def test_tools_info_reports_shard_geometry(tmp_path, capsys):
    from dmlc_core_tpu.tools import main as jax_tools_main

    path = _write_corpus(str(tmp_path / "info.rec"), "zlib")
    assert tools_main(["info", path]) == 0
    shard = json.loads(capsys.readouterr().out)["shard"]
    assert shard["records"] == N_RECORDS and shard["keys"] == N_RECORDS
    assert shard["compressed"] is True and shard["codec"] == "zlib"
    assert shard["blocks"] > 1
    assert shard["block_bytes"]["min"] <= shard["block_bytes"]["max"]
    assert jax_tools_main(["info", path]) == 0
    assert json.loads(capsys.readouterr().out)["shard"] == shard


def test_lookup_telemetry_series_tick(tmp_path):
    from dmlc_core_tpu_torch.telemetry import default_registry

    reg = default_registry()
    b0 = reg.counter("io.lookup.batches").value()
    n0 = reg.counter("io.lookup.negatives").value()
    h = RecordLookup(_write_corpus(str(tmp_path / "tel.rec"), "zlib", n=40),
                     decode_ctx=_l1_ctx())
    try:
        h.lookup([0, 10**9])
    finally:
        h.close()
    assert reg.counter("io.lookup.batches").value() == b0 + 1
    assert reg.counter("io.lookup.negatives").value() == n0 + 1
    assert "io.lookup.batch_seconds" in reg.snapshot()["histograms"]


def test_lookup_wait_spans_have_flow_to_handler_spans(tmp_path):
    """Each ``lookup_wait`` span on the client's thread holds a flow start
    whose id lands in a server-side ``dmlc:lookup_*`` handler span."""
    from dmlc_core_tpu_torch.telemetry import tracing

    tracing.reset()
    tracing.set_enabled(True)
    try:
        h = RecordLookup(_write_corpus(str(tmp_path / "flow.rec"), "zlib"),
                         decode_ctx=_l1_ctx())
        srv = LookupServer(h, port=0)
        try:
            c = LookupClient("127.0.0.1", srv.port)
            assert c.lookup([0]) == [_payload(0)]
            c.warm(max_blocks=2)
            c.stats()
            c.close()
        finally:
            _close_server(srv)
            h.close()
        evs = tracing.to_chrome_trace()["traceEvents"]
        waits = [e for e in evs if e["ph"] == "X" and e["name"] == "dmlc:lookup_wait"]
        assert waits, "no lookup_wait spans recorded"
        handlers = [e for e in evs if e["ph"] == "X" and e["name"].startswith("dmlc:lookup_")
                    and e["name"] != "dmlc:lookup_wait"]
        flows_s = {e["id"]: e for e in evs if e["ph"] == "s"}
        flows_f = {e["id"]: e for e in evs if e["ph"] == "f"}
        for w in waits:
            enclosed = [s for s in flows_s.values()
                        if s["pid"] == w["pid"] and s["tid"] == w["tid"]
                        and w["ts"] <= s["ts"] <= w["ts"] + w["dur"]]
            assert enclosed, f"lookup_wait span at {w['ts']} has no flow"
            f = flows_f.get(enclosed[0]["id"])
            assert f is not None, "flow never landed server-side"
            host = next((hs for hs in handlers if hs["tid"] == f["tid"]
                         and hs["ts"] <= f["ts"] <= hs["ts"] + hs["dur"]), None)
            assert host is not None, "flow-finish outside a handler span"
            assert "tc" in host.get("args", {})
    finally:
        tracing.set_enabled(None)
        tracing.reset()


def test_server_close_joins_its_threads(tmp_path):
    """``close()`` ends the timed accept loop and the connection threads
    within their join timeouts, with a client still connected."""
    h = RecordLookup(_write_corpus(str(tmp_path / "cl.rec"), None, n=20),
                     decode_ctx=_l1_ctx())
    srv = LookupServer(h, port=0)
    c = LookupClient("127.0.0.1", srv.port)
    assert c.ping()
    accept, conns = srv._accept_thread, list(srv._conn_threads)
    srv.close()
    h.close()
    assert not accept.is_alive() and conns and not any(t.is_alive() for t in conns)
    assert not c.ping()
    c.close()


# -- both packages on the same shards -------------------------------------------


@pytest.mark.parametrize("keys", ["int", "str"])
@pytest.mark.parametrize("codec", [None, "zlib"])
def test_record_lookup_equals_jax(tmp_path, codec, keys):
    path = _write_corpus(str(tmp_path / "x.rec"), codec)
    if keys == "str":
        _string_keys(path)
        query = ["user-000", "user-231", "nope", "user-693", "user-231", b"user-003"]
    else:
        query = KEYSET + [231, -5, "9"]
    port, jax = RecordLookup(path), JaxLookup(path)
    try:
        assert port.lookup(query) == jax.lookup(query)
        assert any(v is None for v in port.lookup(query))
        assert port.describe() == jax.describe()
        assert port.warm(query) == jax.warm(query)
        assert port.warm() == jax.warm()
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("direction", ["jax_server", "port_server"])
def test_servers_and_clients_interoperate(tmp_path, direction):
    """A JAX server answers a port client and a port server a JAX client:
    the same bytes, negatives as None, the same refusals, stats."""
    path = _write_corpus(str(tmp_path / "wire.rec"), "zlib")
    if direction == "jax_server":
        h, srv_cls, cli_cls = JaxLookup(path), JaxServer, LookupClient
    else:
        h, srv_cls, cli_cls = RecordLookup(path), LookupServer, JaxClient
    srv = srv_cls(h, port=0)
    want = RecordLookup(path)
    try:
        c = cli_cls("127.0.0.1", srv.port)
        assert c.ping()
        got = c.lookup(KEYSET + [231, 231])
        assert got == want.lookup(KEYSET + [231, 231])
        assert got[3] is None and got[2] == _payload(77)
        assert c.warm(max_blocks=3) >= 0
        with pytest.raises(Exception, match="unknown op"):
            c._request({"op": "evil"})
        assert c.stats()["shard"] == want.describe()
        c.close()
    finally:
        _close_server(srv) if direction == "port_server" else srv.close()
        h.close()
        want.close()
