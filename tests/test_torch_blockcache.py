"""The port's host-shared decoded-block cache
(dmlc_core_tpu_torch/io/blockcache.py and ``codec.DecodeContext``'s shared
tier) against the JAX package's, on the CPU.

The first half holds a port case for each case of tests/test_blockcache.py:
protocol round trips, the publish race, lease-gated eviction, quotas,
dropped connections, the negative cache, the splitter over the shared
tier (a second reader decodes nothing, a killed daemon degrades to local
decodes, a rewritten file misses), the wire key across interpreters, two
processes decoding once per host, and ``tools cached``. The second half
mixes the packages: one ``wire_block_key`` for one zlib file, a JAX
daemon serving a port client and the reverse, and a JAX process and a
port process on one daemon decoding each block once.

Every daemon runs on a private socket and is closed by its test, and the
accept threads are joined with a timeout. The module takes the conftest's
``blockcache`` capability probe (skipped with a reason where POSIX shared
memory or UNIX sockets are missing)."""

import json
import os
import subprocess
import sys
import threading

import pytest

from dmlc_core_tpu.io import blockcache as jax_blockcache
from dmlc_core_tpu.io import codec as jax_codec
from dmlc_core_tpu.io import split as jax_split
from dmlc_core_tpu_torch.io import blockcache
from dmlc_core_tpu_torch.io import split as io_split
from dmlc_core_tpu_torch.io.blockcache import BlockCacheClient, BlockCacheDaemon
from dmlc_core_tpu_torch.io.codec import DecodeContext, DecodedBlockCache, wire_block_key
from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
from dmlc_core_tpu_torch.io.stream import FileStream
from dmlc_core_tpu_torch.telemetry import default_registry

pytestmark = pytest.mark.blockcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def close(d) -> None:
    """Close a daemon of either package and join its accept thread (the
    JAX daemon's close leaves accept() blocked: a shutdown of its
    listening socket wakes it)."""
    import socket

    if isinstance(d, jax_blockcache.BlockCacheDaemon) and d._sock is not None:
        try:
            d._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
    d.close()
    t = d._accept_thread
    if t is not None:
        t.join(10)
        assert not t.is_alive(), "block-cache accept thread did not stop"


@pytest.fixture
def daemon(tmp_path):
    d = BlockCacheDaemon(str(tmp_path / "cache.sock"), max_bytes=16 << 20).start()
    yield d
    close(d)


@pytest.fixture(autouse=True)
def _no_ambient_daemon(monkeypatch, tmp_path):
    """The default client of both packages looks for a daemon on a
    socket of this test's own, so no test meets another's daemon."""
    monkeypatch.setenv("DMLC_BLOCK_CACHE_SOCK", str(tmp_path / "default.sock"))
    blockcache.reset_default_client()
    jax_blockcache.reset_default_client()
    yield
    blockcache.reset_default_client()
    jax_blockcache.reset_default_client()


def client(d, tenant="t"):
    return BlockCacheClient(d.sock_path, tenant=tenant)


def _wait_leases(d, want, tries=100):
    # lease releases are one-way frames: give the daemon a moment
    while d.stats()["active_leases"] != want and tries:
        tries -= 1
        threading.Event().wait(0.01)
    return d.stats()["active_leases"]


# -- the protocol ------------------------------------------------------------------


def test_publish_then_get_roundtrip(daemon):
    a, b = client(daemon, "a"), client(daemon, "b")
    assert a.ping()
    assert a.get("k") is None
    assert a.publish("k", b"payload-bytes")
    assert b.get("k") == b"payload-bytes"
    st = daemon.stats()
    assert st["entries"] == 1 and st["publishes"] == 1
    assert st["hits"] == 1 and st["misses"] == 1
    assert st["tenants"]["a"]["bytes"] == len(b"payload-bytes")


def test_get_view_is_shared_memory(daemon):
    a = client(daemon)
    a.publish("k", b"0123456789")
    v = a.get_view("k")
    assert bytes(v.view) == b"0123456789" and len(v) == 10
    assert daemon.stats()["active_leases"] == 1
    v.close()
    assert _wait_leases(daemon, 0) == 0


def test_leased_view_released_when_collected(daemon):
    """A view dropped without ``close()`` releases its lease when it is
    collected (``weakref.finalize``)."""
    a = client(daemon)
    a.publish("k", b"collected")
    v = a.get_view("k")
    assert daemon.stats()["active_leases"] == 1
    del v
    assert _wait_leases(daemon, 0) == 0


def test_publish_race_single_winner(daemon):
    """Both racers publish: one copy is adopted, the loser unlinks its
    segment and its next lookup hits the winner's bytes."""
    a, b = client(daemon, "a"), client(daemon, "b")
    data = b"x" * 4096
    assert a.publish("blk", data)
    assert not b.publish("blk", data)
    assert b.get("blk") == data
    st = daemon.stats()
    assert st["entries"] == 1 and st["bytes"] == len(data)
    wins = []

    def racer(c):
        wins.append([c.publish(f"race-{i}", bytes([i]) * 512) for i in range(8)])

    threads = [threading.Thread(target=racer, args=(client(daemon, r),)) for r in ("r1", "r2")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    st = daemon.stats()
    assert st["entries"] == 9 and st["bytes"] == len(data) + 8 * 512
    for i, (w1, w2) in enumerate(zip(*wins)):
        assert not (w1 and w2), f"race-{i} adopted twice"
        assert client(daemon).get(f"race-{i}") == bytes([i]) * 512


def test_eviction_never_unlinks_leased(tmp_path):
    d = BlockCacheDaemon(str(tmp_path / "c.sock"), max_bytes=25).start()
    try:
        a = client(d)
        assert a.publish("x1", b"0123456789")
        v = a.get_view("x1")  # a lease held across the pressure below
        assert a.publish("x2", b"0123456789")
        assert a.publish("x3", b"0123456789")  # over budget: evicts
        assert d.stats()["evictions"] == 1
        assert a.get("x2") is None  # the LRU unleased entry went
        assert a.get("x1") == b"0123456789"
        assert bytes(v.view) == b"0123456789"  # the mapping is still valid
        v.close()
        assert a.publish("x4", b"0123456789")  # x1 evictable again
        assert d.stats()["bytes"] <= 25
    finally:
        close(d)


def test_oversized_and_tenant_quota_rejected(tmp_path):
    d = BlockCacheDaemon(str(tmp_path / "c.sock"), max_bytes=1 << 20,
                         tenant_max_bytes=64).start()
    try:
        a, b = client(d, "a"), client(d, "b")
        assert not a.publish("big", b"z" * 128)  # over the tenant quota
        assert a.publish("a1", b"z" * 48)
        assert a.publish("a2", b"z" * 48)  # evicts a1, within tenant a
        assert b.publish("b1", b"y" * 48)  # b's quota untouched by a
        st = d.stats()
        assert st["rejected"] == 1
        assert st["tenants"]["a"]["bytes"] == st["tenants"]["b"]["bytes"] == 48
        assert a.get("a1") is None and a.get("a2") is not None
    finally:
        close(d)


def test_connection_drop_releases_leases(daemon):
    a = client(daemon)
    a.publish("k", b"data-here")
    v = a.get_view("k")
    assert daemon.stats()["active_leases"] == 1
    a.close()  # the connection goes without a release
    assert _wait_leases(daemon, 0, tries=200) == 0
    del v


def test_flush_keeps_leased(daemon):
    a = client(daemon)
    a.publish("k1", b"one")
    a.publish("k2", b"two")
    v = a.get_view("k1")
    assert a.flush() == 1  # k2 only: k1 is leased
    assert a.get("k1") == b"one"
    v.close()
    assert a.flush() == 1


def test_daemon_metrics_port_serves_blockcache_series(tmp_path):
    """``metrics_port`` serves the daemon's registry: the
    ``io.blockcache`` counters per tenant, and its stats as JSON."""
    import socket

    from dmlc_core_tpu_torch.io import retry

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    d = BlockCacheDaemon(str(tmp_path / "m.sock"), max_bytes=1 << 20,
                         metrics_port=port).start()
    try:
        a = client(d, "metrics-tenant")
        a.publish("k", b"bytes")
        assert a.get("k") == b"bytes"
        with retry.request(f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            text = resp.read()
        assert b'tenant="metrics-tenant"' in text and b"blockcache" in text
        with retry.request(f"http://127.0.0.1:{port}/stats", timeout=10) as resp:
            stats = json.loads(resp.read())
        assert stats["entries"] == 1 and stats["hits"] == 1
    finally:
        close(d)


def test_close_ends_the_accept_thread(tmp_path):
    """``close()`` wakes the blocked ``accept()`` (a close of the
    listening socket alone does not on Linux) and joins its thread, so a
    closed daemon leaves no thread behind; a second close is a no-op."""
    d = BlockCacheDaemon(str(tmp_path / "j.sock"), max_bytes=1 << 20).start()
    c = client(d)
    assert c.publish("k", b"v")
    d.close()
    assert not d._accept_thread.is_alive()
    assert not os.path.exists(d.sock_path)
    assert c.get("k") is None and not c.alive  # a closed daemon looks killed
    d.close()


# -- the client's fallback -----------------------------------------------------------


def test_default_client_negative_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("DMLC_BLOCK_CACHE_SOCK", str(tmp_path / "nothing-here.sock"))
    blockcache.reset_default_client()
    assert blockcache.default_client() is None
    assert blockcache.default_client() is None  # cached, no second probe


def test_env_off_disables_even_with_live_daemon(daemon, monkeypatch):
    monkeypatch.setenv("DMLC_BLOCK_CACHE_SOCK", daemon.sock_path)
    monkeypatch.setenv("DMLC_BLOCK_CACHE", "off")
    blockcache.reset_default_client()
    assert blockcache.default_client() is None
    monkeypatch.delenv("DMLC_BLOCK_CACHE")
    blockcache.reset_default_client()
    c = blockcache.default_client()
    assert c is not None and c.ping()


# -- the splitter over the shared tier -------------------------------------------------


def _write_zlib_rec(tmp_path, n=2400, rewrite_tag=b""):
    rec = str(tmp_path / "data.rec")
    idx = rec + ".idx"
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi, codec="zlib", block_bytes=1 << 12)
        for i in range(n):
            w.write_record((rewrite_tag or b"A") + (b"%06d" % i) * 18)
        w.flush_block()
    return rec, idx


def _drain(rec, idx, ctx, kill_daemon_after=None):
    sp = io_split.IndexedRecordIOSplitter(rec, idx, 0, 1, shuffle="window", window=200,
                                          seed=5, decode_ctx=ctx)
    out = []
    pulls = 0
    while (chunk := sp.next_batch_ex(256)) is not None:
        out.append(bytes(chunk))
        pulls += 1
        if kill_daemon_after is not None and pulls == 2:
            close(kill_daemon_after)
    stats = sp.io_stats()
    sp.close()
    return b"".join(out), stats


def _decodes() -> int:
    return default_registry().histogram("io.codec.decode_seconds").snapshot()["count"]


def test_second_context_decodes_nothing(daemon, tmp_path):
    """Reader 2 (a fresh L1, the same daemon) serves every block from
    the shared tier: no decode of its own, the same bytes."""
    rec, idx = _write_zlib_rec(tmp_path)
    c1, c2 = client(daemon, "p1"), client(daemon, "p2")
    b1, st1 = _drain(rec, idx, DecodeContext(cache=DecodedBlockCache(1 << 24), shared=c1))
    assert st1["decode_cache_misses"] > 0 and c1.publishes > 0
    before = _decodes()
    b2, st2 = _drain(rec, idx, DecodeContext(cache=DecodedBlockCache(1 << 24), shared=c2))
    assert b2 == b1
    assert _decodes() == before
    assert c2.hits > 0 and c2.misses == 0
    assert st2["decode_cache_hits"] > 0 and st2["decode_cache_misses"] == 0


def test_daemon_killed_mid_read_degrades_silently(tmp_path):
    """A daemon closed between windows costs only the shared tier: the
    read ends byte-identical through local decodes, with no error."""
    rec, idx = _write_zlib_rec(tmp_path)
    clean, _ = _drain(rec, idx, DecodeContext(cache=DecodedBlockCache(1 << 24), shared=None))
    d = BlockCacheDaemon(str(tmp_path / "kill.sock"), max_bytes=16 << 20).start()
    c = client(d)
    # a zero-budget L1: every window asks the shared tier, so some ask
    # after the kill
    got, _ = _drain(rec, idx, DecodeContext(cache=DecodedBlockCache(0), shared=c),
                    kill_daemon_after=d)
    assert got == clean
    assert not c.alive


def test_stale_mtime_misses_not_serves(daemon, tmp_path):
    """An in-place rewrite (same path, size and block layout) changes
    the identity: the second reader misses and decodes the new bytes."""
    rec, idx = _write_zlib_rec(tmp_path, rewrite_tag=b"A")
    b1, _ = _drain(rec, idx, DecodeContext(cache=DecodedBlockCache(1 << 24),
                                           shared=client(daemon, "p1")))
    rec2, _ = _write_zlib_rec(tmp_path, rewrite_tag=b"B")
    assert rec2 == rec
    os.utime(rec, ns=(1, 1))  # a distinct mtime_ns either way
    c2 = client(daemon, "p2")
    b2, _ = _drain(rec, idx, DecodeContext(cache=DecodedBlockCache(1 << 24), shared=c2))
    assert b2 != b1
    assert c2.hits == 0 and c2.misses > 0


def test_wire_key_stable_across_processes():
    """The daemon key is the same from two interpreters and from the JAX
    package (``hash()`` is seeded per process; the sha1 is not)."""
    key = (("file.rec", 123, 456, "etag-x"), 789, "aa" * 20)
    outs = set()
    for mod in ("dmlc_core_tpu_torch", "dmlc_core_tpu", "dmlc_core_tpu_torch"):
        outs.add(subprocess.run(
            [sys.executable, "-c",
             f"from {mod}.io.codec import wire_block_key; print(wire_block_key({key!r}))"],
            capture_output=True, text=True, check=True, cwd=REPO, timeout=120,
        ).stdout.strip())
    assert outs == {wire_block_key(key)} == {jax_codec.wire_block_key(key)}
    assert wire_block_key("already-flat") == "already-flat"


_DRAIN_SCRIPT = """
import json, sys
pkg, rec, idx = sys.argv[1:4]
if pkg == "jax":
    from dmlc_core_tpu.io import split as io_split
    from dmlc_core_tpu.telemetry import default_registry
else:
    from dmlc_core_tpu_torch.io import split as io_split
    from dmlc_core_tpu_torch.telemetry import default_registry
sp = io_split.IndexedRecordIOSplitter(rec, idx, 0, 1, shuffle="window", window=200, seed=5)
n = 0
while True:
    c = sp.next_batch_ex(256)
    if c is None:
        break
    n += len(c)
sp.close()
reg = default_registry()
print(json.dumps({
    "bytes": n,
    "decodes": reg.histogram("io.codec.decode_seconds").snapshot()["count"],
    "blockcache_hits": sum(reg.counter_values("io.blockcache.hits").values()),
}))
"""


def _drain_process(pkg, rec, idx, sock):
    env = dict(os.environ, DMLC_BLOCK_CACHE_SOCK=sock, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _DRAIN_SCRIPT, pkg, rec, idx],
                         capture_output=True, text=True, env=env, cwd=REPO, check=True,
                         timeout=300)
    return json.loads(out.stdout)


def test_two_real_processes_decode_once_per_host(daemon, tmp_path):
    """A second port process over the same compressed file hits the
    daemon through the default client and decodes no block itself."""
    rec, idx = _write_zlib_rec(tmp_path)
    first = _drain_process("port", rec, idx, daemon.sock_path)
    assert first["decodes"] > 0 and first["blockcache_hits"] == 0
    second = _drain_process("port", rec, idx, daemon.sock_path)
    assert second["bytes"] == first["bytes"]
    assert second["blockcache_hits"] > 0 and second["decodes"] == 0
    assert daemon.stats()["publishes"] > 0


# -- tools cached --------------------------------------------------------------------


def test_tools_cached_stats_and_flush(daemon, capsys):
    from dmlc_core_tpu_torch.tools import main as tools_main

    client(daemon).publish("k", b"some-bytes")
    assert tools_main(["cached", "stats", "--socket", daemon.sock_path]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["entries"] == 1 and stats["publishes"] == 1
    assert tools_main(["cached", "flush", "--socket", daemon.sock_path]) == 0
    assert json.loads(capsys.readouterr().out) == {"evicted": 1}
    assert daemon.stats()["entries"] == 0


def test_tools_cached_no_daemon(tmp_path, capsys):
    from dmlc_core_tpu_torch.tools import main as tools_main

    assert tools_main(["cached", "stats", "--socket", str(tmp_path / "absent.sock")]) == 1
    assert "no block-cache daemon" in capsys.readouterr().err


def test_tools_cached_serve_process(tmp_path):
    """``tools cached serve`` as a process: it answers on its socket, a
    JAX client publishes and a port client reads, and SIGTERM ends it
    with its socket and segments gone."""
    sock = str(tmp_path / "serve.sock")
    proc = subprocess.Popen([sys.executable, "-m", "dmlc_core_tpu_torch.tools", "cached",
                             "serve", "--socket", sock, "--budget-mb", "8"], cwd=REPO,
                            stderr=subprocess.PIPE, text=True)
    try:
        for _ in range(600):
            if os.path.exists(sock) or proc.poll() is not None:
                break
            threading.Event().wait(0.05)
        assert os.path.exists(sock), proc.stderr.read() if proc.poll() is not None else ""
        assert jax_blockcache.BlockCacheClient(sock, tenant="j").publish("k", b"v" * 100)
        c = BlockCacheClient(sock, tenant="p")
        assert c.get("k") == b"v" * 100
        stats = c.stats()
        assert stats["max_bytes"] == 8 << 20 and stats["pid"] == proc.pid
        c.close()
    finally:
        proc.terminate()
        rc = proc.wait(timeout=30)
    assert rc == 0 and not os.path.exists(sock)
    assert "block-cache daemon pid" in proc.stderr.read()


# -- both packages ---------------------------------------------------------------------


@pytest.mark.parametrize("shuffle", ["0", "window"])
def test_wire_block_key_equals_jax_for_one_zlib_file(tmp_path, shuffle):
    """The two packages' splitters over one zlib file name every block
    with the same daemon key."""
    rec, idx = _write_zlib_rec(tmp_path, n=600)
    port = io_split.IndexedRecordIOSplitter(rec, idx, 0, 1, shuffle=shuffle, window=100)
    jax = jax_split.IndexedRecordIOSplitter(rec, idx, 0, 1, shuffle=shuffle, window=100)
    port.before_first()
    jax.before_first()
    try:
        n = len(port._block_offs)
        assert n > 10 and n == len(jax._block_offs)
        got = [wire_block_key(port._block_key(b)) for b in range(n)]
        want = [jax_codec.wire_block_key(jax._block_key(b)) for b in range(n)]
        assert got == want and len(set(got)) == n
    finally:
        port.close()
        jax.close()


@pytest.mark.parametrize("server", ["jax", "port"])
def test_daemon_serves_the_other_packages_client(tmp_path, server):
    """A JAX daemon serves a port client and a port daemon a JAX client:
    publish, then get, get_many and a leased view, with the stats and
    flush of either client."""
    daemon_cls, pub_cls, get_cls = (
        (jax_blockcache.BlockCacheDaemon, BlockCacheClient, jax_blockcache.BlockCacheClient)
        if server == "jax" else
        (BlockCacheDaemon, jax_blockcache.BlockCacheClient, BlockCacheClient))
    d = daemon_cls(str(tmp_path / "x.sock"), max_bytes=1 << 20).start()
    try:
        other, same = pub_cls(d.sock_path, tenant="o"), get_cls(d.sock_path, tenant="s")
        assert other.publish("k1", b"one" * 10) and other.publish("k2", b"two" * 10)
        assert same.get("k1") == b"one" * 10
        assert same.get_many(["k1", "k2", "k3"]) == {"k1": b"one" * 10, "k2": b"two" * 10}
        v = other.get_view("k2")
        assert bytes(v.view) == b"two" * 10
        # same's releases of k1 are one-way; a round trip on its own
        # connection, which the daemon serves in order, lands them first
        assert same.ping()
        assert other.flush() == 1  # k1 only: k2 is leased
        v.close()
        st = other.stats()
        assert st == same.stats()
        assert st["publishes"] == 2 and st["tenants"]["o"]["entries"] == 1
        assert not same.publish("k2", b"two" * 10)  # the race's loser
    finally:
        close(d)


@pytest.mark.parametrize("order", [("jax", "port"), ("port", "jax")])
def test_jax_and_port_processes_decode_once_per_host(tmp_path, order):
    """A process of one package publishes every block to a daemon of
    the other; a process of the second package then decodes none."""
    rec, idx = _write_zlib_rec(tmp_path)
    cls = BlockCacheDaemon if order[0] == "jax" else jax_blockcache.BlockCacheDaemon
    d = cls(str(tmp_path / "mix.sock"), max_bytes=16 << 20).start()
    try:
        first = _drain_process(order[0], rec, idx, d.sock_path)
        assert first["decodes"] > 0 and first["blockcache_hits"] == 0
        second = _drain_process(order[1], rec, idx, d.sock_path)
        assert second["bytes"] == first["bytes"]
        assert second["decodes"] == 0 and second["blockcache_hits"] > 0
        assert d.stats()["publishes"] == first["decodes"]
    finally:
        close(d)
