"""The port's dsserve data plane (``dmlc_core_tpu_torch/dsserve``) and the
staging pipeline's adopt path, against the JAX package:

- the static-mode, wire and data-plane cases of ``tests/test_dsserve.py``
  on the port: frame round trips and hostility, the drip-fed truncation
  walk, ``dsserve://`` through the factories (ELL and dense), the
  reopen-and-seek resume, the transport matrix (TCP, TCP with the
  adaptive codec, shm) bit for bit against the local producer, the shm
  degrade drill, the slot pool under live views, the adoptable-slot
  predicate and the pipeline adopting every received slot;
- the adopt rules of the port: a wrapper that declares no
  ``adopt_slots`` has every slot copied, an adopted buffer stays out of
  the pool until its copy's event has completed, a client drained under
  a host pinning page-locks each pool bank and each mapped shm segment
  once and releases a segment only when no view over it lives, and the
  first slot of a fresh pool lands in a pooled bank;
- across the packages: ``send_frame`` writes the same bytes; a JAX server
  feeds a port client and a port server a JAX client over TCP, TCP with
  zlib and shm, with slots equal to the local producer's; one drain moves
  the dsserve and staging registry series alike in both packages; FM
  trained on the CPU from ``dsserve://`` slots matches the JAX FM on the
  same batches.

The lease-mode cases are in ``test_torch_dsserve_lease.py``. Every
server, client and thread is closed with a bounded join."""

import gc
import hashlib
import os
import socket
import struct
import threading

import numpy as np
import pytest
import torch

from dmlc_core_tpu.dsserve import DsServeBatches as JaxBatches
from dmlc_core_tpu.dsserve import DsServeServer as JaxServer
from dmlc_core_tpu.dsserve import client as jax_client
from dmlc_core_tpu.dsserve import wire as jax_wire
from dmlc_core_tpu.staging import BatchSpec as JaxSpec
from dmlc_core_tpu.staging import ell_batches as jax_ell_batches
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.data.rowrec import encode_rows
from dmlc_core_tpu_torch.dsserve import DsServeBatches, DsServeServer, parse_dsserve_uri
from dmlc_core_tpu_torch.dsserve import client as port_client
from dmlc_core_tpu_torch.dsserve import wire
from dmlc_core_tpu_torch.io.recordio import IndexedRecordIOWriter
from dmlc_core_tpu_torch.io.stream import FileStream
from dmlc_core_tpu_torch.staging import fused
from dmlc_core_tpu_torch.staging import pipeline as pl
from dmlc_core_tpu_torch.staging.batcher import Batch, BatchSpec, host_pinning
from dmlc_core_tpu_torch.telemetry import default_registry
from dmlc_core_tpu_torch.utils.logging import Error

N_ROWS = 2000
K = 8
BATCH = 64


def write_corpus(rec, idx, codec=None, n=N_ROWS, seed=7):
    """``n`` rows of K features through the port's indexed writer."""
    rng = np.random.default_rng(seed)
    blk = RowBlock(offset=np.arange(n + 1, dtype=np.int64) * K,
                   label=(np.arange(n) % 2).astype(np.float32),
                   index=rng.integers(0, 500, n * K).astype(np.uint32),
                   value=rng.normal(size=n * K).astype(np.float32))
    kwargs = {"codec": codec, "block_bytes": 1 << 14} if codec else {}
    with FileStream(rec, "w") as f, FileStream(idx, "w") as fi:
        w = IndexedRecordIOWriter(f, fi, **kwargs)
        for i, payload in enumerate(encode_rows(blk)):
            w.write_record(payload, i)
        w.flush_block()
    return rec, idx


@pytest.fixture
def corpus(tmp_path):
    return write_corpus(str(tmp_path / "d.rec"), str(tmp_path / "d.idx"))


def spec_of(overflow="truncate"):
    return BatchSpec(batch_size=BATCH, layout="ell", max_nnz=K, overflow=overflow)


def uri_of(rec, idx, extra=""):
    return f"{rec}?index={idx}&shuffle=record&seed=3{extra}"


def drain_packed(producer):
    """(rows, sha256 over every packed slot's bytes, slot count)."""
    h = hashlib.sha256()
    rows = slots = 0
    for b in producer:
        h.update(b.packed.tobytes())
        rows += b.n_valid
        slots += 1
    return rows, h.hexdigest(), slots


def local_drain(uri, spec):
    src = fused.ell_batches(uri, spec)
    try:
        return drain_packed(src)
    finally:
        src.close()


class Pipe:
    """Loopback socket pair for frame round-trip tests."""

    def __enter__(self):
        self.a, self.b = socket.socketpair()
        return self.a, self.b

    def __exit__(self, *exc):
        self.a.close()
        self.b.close()


def static_drain(server_cls, client_cls, rec, idx, spec, **kw):
    """One static stream from a fresh server: (drain, the client's io_stats)."""
    srv = server_cls().start()
    try:
        c = client_cls(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec,
                       mode="static", **kw)
        try:
            got = drain_packed(c)
            stats = c.io_stats()
        finally:
            c.close()
    finally:
        srv.close()
    return got, stats, srv


# -- wire unit -------------------------------------------------------------------


def test_wire_frame_roundtrip():
    payload = np.arange(256, dtype=np.uint8)
    with Pipe() as (a, b):
        wire.send_frame(a, wire.KIND_SLOT, {"shard": 3}, payload, seq=7, epoch=2)
        kind, meta, got, seq, epoch = wire.recv_frame(b)
    assert kind == wire.KIND_SLOT
    assert meta == {"shard": 3}
    assert seq == 7 and epoch == 2
    assert np.array_equal(got, payload)


def test_wire_meta_only_frame():
    with Pipe() as (a, b):
        wire.send_frame(a, wire.KIND_EPOCH_END, {"slots": 9})
        kind, meta, payload, _seq, _epoch = wire.recv_frame(b)
    assert kind == wire.KIND_EPOCH_END
    assert meta == {"slots": 9} and payload is None


def test_wire_crc_mismatch_raises():
    payload = np.arange(64, dtype=np.uint8)
    with Pipe() as (a, b):
        wire.send_frame(a, wire.KIND_SLOT, {"shard": 0}, payload)
        raw = b.recv(4096)
    corrupted = bytearray(raw)
    corrupted[-1] ^= 0xFF  # one payload byte past the header + meta
    with Pipe() as (a, b):
        a.sendall(bytes(corrupted))
        with pytest.raises(Error, match="crc mismatch"):
            wire.recv_frame(b)


def test_wire_bad_magic_and_hostile_lengths():
    with Pipe() as (a, b):
        a.sendall(b"\x00" * wire.HDR_BYTES)
        with pytest.raises(Error, match="magic"):
            wire.recv_frame(b)
    hdr = struct.pack("<IBBHqiIII", wire.MAGIC, wire.KIND_SLOT, 0, 0, 0, 0,
                      wire.MAX_META + 1, 0, 0)
    with Pipe() as (a, b):
        a.sendall(hdr)
        with pytest.raises(Error, match="hostile"):
            wire.recv_frame(b)


def test_wire_truncated_frame_raises():
    payload = np.arange(64, dtype=np.uint8)
    with Pipe() as (a, b):
        wire.send_frame(a, wire.KIND_SLOT, {"shard": 0}, payload)
        raw = b.recv(4096)
    a2, b2 = socket.socketpair()
    try:
        a2.sendall(raw[:-10])
        a2.close()  # EOF mid-payload
        with pytest.raises((Error, ConnectionError)):
            wire.recv_frame(b2)
    finally:
        b2.close()


def test_wire_drip_feed_truncation_walk():
    """EOF at every byte boundary of a SLOT frame raises the checked
    truncation Error naming the starved region (header / meta / payload);
    the pooled recv-into reader shares the hardened path."""
    payload = np.arange(48, dtype=np.uint8)
    with Pipe() as (a, b):
        wire.send_frame(a, wire.KIND_SLOT, {"shard": 1}, payload, seq=2)
        b.settimeout(5)
        frame = b""
        while len(frame) < wire.HDR_BYTES + 11 + payload.nbytes:
            chunk = b.recv(4096)
            if not chunk:
                break
            frame += chunk
    mlen = struct.unpack("<IBBHqiIII", frame[: wire.HDR_BYTES])[6]
    assert len(frame) == wire.HDR_BYTES + mlen + payload.nbytes
    for cut in range(len(frame)):
        a2, b2 = socket.socketpair()
        try:
            a2.sendall(frame[:cut])
            a2.close()
            if cut == 0:
                with pytest.raises(ConnectionError):  # the clean close
                    wire.recv_frame(b2)
                continue
            region = ("header" if cut < wire.HDR_BYTES
                      else "meta" if cut < wire.HDR_BYTES + mlen else "payload")
            with pytest.raises(Error, match=f"truncated frame {region}"):
                wire.recv_frame(b2)
        finally:
            b2.close()
    for buf in (np.zeros(64, dtype=np.uint8), lambda n: np.zeros(n, dtype=np.uint8)):
        a2, b2 = socket.socketpair()
        try:
            a2.sendall(frame[: wire.HDR_BYTES + mlen + 10])
            a2.close()
            with pytest.raises(Error, match="truncated frame payload"):
                wire.read_frame_into(b2, buf)
        finally:
            b2.close()


def test_parse_dsserve_uri():
    eps, inner = parse_dsserve_uri("dsserve://h1:70,h2:71/data/x.rec?index=/data/x.idx")
    assert eps == [("h1", 70), ("h2", 71)]
    assert inner == "/data/x.rec?index=/data/x.idx"
    _eps, inner = parse_dsserve_uri("dsserve://h:1/s3://b/k.rec")
    assert inner == "s3://b/k.rec"
    with pytest.raises(Error):
        parse_dsserve_uri("dsserve://hostonly/x.rec")
    with pytest.raises(Error):
        parse_dsserve_uri("dsserve://h:1")


FRAMES = [
    (wire.KIND_SLOT, {"shard": 3, "n_valid": 2, "sections": [["labels", 0, 8, [2], "float32"]]},
     np.arange(256, dtype=np.uint8), 7, 2, 0),
    (wire.KIND_SLOT, {"shard": 0, "codec": "zlib", "raw_len": 4096},
     np.frombuffer(b"z" * 99, dtype=np.uint8), 1, 0, wire.FLAG_COMPRESSED),
    (wire.KIND_HELLO, {"uri": "/d/é.rec?index=/d/x.idx", "spec": {"batch_size": 4}},
     None, 0, 0, 0),
    (wire.KIND_EPOCH_END, {"slots": 9, "retired": True}, None, 0, 5, 0),
    (wire.KIND_SHARD_FIN, None, None, -1, -3, 0),
]


@pytest.mark.parametrize("frame", FRAMES, ids=["slot", "compressed", "hello", "end", "fin"])
def test_wire_send_frame_bytes_equal_jax(frame):
    kind, meta, payload, seq, epoch, flags = frame
    out = []
    for mod in (wire, jax_wire):
        with Pipe() as (a, b):
            n = mod.send_frame(a, kind, meta, payload, seq=seq, epoch=epoch, flags=flags)
            a.shutdown(socket.SHUT_WR)
            got = b""
            while True:
                chunk = b.recv(65536)
                if not chunk:
                    break
                got += chunk
        out.append((n, got))
    assert out[0] == out[1]
    assert (wire.MAGIC, wire.HDR_BYTES) == (jax_wire.MAGIC, jax_wire.HDR_BYTES)


# -- bit identity: dsserve == all-local --------------------------------------------


def test_static_single_server_bit_identical_to_local(corpus):
    rec, idx = corpus
    want = local_drain(uri_of(rec, idx), spec_of())
    got, _stats, _srv = static_drain(DsServeServer, DsServeBatches, rec, idx, spec_of())
    assert got == want
    assert got[0] == N_ROWS


def write_libsvm(path, n=300, d=12, seed=5):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            feats = sorted(rng.choice(d, size=4, replace=False))
            f.write(f"{i % 2} " + " ".join(f"{j}:{rng.normal():.4f}" for j in feats) + "\n")
    return path


@pytest.mark.parametrize("layout", ["ell", "dense"])
def test_factory_routes_dsserve_uri(corpus, tmp_path, layout):
    """``dsserve://`` in ``ell_batches`` and ``dense_batches`` is the
    remote stream, bit for bit the local factory's; static shard
    arguments are refused."""
    if layout == "ell":
        rec, idx = corpus
        inner, spec, factory = uri_of(rec, idx), spec_of(), fused.ell_batches
    else:
        inner = write_libsvm(str(tmp_path / "d.libsvm"))
        spec = BatchSpec(batch_size=BATCH, layout="dense", num_features=12)
        factory = fused.dense_batches
    want_src = factory(inner, spec)
    want = drain_packed(want_src)
    want_src.close()
    srv = DsServeServer().start()
    try:
        src = factory(f"dsserve://127.0.0.1:{srv.port}{inner}", spec)
        assert isinstance(src, DsServeBatches) and src.mode == "static"
        got = drain_packed(src)
        src.close()
        with pytest.raises(Error, match="stripe"):
            factory(f"dsserve://127.0.0.1:{srv.port}{inner}", spec,
                    part_index=1, num_parts=2)
    finally:
        srv.close()
    assert got == want


def test_plain_batches_refuse_dsserve():
    """The plain producer reads local files only: ``dsserve://`` raises."""
    with pytest.raises(Error, match="remote"):
        fused.plain_batches("dsserve://127.0.0.1:1/x.rec", spec_of())


def test_static_resume_skips_delivered_slots(corpus):
    """HELLO.start_seq re-runs the deterministic stream and skips the
    first k slots: the resumed tail equals the full stream's tail."""
    rec, idx = corpus
    srv = DsServeServer().start()
    try:
        c = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec_of(),
                           mode="static")
        full = [b.packed.tobytes() for b in c]
        c.close()
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        try:
            wire.send_frame(sock, wire.KIND_HELLO, {
                "uri": uri_of(rec, idx), "format": "auto", "epoch": 0,
                "mode": "static", "part": 0, "nparts": 1, "start_seq": 5,
                "spec": {"batch_size": BATCH, "layout": "ell", "max_nnz": K,
                         "num_features": None, "overflow": "truncate",
                         "index_dtype": "int32", "value_dtype": "float32"},
            })
            kind, _m, _p, _s, _e = wire.recv_frame(sock)
            assert kind == wire.KIND_OK
            tail = []
            while True:
                kind, _meta, payload, seq, _e = wire.recv_frame(sock)
                if kind == wire.KIND_EPOCH_END:
                    break
                if kind == wire.KIND_SLOT:
                    assert seq >= 5
                    tail.append(payload.tobytes())
        finally:
            sock.close()
    finally:
        srv.close()
    assert tail == full[5:]


def test_server_rejects_garbage_hello(corpus):
    srv = DsServeServer().start()
    try:
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        try:
            wire.send_frame(sock, wire.KIND_HELLO, {"nonsense": 1})
            kind, meta, _p, _s, _e = wire.recv_frame(sock)
            assert kind == wire.KIND_ERROR
            assert "HELLO" in meta["error"] or "config" in meta["error"]
        finally:
            sock.close()
        rec, idx = corpus  # the server survives a bad client
        c = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec_of(),
                           mode="static")
        assert sum(b.n_valid for b in c) == N_ROWS
        c.close()
    finally:
        srv.close()


def test_one_epoch_stream_guard(corpus):
    rec, idx = corpus
    srv = DsServeServer().start()
    try:
        c = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec_of(),
                           mode="static")
        assert sum(b.n_valid for b in c) == N_ROWS
        with pytest.raises(Error, match="one-epoch"):
            for _ in c:
                pass
        c.close()
    finally:
        srv.close()


# -- the data plane ----------------------------------------------------------------


@pytest.mark.parametrize("transport", ["tcp", "tcp_codec", "shm"])
@pytest.mark.parametrize("path", ["fused", "generic"])
def test_transport_matrix_bit_identity(transport, path, corpus, monkeypatch):
    """{plain TCP, TCP + adaptive codec (throttled so compression
    engages), same-host shm} × {fused, overflow='error'} drains equal the
    local producer, and the telemetry shows which transport carried the
    slots."""
    rec, idx = corpus
    spec = spec_of(overflow="error" if path == "generic" else "truncate")
    want = local_drain(uri_of(rec, idx), spec)
    monkeypatch.setenv("DMLC_DSSERVE_SHM", "on" if transport == "shm" else "off")
    if transport == "tcp_codec":
        monkeypatch.setenv("DMLC_DSSERVE_WIRE_CODEC", "zlib")
        monkeypatch.setenv("DMLC_DSSERVE_WIRE_BPS", "1000000")
    w0, r0 = wire._BYTES_WIRE.value(), wire._BYTES_RAW.value()
    got, stats, srv = static_drain(DsServeServer, DsServeBatches, rec, idx, spec)
    assert got == want
    slots = stats["slots"]
    if transport == "shm":
        assert stats["shm_slots"] >= 1
        assert stats["shm_slots"] + stats["tcp_slots"] == slots
        assert srv.shm_slots_sent == stats["shm_slots"]
        assert stats["reconnects"] == 0
    else:
        assert stats["shm_slots"] == 0 and stats["tcp_slots"] == slots
    if transport == "tcp_codec":
        dw, dr = wire._BYTES_WIRE.value() - w0, wire._BYTES_RAW.value() - r0
        assert dr > 0 and dw < dr  # the adaptive codec engaged


def test_shm_degrade_drill_silent_tcp_fallback(corpus, monkeypatch):
    """After N shm slots the server names a never-created segment: the
    endpoint degrades to TCP once (sticky) and the resumed stream is bit
    for bit the local one."""
    rec, idx = corpus
    want = local_drain(uri_of(rec, idx), spec_of())
    monkeypatch.setenv("DMLC_DSSERVE_SHM_BREAK_AFTER", "3")
    monkeypatch.setenv("DMLC_DSSERVE_SHM_SLOTS", "64")
    srv = DsServeServer().start()
    try:
        c = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec_of(),
                           mode="static")
        got = drain_packed(c)
        stats = c.io_stats()
        assert c._eps[0].shm_ok is False
        c.close()
    finally:
        srv.close()
    assert got == want
    assert stats["shm_slots"] == 3
    assert stats["tcp_slots"] == want[2] - 3
    assert stats["reconnects"] == 1


def test_slot_pool_reuse_under_live_views():
    """A bank is re-banked only when the LAST view over its carve dies,
    and growth retires undersized banks."""
    pool = port_client._SlotPool()
    assert pool.get() is None
    pool.ensure(1 << 12)
    a = pool.get()
    assert a.nbytes == 1 << 12 and a.ctypes.data % 4096 == 0
    b = pool.get()
    assert pool.banks == 2
    a[:] = 7
    view = a[100:200]
    del a
    gc.collect()
    c = pool.get()  # the first bank is still aliased by `view`
    assert pool.banks == 3
    c[:] = 9
    assert (view == 7).all()
    del view
    gc.collect()
    d = pool.get()  # recycled: no new bank
    assert pool.banks == 3
    pool.ensure(1 << 13)
    e = pool.get()
    assert e.nbytes == 1 << 13 and pool.banks == 4
    del b, c, d
    gc.collect()
    assert pool.banks == 1
    del e


def test_adoptable_slot_predicate():
    mem = bytearray((1 << 13) + 4096)
    whole = np.frombuffer(mem, dtype=np.uint8)
    off = (-whole.ctypes.data) % 4096
    aligned = np.frombuffer(mem, dtype=np.uint8, count=1 << 12, offset=off)
    lab = np.zeros(4, dtype=np.float32)

    def mk(packed):
        return Batch(labels=lab, weights=lab, n_valid=4, packed=packed)

    assert pl.adoptable_slot(mk(aligned))
    assert not pl.adoptable_slot(mk(None))
    assert not pl.adoptable_slot(mk(np.frombuffer(mem, dtype=np.uint8, count=1 << 12,
                                                  offset=off + 1)))
    assert not pl.adoptable_slot(mk(aligned[::2]))


# -- the staging pipeline over dsserve ----------------------------------------------


def pipeline_drain(src, **env):
    """Drain a source through a CPU StagingPipeline: (staged arrays,
    staging_stats)."""
    pipe = pl.StagingPipeline(src, device="cpu")
    got = [{k: v.numpy().copy() for k, v in d.items()} for d in pipe]
    stats = pipe.staging_stats()
    assert pl.drain_close(pipe, src)
    return got, stats


class PassThrough:
    """A source passed through by a wrapper that declares no
    ``adopt_slots``."""

    def __init__(self, source):
        self.source = source

    def __iter__(self):
        return iter(self.source)

    def close(self):
        self.source.close()


@pytest.mark.parametrize("adopt", ["on", "wrapped"])
def test_staging_pipeline_adopts_received_slots(corpus, adopt):
    """recv → one hand-over: every received slot is adopted (no copy,
    ``dsserve.slot_copies`` flat); through a wrapper that declares no
    ``adopt_slots``, none is and none counts as a copy. The staged
    arrays equal the local producer's either way."""
    rec, idx = corpus
    want = []
    local = fused.ell_batches(uri_of(rec, idx), spec_of())
    for b in local:
        want.append({k: v.copy() for k, v in b.as_dict().items()})
    local.close()
    a0, c0 = pl._SLOTS_ADOPTED.value(), pl._SLOT_COPIES.value()
    srv = DsServeServer().start()
    try:
        src = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec_of(),
                             mode="static")
        got, stats = pipeline_drain(src if adopt == "on" else PassThrough(src))
    finally:
        srv.close()
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    n = len(want)
    assert stats["packed_batches"] == n and stats["per_array_batches"] == 0
    assert stats["slots_adopted"] == (n if adopt == "on" else 0)
    assert pl._SLOTS_ADOPTED.value() - a0 == stats["slots_adopted"]
    assert pl._SLOT_COPIES.value() == c0


def test_a_fresh_pool_lands_the_first_slot_in_a_bank(corpus, monkeypatch):
    """The pooled bank is chosen once the header names the size, so even
    the first slot of a fresh pool is received into a page-aligned bank
    (no fresh allocation) and adopted."""
    rec, idx = corpus
    monkeypatch.setattr(port_client, "_POOL", port_client._SlotPool())
    alloc0 = wire.recv_alloc_bytes()
    srv = DsServeServer().start()
    try:
        src = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec_of(),
                             mode="static")
        got, stats = pipeline_drain(src)
    finally:
        srv.close()
    assert stats["slots_adopted"] == len(got) == N_ROWS // BATCH + 1
    assert wire.recv_alloc_bytes() == alloc0


class NeverEvent:
    """A copy's event that has not completed until ``done`` is set."""

    def __init__(self):
        self.done = False

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_inflight_copy_keeps_the_bank_out_of_the_pool():
    """An adopted bank whose copy has not completed stays referenced by
    the pipeline's in-flight list, so its finalizer cannot recycle it;
    once the event completes and the list is pruned, the bank returns."""
    pool = port_client._SlotPool()
    pool.ensure(4096)
    inflight = pl._InFlight(cap=4)
    ev = NeverEvent()
    a = pool.get()
    a[:] = 3
    inflight.add(ev, a[:128])  # the copy's source: a view of the bank
    del a
    gc.collect()
    b = pool.get()  # the adopted bank is not handed out again
    b[:] = 5
    assert pool.banks == 2
    inflight.prune()
    assert len(inflight) == 1
    ev.done = True
    inflight.prune()
    assert len(inflight) == 0
    gc.collect()
    c = pool.get()  # now recycled
    assert pool.banks == 2 and (c[:128] == 3).all()
    assert not inflight.full()
    for _ in range(4):
        inflight.add(NeverEvent(), c)
    assert inflight.full()
    inflight.wait_oldest()  # makes room by waiting for the oldest copy
    assert len(inflight) == 3
    inflight.drain()
    assert len(inflight) == 0


class StubPinning:
    """Records the page-locking the client asks for (a CUDA pipeline's
    ``_CudaPinning`` does it for real)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.banks = 0
        self.registered = {}
        self.log = []

    def bank(self, nbytes):
        with self.lock:
            self.banks += 1
        return np.zeros(nbytes, dtype=np.uint8)

    def register(self, addr, nbytes):
        with self.lock:
            assert addr not in self.registered, "a segment registered twice"
            self.registered[addr] = nbytes
            self.log.append(("register", addr))

    def unregister(self, addr):
        with self.lock:
            del self.registered[addr]
            self.log.append(("unregister", addr))


@pytest.mark.parametrize("transport", ["tcp", "shm"])
def test_host_pinning_covers_banks_and_segments(corpus, monkeypatch, transport):
    """With a pinning installed, pool banks come from it, every mapped
    shm segment is registered once when first mapped, and unregistered
    only after the last view over it died (here: once every batch the
    consumer held is gone), before the mapping is closed."""
    rec, idx = corpus
    monkeypatch.setenv("DMLC_DSSERVE_SHM", "on" if transport == "shm" else "off")
    monkeypatch.setenv("DMLC_DSSERVE_SHM_SLOTS", "64")
    monkeypatch.setattr(port_client, "_POOL", port_client._SlotPool())
    monkeypatch.setattr(port_client, "_LINGER", [])
    pin = StubPinning()
    try:
        srv = DsServeServer().start()
        try:
            c = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}",
                               spec_of(), mode="static")
            with host_pinning(pin):
                held = list(c)  # every slot's view alive at the end of the stream
            stats = c.io_stats()
            if transport == "shm":
                assert stats["shm_slots"] >= 1
                with pin.lock:
                    assert len(pin.registered) >= 1
                    assert not any(op == "unregister" for op, _ in pin.log)
            else:
                assert stats["tcp_slots"] == len(held) and pin.banks >= 1
            del held
            gc.collect()
            c.close()  # retries the mappings the stream left behind
        finally:
            srv.close()
    finally:
        port_client.set_host_pinning(None)
    assert pin.registered == {}
    assert port_client._LINGER == []
    regs = [a for op, a in pin.log if op == "register"]
    assert len(regs) == len(set(regs))


def test_shm_map_live_count_under_threads():
    """The mapping's live-view count is shared by the receive thread and
    whichever threads drop the last views: 16 threads making and dropping
    views under a short switch interval leave it at 0, and the mapping
    then closes."""
    import sys
    import time

    from dmlc_core_tpu_torch.io.shm import ShmSegment

    name = f"dmlc-test-{os.getpid()}-{time.monotonic_ns()}"
    owner = ShmSegment(name, create=True, size=4096)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        m = port_client._ShmMap(name)
        lock = threading.Lock()

        def churn():
            for _ in range(200):
                v = m.view(64, None, lock)  # acks to no socket are dropped
                v[:8].sum()
                del v

        threads = [threading.Thread(target=churn) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        gc.collect()
        assert m.live == 0
        assert m.try_close()
    finally:
        sys.setswitchinterval(old)
        owner.close()
        owner.unlink()


class FailingPinning(StubPinning):
    def register(self, addr, nbytes):
        raise Error("cudaHostRegister failed: stub")


def test_a_failed_segment_pinning_fails_the_stream(corpus, monkeypatch):
    """A failed page-locking is not a transport fault: the stream does not
    degrade to TCP (the adopting pipeline has no pageable fallback), the
    endpoint fails and the drain raises."""
    rec, idx = corpus
    monkeypatch.setenv("DMLC_DSSERVE_SHM", "on")
    monkeypatch.setattr(port_client, "_POOL", port_client._SlotPool())
    try:
        srv = DsServeServer().start()
        try:
            c = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}",
                               spec_of(), mode="static")
            with pytest.raises(Error, match="dsserve") as exc, host_pinning(FailingPinning()):
                for _ in c:
                    pass
            stats = c.io_stats()
            c.close()
        finally:
            srv.close()
    finally:
        port_client.set_host_pinning(None)
    assert isinstance(exc.value.__cause__, port_client.HostPinningFailed)
    assert stats["endpoints_dead"] == 1 and stats["reconnects"] == 0


# -- across the packages ----------------------------------------------------------


@pytest.mark.parametrize("transport", ["tcp", "tcp_zlib", "shm"])
@pytest.mark.parametrize("direction", ["jax_server", "port_server"])
def test_cross_package_streams_equal_the_local_producer(corpus, monkeypatch, transport,
                                                        direction):
    """A JAX server streams to a port client, and a port server to a JAX
    client, with slots bit for bit the local producers'."""
    rec, idx = corpus
    monkeypatch.setenv("DMLC_DSSERVE_SHM", "on" if transport == "shm" else "off")
    if transport == "tcp_zlib":
        monkeypatch.setenv("DMLC_DSSERVE_WIRE_CODEC", "zlib")
        monkeypatch.setenv("DMLC_DSSERVE_WIRE_BPS", "1000000")
    want = local_drain(uri_of(rec, idx), spec_of())
    jsrc = jax_ell_batches(uri_of(rec, idx), JaxSpec(batch_size=BATCH, layout="ell",
                                                     max_nnz=K))
    assert drain_packed(jsrc) == want
    jsrc.close()
    if direction == "jax_server":
        got, stats, _ = static_drain(JaxServer, DsServeBatches, rec, idx, spec_of())
    else:
        got, stats, _ = static_drain(DsServeServer, JaxBatches, rec, idx,
                                     JaxSpec(batch_size=BATCH, layout="ell", max_nnz=K))
    assert got == want
    if transport == "shm":
        assert stats["shm_slots"] >= 1
    else:
        assert stats["shm_slots"] == 0


PREFIXES = ("dsserve.", "staging.")


def registry_delta(reg, before):
    snap = reg.snapshot()
    counters = {k: v - before["counters"].get(k, 0) for k, v in snap["counters"].items()
                if k.startswith(PREFIXES) and v - before["counters"].get(k, 0)}
    hists = {k: h["count"] - before["histograms"].get(k, {}).get("count", 0)
             for k, h in snap["histograms"].items()
             if k.startswith(PREFIXES)
             and h["count"] - before["histograms"].get(k, {}).get("count", 0)}
    return counters, hists


def test_dsserve_drain_registry_deltas_equal_jax(corpus, monkeypatch):
    """One static drain of the same file through each package's server,
    client and CPU staging pipeline moves the dsserve.* and staging.*
    series by the same amounts (counters exactly, histograms by sample
    count). Both pools are sized beforehand, so each package receives
    every slot into a pooled bank and adopts it."""
    import jax

    from dmlc_core_tpu.staging import StagingPipeline as JaxPipeline
    from dmlc_core_tpu.staging import drain_close as jax_drain_close
    from dmlc_core_tpu.telemetry import default_registry as jax_registry

    rec, idx = corpus
    monkeypatch.setenv("DMLC_DSSERVE_SHM", "off")
    monkeypatch.setenv("DMLC_DSSERVE_WIRE_CODEC", "off")
    slot = next(iter(local_packed := fused.ell_batches(uri_of(rec, idx), spec_of())))
    port_client._POOL.ensure(slot.packed.nbytes)
    jax_client._POOL.ensure(slot.packed.nbytes)
    del slot
    local_packed.close()
    uri = uri_of(rec, idx)

    reg = default_registry()
    before = reg.snapshot()
    srv = DsServeServer().start()
    try:
        src = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri}", spec_of(), mode="static")
        got, _ = pipeline_drain(src)
    finally:
        srv.close()
    port = registry_delta(reg, before)

    jreg = jax_registry()
    jbefore = jreg.snapshot()
    jsrv = JaxServer().start()
    try:
        jsrc = JaxBatches(f"dsserve://127.0.0.1:{jsrv.port}{uri}",
                          JaxSpec(batch_size=BATCH, layout="ell", max_nnz=K), mode="static")
        jpipe = JaxPipeline(jsrc, device=jax.devices("cpu")[0])
        jn = sum(1 for _ in jpipe)
        jax_drain_close(jpipe, jsrc)
    finally:
        jsrv.close()
    jax_side = registry_delta(jreg, jbefore)
    assert len(got) == jn == N_ROWS // BATCH + 1
    assert port[0]["dsserve.slots_served"] == jn
    assert port[0]["staging.adopted_slots"] == jn
    assert port == jax_side


def test_fm_trained_from_dsserve_slots_matches_jax(corpus):
    """FM SGD on the CPU over the batches a port server streams equals the
    JAX FM over the JAX local producer's batches, within the tolerance of
    ``test_torch_models.py`` (1e-4 of max |param|)."""
    import jax

    from dmlc_core_tpu.models import FactorizationMachine as JaxFM
    from dmlc_core_tpu_torch.convert import params_from_jax, params_to_numpy
    from dmlc_core_tpu_torch.models import FactorizationMachine

    rec, idx = corpus
    d, e, lr = 512, 4, 0.5
    rng = np.random.default_rng(11)
    params = {"w": rng.normal(size=d).astype(np.float32) * 0.1,
              "v": rng.normal(size=(d, e)).astype(np.float32) * 0.1,
              "b": np.float32(0.0)}
    jmodel = JaxFM(d, embed_dim=e)
    jparams = {k: jax.numpy.asarray(v) for k, v in params.items()}
    jsrc = jax_ell_batches(uri_of(rec, idx), JaxSpec(batch_size=BATCH, layout="ell",
                                                     max_nnz=K))
    jsteps = 0
    for b in jsrc:
        jparams, _loss = jmodel.sgd_step(jparams, {k: v.copy() for k, v in b.as_dict().items()},
                                         lr=lr)
        jsteps += 1
    jsrc.close()

    model = FactorizationMachine(d, e, device="cpu")
    model.load_state_dict(params_from_jax(params, "cpu"))
    srv = DsServeServer().start()
    try:
        src = DsServeBatches(f"dsserve://127.0.0.1:{srv.port}{uri_of(rec, idx)}", spec_of(),
                             mode="static")
        pipe = pl.StagingPipeline(src, device="cpu")
        steps = 0
        for batch in pipe:
            model.sgd_step(batch, lr=lr)
            steps += 1
        assert pl.drain_close(pipe, src)
    finally:
        srv.close()
    assert steps == jsteps == N_ROWS // BATCH + 1
    got = params_to_numpy(model.state_dict())
    for k, want in jparams.items():
        want = np.asarray(want, np.float32)
        err = float(np.abs(np.asarray(got[k], np.float32) - want).max())
        assert err <= 1e-4 * max(float(np.abs(want).max()), 1e-30), (k, err)
    assert torch.isfinite(model.w).all()
