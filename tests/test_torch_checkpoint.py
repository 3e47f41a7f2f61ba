"""The port's single-process checkpoints against the JAX package's, on the
CPU: ``save_pytree`` writes the same bytes for the same numpy tree (bit
for bit, no tolerance), each package restores the other's checkpoints
and metadata, retention, torn-save pruning and the sidecar order leave
the same files, and ``save_async`` keeps the values of tensors that the
caller updates in place right after the call."""

import os
import threading

import numpy as np
import pytest
import torch

from dmlc_core_tpu import checkpoint as jax_ckpt
from dmlc_core_tpu.io.stream import MemoryStream as JaxMemoryStream
from dmlc_core_tpu_torch import checkpoint
from dmlc_core_tpu_torch.checkpoint import Checkpointer
from dmlc_core_tpu_torch.io.stream import MemoryStream
from dmlc_core_tpu_torch.utils.logging import Error


def tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=17).astype(np.float32),
            "v": rng.normal(size=(9, 4)).astype(np.float32),
            "b": np.asarray(np.float32(0.5)),
            "meta": {"step": 3, "tags": ["a", (1, 2.5)], "none": None}}


def same(a, b):
    assert repr(a) == repr(b)


def jax_checkpointer(path, keep=3):
    return jax_ckpt.Checkpointer(str(path), keep=keep, process_index=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_save_pytree_bytes_match_jax(seed):
    t = tree(seed)
    port, jax = MemoryStream(), JaxMemoryStream()
    checkpoint.save_pytree(port, t)
    jax_ckpt.save_pytree(jax, t)
    assert port.getvalue() == jax.getvalue()
    # tensors save as the numpy arrays they hold
    as_tensors = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                  for k, v in t.items()}
    again = MemoryStream()
    checkpoint.save_pytree(again, as_tensors)
    assert again.getvalue() == jax.getvalue()
    port.seek(0)
    same(checkpoint.load_pytree(port), jax_ckpt.load_pytree(JaxMemoryStream(jax.getvalue())))


def test_bad_magic_raises():
    with pytest.raises(Error, match="bad checkpoint magic"):
        checkpoint.load_pytree(MemoryStream(b"NOTACKPT" + b"\0" * 8))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    w = jax_checkpointer(tmp_path) if writer == "jax" else Checkpointer(str(tmp_path))
    r = Checkpointer(str(tmp_path)) if writer == "jax" else jax_checkpointer(tmp_path)
    w.save(4, tree(1), meta={"epoch": 2, "records": {"0": 4096}})
    w.save(7, tree(2))
    assert r.steps() == w.steps() == [4, 7]
    step, got = r.restore()
    assert step == 7
    same(got, tree(2))
    same(r.restore(4)[1], tree(1))
    assert r.restore_meta(4) == {"epoch": 2, "records": {"0": 4096}}
    assert r.restore_meta() is None
    assert r.steps_info() == w.steps_info()


def run_both(tmp_path, actions):
    """Run ``actions(checkpointer)`` on a port and a JAX checkpointer in
    two directories; returns their file listings."""
    out = []
    for name, make in (("port", lambda p: Checkpointer(str(p), keep=2)),
                       ("jax", lambda p: jax_checkpointer(p, keep=2))):
        d = tmp_path / name
        d.mkdir()
        actions(make(d), d)
        out.append(sorted(os.listdir(d)))
    return out


def test_retention_and_prune_match_jax(tmp_path):
    def actions(ck, d):
        for step in (1, 2, 3, 5):
            ck.save(step, tree(step), meta={"epoch": step} if step % 2 else None)
        assert ck.latest_step() == 5
        ck.keep = 3
        ck.save(6, tree(6))
        assert ck.prune(keep=1) == [3, 5]

    port, jax = run_both(tmp_path, actions)
    assert port == jax == ["ckpt-0000000006.bin"]


def test_torn_debris_is_pruned_like_jax(tmp_path):
    def actions(ck, d):
        ck.save(5, tree())
        for name in ("ckpt-0000000003.bin.tmp", "ckpt-0000000009.bin.tmp"):
            (d / name).write_bytes(b"torn")
        for name in ("ckpt-0000000002.d", "ckpt-0000000008.d"):
            (d / name).mkdir()
            (d / name / "shard-00000.bin").write_bytes(b"x")
        ck.save(6, tree())

    port, jax = run_both(tmp_path, actions)
    # debris older than the newest complete step goes; newer may be a
    # save in flight and stays
    assert port == jax == ["ckpt-0000000005.bin", "ckpt-0000000006.bin",
                           "ckpt-0000000008.d", "ckpt-0000000009.bin.tmp"]


@pytest.mark.parametrize("crash", ["tree", "sidecar"])
def test_sidecar_order_matches_jax(tmp_path, monkeypatch, crash):
    """Old sidecar removed, tree landed, new sidecar written: a crash at
    either write leaves no sidecar beside the visible tree, so
    ``restore_meta`` answers None (position unknown), in both packages."""
    results = []
    for mod, make in ((checkpoint, lambda p: Checkpointer(str(p))),
                      (jax_ckpt, jax_checkpointer)):
        d = tmp_path / mod.__name__
        ck = make(d)
        ck.save(4, tree(1), meta={"epoch": 1})
        real = mod._write_atomic

        def failing(path, t, real=real):
            if path.endswith(".meta.bin") == (crash == "sidecar"):
                raise OSError("disk gone")
            real(path, t)

        monkeypatch.setattr(mod, "_write_atomic", failing)
        with pytest.raises(OSError):
            ck.save(4, tree(2), meta={"epoch": 2})
        monkeypatch.setattr(mod, "_write_atomic", real)
        step, got = ck.restore()
        results.append((step, repr(got), ck.restore_meta(4), sorted(os.listdir(d))))
    assert results[0] == results[1]
    assert results[0][2] is None


def test_save_async_keeps_the_values_at_the_call(tmp_path, monkeypatch):
    ck = Checkpointer(str(tmp_path), keep=2)
    params = {"w": torch.arange(6, dtype=torch.float32), "b": torch.zeros(())}
    want = {k: v.numpy().copy() for k, v in params.items()}
    release = threading.Event()
    real = checkpoint._write_atomic

    def slow(path, t):
        release.wait(10)  # the write starts after the caller's update
        real(path, t)

    monkeypatch.setattr(checkpoint, "_write_atomic", slow)
    handle = ck.save_async(3, params, meta={"epoch": 0, "records": 6})
    with torch.no_grad():
        for p in params.values():
            p.add_(100.0)  # an in-place step right after the call
    release.set()
    assert handle.result(timeout=30).endswith("ckpt-0000000003.bin")
    step, got = Checkpointer(str(tmp_path)).restore()
    assert step == 3
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    for t in threading.enumerate():
        if t.name.startswith("ckpt-async"):
            t.join(5)  # the writer ends right after it reports
            assert not t.is_alive()


def test_save_async_failure_surfaces_on_wait(tmp_path):
    (tmp_path / "file").write_bytes(b"")
    ck = Checkpointer(str(tmp_path / "file" / "ck"))
    ck.save_async(1, tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()  # the failed handle is gone


def test_sharded_layout_raises_and_is_replaced_like_jax(tmp_path):
    d = tmp_path / "ckpt-0000000004.d"
    d.mkdir()
    (d / "MANIFEST.bin").write_bytes(b"")
    ck = Checkpointer(str(tmp_path))
    assert ck.steps() == [4]
    # a manifest that is not a checkpoint: restoring it raises the text
    # the JAX package raises for the same .d
    with pytest.raises(Error, match="Stream: expected 8 bytes, got 0"):
        ck.restore()
    with pytest.raises(Error, match="Stream: expected 8 bytes, got 0"):
        ck.restore_meta(4)
    ck.save(4, tree())  # a same-step save replaces the sharded one
    assert sorted(os.listdir(tmp_path)) == ["ckpt-0000000004.bin"]
    same(ck.restore()[1], tree())


def test_remote_and_empty_bases(tmp_path):
    """A base on another filesystem, refused until ROADMAP.md §1 item 8b
    was ported, holds checkpoints (the bases over a fake server are in
    ``test_checkpointer_on_a_remote_base``); an unknown scheme raises,
    and an empty base has no step."""
    for base in ("mem://b/ckpts", f"fault://seed=1{tmp_path}"):
        ck = Checkpointer(base, keep=1)
        ck.save(2, tree(), meta={"epoch": 0})
        assert ck.steps() == [2] and ck.restore_meta() == {"epoch": 0}
        same(ck.restore()[1], tree())
    with pytest.raises(Error, match="unknown filesystem protocol"):
        Checkpointer("nope://bucket/ckpts")
    ck = Checkpointer(str(tmp_path / "none"))
    assert ck.steps() == [] and ck.latest_step() is None
    with pytest.raises(Error, match="no checkpoints"):
        ck.restore()


@pytest.fixture
def remote_base(request, monkeypatch):
    """(base URI, {object name: bytes}) of a checkpoint base on
    ``request.param``: s3://, fault://inner=s3, hdfs:// (fake servers of
    tests/test_cloudfs.py on the loopback) or mem://."""
    from test_cloudfs import FakeS3Handler, FakeWebHdfsHandler
    from test_torch_cloudfs import Served, reset_both, start_s3

    kind = request.param
    if kind == "mem":
        from dmlc_core_tpu_torch.io.filesystem import MemoryFileSystem

        store = MemoryFileSystem._store
        for k in [k for k in store if k.startswith("mem://ckb/")]:
            del store[k]
        yield "mem://ckb/run", lambda: {k[len("mem://ckb/run/"):]: v for k, v in store.items()
                                         if k.startswith("mem://ckb/run/")}
        return
    if kind == "hdfs":
        FakeWebHdfsHandler.FILES = {}
        srv = Served(FakeWebHdfsHandler)
        monkeypatch.setenv("DMLC_WEBHDFS_PORT", str(srv.port))
        reset_both()
        files = lambda: {k[len("/ck/run/"):]: v for k, v in  # noqa: E731
                         FakeWebHdfsHandler.FILES.items() if k.startswith("/ck/run/")}
        base = "hdfs://127.0.0.1:8020/ck/run"
    else:
        srv = start_s3(monkeypatch)
        files = lambda: {k[len("bkt/run/"):]: v for k, v in  # noqa: E731
                         FakeS3Handler.STORE.items() if k.startswith("bkt/run/")}
        base = ("s3://bkt/run" if kind == "s3" else
                "fault://inner=s3,resets=1,short=1,seed=3/bkt/run")
    monkeypatch.setenv("DMLC_RETRY_BASE_SECS", "0.001")
    monkeypatch.setenv("DMLC_RETRY_CAP_SECS", "0.01")
    try:
        yield base, files
    finally:
        reset_both()
        srv.stop()


@pytest.mark.parametrize("remote_base", ["s3", "hdfs", "mem", "fault_s3"], indirect=True)
def test_checkpointer_on_a_remote_base(remote_base):
    """The port's Checkpointer on s3://, hdfs://, mem:// and
    fault://inner=s3: each save lands through the verify-then-rename
    write (no ``.tmp`` left), steps are found by listing the base,
    retention and a same-step re-save go through ``FileSystem.delete``,
    the sidecar follows its step, older debris is removed and newer
    debris kept, and a fresh Checkpointer restores the newest step."""
    base, files = remote_base
    from dmlc_core_tpu_torch.io.filesystem import FileSystem

    ck = Checkpointer(base, keep=2)
    for step in (1, 2, 3):
        ck.save(step, tree(step), meta={"epoch": step})
    assert ck.steps() == [2, 3] and ck.latest_step() == 3
    assert sorted(files()) == ["ckpt-0000000002.bin", "ckpt-0000000002.meta.bin",
                               "ckpt-0000000003.bin", "ckpt-0000000003.meta.bin"]
    fs = FileSystem.get_instance(base)
    for name in ("ckpt-0000000001.bin.tmp", "ckpt-0000000009.bin.tmp"):
        with fs.open(f"{base}/{name}", "w") as w:
            w.write(b"torn")
    ck.save(3, tree(7))  # a same-step re-save without meta drops the sidecar
    assert sorted(files()) == ["ckpt-0000000002.bin", "ckpt-0000000002.meta.bin",
                               "ckpt-0000000003.bin", "ckpt-0000000009.bin.tmp"]
    fresh = Checkpointer(base)
    step, got = fresh.restore()
    assert step == 3 and fresh.restore_meta() is None and fresh.restore_meta(2) == {"epoch": 2}
    same(got, tree(7))
    assert [i["bytes"] for i in fresh.steps_info()] == [
        len(files()["ckpt-0000000002.bin"]), len(files()["ckpt-0000000003.bin"])]
    assert fresh.prune(keep=1) == [2]
    assert fresh.steps() == [3]
