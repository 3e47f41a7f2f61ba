"""Ring slots copied to the card in place: which producers a pipeline
copies directly and which it packs (``pack_reason``, the per-batch
pinned and page-aligned check), the ring bound's message, and where a
producer's ring comes from (``batcher.host_pinning``): allocated at its
first iteration, on the thread that drains it, page-locked only under a
pipeline that copies in place. The copies themselves run on the card
(``tests/test_torch_kernels_gpu.py``)."""

import threading

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.data.rowrec import write_rowrec
from dmlc_core_tpu_torch.staging import pipeline as pl
from dmlc_core_tpu_torch.staging.batcher import (
    Batch,
    BatchSpec,
    alloc_dense_slot,
    host_pinning,
)
from dmlc_core_tpu_torch.staging.fused import dense_batches, ell_batches, plain_batches
from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close, pack_reason
from perfbench.loop import RowLog

CUDA = torch.device("cuda", 0)
CPU = torch.device("cpu")
D, B = 6, 16
DSPEC = BatchSpec(batch_size=B, layout="dense", num_features=D)
ESPEC = BatchSpec(batch_size=B, max_nnz=4)


def write_csv(tmp_path, n=100, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-99, 99, (n, D + 1)) / 8
    path = tmp_path / "t.csv"
    path.write_text("".join(",".join(f"{v:g}" for v in r) + "\n" for r in rows))
    return f"{path}?format=csv&label_column=0"


def write_svm(tmp_path, n=60, seed=1):
    rng = np.random.default_rng(seed)
    path = tmp_path / "t.svm"
    path.write_text("".join(
        f"{rng.integers(0, 2)} " + " ".join(f"{j}:{rng.integers(1, 9)}" for j in
                                             sorted(rng.choice(D, 3, replace=False)))
        + "\n" for _ in range(n)))
    return str(path)


def write_rec(tmp_path, n=60, seed=2):
    rng = np.random.default_rng(seed)
    blk = RowBlock(offset=np.arange(n + 1) * 3, label=rng.random(n).astype(np.float32),
                   index=rng.integers(0, 50, 3 * n).astype(np.uint32),
                   value=rng.random(3 * n).astype(np.float32))
    path = tmp_path / "t.rec"
    with open(path, "wb") as f:
        write_rowrec(f, [blk])
    return str(path)


class _Source:
    def __init__(self, ring_slots=None, adopt_slots=False):
        if ring_slots is not None:
            self.ring_slots = ring_slots
        if adopt_slots:
            self.adopt_slots = True

    def __iter__(self):
        return iter(())


@pytest.mark.parametrize("case,args,why", [
    ("least_ring", (_Source(8), CUDA, False, 2, 2), None),
    ("one_slot_short", (_Source(7), CUDA, False, 2, 2),
     "producer ring has 7 slots but an in-place copy needs 8 (1 being filled + "
     "prefetch=2 + 1 staging + depth+2=4 copies in flight)"),
    ("deeper", (_Source(10), CUDA, False, 3, 4),
     "producer ring has 10 slots but an in-place copy needs 11 (1 being filled + "
     "prefetch=3 + 1 staging + depth+2=6 copies in flight)"),
    ("mesh_shards", (_Source(10), CUDA, True, 2, 2),
     "mesh shard staging packs this rank's rows"),
    ("cpu", (_Source(10), CPU, False, 2, 2), "a CPU pipeline copies every batch"),
    ("no_ring", (_Source(), CUDA, False, 2, 2), "the producer declares no ring"),
    ("dsserve", (_Source(None, adopt_slots=True), CUDA, False, 2, 2), None),
    # shared on the CPU: the tensor holds the adopted buffer
    ("dsserve_cpu", (_Source(None, adopt_slots=True), CPU, False, 2, 2), None),
])
def test_ring_in_place_says_which_sources_pack(case, args, why):
    assert pack_reason(*args) == why


def test_the_default_producers_and_their_paths(tmp_path):
    """At the defaults (ring 10, prefetch 2, depth 2) every native
    producer and the plain rowrec one go in place; an ``nthread`` fan-out
    promises 3 slots less and packs."""
    csv, svm, rec = write_csv(tmp_path), write_svm(tmp_path), write_rec(tmp_path)
    in_place = [dense_batches(csv, DSPEC), dense_batches(svm, DSPEC),
                ell_batches(rec, ESPEC), ell_batches(f"{svm}?format=libsvm", ESPEC),
                plain_batches(rec, ESPEC)]
    fanned = [dense_batches(csv, DSPEC, nthread=2), ell_batches(rec, ESPEC, nthread=2)]
    for src in in_place:
        assert pack_reason(RowLog(src), CUDA, False, 2, 2) is None
    for src in fanned:
        assert "ring has 7 slots but an in-place copy needs 8" in pack_reason(
            src, CUDA, False, 2, 2)
    for src in in_place + fanned:
        src.close()


def _batch(buf):
    views = {"x": buf[:B * D * 4].view(np.float32).reshape(B, D),
             "labels": buf[B * D * 4:B * D * 4 + 4 * B].view(np.float32),
             "weights": buf[B * D * 4 + 4 * B:B * D * 4 + 8 * B].view(np.float32)}
    return Batch(n_valid=B, packed=buf, **views)


def _page_aligned(nbytes, offset=0):
    raw = np.zeros(nbytes + 2 * pl._PAGE, dtype=np.uint8)
    start = -raw.ctypes.data % pl._PAGE + offset
    return raw[start:start + nbytes]


@pytest.mark.parametrize("offset,pinned,adopts", [
    (0, True, True),  # a pinned page-aligned ring slot: in place
    (64, True, False),  # unaligned: packed
    (0, False, False),  # pageable: packed
])
def test_each_batch_goes_in_place_only_pinned_and_page_aligned(monkeypatch, offset,
                                                               pinned, adopts):
    nbytes = alloc_dense_slot(DSPEC)[0].nbytes
    batch = _batch(_page_aligned(nbytes, offset))
    pipe = StagingPipeline(_Source(10), device="cpu")
    try:
        pipe._direct = "ring"  # what a CUDA pipeline of this source decides
        monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: pinned)
        assert pipe._goes_direct(batch) is adopts
        pipe._direct = None
        assert pipe._goes_direct(batch) is False
    finally:
        pipe.close()


class _Host:
    """A stand-in for the pipeline's pinning: zeroed page-aligned ring
    slots, each remembered."""

    def __init__(self):
        self.made = []
        self.threads = set()

    def ring_slot(self, nbytes):
        self.threads.add(threading.get_ident())
        buf = _page_aligned(nbytes)
        self.made.append(buf)
        return buf

    def owns(self, buf):
        return any(buf is b for b in self.made)


def _bytes(src):
    return [b.packed.tobytes() for b in src]


@pytest.mark.parametrize("make", [
    lambda t: dense_batches(write_csv(t), DSPEC),
    lambda t: ell_batches(write_rec(t), ESPEC),
    lambda t: plain_batches(write_rec(t), ESPEC),
], ids=["csv", "rowrec", "plain_rowrec"])
def test_ring_comes_from_the_draining_threads_host_memory(tmp_path, make):
    want = _bytes(make(tmp_path))
    host = _Host()
    src = make(tmp_path)
    assert src._ring is None  # nothing is allocated before the first iteration
    got = []
    t = threading.Thread(target=lambda: got.extend(
        b.packed.tobytes() for b in pl._produced(RowLog(src), host)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert got == want  # zeroed slots: the batches are the numpy ring's bytes
    assert len(host.made) == src.ring_slots
    assert host.threads == {t.ident}
    assert all(host.owns(buf) for buf, _views in src._ring)
    src.close()


def test_a_producer_drained_alone_keeps_a_numpy_ring(tmp_path):
    host = _Host()
    csv = write_csv(tmp_path)
    alone = dense_batches(csv, DSPEC)
    _bytes(alone)
    fanned = dense_batches(csv, DSPEC, nthread=2)
    with host_pinning(host):
        _bytes(fanned)  # its sub-producers drain on threads of their own
    assert host.made == []
    for src in (alone, *fanned._producers):
        assert all(buf.base is None for buf, _views in src._ring)  # np.zeros
    alone.close()
    fanned.close()


def test_a_cpu_pipeline_asks_for_no_pinned_ring(tmp_path):
    csv = write_csv(tmp_path)
    want = _bytes(dense_batches(csv, DSPEC))
    src = dense_batches(csv, DSPEC)
    pipe = StagingPipeline(RowLog(src), device="cpu")
    got = [np.concatenate([dev[k].numpy().view(np.uint8).ravel()
                           for k in ("x", "labels", "weights")]).tobytes() for dev in pipe]
    assert got == want
    assert all(buf.base is None for buf, _views in src._ring)
    assert pipe.staging_stats()["slots_adopted"] == 0
    assert pl.host_pinning_stats()["ring_slots_pinned"] == 0
    assert drain_close(pipe, src)
