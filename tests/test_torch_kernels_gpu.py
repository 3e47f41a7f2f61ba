"""The CUDA kernels K1-K4 against their plain PyTorch versions on the
card, and the native producers' paths through staging onto it (marked
``gpu``: skips where torch.cuda.is_available() is False).

    python -m pytest tests/test_torch_kernels_gpu.py -q

Inputs include duplicates, padding, wrapped negatives and out-of-range
indices, with f32 and f16 values, at the slice's shape and at the edge
shapes the designs branch on (K, E, B, and operands that are not 16-byte
aligned), and the gradient scatters' own edge inputs: every row naming
the same rows, every entry naming its own row (a tile of distinct rows),
E in several column chunks, and dense gradients that are not 16-byte
aligned; the scatters give the same bits on every launch. Tolerances:
forward 1e-6 + 1e-5 of the summed terms' magnitudes (sums in another
order; the pair term ½Σ(s² − q) cancels, so its rounding error scales
with s²); gradients 1e-4 of max |g| (the scatters sum in another order
than the plain index_add_)."""

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.data.rowrec import write_rowrec
from dmlc_core_tpu_torch.models import FactorizationMachine, LogisticRegression
from dmlc_core_tpu_torch.ops import _build, fm as tfm, sparse as tops
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import dense_batches, ell_batches
from dmlc_core_tpu_torch.staging.pipeline import (
    StagingPipeline,
    drain_close,
    host_pinning_stats,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


def inputs(dev, B, K, D, E, vdtype, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-D, D, (B, K)).astype(np.int32)
    idx[0, 1:] = idx[0, 0]
    idx[1, K // 2:] = 0
    val = rng.normal(size=(B, K)).astype(np.float32)
    val[1, K // 2:] = 0
    idx[2, 0] = D + 7
    idx[3, 0] = -D - 7

    def t(a, dt=None):
        return torch.from_numpy(a).to(dev, dt)

    return (t(idx), t(val, vdtype), t(rng.normal(size=D).astype(np.float32)),
            t(rng.normal(size=(D, E)).astype(np.float32)),
            t(rng.normal(size=B).astype(np.float32)))


def shifted(t):
    """A copy of ``t`` that starts one element past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    return out.copy_(t)


def fwd_close(got, want, scale):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    assert bool(((got - want).abs()[fin] <= 1e-6 + 1e-5 * scale[fin]).all())


def grad_close(got, want):
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~torch.isnan(want)
    tol = 1e-4 * float(want[fin].abs().max())
    assert float((got[fin] - want[fin]).abs().max()) <= tol


# (B, K, D, E): a small case, the slice, and the edge shapes the designs
# branch on: K from 1 to past two warps, E from one scalar lane to 16-byte
# lanes and over several of K4's 16-column chunks (33: scalar flush, 64:
# float4 flush), B a multiple of neither K1's 16 rows a block nor K3's 8,
# and B*K a multiple of none of K2's and K4's 256-entry tiles
SHAPES = {"small": (37, 5, 100, 3), "slice": (2048, 39, 1 << 20, 16)}
SHAPES.update({f"K{k}-E{e}": (1037, k, 1000, e) for k in (1, 33, 39, 64) for e in (1, 5, 16)})
SHAPES.update({f"K39-E{e}": (1037, 39, 1000, e) for e in (33, 64)})


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("vdtype", [torch.float32, torch.float16])
def test_kernels_match_plain_versions(cuda, shape, vdtype):
    B, K, D, E = shape
    idx, val, w, v, g = inputs(cuda, B, K, D, E, vdtype)
    before = dict(_build.launches)
    fwd_close(tops.ell_matvec_fwd_kernel(idx, val, w), tops.ell_matvec_fwd_plain(idx, val, w),
              tops.ell_matvec_fwd_plain(idx, val.abs(), w.abs()))
    grad_close(tops.ell_matvec_bwd_kernel(idx, val, g, D),
               tops.ell_matvec_bwd_plain(idx, val, g, D))
    pk, sk = tfm.fm_pair_fwd_kernel(idx, val, v)
    pp, sp = tfm.fm_pair_fwd_plain(idx, val, v)
    scale_s = tfm.fm_pair_fwd_plain(idx, val.abs(), v.abs())[1]
    fwd_close(pk, pp, (scale_s ** 2).sum(-1))
    fwd_close(sk, sp, scale_s)
    grad_close(tfm.fm_pair_bwd_kernel(idx, val, v, sp, g),
               tfm.fm_pair_bwd_plain(idx, val, v, sp, g))
    torch.cuda.synchronize()
    assert all(_build.launches[k] == before[k] + 1 for k in before)


def test_fm_step_on_card_matches_cpu(cuda):
    B, K, D, E = 64, 39, 4096, 8
    idx, val, *_ = inputs(cuda, B, K, D, E, torch.float32, seed=1)
    idx = idx.abs() % D  # in range: a finite loss
    batch = {"indices": idx, "values": val,
             "labels": (torch.arange(B, device=cuda) % 2).float(),
             "weights": torch.ones(B, device=cuda)}
    gpu = FactorizationMachine(D, E, device=cuda)
    cpu = FactorizationMachine(D, E, device="cpu")
    cpu.load_state_dict({k: p.cpu() for k, p in gpu.state_dict().items()})
    loss_g = gpu.sgd_step(batch, lr=0.5)
    loss_c = cpu.sgd_step({k: t.cpu() for k, t in batch.items()}, lr=0.5)
    assert float(loss_g) == pytest.approx(float(loss_c), rel=1e-5)
    for k, p in cpu.state_dict().items():
        grad_close(gpu.state_dict()[k].cpu(), p)


@pytest.mark.parametrize("vdtype", [torch.float32, torch.float16])
def test_forward_kernels_on_unaligned_operands(cuda, vdtype):
    """Contiguous operands that start one element past a 16-byte boundary
    take K1's and K3's scalar loads."""
    B, K, D, E = 203, 39, 1000, 16
    idx, val, w, v, _ = inputs(cuda, B, K, D, E, vdtype, seed=3)
    idx, val, v = shifted(idx), shifted(val), shifted(v)
    assert idx.data_ptr() % 16 and val.data_ptr() % 8 and v.data_ptr() % 16
    fwd_close(tops.ell_matvec_fwd_kernel(idx, val, w), tops.ell_matvec_fwd_plain(idx, val, w),
              tops.ell_matvec_fwd_plain(idx, val.abs(), w.abs()))
    pk, sk = tfm.fm_pair_fwd_kernel(idx, val, v)
    pp, sp = tfm.fm_pair_fwd_plain(idx, val, v)
    scale_s = tfm.fm_pair_fwd_plain(idx, val.abs(), v.abs())[1]
    fwd_close(pk, pp, (scale_s ** 2).sum(-1))
    fwd_close(sk, sp, scale_s)
    torch.cuda.synchronize()


def scatter_inputs(dev, kind, E, vdtype, seed=5):
    """At B=2048, K=39: ``contention``, every row naming the same K rows;
    ``distinct``, every entry naming its own row of D = B*K, so each
    256-entry tile's table holds 256 keys."""
    B, K = 2048, 39
    rng = np.random.default_rng(seed)
    if kind == "contention":
        D = 1000
        idx = np.broadcast_to(rng.integers(-D, D, K), (B, K))
    else:
        D = B * K
        idx = rng.permutation(D).reshape(B, K)

    def t(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    return (t(idx.astype(np.int32)), t(rng.normal(size=(B, K)).astype(np.float32), vdtype),
            t(rng.normal(size=(D, E)).astype(np.float32)), t(rng.normal(size=B).astype(np.float32)))


@pytest.mark.parametrize("E", [16, 33])
@pytest.mark.parametrize("kind", ["contention", "distinct"])
@pytest.mark.parametrize("vdtype", [torch.float32, torch.float16])
def test_gradient_scatters_on_their_edge_inputs(cuda, kind, E, vdtype):
    idx, val, v, g = scatter_inputs(cuda, kind, E, vdtype)
    D = v.shape[0]
    grad_close(tops.ell_matvec_bwd_kernel(idx, val, g, D),
               tops.ell_matvec_bwd_plain(idx, val, g, D))
    _, s = tfm.fm_pair_fwd_plain(idx, val, v)
    grad_close(tfm.fm_pair_bwd_kernel(idx, val, v, s, g),
               tfm.fm_pair_bwd_plain(idx, val, v, s, g))
    torch.cuda.synchronize()


@pytest.mark.parametrize("vdtype", [torch.float32, torch.float16])
def test_gradient_scatters_on_unaligned_gradients(cuda, vdtype):
    """K2 and K4 into zeroed dense gradients that start one element past
    a 16-byte boundary (the wrappers' own are aligned)."""
    B, K, D, E = 203, 39, 1000, 16
    idx, val, _, v, g = inputs(cuda, B, K, D, E, vdtype, seed=4)
    _, s = tfm.fm_pair_fwd_plain(idx, val, v)
    gw = shifted(torch.zeros(D, device=cuda))
    gv = shifted(torch.zeros(D, E, device=cuda))
    assert gw.data_ptr() % 16 and gv.data_ptr() % 16
    tops.ell_matvec_bwd_into(idx, val, g, gw)
    tfm.fm_pair_bwd_into(idx, val, v, s, g, gv)
    grad_close(gw, tops.ell_matvec_bwd_plain(idx, val, g, D))
    grad_close(gv, tfm.fm_pair_bwd_plain(idx, val, v, s, g))
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["contention", "distinct"])
def test_gradient_scatters_give_the_same_bits_on_every_launch(cuda, kind):
    """K2 and K4 fix their order of summation by their inputs alone:
    launched 10 times on the same inputs, every gradient is bit-identical
    (compared as int32) to the first."""
    idx, val, v, g = scatter_inputs(cuda, kind, 16, torch.float32)
    D = v.shape[0]
    _, s = tfm.fm_pair_fwd_plain(idx, val, v)
    for kernel in (lambda: tops.ell_matvec_bwd_kernel(idx, val, g, D),
                   lambda: tfm.fm_pair_bwd_kernel(idx, val, v, s, g)):
        first = kernel().view(torch.int32)
        assert all(torch.equal(kernel().view(torch.int32), first) for _ in range(9))


def test_gradient_scatters_from_two_threads_on_one_stream(cuda):
    """Two host threads scattering on one stream with the same inputs,
    K2 and K4 in turn: each call keeps its tile and flush launches
    together, so every gradient equals the one-thread result bit for bit
    (the calls share the stream's scratch)."""
    import threading

    idx, val, v, g = scatter_inputs(cuda, "contention", 16, torch.float32)
    D = v.shape[0]
    _, s = tfm.fm_pair_fwd_plain(idx, val, v)
    want = (tops.ell_matvec_bwd_kernel(idx, val, g, D).view(torch.int32),
            tfm.fm_pair_bwd_kernel(idx, val, v, s, g).view(torch.int32))
    got = {0: [], 1: []}

    def scatter(t):
        for _ in range(50):
            got[t].append((tops.ell_matvec_bwd_kernel(idx, val, g, D),
                           tfm.fm_pair_bwd_kernel(idx, val, v, s, g)))

    threads = [threading.Thread(target=scatter, args=(t,)) for t in got]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for calls in got.values():
        for gw, gv in calls:
            assert torch.equal(gw.view(torch.int32), want[0])
            assert torch.equal(gv.view(torch.int32), want[1])


def _criteo_libsvm(path, n, d, seed=5):
    rng = np.random.default_rng(seed)
    dense = rng.uniform(0, 1, (n, 13))
    cats = rng.integers(13, d, (n, 26))
    labels = rng.integers(0, 2, n)
    path.write_text("".join(
        f"{labels[i]} " + " ".join(f"{j}:{dense[i, j]:.6f}" for j in range(13)) + " "
        + " ".join(str(c) for c in cats[i]) + "\n" for i in range(n)))
    return f"{path}?format=libsvm"


@pytest.mark.parametrize("nthread", [None, 3])
@pytest.mark.parametrize("fmt", ["rowrec", "libsvm"])
def test_native_producers_stage_their_host_bytes(cuda, tmp_path, fmt, nthread):
    """Native ELL producers → StagingPipeline on the card: the staged
    batches equal the host batches' bytes (as a multiset: sub-shards'
    batches interleave in the order their threads deliver them)."""
    n, d = 1000, 4096
    if fmt == "rowrec":
        rng = np.random.default_rng(6)
        uri = str(tmp_path / "c.rec")
        with open(uri, "wb") as f:
            write_rowrec(f, [RowBlock(offset=np.arange(n + 1) * 39,
                                      label=rng.integers(0, 2, n).astype(np.float32),
                                      index=rng.integers(0, d, n * 39).astype(np.uint32),
                                      value=rng.normal(size=n * 39).astype(np.float32))])
    else:
        uri = _criteo_libsvm(tmp_path / "c.svm", n, d)
    spec = BatchSpec(batch_size=128, max_nnz=39, value_dtype=np.float16)
    keys = ("indices", "values", "nnz", "labels", "weights")
    host = sorted(b"".join(b.as_dict()[k].tobytes() for k in keys)
                  for b in ell_batches(uri, spec, nthread=nthread))
    src = ell_batches(uri, spec, nthread=nthread)
    pipe = StagingPipeline(src, device=cuda)
    staged = [b"".join(batch[k].cpu().numpy().tobytes() for k in keys) for batch in pipe]
    assert drain_close(pipe, src)
    assert sorted(staged) == host


@pytest.mark.parametrize("ring,in_place", [(8, True), (7, False)])
def test_ring_slots_stage_in_place_under_a_stalled_copy_stream(cuda, tmp_path, ring,
                                                               in_place):
    """At the least ring an in-place copy admits (1 being filled +
    prefetch 2 + 1 staging + depth 2 + 2 copies in flight = 8 slots),
    with the pipeline's copy stream stalled behind a sleep at every batch
    the loop takes, every staged batch equals the producer's bytes over
    five ring wraps: the transfer thread waits for the oldest copy before
    the producer can come round to its slot. A ring one slot shorter is
    refused for the in-place path and packs."""
    rng = np.random.default_rng(8)
    n, d = 40 * 256 + 77, 28
    rows = rng.integers(-2**15, 2**15, (n, d + 1)) / 2**10
    path = tmp_path / "w.csv"
    path.write_text("".join(",".join(f"{v:g}" for v in r) + "\n" for r in rows))
    uri = f"{path}?format=csv&label_column=0"
    spec = BatchSpec(batch_size=256, layout="dense", num_features=d)
    want = [{k: v.copy() for k, v in b.as_dict().items()}
            for b in dense_batches(uri, spec, ring=ring)]
    pinned0 = host_pinning_stats()["ring_slots_pinned"]
    src = dense_batches(uri, spec, ring=ring)
    pipe = StagingPipeline(src, device=cuda)
    got = []
    for batch in pipe:
        with torch.cuda.stream(pipe._copier.stream):
            torch.cuda._sleep(20_000_000)  # ~10 ms: later copies queue behind it
        got.append(batch)
    torch.cuda.synchronize()
    stats = pipe.staging_stats()
    slot_wait = pipe.stage_seconds["dispatch_slot_wait"]
    assert drain_close(pipe, src)
    assert len(got) == len(want) == 41
    for g, w in zip(got, want):
        for k, v in w.items():
            np.testing.assert_array_equal(g[k].cpu().numpy(), v)
    n_in_place = len(want) if in_place else 0
    assert stats["packed_batches"] == len(want)
    assert stats["slots_adopted"] == stats["slots_adopted_pinned"] == n_in_place
    assert host_pinning_stats()["ring_slots_pinned"] - pinned0 == (ring if in_place else 0)
    if in_place:
        assert slot_wait > 0  # the stall filled the copies in flight


def test_libsvm_fm_path_launches_the_kernels(cuda, tmp_path):
    d = 4096
    uri = _criteo_libsvm(tmp_path / "c.svm", 600, d)
    src = ell_batches(uri, BatchSpec(batch_size=128, max_nnz=39))
    model = FactorizationMachine(d, 8, device=cuda)
    pipe = StagingPipeline(src, device=cuda)
    _build.reset_launches()
    losses = [float(model.sgd_step(b, lr=0.5)) for b in pipe]
    assert drain_close(pipe, src)
    assert len(losses) == 5 and all(np.isfinite(losses))
    assert all(_build.launches[k] == 5 for k in _build.launches)


def test_csv_dense_lr_step_on_card_matches_cpu(cuda, tmp_path):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4096, 28))
    y = (x @ rng.normal(size=28) > 0).astype(int)
    path = tmp_path / "h.csv"
    path.write_text("".join(f"{y[i]}," + ",".join(f"{v:.6f}" for v in x[i]) + "\n"
                            for i in range(len(y))))
    spec = BatchSpec(batch_size=2048, layout="dense", num_features=28)
    uri = f"{path}?format=csv&label_column=0"
    src = dense_batches(uri, spec)
    pipe = StagingPipeline(src, device=cuda)
    first = {k: t.clone() for k, t in next(iter(pipe)).items()}
    assert drain_close(pipe, src)
    host = next(iter(dense_batches(uri, spec)))
    for k, v in host.as_dict().items():
        np.testing.assert_array_equal(first[k].cpu().numpy(), v)
    gpu = LogisticRegression(28, device=cuda)
    cpu = LogisticRegression(28, device="cpu")
    cpu.load_state_dict({k: p.cpu() for k, p in gpu.state_dict().items()})
    loss_g, grads_g = gpu.loss_and_grads(first)
    loss_c, grads_c = cpu.loss_and_grads({k: t.cpu() for k, t in first.items()})
    assert float(loss_g) == pytest.approx(float(loss_c), rel=1e-5)
    for k in grads_c:
        grad_close(grads_g[k].cpu(), grads_c[k])
