"""The CUDA kernels K1-K4 against their plain PyTorch versions on the
card (marked ``gpu``: skips where torch.cuda.is_available() is False).

    python -m pytest tests/test_torch_kernels_gpu.py -q

Inputs include duplicates, padding, wrapped negatives and out-of-range
indices, with f32 and f16 values, at the slice's shape and at the edge
shapes the designs branch on (K, E, B, and operands that are not 16-byte
aligned), and the gradient scatters' own edge inputs: every row naming
the same rows, every entry naming its own row (a tile's table full), E in
several column chunks, and dense gradients that are not 16-byte
aligned. Tolerances: forward 1e-6 + 1e-5 of the summed
terms' magnitudes (sums in another order; the pair term ½Σ(s² − q)
cancels, so its rounding error scales with s²); gradients 1e-4 of max |g|
(f32 atomics add in an order that changes from run to run)."""

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.ops import _build, fm as tfm, sparse as tops

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
    """K2 and K4 through their C entry points into zeroed dense gradients
    that start one element past a 16-byte boundary (the wrappers' own are
    aligned): K4 takes its scalar flush."""
    B, K, D, E = 203, 39, 1000, 16
    idx, val, _, v, g = inputs(cuda, B, K, D, E, vdtype, seed=4)
    _, s = tfm.fm_pair_fwd_plain(idx, val, v)
    gw = shifted(torch.zeros(D, device=cuda))
    gv = shifted(torch.zeros(D, E, device=cuda))
    assert gw.data_ptr() % 16 and gv.data_ptr() % 16
    f16 = int(vdtype == torch.float16)
    _build.launch("ell_matvec_bwd", cuda, idx.data_ptr(), val.data_ptr(), f16,
                  g.data_ptr(), gw.data_ptr(), B, K, D)
    _build.launch("fm_pair_bwd", cuda, idx.data_ptr(), val.data_ptr(), f16, v.data_ptr(),
                  s.data_ptr(), g.data_ptr(), gv.data_ptr(), B, K, E, D)
    grad_close(gw, tops.ell_matvec_bwd_plain(idx, val, g, D))
    grad_close(gv, tfm.fm_pair_bwd_plain(idx, val, v, s, g))
    torch.cuda.synchronize()
