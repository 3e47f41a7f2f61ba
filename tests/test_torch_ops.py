"""Port parity: dmlc_core_tpu_torch.ops against dmlc_core_tpu.ops on the
CPU (the port's plain versions; its CUDA kernels are held against the
same plain versions in test_torch_kernels_gpu.py and chip_smoke.py).

Inputs come from a numpy seed and include duplicate indices, padding
slots (index 0, value 0), wrapped negatives in [-D, -1] and out-of-range
indices (>= D, < -D), which jnp.take reads as NaN and its gradient drops.
Tolerances: forward rtol 1e-5 / atol 1e-6 (sums in another order);
gradients 1e-4 of max |g| (scatter-adds in another order). At the edge
shapes the kernels' designs branch on (K in {1, 33, 39, 64}, E in {1, 5,
16}), the forward tolerance is the one the kernels are held to:
1e-6 + 1e-5 of the summed terms' magnitudes (the pair term ½Σ(s² − q)
cancels, so its rounding error scales with s², not with the result)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dmlc_core_tpu.models.fm import FactorizationMachine as JaxFM
from dmlc_core_tpu.ops import sparse as jops
from dmlc_core_tpu_torch.ops import _common, fm as tfm, sparse as tops
from dmlc_core_tpu_torch.utils.logging import Error

B, K, D, E = 16, 7, 50, 4
FWD = dict(rtol=1e-5, atol=1e-6, equal_nan=True)


def assert_grad_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    tol = 1e-4 * float(np.abs(want[fin]).max())
    assert float(np.abs(got[fin] - want[fin]).max()) <= tol


def ell_inputs(seed, vdtype, out_of_range=True):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-D, D, (B, K)).astype(np.int32)  # negatives wrap
    idx[1, 1:4] = idx[1, 0]  # duplicates in a row
    idx[2, 4:] = 0  # padding slots
    val = rng.normal(size=(B, K)).astype(vdtype)
    val[2, 4:] = 0
    if out_of_range:
        idx[3, 2] = D + 3
        idx[4, 5] = -D - 2
    return idx, val


def tt(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
def test_ell_matvec_matches_jax(vdtype):
    idx, val = ell_inputs(0, vdtype)
    w = np.random.default_rng(1).normal(size=D).astype(np.float32)
    want = np.asarray(jops.ell_matvec(idx, val, w))
    assert np.isnan(want[[3, 4]]).all()  # out-of-range rows read NaN
    got = tops.ell_matvec(tt(idx), tt(val), tt(w))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
def test_ell_matvec_grad_matches_jax(vdtype):
    idx, val = ell_inputs(2, vdtype)
    rng = np.random.default_rng(3)
    w = rng.normal(size=D).astype(np.float32)
    g = rng.normal(size=B).astype(np.float32)
    want = jax.grad(lambda w: jnp.sum(jops.ell_matvec(idx, val, w) * g))(w)
    wt = tt(w).requires_grad_()
    (tops.ell_matvec(tt(idx), tt(val), wt) * tt(g)).sum().backward()
    assert_grad_close(wt.grad.numpy(), want)
    # the plain backward alone, as the kernel's comparison uses it
    assert_grad_close(
        tops.ell_matvec_bwd_plain(tt(idx), tt(val), tt(g), D).numpy(), want
    )


def _jax_pair(idx, val, v):
    """The JAX FM pair term: forward with w = 0 and b = 0."""
    model = JaxFM(D, embed_dim=E)
    params = {"w": jnp.zeros(D), "v": v, "b": jnp.zeros(())}
    return model.forward(params, {"indices": idx, "values": val})


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
def test_fm_pair_matches_jax(vdtype):
    idx, val = ell_inputs(4, vdtype)
    v = np.random.default_rng(5).normal(size=(D, E)).astype(np.float32)
    want = np.asarray(_jax_pair(idx, val, v))
    pair, s = tfm.fm_pair_fwd_plain(tt(idx), tt(val), tt(v))
    np.testing.assert_allclose(pair.numpy(), want, **FWD)
    np.testing.assert_allclose(
        tfm.fm_pair(tt(idx), tt(val), tt(v)).numpy(), want, **FWD
    )
    # s is the per-row embedding sum Σ_k val·v[idx]
    idx_ok, val_ok = ell_inputs(4, vdtype, out_of_range=False)
    s_want = np.asarray(jops.ell_matmul(idx_ok, val_ok, v))
    _, s_ok = tfm.fm_pair_fwd_plain(tt(idx_ok), tt(val_ok), tt(v))
    np.testing.assert_allclose(s_ok.numpy(), s_want, **FWD)
    assert s.shape == (B, E)


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
def test_fm_pair_grad_matches_jax(vdtype):
    idx, val = ell_inputs(6, vdtype)
    rng = np.random.default_rng(7)
    v = rng.normal(size=(D, E)).astype(np.float32)
    g = rng.normal(size=B).astype(np.float32)
    want = np.asarray(
        jax.grad(lambda v: jnp.sum(_jax_pair(idx, val, v) * g))(v)
    )
    assert np.isnan(want).any()  # NaN rows poison their slots' gradient
    vt = tt(v).requires_grad_()
    (tfm.fm_pair(tt(idx), tt(val), vt) * tt(g)).sum().backward()
    assert_grad_close(vt.grad.numpy(), want)


def test_ell_matmul_matches_jax():
    idx, val = ell_inputs(8, np.float16)
    table = np.random.default_rng(9).normal(size=(D, E)).astype(np.float32)
    want = np.asarray(jops.ell_matmul(idx, val, table))
    got = tops.ell_matmul(tt(idx), tt(val), tt(table))
    np.testing.assert_allclose(got.numpy(), want, **FWD)


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
def test_ell_to_dense_matches_jax(vdtype):
    idx, val = ell_inputs(10, vdtype)
    want = np.asarray(jops.ell_to_dense(idx, val, D))
    got = tops.ell_to_dense(tt(idx), tt(val), D)
    assert got.dtype == tt(val).dtype
    # duplicates accumulate in the values' dtype, in another order: f16
    # keeps ~3 decimal digits
    np.testing.assert_allclose(
        got.float().numpy(), want.astype(np.float32),
        rtol=1e-3 if vdtype == np.float16 else 1e-6, atol=1e-6,
    )


def test_weighted_mean_matches_jax():
    rng = np.random.default_rng(11)
    per_row = rng.normal(size=B).astype(np.float32)
    for weights in (
        rng.uniform(size=B).astype(np.float32),
        np.r_[np.ones(5), np.zeros(B - 5)].astype(np.float32),
        np.zeros(B, np.float32),  # the 1e-9 floor keeps this finite
    ):
        want = float(jops.weighted_mean(per_row, weights))
        got = float(tops.weighted_mean(tt(per_row), tt(weights)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_wrap_index_follows_jnp_take():
    idx = np.array([0, 4, -1, -5, 5, -6], dtype=np.int32)
    want = np.asarray(jnp.take(jnp.arange(5.0), idx))
    j, valid = _common.wrap_index(tt(idx), 5)
    got = np.where(valid.numpy(), j.numpy().astype(np.float64), np.nan)
    np.testing.assert_array_equal(got, want)


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    """The argument checks run before any build or launch."""
    idx, val = ell_inputs(12, np.float32, out_of_range=False)
    w = tt(np.zeros(D, np.float32))
    v = tt(np.zeros((D, E), np.float32))
    bad = [
        (tops.ell_matvec_fwd_kernel, (tt(idx.astype(np.int64)), tt(val), w)),
        (tops.ell_matvec_fwd_kernel, (tt(idx), tt(val.astype(np.float64)), w)),
        (tops.ell_matvec_fwd_kernel, (tt(idx), tt(val)[:, :3], w)),
        (tops.ell_matvec_fwd_kernel, (tt(idx).t(), tt(val).t(), w)),
        (tops.ell_matvec_fwd_kernel, (tt(idx), tt(val), w.double())),
        (tops.ell_matvec_bwd_kernel, (tt(idx), tt(val), torch.zeros(B + 1), D)),
        (tfm.fm_pair_fwd_kernel, (tt(idx), tt(val), v[:, 0])),
        (tfm.fm_pair_bwd_kernel,
         (tt(idx), tt(val), v, torch.zeros(B, E + 1), torch.zeros(B))),
    ]
    for fn, args in bad:
        with pytest.raises(Error):
            fn(*args)


def test_non_cpu_tensors_never_take_the_plain_versions():
    """Only CPU tensors run the plain versions: a mix of devices, or a
    device that is neither CPU nor CUDA, raises instead."""
    idx, val = ell_inputs(13, np.float32, out_of_range=False)
    w = np.zeros(D, np.float32)
    with pytest.raises(Error):
        tops.ell_matvec(tt(idx), tt(val), tt(w).to("meta"))
    with pytest.raises(Error):
        tfm.fm_pair(tt(idx).to("meta"), tt(val).to("meta"),
                    torch.zeros(D, E, device="meta"))


# K from 1 to past two warps, E from one scalar lane to 16-byte lanes, and
# B a multiple of neither K1's 16 rows a block nor K3's 8
EDGE_K = [1, 33, 39, 64]
EDGE_E = [1, 5, 16]
EDGE_B, EDGE_D = 37, 60


def edge_inputs(seed, k, vdtype):
    """Indices over [-D, D) (half wrapped negatives), a row of duplicates,
    padding slots and rows, one index above and one below the range."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-EDGE_D, EDGE_D, (EDGE_B, k)).astype(np.int32)
    val = rng.normal(size=(EDGE_B, k)).astype(vdtype)
    idx[1] = idx[1, 0]
    idx[2, k // 2:] = 0
    val[2, k // 2:] = 0
    idx[EDGE_B - 3:] = 0
    val[EDGE_B - 3:] = 0
    idx[3, 0] = EDGE_D + 5
    idx[4, k - 1] = -EDGE_D - 5
    return idx, val


def assert_fwd_close(got, want, scale):
    """|got - want| <= 1e-6 + 1e-5·scale where finite, NaN where NaN."""
    got, want, scale = (np.asarray(a, np.float64) for a in (got, want, scale))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = ~np.isnan(want)
    assert (np.abs(got - want)[fin] <= 1e-6 + 1e-5 * scale[fin]).all()


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
@pytest.mark.parametrize("k", EDGE_K)
def test_ell_matvec_plain_matches_jax_at_edge_shapes(k, vdtype):
    idx, val = edge_inputs(20 + k, k, vdtype)
    w = np.random.default_rng(21).normal(size=EDGE_D).astype(np.float32)
    want = np.asarray(jops.ell_matvec(idx, val, w))
    assert np.isnan(want[[3, 4]]).all() and not np.isnan(np.delete(want, [3, 4])).any()
    got = tops.ell_matvec_fwd_plain(tt(idx), tt(val), tt(w))
    scale = np.asarray(jops.ell_matvec(idx, np.abs(val), np.abs(w)))
    assert_fwd_close(got.numpy(), want, scale)


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
@pytest.mark.parametrize("e", EDGE_E)
@pytest.mark.parametrize("k", EDGE_K)
def test_fm_pair_plain_matches_jax_at_edge_shapes(k, e, vdtype):
    idx, val = edge_inputs(30 + k + e, k, vdtype)
    v = np.random.default_rng(31).normal(size=(EDGE_D, e)).astype(np.float32)
    params = {"w": jnp.zeros(EDGE_D), "v": v, "b": jnp.zeros(())}
    want = np.asarray(JaxFM(EDGE_D, embed_dim=e).forward(
        params, {"indices": idx, "values": val}))
    pair, s = tfm.fm_pair_fwd_plain(tt(idx), tt(val), tt(v))
    # the summed terms' magnitudes: s of |val|·|v|, per row Σ_e of its square
    scale_s = np.asarray(jops.ell_matmul(idx, np.abs(val), np.abs(v)))
    assert_fwd_close(pair.numpy(), want, (scale_s ** 2).sum(-1))
    # s is Σ_k val·v[idx]: NaN in the out-of-range rows, ell_matmul elsewhere
    ok = np.ones(EDGE_B, bool)
    ok[[3, 4]] = False
    assert np.isnan(s.numpy()[~ok]).all()
    s_want = np.asarray(jops.ell_matmul(idx[ok], val[ok], v))
    assert_fwd_close(s.numpy()[ok], s_want, scale_s[ok])


def hot_inputs(seed, k, vdtype):
    """The Criteo layout at the edge width: every row shares its first
    min(13, k) columns (ids 0-12), the rest over [-D, D) (half wrapped
    negatives); one row repeats a single index k times, and the last three
    rows are padding. No out-of-range index: its NaN would reach every
    shared row."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-EDGE_D, EDGE_D, (EDGE_B, k)).astype(np.int32)
    hot = min(13, k)
    idx[:, :hot] = np.arange(hot)
    val = rng.normal(size=(EDGE_B, k)).astype(vdtype)
    idx[1] = EDGE_D - 1
    idx[EDGE_B - 3:] = 0
    val[EDGE_B - 3:] = 0
    return idx, val


# the edge inputs at every K, and the hot layout at every K
GRAD_LAYOUTS = {"edge": edge_inputs, "hot": hot_inputs}


@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
@pytest.mark.parametrize("k", EDGE_K)
@pytest.mark.parametrize("layout", list(GRAD_LAYOUTS))
def test_ell_matvec_bwd_plain_matches_jax_grad(layout, k, vdtype):
    """The plain gradient K2 is held to on the card, against jax.grad."""
    idx, val = GRAD_LAYOUTS[layout](40 + k, k, vdtype)
    rng = np.random.default_rng(41)
    w = rng.normal(size=EDGE_D).astype(np.float32)
    g = rng.normal(size=EDGE_B).astype(np.float32)
    want = np.asarray(jax.grad(lambda w: jnp.sum(jops.ell_matvec(idx, val, w) * g))(w))
    got = tops.ell_matvec_bwd_plain(tt(idx), tt(val), tt(g), EDGE_D)
    assert got.dtype == torch.float32 and got.shape == (EDGE_D,)
    assert_grad_close(got.numpy(), want)


@pytest.mark.parametrize(
    "layout,k,e",
    [("edge", k, e) for k in EDGE_K for e in EDGE_E] + [("hot", k, 16) for k in EDGE_K],
)
@pytest.mark.parametrize("vdtype", [np.float32, np.float16])
def test_fm_pair_bwd_plain_matches_jax_grad(layout, k, e, vdtype):
    """The plain gradient K4 is held to on the card, against jax.grad of
    the JAX FM's pair term (at K = 1 exactly 0)."""
    idx, val = GRAD_LAYOUTS[layout](50 + k + e, k, vdtype)
    rng = np.random.default_rng(51)
    v = rng.normal(size=(EDGE_D, e)).astype(np.float32)
    g = rng.normal(size=EDGE_B).astype(np.float32)
    model = JaxFM(EDGE_D, embed_dim=e)
    batch = {"indices": idx, "values": val}

    def pair(v):
        return model.forward({"w": jnp.zeros(EDGE_D), "v": v, "b": jnp.zeros(())}, batch)

    want = np.asarray(jax.grad(lambda v: jnp.sum(pair(v) * g))(v))
    # an out-of-range row poisons the entries of its other, valid indices:
    # edge rows 3 and 4 have some where K > 1
    assert np.isnan(want).any() == (layout == "edge" and k > 1)
    _, s = tfm.fm_pair_fwd_plain(tt(idx), tt(val), tt(v))
    got = tfm.fm_pair_bwd_plain(tt(idx), tt(val), tt(v), s, tt(g))
    assert got.dtype == torch.float32 and got.shape == (EDGE_D, e)
    assert_grad_close(got.numpy(), want)


def test_scatter_variants_apply_to_the_kernel_source():
    """Every variant ops/scatter_variants.py times is a substitution that
    still applies to csrc/ell_kernels.cu (it builds nothing here)."""
    from dmlc_core_tpu_torch.ops import _build, scatter_variants

    src = _build._SRC.read_text()
    for name, subs in scatter_variants.VARIANTS.items():
        assert all(old in src for old, _ in subs), name
        assert scatter_variants._source(subs) != src or not subs, name


def test_scatter_launches_on_one_stream_never_interleave(monkeypatch):
    """Two host threads scattering on one stream: each call's launch
    (its tile and flush kernels, enqueued in one call that releases the
    GIL) runs whole before the other's starts, every call passes the
    stream's kept scratch (tile lists included), and a refused launch
    drops that scratch so the next call zeroes a new one. The launch is a
    stand-in here; the kernels' own two-thread check is in
    test_torch_kernels_gpu.py."""
    import threading
    import time
    import types

    from dmlc_core_tpu_torch.ops import _build

    events, ptrs, refuse = [], [], []

    def fake_launch(name, device, *args):
        events.append(("start", threading.get_ident()))
        time.sleep(0.005)
        ptrs.append(args[-6:])
        events.append(("end", threading.get_ident()))
        if refuse:
            raise Error("refused")

    stream = types.SimpleNamespace(cuda_stream=12345)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(_common, "_kept", {})
    dev = torch.device("cpu")

    def scatter():
        for _ in range(8):
            _common.launch_scatter("fm_pair_bwd", dev, (), 40, 300, 4)

    threads = [threading.Thread(target=scatter) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(events) == 32
    for i in range(0, 32, 2):
        assert events[i][0] == "start" and events[i + 1] == ("end", events[i][1])
    assert len(set(ptrs)) == 1  # every call took the one kept set
    _, kept = _common._kept[(None, 12345)]
    assert [kept[p].numel() for p in ("rows", "parts", "runs", "meta", "acc", "flags")] == \
        [512, 512 * 4, 2, 4 * 48, 512 * 4, 512 * 4]
    refuse.append(True)
    with pytest.raises(Error):
        _common.launch_scatter("fm_pair_bwd", dev, (), 40, 300, 4)
    assert kept == {}
