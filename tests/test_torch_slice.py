"""The port's slices end to end on the CPU against the JAX package: one
Criteo-shaped rowrec shard → ell_batches → StagingPipeline →
5 FactorizationMachine SGD steps (f32 values) and 5 LogisticRegression
steps (f16 values), from the same numpy parameters; and the shuffled,
resumable slice: FM SGD over ``?index=…&shuffle=batch``, checkpointed
with ``save_async`` at a span, restored by a fresh ``Checkpointer`` and
resumed with ``skip_records``, against the JAX FM stepping through the
JAX package's batches of the same URI. Tolerance: losses rtol 1e-5,
final parameters 1e-4 of max |param| (sums in another order, carried
through the steps); the restored parameters equal the saved ones bit for
bit."""

import jax
import numpy as np
import pytest

from dmlc_core_tpu.models import (
    FactorizationMachine as JaxFM,
    LogisticRegression as JaxLogReg,
)
from dmlc_core_tpu.staging import BatchSpec as JaxSpec, ell_batches as jax_ell_batches
from dmlc_core_tpu_torch.checkpoint import Checkpointer
from dmlc_core_tpu_torch.convert import params_from_jax, params_to_numpy
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.data.rowrec import write_rowrec
from dmlc_core_tpu_torch.io.stream import FileStream
from dmlc_core_tpu_torch.models import FactorizationMachine, LogisticRegression
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches
from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

B, K, D, E = 64, 39, 4096, 8
ROWS = 4 * B + 44  # 5 batches, the last one zero padded


def write_shard(path, rows=ROWS, index=False):
    """Criteo-shaped rows; with ``index``, also the ``.idx`` index."""
    rng = np.random.default_rng(0)
    idx = np.empty((rows, K), dtype=np.uint32)
    idx[:, :13] = np.arange(13)
    idx[:, 13:] = rng.integers(13, D, (rows, K - 13))
    val = np.ones((rows, K), dtype=np.float32)
    val[:, :13] = rng.uniform(0, 1, (rows, 13))
    labels = ((rng.normal(size=D)[idx] * val).sum(1) > 0).astype(np.float32)
    blk = RowBlock(offset=np.arange(rows + 1) * K, label=labels,
                   index=idx.reshape(-1), value=val.reshape(-1))
    with FileStream(path, "w") as f:
        if index:
            with FileStream(path + ".idx", "w") as fi:
                write_rowrec(f, [blk], index_stream=fi)
        else:
            write_rowrec(f, [blk])


@pytest.mark.parametrize("kind", ["fm", "lr"])
def test_slice_steps_match_jax(tmp_path, kind):
    path = str(tmp_path / "criteo.rec")
    write_shard(path)
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=D).astype(np.float32) * 0.05,
              "b": np.float32(0.0)}
    if kind == "fm":
        params["v"] = rng.normal(size=(D, E)).astype(np.float32) * 0.05
        vdtype, lr = np.float32, 0.5
        jmodel = JaxFM(D, embed_dim=E)
        model = FactorizationMachine(D, E, device="cpu")
    else:
        vdtype, lr = np.float16, 0.5
        jmodel = JaxLogReg(D)
        model = LogisticRegression(D, device="cpu")
    model.load_state_dict(params_from_jax(params, "cpu"))

    jstep = jax.jit(lambda p, b: jmodel.sgd_step(p, b, lr=lr))
    jparams, jlosses = dict(params), []
    jsrc = jax_ell_batches(path, JaxSpec(batch_size=B, layout="ell", max_nnz=K,
                                         value_dtype=np.dtype(vdtype)))
    for batch in jsrc:
        jparams, loss = jstep(jparams, batch.as_dict())
        jlosses.append(float(loss))
    jsrc.close()

    src = ell_batches(path, BatchSpec(batch_size=B, max_nnz=K, value_dtype=vdtype))
    pipe = StagingPipeline(src, device="cpu")
    losses = [float(model.sgd_step(batch, lr=lr)) for batch in pipe]
    assert drain_close(pipe, src)

    assert len(losses) == len(jlosses) == 5
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    got = params_to_numpy(model.state_dict())
    for k, want in jparams.items():
        want = np.asarray(want)
        tol = 1e-4 * float(np.abs(want).max())
        assert float(np.abs(got[k] - want).max()) <= tol, k


def close_to_jax(got, jparams):
    for k, want in jparams.items():
        want = np.asarray(want)
        tol = 1e-4 * float(np.abs(want).max())
        assert float(np.abs(got[k] - want).max()) <= tol, k


def test_shuffled_slice_resumes_at_a_span_like_jax(tmp_path):
    """7 steps over spans of B records in a (seed, epoch) order, the
    remainder span last: the port stops after step 3 with a checkpoint
    at records 3·B, a fresh Checkpointer restores it, and a new pipeline
    with skip_records takes steps 4-7."""
    path = str(tmp_path / "criteo.rec")
    rows, stop = 6 * B + 20, 3
    write_shard(path, rows, index=True)
    uri = f"{path}?index={path}.idx&shuffle=batch&batch_size={B}&seed=1&epoch=0"
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=D).astype(np.float32) * 0.05, "b": np.float32(0.0),
              "v": rng.normal(size=(D, E)).astype(np.float32) * 0.05}
    jmodel = JaxFM(D, embed_dim=E)
    jstep = jax.jit(lambda p, b: jmodel.sgd_step(p, b, lr=0.5))
    jparams, jlosses = dict(params), []
    jsrc = jax_ell_batches(uri, JaxSpec(batch_size=B, layout="ell", max_nnz=K))
    for batch in jsrc:
        jparams, loss = jstep(jparams, batch.as_dict())
        jlosses.append(float(loss))
        if len(jlosses) == stop:
            jsaved = {k: np.asarray(v) for k, v in jparams.items()}
    jsrc.close()

    spec = BatchSpec(batch_size=B, max_nnz=K)
    ck_dir = str(tmp_path / "ckpt")
    model = FactorizationMachine(D, E, device="cpu")
    model.load_state_dict(params_from_jax(params, "cpu"))
    ck = Checkpointer(ck_dir, keep=2)
    src = ell_batches(uri, spec)
    pipe = StagingPipeline(src, device="cpu")
    losses = []
    for batch in pipe:
        losses.append(float(model.sgd_step(batch, lr=0.5)))
        ck.save_async(len(losses), model.params(),
                      meta={"epoch": 0, "records": len(losses) * B})
        if len(losses) == stop:
            break
    assert drain_close(pipe, src)
    ck.wait()
    saved = params_to_numpy(model.state_dict())
    close_to_jax(saved, jsaved)

    fresh = Checkpointer(ck_dir, keep=2)
    step, tree = fresh.restore()
    meta = fresh.restore_meta()
    assert step == stop and meta == {"epoch": 0, "records": stop * B}
    for k, v in saved.items():
        np.testing.assert_array_equal(tree[k], v)
    resumed = FactorizationMachine(D, E, device="cpu")
    resumed.load_state_dict(params_from_jax(tree, "cpu"))
    src = ell_batches(f"{uri}&skip_records={meta['records']}", spec)
    pipe = StagingPipeline(src, device="cpu")
    losses += [float(resumed.sgd_step(batch, lr=0.5)) for batch in pipe]
    assert drain_close(pipe, src)

    assert len(losses) == len(jlosses) == 7
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    close_to_jax(params_to_numpy(resumed.state_dict()), jparams)
