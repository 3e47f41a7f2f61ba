"""Port parity of the mesh half of staging: each rank of a port mesh stages
the bytes the JAX package's ``stage_batch(batch, mesh=…)`` puts on the
device at the same place of a JAX mesh of the same shape, for every
parser family (dense libsvm and csv, rowrec and libfm ELL, f16 values,
padded tails), through ``stage_batch`` and ``StagingPipeline(mesh=)``.

A port rank's staging reads only its coordinates, so each rank's mesh
is built here, in this process, without a process group
(``Mesh(grid, axes, rank=r)``); the meshed jobs of
``test_torch_parallel.py`` stage through real gloo ranks.
"""

import numpy as np
import pytest

import dmlc_core_tpu.staging as jst
from dmlc_core_tpu.data.row_block import RowBlock as JaxRowBlock
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.parallel import Mesh
from dmlc_core_tpu_torch.staging.batcher import BatchSpec, FixedShapeBatcher
from dmlc_core_tpu_torch.staging.fused import dense_batches, ell_batches
from dmlc_core_tpu_torch.staging.pipeline import (
    StagingPipeline,
    StagingStats,
    _shard_plan,
    drain_close,
    stage_batch,
)
from dmlc_core_tpu_torch.utils.logging import Error

BATCH_ROWS = 16
N_ROWS = 41  # 41 % 16 = 9: a padded tail, and odd against every mesh


def _jax_mesh(shape, axes):
    import jax
    from jax.sharding import Mesh as JMesh

    return JMesh(np.array(jax.devices("cpu")[: int(np.prod(shape))]).reshape(shape), axes)


def _port_meshes(shape, axes):
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    return [Mesh(grid, axes, rank=r, device="cpu") for r in range(grid.size)]


def _write_inputs(tmp_path):
    rng = np.random.default_rng(5)
    with open(tmp_path / "g.libsvm", "w") as f:
        for i in range(N_ROWS):
            f.write(f"{i % 2} " + " ".join(f"{j}:{rng.normal():.6f}" for j in range(6)) + "\n")
    with open(tmp_path / "g.csv", "w") as f:
        for i in range(N_ROWS):
            f.write("%d,%s\n" % (i % 2, ",".join(f"{rng.normal():.6f}" for _ in range(6))))
    with open(tmp_path / "g.libfm", "w") as f:
        for i in range(N_ROWS):
            f.write(f"{i % 2} " + " ".join(f"{j}:{j * 3 + 1}:{rng.uniform():.6f}"
                                           for j in range(4)) + "\n")
    from dmlc_core_tpu_torch.data.rowrec import write_rowrec
    from dmlc_core_tpu_torch.io.stream import FileStream

    k = 4
    blk = RowBlock(offset=np.arange(N_ROWS + 1, dtype=np.int64) * k,
                   label=(np.arange(N_ROWS) % 2).astype(np.float32),
                   index=rng.integers(0, 32, N_ROWS * k).astype(np.uint32),
                   value=rng.normal(size=N_ROWS * k).astype(np.float32))
    with FileStream(str(tmp_path / "g.rec"), "w") as f:
        write_rowrec(f, [blk])


FAMILIES = {
    "libsvm_dense": ("g.libsvm", "dense"),
    "csv_dense": ("g.csv?format=csv&label_column=0", "dense"),
    "rowrec_ell": ("g.rec", "ell"),
    "libfm_ell": ("g.libfm?format=libfm", "ell"),
}


def _streams(tmp_path, family, value_dtype):
    """(JAX stream, port stream) of one family over the same file."""
    uri, layout = FAMILIES[family]
    uri = str(tmp_path / uri)
    kw = (dict(num_features=8) if layout == "dense" else dict(max_nnz=4))
    jspec = jst.BatchSpec(batch_size=BATCH_ROWS, layout=layout,
                          value_dtype=np.dtype(value_dtype), **kw)
    spec = BatchSpec(batch_size=BATCH_ROWS, layout=layout,
                     value_dtype=np.dtype(value_dtype), **kw)
    if layout == "dense":
        return jst.dense_batches(uri, jspec), dense_batches(uri, spec)
    return jst.ell_batches(uri, jspec), ell_batches(uri, spec)


def _jax_shards(arrays, jmesh):
    """{mesh position: {name: the device's shard as numpy}}."""
    pos = {d.id: i for i, d in enumerate(jmesh.devices.flat)}
    out = {}
    for name, arr in arrays.items():
        for s in arr.addressable_shards:
            out.setdefault(pos[s.device.id], {})[name] = np.asarray(s.data)
    return out


def _same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        g = got[k].numpy()
        assert g.dtype == want[k].dtype and g.shape == want[k].shape, (what, k)
        assert g.tobytes() == want[k].tobytes(), (what, k)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("mesh_shape,axes", [((4, 2), ("data", "model")), ((8,), ("data",)),
                                             ((2, 2), ("data", "model"))])
def test_stage_batch_equals_jax_shards(tmp_path, family, mesh_shape, axes):
    """Every batch, the padded tail included: rank r's staged arrays are
    the bytes of the JAX shard at mesh position r, through one copy of
    its packed block."""
    _write_inputs(tmp_path)
    jmesh = _jax_mesh(mesh_shape, axes)
    meshes = _port_meshes(mesh_shape, axes)
    jstream, pstream = _streams(tmp_path, family, np.float32)
    n = 0
    for jb, pb in zip(jstream, pstream):
        assert pb.packed is not None
        want = _jax_shards(jst.stage_batch(jb, mesh=jmesh, data_axis="data"), jmesh)
        for r, mesh in enumerate(meshes):
            stats = StagingStats()
            got = stage_batch(pb, mesh=mesh, data_axis="data", stats=stats)
            _same(got, want[r], f"{family} batch {n} rank {r}")
            snap = stats.snapshot()
            assert snap["packed_shard_dma"] and snap["device_puts"] == 1
        n += 1
    jstream.close()
    pstream.close()
    assert n == 3


def test_generic_batcher_f16_equals_jax_shards():
    """``FixedShapeBatcher`` output with f16 values (odd itemsize against
    the 8-byte alignment), a full batch and a padded tail of 3 rows."""
    sizes = [2] * 19
    offset = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=offset[1:])
    cols = dict(offset=offset, label=np.arange(len(sizes), dtype=np.float32),
                index=(np.arange(int(offset[-1]), dtype=np.uint64) % 16),
                value=np.linspace(1, 2, int(offset[-1]), dtype=np.float32))
    kw = dict(batch_size=BATCH_ROWS, layout="ell", max_nnz=3, value_dtype=np.dtype(np.float16))
    jbatches = list(jst.FixedShapeBatcher(jst.BatchSpec(**kw)).batches(iter([JaxRowBlock(**cols)])))
    pbatches = list(FixedShapeBatcher(BatchSpec(**kw)).batches(iter([RowBlock(**cols)])))
    assert [b.n_valid for b in pbatches] == [16, 3]
    jmesh = _jax_mesh((8,), ("data",))
    for jb, pb in zip(jbatches, pbatches):
        want = _jax_shards(jst.stage_batch(jb, mesh=jmesh), jmesh)
        for r, mesh in enumerate(_port_meshes((8,), ("data",))):
            _same(stage_batch(pb, mesh=mesh), want[r], f"f16 rank {r}")


def test_pipeline_mesh_packed_shard_stats(tmp_path):
    """Through ``StagingPipeline(mesh=)``: each rank of a (4, 2) mesh
    stages every batch on the packed-shard path, one copy a batch, its
    views equal to the JAX pipeline's shard; the ranks of a data line
    together hold every row once, and a model line's ranks the same
    rows."""
    _write_inputs(tmp_path)
    jmesh = _jax_mesh((4, 2), ("data", "model"))
    jstream, _ = _streams(tmp_path, "rowrec_ell", np.float32)
    jpipe = jst.StagingPipeline(jstream, mesh=jmesh, data_axis="data")
    want = [_jax_shards(b, jmesh) for b in jpipe]
    jst.drain_close(jpipe, jstream)
    labels = {}
    for r, mesh in enumerate(_port_meshes((4, 2), ("data", "model"))):
        _, stream = _streams(tmp_path, "rowrec_ell", np.float32)
        pipe = StagingPipeline(stream, mesh=mesh, data_axis="data")
        got = list(pipe)
        st = pipe.staging_stats()
        assert drain_close(pipe, stream)
        assert len(got) == len(want) == 3
        for i, b in enumerate(got):
            _same(b, want[i][r], f"batch {i} rank {r}")
        assert st["packed_shard_dma"] and st["packed_shard_batches"] == 3
        assert st["per_array_batches"] == 0 and st["device_puts"] == 3
        assert st["puts_per_device"] == {"cpu": 3}
        secs = pipe.stage_seconds
        assert secs["stage_dispatch"] == pytest.approx(secs["dispatch_pack"] + secs["dispatch_put"])
        labels[r] = [b["labels"][b["weights"] > 0].tolist() for b in got]
    for r in range(8):
        assert labels[r] == labels[r - r % 2]  # the model line's ranks: the same rows
    assert sum(len(x) for r in range(0, 8, 2) for x in labels[r]) == N_ROWS


def test_unsplittable_and_unpacked_batches_go_per_array():
    """A batch of 6 rows cannot split over 4 data ranks: the plan refuses
    it (and an unknown data axis), and staging raises as the JAX
    ``NamedSharding`` put does. An unpacked batch that splits takes one
    copy per array, with the packed-shard path's rows."""
    import jax

    spec = BatchSpec(batch_size=6, layout="dense", num_features=4)
    blk = RowBlock(offset=np.arange(7, dtype=np.int64), label=np.zeros(6, np.float32),
                   index=np.arange(6, dtype=np.uint64) % 4, value=np.ones(6, np.float32))
    (batch,) = list(FixedShapeBatcher(spec).push(blk))
    meshes = _port_meshes((4, 2), ("data", "model"))
    assert _shard_plan(batch, meshes[0], "data") is None
    assert _shard_plan(batch, meshes[0], "nope") is None
    with pytest.raises(Error, match="should be divisible by 4"):
        stage_batch(batch, mesh=meshes[0])
    jspec = jst.BatchSpec(batch_size=6, layout="dense", num_features=4)
    (jbatch,) = list(jst.FixedShapeBatcher(jspec).push(JaxRowBlock(
        offset=np.arange(7, dtype=np.int64), label=np.zeros(6, np.float32),
        index=np.arange(6, dtype=np.uint64) % 4, value=np.ones(6, np.float32))))
    with pytest.raises(ValueError, match="should be divisible by 4"):
        jax.block_until_ready(jst.stage_batch(jbatch, mesh=_jax_mesh((4, 2), ("data", "model"))))
    # the same rows, unpacked, on a (2, 2) mesh: per array, as packed
    spec8 = BatchSpec(batch_size=8, layout="dense", num_features=4)
    blk8 = RowBlock(offset=np.arange(9, dtype=np.int64), label=np.arange(8, dtype=np.float32),
                    index=np.arange(8, dtype=np.uint64) % 4, value=np.arange(8, dtype=np.float32))
    (packed,) = list(FixedShapeBatcher(spec8).push(blk8))
    unpacked = type(packed)(labels=packed.labels.copy(), weights=packed.weights.copy(),
                            n_valid=packed.n_valid, x=packed.x.copy())
    for mesh in _port_meshes((2, 2), ("data", "model")):
        stats = StagingStats()
        got = stage_batch(unpacked, mesh=mesh, stats=stats)
        want = stage_batch(packed, mesh=mesh)
        assert stats.snapshot()["per_array_batches"] == 1
        assert stats.snapshot()["device_puts"] == 3
        for k in want:
            assert got[k].numpy().tobytes() == want[k].numpy().tobytes(), k
