"""Port parity of local-rows staging (the JAX package's multi-process
branch of ``stage_batch``, ``make_array_from_process_local_data``): each
rank of a port mesh reads only part ``process_shard(mesh)`` of a rowrec
file and stages its own block (``StagingPipeline(mesh=, local_rows=True)``).

- The port's copy of ``tests/test_multiprocess_staging.py::
  test_two_process_staging_exact_cover`` (N = 512, B_LOCAL = 128, K = 7,
  labels = row ids) on a (2,) and a (2, 2) gloo mesh: every row once per
  model line, the ranks of a model line the same bytes, each rank's
  block the JAX producer's batch of that part, staged as one device
  array.
- The FM ``data_parallel_step`` on (2, 2) with local rows against the JAX
  ``data_parallel_step`` on the global batches made from the parts'
  batches in data order, on parts of even and uneven length (the part
  that ends first yields all-padding batches until every part has
  ended). Tolerances as in ``tests/test_torch_parallel.py``: losses rel
  1e-5, params rtol 1e-5.

Each job runs its ranks as processes of their own, meeting through a
``FileStore`` under ``tmp_path``, each joined with a timeout.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

import dmlc_core_tpu.staging as jst
from dmlc_core_tpu.models import FactorizationMachine as JaxFM
from dmlc_core_tpu.parallel import data_parallel_step as jax_dps
from dmlc_core_tpu.parallel import make_mesh as jax_make_mesh
from dmlc_core_tpu_torch.data.row_block import RowBlock
from dmlc_core_tpu_torch.data.rowrec import write_rowrec
from dmlc_core_tpu_torch.io.stream import FileStream
from dmlc_core_tpu_torch.parallel import Mesh, process_shard
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches
from dmlc_core_tpu_torch.staging.pipeline import (
    StagingPipeline,
    StagingStats,
    drain_close,
    stage_batch,
)
from dmlc_core_tpu_torch.utils.logging import Error

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 120

N_ROWS, B_LOCAL, K = 512, 128, 7       # the JAX test's sizes
D_FM, E_FM, B_FM, LR = 64, 8, 32, 0.1   # the FM jobs: 32 rows a rank a step
# the uneven file: 128 rows, the first 32 of 2 entries and the rest of 7,
# so the byte-range parts hold 73 and 55 rows: 3 and 2 batches of 32
UNEVEN_ROWS, UNEVEN_CUT = 128, 32

PRELUDE = """
import os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist
from dmlc_core_tpu_torch.convert import placed_from_jax
from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.parallel import (
    P, data_parallel_step, destroy_process_group, init_process_group, make_mesh,
    place_model, process_shard)
from dmlc_core_tpu_torch.staging.batcher import BatchSpec
from dmlc_core_tpu_torch.staging.fused import ell_batches
from dmlc_core_tpu_torch.staging.pipeline import StagingPipeline, drain_close

rank, world = init_process_group(rank=int(sys.argv[1]), world=int(sys.argv[2]),
                                 device="cpu", init_method="file://" + sys.argv[3])
OUT = sys.argv[4]
IN = dict(np.load(os.path.join(OUT, "inputs.npz"), allow_pickle=False))
res = {{}}
"""

JOB = """
mesh = make_mesh(tuple(IN["shape"].tolist()), tuple(str(a) for a in IN["axes"]))
part, nparts = process_shard(mesh)
res["part"] = np.array([part, nparts])
line = mesh.group(("data",))

def staged(uri, b_local, k):
    src = ell_batches(uri, BatchSpec(batch_size=b_local, max_nnz=k),
                      part_index=part, num_parts=nparts)
    return src, StagingPipeline(src, mesh=mesh, local_rows=True)

def stats_of(pipe):
    st = pipe.staging_stats()
    return np.array([st["packed_batches"], st["device_puts"], st["per_array_batches"],
                     st["packed_shard_batches"], st["padding_batches"], pipe.rows_staged])

# exact cover: each rank's staged block, and the data line's sums of it
src, pipe = staged(str(IN["cover_rec"]), int(IN["b_local"]), int(IN["k"]))
blobs, sums = [], []
for b in pipe:
    blobs.append(np.concatenate([b[n].numpy().view(np.uint8).reshape(-1) for n in sorted(b)]))
    t = torch.tensor([float(b["labels"].double().sum()), float(b["weights"].double().sum()),
                      float(b["labels"].shape[0])], dtype=torch.float64)
    if line is not None:
        dist.all_reduce(t, group=line)
    sums.append(t.numpy())
res["cover_stats"] = stats_of(pipe)
drain_close(pipe, src)
res["cover_bytes"] = np.stack(blobs)
res["cover_sums"] = np.stack(sums)

if "empty_rec" in IN:  # part 1 of a one-row file holds no batch
    src, pipe = staged(str(IN["empty_rec"]), 4, int(IN["k"]))
    got = [{n: t.numpy().copy() for n, t in b.items()} for b in pipe]
    res["empty_stats"] = stats_of(pipe)
    drain_close(pipe, src)
    res["empty_n"] = np.array(len(got))
    for n, v in got[0].items():
        res[f"empty_{n}"] = v

if "fm_w" in IN:
    rules = {"v": P(None, "model")}
    init = {n: IN[f"fm_{n}"] for n in ("w", "v", "b")}
    for tag in ("even", "uneven"):
        model = FactorizationMachine(int(IN["d"]), int(IN["e"]), device="cpu", l2=0.01)
        place_model(model, mesh, rules)
        model.load_placed(placed_from_jax(init, mesh, rules))
        step = data_parallel_step(lambda m, b: m.sgd_step(b, lr=float(IN["lr"])), mesh,
                                  "data", rules)
        src, pipe = staged(str(IN[f"{tag}_rec"]), int(IN["b_fm"]), int(IN["k"]))
        res[f"{tag}_losses"] = np.array([float(step(model, b)) for b in pipe])
        res[f"{tag}_stats"] = stats_of(pipe)
        drain_close(pipe, src)
        for n, p in model.params().items():
            res[f"{tag}_{n}"] = p.detach().numpy()
"""

EPILOGUE = """
np.savez(os.path.join(OUT, f"rank{rank}.npz"), **res)
destroy_process_group()
"""


def run_ranks(out: Path, inputs: dict, n: int):
    """Run JOB in ``n`` gloo rank processes on the CPU; returns the ranks'
    result dicts."""
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "inputs.npz", **inputs)
    script = out / "job.py"
    script.write_text(PRELUDE.format(repo=str(REPO)) + textwrap.dedent(JOB) + EPILOGUE)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(n),
                               str(out / "job.pg"), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env)
             for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o[-3000:]}\n{e[-3000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]


def write_rec(path, n, sizes, labels, d, seed):
    rng = np.random.default_rng(seed)
    off = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=off[1:])
    blk = RowBlock(offset=off, label=labels.astype(np.float32),
                   index=rng.integers(0, d, int(off[-1])).astype(np.uint32),
                   value=rng.normal(size=int(off[-1])).astype(np.float32))
    with FileStream(str(path), "w") as f:
        write_rowrec(f, [blk])
    return str(path)


def cover_rec(tmp):
    """The JAX test's file: labels are row ids, so the label sum is a
    fingerprint of every row once."""
    return write_rec(tmp / "mp.rec", N_ROWS, np.full(N_ROWS, K),
                     np.arange(N_ROWS), 1000, 0)


def fm_inputs(tmp):
    rng = np.random.default_rng(3)
    even = write_rec(tmp / "even.rec", 4 * 2 * B_FM, np.full(8 * B_FM, K),
                     rng.integers(0, 2, 8 * B_FM), D_FM, 1)
    sizes = np.where(np.arange(UNEVEN_ROWS) < UNEVEN_CUT, 2, K)
    uneven = write_rec(tmp / "uneven.rec", UNEVEN_ROWS, sizes,
                       rng.integers(0, 2, UNEVEN_ROWS), D_FM, 2)
    params = {k: np.asarray(v) for k, v in
              JaxFM(D_FM, E_FM, l2=0.01).init(jax.random.PRNGKey(4)).items()}
    return {"even_rec": even, "uneven_rec": uneven, "d": D_FM, "e": E_FM, "b_fm": B_FM,
            "lr": LR, **{f"fm_{k}": v for k, v in params.items()}}


def base_inputs(tmp, shape, axes):
    return {"shape": np.array(shape), "axes": np.array(axes), "cover_rec": cover_rec(tmp),
            "b_local": B_LOCAL, "k": K}


@pytest.fixture(scope="module")
def job2(tmp_path_factory):
    """Two ranks on a (2,) mesh, with a one-row file whose part 1 is
    empty."""
    tmp = tmp_path_factory.mktemp("local2")
    inp = base_inputs(tmp, (2,), ("data",))
    inp["empty_rec"] = write_rec(tmp / "one.rec", 1, np.array([K]), np.array([5]), 1000, 9)
    return inp, run_ranks(tmp / "job", inp, 2)


@pytest.fixture(scope="module")
def job4(tmp_path_factory):
    """Four ranks on a (2, 2) data × model mesh: the exact cover and the
    FM steps on even and uneven parts."""
    tmp = tmp_path_factory.mktemp("local4")
    inp = {**base_inputs(tmp, (2, 2), ("data", "model")), **fm_inputs(tmp)}
    return inp, run_ranks(tmp / "job", inp, 4)


def jax_part_batches(uri, b, k, part, nparts):
    """The JAX producer's batches of one part, each array copied out of
    its ring slot."""
    stream = jst.ell_batches(uri, jst.BatchSpec(batch_size=b, layout="ell", max_nnz=k),
                             part_index=part, num_parts=nparts)
    out = [{n: np.array(v) for n, v in bt.as_dict().items()} for bt in stream]
    stream.close()
    return out


def staged_bytes(arrays):
    return np.concatenate([np.ascontiguousarray(arrays[n]).view(np.uint8).reshape(-1)
                           for n in sorted(arrays)])


@pytest.mark.parametrize("world", [2, 4], ids=["mesh2", "mesh2x2"])
def test_local_rows_exact_cover(job2, job4, world):
    """As the JAX test: every row lands exactly once in the data line's
    global batches (the label sum is the arange fingerprint, the weights
    sum to N, the global batch has 2 × B_LOCAL rows), each rank parsed
    only its own part (its rows staged are its part's), and each staged
    block is the bytes of the JAX producer's batch of that part. On
    (2, 2) the ranks of a model line stage the same bytes."""
    inp, ranks = job2 if world == 2 else job4
    n_model = world // 2
    want_sum = float(N_ROWS * (N_ROWS - 1) / 2)
    jparts = [jax_part_batches(str(inp["cover_rec"]), B_LOCAL, K, d, 2) for d in range(2)]
    assert [sum(int(b["weights"].sum()) for b in p) for p in jparts] == [N_ROWS // 2] * 2
    staged_rows = 0
    for r, res in enumerate(ranks):
        d = r // n_model
        assert res["part"].tolist() == [d, 2]
        sums = res["cover_sums"]
        assert sums[:, 0].sum() == want_sum and sums[:, 1].sum() == N_ROWS
        assert set(sums[:, 2].tolist()) == {2 * B_LOCAL}
        packed, puts, per_array, shard, padding, rows = res["cover_stats"].tolist()
        assert (packed, puts, per_array, shard, padding) == (2, 2, 0, 0, 0)
        assert rows == N_ROWS // 2
        if r % n_model == 0:
            staged_rows += rows
        want = np.stack([staged_bytes(b) for b in jparts[d]])
        assert res["cover_bytes"].tobytes() == want.tobytes(), r
        assert res["cover_bytes"].tobytes() == ranks[r - r % n_model]["cover_bytes"].tobytes()
    assert staged_rows == N_ROWS


def test_an_empty_part_yields_padding_laid_out_by_its_spec(job2):
    """Part 1 of a one-row file holds no batch: rank 1 yields one
    all-padding batch, laid out from its source's BatchSpec, while rank 0
    stages the row, and both stop after that step."""
    inp, ranks = job2
    (want,) = jax_part_batches(str(inp["empty_rec"]), 4, K, 0, 2)
    got0 = {n[len("empty_"):]: v for n, v in ranks[0].items() if n.startswith("empty_")
            and n not in ("empty_n", "empty_stats")}
    got1 = {n[len("empty_"):]: v for n, v in ranks[1].items() if n.startswith("empty_")
            and n not in ("empty_n", "empty_stats")}
    assert int(ranks[0]["empty_n"]) == int(ranks[1]["empty_n"]) == 1
    assert staged_bytes(got0).tobytes() == staged_bytes(want).tobytes()
    assert set(got1) == set(want)
    for n, v in want.items():
        assert got1[n].dtype == v.dtype and got1[n].shape == v.shape, n
        assert not got1[n].any(), n
    assert ranks[0]["empty_stats"].tolist() == [1, 1, 0, 0, 0, 1]
    assert ranks[1]["empty_stats"].tolist() == [0, 0, 0, 0, 1, 0]


def close(got, want, what, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7, err_msg=what)


def global_batches(uri):
    """The global batches as the ranks' blocks make them: part 0's batch
    i then part 1's, an all-zero (weight-0) block for a part that has
    ended."""
    parts = [jax_part_batches(uri, B_FM, K, d, 2) for d in range(2)]
    zero = {n: np.zeros_like(v) for n, v in parts[0][0].items()}
    steps = max(len(p) for p in parts)
    return [{n: np.concatenate([(p[i] if i < len(p) else zero)[n] for p in parts])
             for n in zero} for i in range(steps)], [len(p) for p in parts]


@pytest.mark.parametrize("tag", ["even", "uneven"])
def test_fm_step_on_local_rows_matches_jax(job4, tag):
    """The FM with ``v`` split over ``model`` on (2, 2), each rank
    stepping on its own block, equals the JAX ``data_parallel_step`` on
    the global batches in data order. On the uneven file part 0 is a
    batch longer: every rank takes the same 3 steps, the data line of
    part 1 yields one all-padding batch, and the result is the JAX step
    over the zero-weight-padded global batches."""
    inp, ranks = job4
    batches, lengths = global_batches(str(inp[f"{tag}_rec"]))
    assert lengths == ([4, 4] if tag == "even" else [3, 2])
    jmesh = jax_make_mesh((2, 2), ("data", "model"), devices=jax.devices("cpu")[:4])
    params = {n: inp[f"fm_{n}"] for n in ("w", "v", "b")}
    step = jax_dps(lambda p, b: JaxFM(D_FM, E_FM, l2=0.01).sgd_step(p, b, lr=LR), jmesh,
                   param_rules={"v": JP(None, "model")}, donate_params=False)
    losses = []
    for b in batches:
        params, loss = step(params, b)
        losses.append(float(loss))
    want = {n: np.asarray(v) for n, v in params.items()}
    for r, res in enumerate(ranks):
        assert len(res[f"{tag}_losses"]) == len(batches), r
        padding = max(lengths) - lengths[r // 2]
        packed, puts, per_array, shard, pad, _rows = res[f"{tag}_stats"].tolist()
        assert (packed, puts, per_array, shard, pad) == (lengths[r // 2],) * 2 + (0, 0, padding)
    close(ranks[0][f"{tag}_losses"], losses, f"{tag} losses")
    close(np.concatenate([ranks[m][f"{tag}_v"] for m in range(2)], axis=1), want["v"], "v")
    for n in ("w", "b"):
        close(ranks[0][f"{tag}_{n}"], want[n], n)
        for res in ranks[1:]:
            assert res[f"{tag}_{n}"].tobytes() == ranks[0][f"{tag}_{n}"].tobytes(), n
    for r, res in enumerate(ranks):
        assert res[f"{tag}_v"].tobytes() == ranks[r % 2][f"{tag}_v"].tobytes()


def test_process_shard_of_a_mesh():
    """``process_shard(mesh)`` is the data coordinate and the data axis's
    size: the ranks of a model line read the same part. The bare call
    keeps ``(rank, world)``."""
    grid = np.arange(4).reshape(2, 2)
    got = [process_shard(Mesh(grid, ("data", "model"), rank=r)) for r in range(4)]
    assert got == [(0, 2), (0, 2), (1, 2), (1, 2)]
    assert process_shard(Mesh(grid, ("data", "model"), rank=3), "model") == (1, 2)
    assert process_shard() == (0, 1)
    with pytest.raises(Error, match="not an axis"):
        process_shard(Mesh(grid, ("data", "model"), rank=0), "nope")


def test_stage_batch_local_rows_is_the_one_device_staging(tmp_path):
    """``stage_batch(batch, mesh=, local_rows=True)`` stages the whole
    batch on the mesh's device as one packed copy: the bytes of the
    one-device ``stage_batch`` and of the JAX one for the same batch; the
    pipeline's blocks are the same, and without a mesh it raises."""
    import torch

    uri = cover_rec(tmp_path)
    spec = BatchSpec(batch_size=B_LOCAL, max_nnz=K)
    meshes = [Mesh(np.arange(4).reshape(2, 2), ("data", "model"), rank=r, device="cpu")
              for r in range(4)]
    jspec = jst.BatchSpec(batch_size=B_LOCAL, layout="ell", max_nnz=K)
    cpu = jax.devices("cpu")[0]
    for part in range(2):
        stream = ell_batches(uri, spec, part_index=part, num_parts=2)
        jstream = jst.ell_batches(uri, jspec, part_index=part, num_parts=2)
        for pb, jb in zip(stream, jstream):
            want = {n: np.asarray(v) for n, v in jst.stage_batch(jb, device=cpu).items()}
            one = stage_batch(pb, device="cpu")
            for mesh in meshes:
                stats = StagingStats()
                got = stage_batch(pb, mesh=mesh, local_rows=True, stats=stats)
                assert set(got) == set(want) == set(one)
                for n in want:
                    assert got[n].dtype == one[n].dtype and got[n].shape == want[n].shape
                    assert got[n].numpy().tobytes() == want[n].tobytes() == \
                        one[n].numpy().tobytes()
                snap = stats.snapshot()
                assert (snap["packed_batches"], snap["device_puts"]) == (1, 1)
                assert not snap["packed_shard_dma"]
        stream.close()
        jstream.close()
        src = ell_batches(uri, spec, part_index=part, num_parts=2)
        pipe = StagingPipeline(src, mesh=meshes[2 * part], local_rows=True)
        got = [{n: t.numpy().copy() for n, t in b.items()} for b in pipe]
        st = pipe.staging_stats()
        assert drain_close(pipe, src)
        want = [{n: np.asarray(v) for n, v in jst.stage_batch(b, device=cpu).items()}
                for b in jst.ell_batches(uri, jspec, part_index=part, num_parts=2)]
        assert [staged_bytes(b).tobytes() for b in got] == \
            [staged_bytes(b).tobytes() for b in want]
        assert (st["packed_batches"], st["device_puts"], st["padding_batches"]) == (2, 2, 0)
    with pytest.raises(Error, match="needs mesh="):
        stage_batch(pb, device="cpu", local_rows=True)
    with pytest.raises(Error, match="needs mesh="):
        StagingPipeline([], device=torch.device("cpu"), local_rows=True)
