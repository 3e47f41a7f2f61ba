"""Port parity of the sharded checkpoints (``ckpt-<step>.d``): the port's
``save_pytree_sharded``/``load_pytree_sharded`` and ``Checkpointer`` with
``sharded=``/``process_count=``/``template=`` against the JAX package's.

- at world 1, ``MANIFEST.bin`` and ``shard-00000.bin`` are the bytes the
  JAX package writes for the same numpy weights on a 1-device mesh;
- a port ``.d`` from a 4-rank (2, 2) job is reassembled bit for bit by
  the JAX ``load_pytree_sharded``, and a JAX ``.d`` from a (4, 2) mesh
  restores into the port's (2, 2) ranks by template;
- the cases of ``tests/test_checkpoint_sharded.py:54-300`` (torn ``.d``
  invisible, debris pruned, same-step re-saves never shadowed, locally
  and on ``mem://``, async overlap and failure, a ``.bin`` restored by
  template);
- the resume of ``tests/test_checkpoint_sharded.py:477-552``: a 2-rank
  run saves at step 3 (sync and async), and restores on 1 and on 4
  ranks finish it with the straight run's losses (rel 1e-6: the data
  ranks' partial sums add in another order) from the saved params bit
  for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from dmlc_core_tpu.checkpoint import Checkpointer as JaxCheckpointer
from dmlc_core_tpu.checkpoint import load_pytree_sharded as jax_load_sharded
from dmlc_core_tpu.models import FactorizationMachine as JaxFM
from dmlc_core_tpu.parallel import make_mesh as jax_make_mesh
from dmlc_core_tpu_torch.checkpoint import (
    Checkpointer,
    load_pytree_sharded,
    save_pytree,
    save_pytree_sharded,
)
from dmlc_core_tpu_torch.io.filesystem import MemoryFileSystem
from dmlc_core_tpu_torch.parallel import P, make_mesh, place, shard_params
from dmlc_core_tpu_torch.utils.logging import Error
from test_torch_parallel import run_ranks

D, E, BATCH, K, N_STEPS, CKPT_STEP = 64, 8, 16, 4, 6, 3
RULES = {"v": P(None, "model")}


def fm_init():
    return {k: np.asarray(v) for k, v in JaxFM(D, E).init(jax.random.PRNGKey(0)).items()}


def mesh1():
    return make_mesh(device="cpu")


def same_tree(got, want):
    assert set(got) == set(want)
    for k in want:
        g = got[k].local.numpy() if hasattr(got[k], "local") else np.asarray(got[k])
        assert g.tobytes() == np.asarray(want[k]).tobytes(), k


# -- in one process ------------------------------------------------------------


def test_world1_files_are_jax_bytes(tmp_path):
    params = fm_init()
    jmesh = jax_make_mesh((1,), ("data",), devices=jax.devices("cpu")[:1])
    jtree = {k: jax.device_put(v, NamedSharding(jmesh, JP())) for k, v in params.items()}
    meta = {"epoch": 1, "records": 4096}
    JaxCheckpointer(str(tmp_path / "jax"), sharded=True).save(3, jtree, meta=meta)
    Checkpointer(str(tmp_path / "port"), sharded=True).save(3, shard_params(params, mesh1()),
                                                            meta=meta)
    for name in ("MANIFEST.bin", "shard-00000.bin"):
        a = (tmp_path / "jax" / "ckpt-0000000003.d" / name).read_bytes()
        b = (tmp_path / "port" / "ckpt-0000000003.d" / name).read_bytes()
        assert a == b, name
    assert sorted(os.listdir(tmp_path / "port" / "ckpt-0000000003.d")) == [
        "MANIFEST.bin", "shard-00000.bin"]


def test_sharded_without_template_returns_host(tmp_path):
    params = shard_params(fm_init(), mesh1())
    ck = Checkpointer(str(tmp_path / "ck"), sharded=True)
    ck.save(1, {"params": params, "step": 1, "note": "meta"})
    step, back = ck.restore()
    assert step == 1 and back["note"] == "meta" and back["step"] == 1
    assert isinstance(back["params"]["v"], np.ndarray)
    np.testing.assert_array_equal(back["params"]["v"], params["v"].local.numpy())
    # by template: Placed blocks on the template's mesh
    _, placed = ck.restore(template={"params": params})
    same_tree(placed["params"], {k: p.local.numpy() for k, p in params.items()})
    assert placed["params"]["v"].spec == P()


def test_torn_sharded_checkpoint_is_invisible(tmp_path):
    base = tmp_path / "ck"
    ck = Checkpointer(str(base), process_index=0)
    ck.save(3, {"w": np.ones(4, np.float32)})
    torn = base / "ckpt-0000000009.d"
    torn.mkdir(parents=True)
    save_pytree(str(torn / "shard-00000.bin"), {"proc": 0, "chunks": {}})
    assert ck.steps() == [3]
    assert ck.restore()[0] == 3


def test_process_local_tensors_dedupe_proc0_wins(tmp_path):
    """A plain tensor is each process's own copy: every process writes it
    whole, and the restore keeps process 0's, counted once."""
    base = str(tmp_path / "ck.d")
    for pid, fill in ((0, 1.0), (1, 2.0)):
        save_pytree_sharded(base, {"step_ctr": torch.full((4,), fill)}, pid, 2)
    back = load_pytree_sharded(base)
    np.testing.assert_array_equal(back["step_ctr"], np.full(4, 1.0))
    back = jax_load_sharded(base)  # the JAX package reads the port's files
    np.testing.assert_array_equal(back["step_ctr"], np.full(4, 1.0))


def test_prune_removes_torn_debris(tmp_path):
    base = tmp_path / "ck"
    ck = Checkpointer(str(base), keep=2, process_index=0)
    ck.save(1, {"w": np.ones(2, np.float32)})
    torn = base / "ckpt-0000000002.d"
    torn.mkdir()
    save_pytree(str(torn / "shard-00000.bin"), {"proc": 0, "chunks": {}})
    (base / "ckpt-0000000002.bin.tmp").write_bytes(b"junk")
    ck.save(3, {"w": np.ones(2, np.float32)})
    names = set(os.listdir(base))
    assert "ckpt-0000000002.d" not in names and "ckpt-0000000002.bin.tmp" not in names
    assert ck.steps() == [1, 3]


@pytest.mark.parametrize("base", ["local", "mem"])
def test_same_step_resave_never_shadowed(tmp_path, base):
    """Re-saving a step in the other layout invalidates the old one, both
    ways, and retention works across layouts, on a local base and on
    ``mem://`` (through ``FileSystem.delete``)."""
    MemoryFileSystem.reset()
    try:
        uri = str(tmp_path / "ck") if base == "local" else "mem://ck/run1"
        mesh = mesh1()
        legacy = Checkpointer(uri, keep=2, process_index=0)
        sharded = Checkpointer(uri, keep=2, sharded=True)
        sharded.save(5, {"w": place(np.zeros(8, np.float32), mesh)})
        legacy.save(5, {"w": np.ones(8, np.float32)})
        np.testing.assert_array_equal(legacy.restore()[1]["w"], np.ones(8))
        assert [i["layout"] for i in legacy.steps_info()] == ["single"]
        sharded.save(5, {"w": place(np.full(8, 2.0, np.float32), mesh)})
        np.testing.assert_array_equal(sharded.restore()[1]["w"], np.full(8, 2.0))
        assert [i["layout"] for i in sharded.steps_info()] == ["sharded"]
        if base == "local":
            assert not os.path.exists(tmp_path / "ck" / "ckpt-0000000005.bin")
        legacy.save(6, {"w": np.ones(8, np.float32)})
        for s in (7, 8):
            sharded.save(s, {"w": place(np.ones(8, np.float32), mesh)})
        assert sharded.steps() == [7, 8]
    finally:
        MemoryFileSystem.reset()


def test_legacy_restore_applies_template(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), process_index=0)
    w = np.arange(16, dtype=np.float32)
    ck.save(2, {"w": w})
    tmpl = {"w": place(np.zeros(16, np.float32), mesh1())}
    _, back = ck.restore(template=tmpl)
    assert back["w"].spec == tmpl["w"].spec and back["w"].shape == (16,)
    np.testing.assert_array_equal(back["w"].local.numpy(), w)
    _, back = ck.restore(template={"w": torch.zeros(16)})  # a tensor: a tensor back
    assert isinstance(back["w"], torch.Tensor) and back["w"].tolist() == w.tolist()


def test_async_save_overlaps_and_restores(tmp_path):
    """``save_async`` snapshots on the caller's thread, so the step may
    update the parameters in place at once; consecutive saves serialize
    and retention applies."""
    w = place(np.arange(64, dtype=np.float32).reshape(8, 8), mesh1())
    ck = Checkpointer(str(tmp_path / "ck"), sharded=True)
    handle = ck.save_async(4, {"w": w})
    w.local.add_(100.0)  # the next step, in place
    uri = handle.result(timeout=30)
    assert uri.endswith(".d") and handle.done()
    step, back = ck.restore()
    assert step == 4
    np.testing.assert_array_equal(back["w"], np.arange(64, dtype=np.float32).reshape(8, 8))
    for s in (5, 6, 7):
        ck.save_async(s, {"w": place(np.full((8, 8), s, np.float32), mesh1())}, meta={"s": s})
    ck.wait()
    assert ck.steps() == [5, 6, 7] and ck.restore_meta() == {"s": 7}


def test_async_save_snapshots_host_leaves(tmp_path):
    counter = np.zeros(4, np.float32)
    ck = Checkpointer(str(tmp_path / "ck"), process_index=0, sharded=False)
    handle = ck.save_async(1, {"counter": counter})
    counter += 99.0
    handle.result(timeout=30)
    np.testing.assert_array_equal(ck.restore()[1]["counter"], np.zeros(4))


def test_async_save_failure_surfaces(tmp_path):
    target = tmp_path / "blocked"
    target.write_text("a file where the checkpoint dir must go")
    for sharded in (False, True):
        ck = Checkpointer(str(target / "sub"), process_index=0, sharded=sharded)
        handle = ck.save_async(1, {"w": place(np.ones(3, np.float32), mesh1())})
        with pytest.raises((OSError, Error)):
            handle.result(timeout=30)


# -- across rank processes -------------------------------------------------------

COMMON = """
from dmlc_core_tpu_torch.checkpoint import Checkpointer
from dmlc_core_tpu_torch.models import FactorizationMachine
D, E, N_STEPS, CKPT_STEP = {D}, {E}, {N_STEPS}, {CKPT_STEP}
RULES = {{"v": P(None, "model")}}
batches = [{{k: IN[f"b{{s}}_{{k}}"] for k in ("indices", "values", "nnz", "labels", "weights")}}
           for s in range(N_STEPS)]

def fm(mesh):
    model = FactorizationMachine(D, E, device="cpu")
    place_model(model, mesh, RULES if "model" in mesh.shape else None)
    return model

def blocks(model, tag):
    for k, p in model.placed().items():
        res[f"{{tag}}_{{k}}"] = p.local.numpy().copy()
        res[f"{{tag}}_{{k}}_index"] = np.array([[s.start, s.stop] for s in p.index])
"""

STRAIGHT = """
mesh = make_mesh((1, 2), ("data", "model"))
model = fm(mesh)
model.load_placed(placed_from_jax({k: IN["p_" + k] for k in ("w", "v", "b")}, mesh, RULES))
step = data_parallel_step(lambda m, b: m.sgd_step(b, lr=0.1), mesh, "data", RULES)
losses = []
for i in range(N_STEPS):
    losses.append(float(step(model, shard_batch(batches[i], mesh))))
    if i + 1 == CKPT_STEP:
        blocks(model, "saved")
        uri = Checkpointer(os.path.join(OUT, "ck_sync")).save(i + 1, model.placed(),
                                                            meta={"records": 48})
        assert uri.endswith(".d"), uri
        handle = Checkpointer(os.path.join(OUT, "ck_async")).save_async(
            i + 1, model.placed(), meta={"records": 48})
uri = handle.result(timeout=60)
assert uri.endswith(".d"), uri
res["losses"] = np.array(losses)
"""

FOUR = """
mesh = make_mesh((2, 2), ("data", "model"))
# a JAX .d from a (4, 2) mesh, restored by template onto (2, 2)
model = fm(mesh)
step_no, tree = Checkpointer(os.path.join(OUT, "jax_ck")).restore(template=model.placed())
assert step_no == 7, step_no
for k, p in tree.items():
    res[f"jax_{{k}}"] = p.local.numpy().copy()
# the resume of the 2-rank run's step-3 save, sync and async layouts
for kind in ("sync", "async"):
    model = fm(mesh)
    ck = Checkpointer(os.path.join(IN_DIR, f"ck_{{kind}}"))
    step_no, tree = ck.restore(template=model.placed())
    assert step_no == CKPT_STEP and ck.restore_meta() == {{"records": 48}}
    model.load_placed(tree)
    blocks(model, f"restored_{{kind}}")
    step = data_parallel_step(lambda m, b: m.sgd_step(b, lr=0.1), mesh, "data", RULES)
    res[f"losses_{{kind}}"] = np.array([float(step(model, shard_batch(batches[i], mesh)))
                                       for i in range(CKPT_STEP, N_STEPS)])
# this run's own .d: an async save overlapping a step's collectives, then sync
out = Checkpointer(os.path.join(OUT, "port_ck"))
handle = out.save_async(8, model.placed(), meta={{"from": "port"}})
step(model, shard_batch(batches[0], mesh))
handle.result(timeout=60)
out.save(9, model.placed())
blocks(model, "final")
"""


def batch_inputs():
    rng = np.random.default_rng(42)
    out = {}
    for s in range(N_STEPS):
        b = {"indices": rng.integers(0, D, (BATCH, K)).astype(np.int32),
             "values": rng.normal(size=(BATCH, K)).astype(np.float32),
             "nnz": np.full(BATCH, K, np.int32),
             "labels": rng.integers(0, 2, BATCH).astype(np.float32),
             "weights": np.ones(BATCH, np.float32)}
        out.update({f"b{s}_{k}": v for k, v in b.items()})
    out.update({f"p_{k}": v for k, v in fm_init().items()})
    return out


def assemble(ranks, tag, name, shape):
    out = np.empty(shape, np.float32)
    for r in ranks:
        out[tuple(slice(a, b) for a, b in r[f"{tag}_{name}_index"])] = r[f"{tag}_{name}"]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The straight 2-rank run with its step-3 saves, then the 4-rank job
    that restores them (and a JAX (4, 2) ``.d``) and writes its own."""
    fmt = dict(D=D, E=E, N_STEPS=N_STEPS, CKPT_STEP=CKPT_STEP)
    inp = batch_inputs()
    d2 = tmp_path_factory.mktemp("two")
    np.savez(d2 / "inputs.npz", **inp)
    two = run_ranks(d2, COMMON.format(**fmt) + STRAIGHT, 2, "straight")
    d4 = tmp_path_factory.mktemp("four")
    np.savez(d4 / "inputs.npz", **inp)
    jmesh = jax_make_mesh((4, 2), ("data", "model"), devices=jax.devices("cpu"))
    jparams = {k: jax.device_put(v, NamedSharding(jmesh, JP(None, "model") if k == "v" else JP()))
               for k, v in fm_init().items()}
    JaxCheckpointer(str(d4 / "jax_ck"), sharded=True).save(7, jparams)
    four = run_ranks(d4, f"IN_DIR = {str(d2)!r}\n" + COMMON.format(**fmt) + FOUR.format(), 4,
                     "four")
    return inp, d2, two, d4, four


def test_jax_reads_the_port_4_rank_checkpoint(runs):
    """A port ``.d`` from a (2, 2) job (4 shard files, the manifest, the
    async one with its meta) reassembles bit for bit in the JAX package."""
    _, _, _, d4, four = runs
    want = {k: assemble(four, "final", k, s) for k, s in (("w", (D,)), ("v", (D, E)), ("b", ()))}
    for step_dir in ("ckpt-0000000008.d", "ckpt-0000000009.d"):
        d = d4 / "port_ck" / step_dir
        assert sorted(os.listdir(d)) == ["MANIFEST.bin"] + [f"shard-{r:05d}.bin" for r in range(4)]
    got = jax_load_sharded(str(d4 / "port_ck" / "ckpt-0000000009.d"))
    for k in want:
        assert np.asarray(got[k]).tobytes() == want[k].tobytes(), k
    jck = JaxCheckpointer(str(d4 / "port_ck"))
    assert jck.steps() == [8, 9] and jck.restore_meta(8) == {"from": "port"}


def test_port_restores_a_jax_4x2_checkpoint_onto_2x2(runs):
    """A JAX ``.d`` saved from a (4, 2) mesh restores into the port's
    (2, 2) ranks by template: each rank's block of the JAX params."""
    _, _, _, _, four = runs
    params = fm_init()
    for r, rank in enumerate(four):
        m = r % 2
        np.testing.assert_array_equal(rank["jax_v"], params["v"][:, m * E // 2:(m + 1) * E // 2])
        np.testing.assert_array_equal(rank["jax_w"], params["w"])
        np.testing.assert_array_equal(rank["jax_b"], params["b"])


def _straight_losses(two):
    for r in two[1:]:
        assert r["losses"].tobytes() == two[0]["losses"].tobytes()
    return two[0]["losses"]


def _resume_one(d2, kind):
    """The 2-rank run's step-3 save restored in this process (a world of
    one) and run to the end: (saved params, restored params, losses)."""
    from dmlc_core_tpu_torch.models import FactorizationMachine
    from dmlc_core_tpu_torch.parallel import data_parallel_step, place_model, shard_batch

    inp = dict(np.load(d2 / "inputs.npz"))
    mesh = mesh1()
    model = FactorizationMachine(D, E, device="cpu")
    place_model(model, mesh)
    ck = Checkpointer(str(d2 / f"ck_{kind}"))
    step_no, tree = ck.restore(template=model.placed())
    assert step_no == CKPT_STEP and ck.restore_meta() == {"records": 48}
    model.load_placed(tree)
    restored = {k: p.detach().numpy().copy() for k, p in model.params().items()}
    step = data_parallel_step(lambda m, b: m.sgd_step(b, lr=0.1), mesh)
    losses = []
    for i in range(CKPT_STEP, N_STEPS):
        b = {k: inp[f"b{i}_{k}"] for k in ("indices", "values", "nnz", "labels", "weights")}
        losses.append(float(step(model, shard_batch(b, mesh))))
    return restored, np.array(losses)


@pytest.mark.parametrize("kind", ["sync", "async"])
@pytest.mark.parametrize("n", [1, 4])
def test_resume_across_rank_counts(runs, n, kind):
    """Saved at step 3 by 2 ranks ((1, 2), ``v`` split), restored by 1 rank
    and by 4 ((2, 2)): the restored params are the saved ones bit for
    bit, and the rest of the run has the straight run's losses."""
    _, d2, two, _, four = runs
    straight = _straight_losses(two)
    saved = {k: assemble(two, "saved", k, s) for k, s in (("w", (D,)), ("v", (D, E)), ("b", ()))}
    if n == 1:
        restored, losses = _resume_one(d2, kind)
    else:
        restored = {k: assemble(four, f"restored_{kind}", k, s)
                    for k, s in (("w", (D,)), ("v", (D, E)), ("b", ()))}
        losses = four[0][f"losses_{kind}"]
        for r in four[1:]:
            assert r[f"losses_{kind}"].tobytes() == losses.tobytes()
    for k in saved:
        assert restored[k].tobytes() == saved[k].tobytes(), k
    np.testing.assert_allclose(losses, straight[CKPT_STEP:], rtol=1e-6)
    files = sorted(os.listdir(d2 / f"ck_{kind}" / "ckpt-0000000003.d"))
    assert files == ["MANIFEST.bin", "shard-00000.bin", "shard-00001.bin"]


RESAVE_DELAY = 1.0

RESAVE = """
import time
import torch.distributed as dist
from dmlc_core_tpu_torch.checkpoint import Checkpointer, load_pytree_sharded, save_pytree_sharded
from dmlc_core_tpu_torch.parallel import shard_params

mesh = make_mesh((1, 2), ("data", "model"))
d = {"raw": os.path.join(OUT, "raw.d"), "sync": os.path.join(OUT, "sync"),
     "async": os.path.join(OUT, "async")}
saves = {
    "raw": lambda tree: save_pytree_sharded(d["raw"], tree),
    # a new Checkpointer for each save, into the same step's .d
    "sync": lambda tree: Checkpointer(d["sync"]).save(5, tree),
    "async": lambda tree: Checkpointer(d["async"]).save_async(5, tree).result(timeout=60),
}
for kind, save in saves.items():
    for rnd in (1, 2):
        tree = shard_params({"v": np.full((4, 4), rnd, np.float32)}, mesh,
                            {"v": P(None, "model")})
        if rnd == 2 and rank == 1:
            time.sleep(%r)  # this rank comes late to the re-save
        res[f"{kind}{rnd}_start"] = np.float64(time.time())
        save(tree)
        res[f"{kind}{rnd}_end"] = np.float64(time.time())
        got = (load_pytree_sharded(d["raw"]) if kind == "raw"
               else Checkpointer(d[kind]).restore()[1])
        res[f"{kind}{rnd}_seen"] = np.asarray(got["v"])
        dist.barrier()  # every rank has read before the next save clears the .d
""" % RESAVE_DELAY


@pytest.mark.parametrize("kind", ["raw", "sync", "async"])
def test_resave_into_the_same_dir_waits_for_every_rank(tmp_path_factory, kind):
    """Two ranks save a sharded tree twice into the same ``.d`` (through
    ``save_pytree_sharded``, and through a new ``Checkpointer`` for each
    sync or async save), rank 1 coming late to the second save: no rank
    returns from it before rank 1 began it, each then restores only the
    second tree, and the manifest is no older than rank 1's new shard."""
    out = _resave_run(tmp_path_factory)
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    late_start = float(ranks[1][f"{kind}2_start"])
    for r, rank in enumerate(ranks):
        assert float(rank[f"{kind}2_end"]) >= late_start, f"rank {r} did not wait"
        for rnd in (1, 2):
            np.testing.assert_array_equal(rank[f"{kind}{rnd}_seen"],
                                          np.full((4, 4), rnd, np.float32))
    d = out / "raw.d" if kind == "raw" else out / kind / "ckpt-0000000005.d"
    assert sorted(os.listdir(d)) == ["MANIFEST.bin", "shard-00000.bin", "shard-00001.bin"]
    assert (d / "MANIFEST.bin").stat().st_mtime_ns >= (d / "shard-00001.bin").stat().st_mtime_ns


_RESAVE_OUT = {}


def _resave_run(tmp_path_factory):
    """The 2-rank re-save job, run once for the three kinds."""
    if "out" not in _RESAVE_OUT:
        out = tmp_path_factory.mktemp("resave")
        run_ranks(out, RESAVE, 2, "resave")
        _RESAVE_OUT["out"] = out
    return _RESAVE_OUT["out"]
