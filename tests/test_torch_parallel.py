"""Port parity of ``parallel/``: the port's meshes and data-parallel steps
in gloo rank processes on the CPU against the JAX package's
``data_parallel_step`` on the conftest's 8-device CPU mesh, and the
port's ``dryrun_multichip`` against the JAX one.

Each spawned job runs its ranks as processes of their own (one
``torch`` import each, so the cases share few jobs), meeting through a
``FileStore`` under ``tmp_path``; every process is joined with a timeout.
Tolerances: losses rel 1e-5, params rtol 1e-5 (``tests/test_models.py``'s
mesh cases); the ranks that hold the same block bit for bit.
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

import __graft_entry__ as jax_entry
from dmlc_core_tpu.models import FactorizationMachine as JaxFM
from dmlc_core_tpu.models import LogisticRegression as JaxLR
from dmlc_core_tpu.parallel import data_parallel_step as jax_dps
from dmlc_core_tpu.parallel import make_mesh as jax_make_mesh
from dmlc_core_tpu_torch.entry import dryrun_multichip
from dmlc_core_tpu_torch.parallel import Mesh, P, make_mesh, process_shard
from dmlc_core_tpu_torch.utils.logging import Error

REPO = Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 120

PRELUDE = """
import json, os, sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from dmlc_core_tpu_torch.parallel import (
    P, data_parallel_step, destroy_process_group, init_process_group, make_mesh,
    place_model, shard_batch)
from dmlc_core_tpu_torch.convert import placed_from_jax
from dmlc_core_tpu_torch.utils.logging import Error

rank, world = init_process_group(rank=int(sys.argv[1]), world=int(sys.argv[2]),
                                 device="cpu", init_method="file://" + sys.argv[3])
OUT = sys.argv[4]
IN = dict(np.load(os.path.join(OUT, "inputs.npz"))) if os.path.exists(
    os.path.join(OUT, "inputs.npz")) else {{}}
res = {{}}
"""

EPILOGUE = """
np.savez(os.path.join(OUT, f"rank{rank}.npz"), **res)
destroy_process_group()
"""


def run_ranks(out: Path, body: str, n: int, name: str = "job"):
    """Run ``body`` in ``n`` gloo rank processes (CPU) with ``rank``,
    ``world``, ``OUT`` (``out``), ``IN`` (``out/inputs.npz``) and a
    ``res`` dict that each rank saves to ``out/rank<r>.npz``; returns the
    ranks' dicts."""
    out.mkdir(parents=True, exist_ok=True)
    script = out / f"{name}.py"
    script.write_text(PRELUDE.format(repo=str(REPO)) + textwrap.dedent(body) + EPILOGUE)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(n),
                               str(out / f"{name}.pg"), str(out)],
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
        assert p.returncode == 0, f"{name} rank {r} failed:\n{o[-3000:]}\n{e[-3000:]}"
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]


def close(got, want, what, rtol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7, err_msg=what)


# -- inputs -------------------------------------------------------------------

D_LR, D_FM, E_FM, BATCH, K, STEPS = 32, 32, 8, 32, 6, 3


def ell_batch(rng, d, weights=None):
    idx = np.stack([rng.choice(d, size=K, replace=False) for _ in range(BATCH)]).astype(np.int32)
    val = rng.normal(size=(BATCH, K)).astype(np.float32)
    return {"indices": idx, "values": val, "nnz": np.full(BATCH, K, np.int32),
            "labels": rng.integers(0, 2, BATCH).astype(np.float32),
            "weights": np.ones(BATCH, np.float32) if weights is None else weights}


def tail_weights(n_data):
    """A tail batch's weights: the valid rows end partway through data
    shard 1 of ``n_data``, so the data ranks get 0 to all of their rows
    as weight-0 padding, each a different number."""
    w = np.zeros(BATCH, np.float32)
    w[: BATCH // n_data + 3] = 1.0
    return w


def inputs():
    rng = np.random.default_rng(11)
    lr = {k: np.asarray(v) for k, v in JaxLR(D_LR).init(jax.random.PRNGKey(1)).items()}
    fm = {k: np.asarray(v) for k, v in JaxFM(D_FM, E_FM, l2=0.01).init(jax.random.PRNGKey(2)).items()}
    out = {f"lr_{k}": v for k, v in lr.items()}
    out.update({f"fm_{k}": v for k, v in fm.items()})
    for s in range(STEPS):
        for key, d in (("lr", D_LR), ("fm", D_FM)):
            for k, v in ell_batch(rng, d).items():
                out[f"{key}_batch{s}_{k}"] = v
    for key, d, n in (("lrtail", D_LR, 4), ("fmtail", D_FM, 2)):
        for k, v in ell_batch(rng, d, tail_weights(n)).items():
            out[f"{key}_{k}"] = v
    return out


def batch_of(inp, key):
    return {k[len(key) + 1:]: v for k, v in inp.items() if k.startswith(key + "_")
            and k[len(key) + 1:] in ("indices", "values", "nnz", "labels", "weights")}


def jax_run(model, params, batches, mesh, rules, lr):
    step = jax_dps(lambda p, b: model.sgd_step(p, b, lr=lr), mesh, param_rules=rules,
                   donate_params=False)
    losses = []
    for b in batches:
        params, loss = step(params, b)
        losses.append(float(loss))
    return {k: np.asarray(v) for k, v in params.items()}, losses


JOB = """
# mesh shapes and errors at world 4
res["mesh_default"] = np.array(list(make_mesh(device="cpu").shape.values()))
res["mesh_fill"] = np.array(list(make_mesh((2, -1), ("data", "model")).shape.values()))
try:
    make_mesh((3, 2), ("data", "model"))
    res["mesh_error"] = np.array("none")
except Error as e:
    res["mesh_error"] = np.array(str(e))

def run(model_cls, key, shape, axes, rules, lr, batches, **kw):
    mesh = make_mesh(shape, axes)
    model = model_cls(*kw.pop("dims"), device="cpu", **kw)
    place_model(model, mesh, rules)
    model.load_placed(placed_from_jax(
        {k[len(key) + 1:]: IN[k] for k in IN if k.startswith(key + "_") and "_batch" not in k
         and k.count("_") == 1}, mesh, rules))
    step = data_parallel_step(lambda m, b: m.sgd_step(b, lr=lr), mesh, "data", rules)
    losses = [float(step(model, shard_batch(b, mesh))) for b in batches]
    return model, losses

def batch(prefix):
    return {k: IN[f"{prefix}_{k}"] for k in ("indices", "values", "nnz", "labels", "weights")}

from dmlc_core_tpu_torch.models import FactorizationMachine, LogisticRegression
lr_batches = [batch(f"lr_batch{s}") for s in range(STEPS)]
fm_batches = [batch(f"fm_batch{s}") for s in range(STEPS)]
tp = {"v": P(None, "model")}
for tag, model_cls, key, shape, axes, rules, lr, batches, kw in (
        ("lr", LogisticRegression, "lr", (world,), ("data",), None, 0.5, lr_batches,
         {"dims": (D_LR,)}),
        ("lrtail", LogisticRegression, "lr", (world,), ("data",), None, 0.5,
         [batch("lrtail")], {"dims": (D_LR,)}),
        ("fm", FactorizationMachine, "fm", (world // 2, 2), ("data", "model"), tp, 0.1,
         fm_batches, {"dims": (D_FM, E_FM), "l2": 0.01}),
        ("fmtail", FactorizationMachine, "fm", (world // 2, 2), ("data", "model"), tp, 0.1,
         [batch("fmtail")], {"dims": (D_FM, E_FM), "l2": 0.01})):
    if world == 2 and not tag.startswith("fm"):
        continue
    model, losses = run(model_cls, key, shape, axes, rules, lr, batches, **kw)
    res[f"{tag}_losses"] = np.array(losses)
    for k, p in model.params().items():
        res[f"{tag}_{k}"] = p.detach().numpy()
"""


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The 4-rank job ((4,) and (2, 2) meshes) and the 2-rank job ((1, 2)
    mesh), on the same inputs."""
    inp = inputs()
    body = f"STEPS, D_LR, D_FM, E_FM = {STEPS}, {D_LR}, {D_FM}, {E_FM}\n" + JOB
    out = {}
    for n in (4, 2):
        d = tmp_path_factory.mktemp(f"ranks{n}")
        np.savez(d / "inputs.npz", **inp)
        out[n] = run_ranks(d, body, n, name=f"parallel{n}")
    return inp, out


def test_make_mesh_shapes_and_errors(jobs):
    """As ``tests/test_models.py:140``: the default mesh is every rank on
    ``data``, -1 takes the rest, a shape that does not cover the world
    raises with the JAX text."""
    _, out = jobs
    for r in out[4]:
        assert r["mesh_default"].tolist() == [4]
        assert r["mesh_fill"].tolist() == [2, 2]
        assert "mesh shape (3, 2) != 4 devices" in str(r["mesh_error"])
    mesh = make_mesh(device="cpu")  # outside a world: one rank, no groups
    assert mesh.shape == {"data": 1} and process_shard() == (0, 1)
    assert mesh.group(("data",)) is None
    with pytest.raises(Error, match=r"mesh shape \(2,\) != 1 devices"):
        make_mesh((2,), device="cpu")
    with pytest.raises(Error, match="length mismatch"):
        make_mesh((1, 1), ("data",), device="cpu")


def test_nccl_refuses_ranks_that_share_a_card(monkeypatch, tmp_path):
    """Two ranks of one host and one card: NCCL is refused by name before
    any init, and nothing falls back to gloo on its own."""
    import socket

    import torch
    import torch.distributed as dist

    from dmlc_core_tpu_torch.parallel import init_process_group

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    store = dist.FileStore(str(tmp_path / "pg"), 2)
    store.set("dmlc_host/1", socket.gethostname())  # the other rank, on this host
    with pytest.raises(Error, match="pass backend='gloo'"):
        init_process_group(rank=0, world=2, init_method=f"file://{tmp_path / 'pg'}")
    assert not dist.is_initialized()


def test_mesh_coordinates_and_placement():
    """A rank's coordinates, lines and blocks on a (2, 2) grid, with the
    JAX shards' ``index`` and ``replica_id`` for the same placements."""
    from jax.sharding import NamedSharding

    from dmlc_core_tpu_torch.parallel import place

    grid = np.arange(4).reshape(2, 2)
    jmesh = jax_make_mesh((2, 2), ("data", "model"), devices=jax.devices("cpu")[:4])
    x = np.arange(64, dtype=np.float32).reshape(4, 16)
    for spec in (P(), P(None, "model"), P("data"), P("data", "model")):
        jarr = jax.device_put(x, NamedSharding(jmesh, JP(*spec)))
        shards = {s.device.id: s for s in jarr.addressable_shards}
        for r in range(4):
            mesh = Mesh(grid, ("data", "model"), rank=r)
            assert mesh.coords == {"data": r // 2, "model": r % 2}
            blk = place(x, mesh, spec)
            dev = jmesh.devices.flat[r].id
            assert blk.replica_id == shards[dev].replica_id, (spec, r)
            assert [(s.start, s.stop) for s in blk.index] == [
                (s.start or 0, x.shape[i] if s.stop is None else s.stop)
                for i, s in enumerate(shards[dev].index)], (spec, r)
            np.testing.assert_array_equal(blk.local.numpy(), np.asarray(shards[dev].data))
    with pytest.raises(Error, match="does not split"):
        place(np.zeros((4, 15), np.float32), Mesh(grid, ("data", "model"), rank=0),
              P(None, "model"))


def test_lr_data_parallel_step_matches_jax(jobs):
    """LR ``data_parallel_step`` on a (4,) mesh equals the JAX one on
    ``make_mesh((4,), devices=cpu[:4])``, step by step; every rank holds
    the same bits."""
    inp, out = jobs
    mesh = jax_make_mesh((4,), ("data",), devices=jax.devices("cpu")[:4])
    params = {"w": inp["lr_w"], "b": inp["lr_b"]}
    batches = [batch_of(inp, f"lr_batch{s}") for s in range(STEPS)]
    want, losses = jax_run(JaxLR(D_LR), params, batches, mesh, None, 0.5)
    ranks = out[4]
    close(ranks[0]["lr_losses"], losses, "losses")
    for k in ("w", "b"):
        close(ranks[0][f"lr_{k}"], want[k], k)
        for r in ranks[1:]:
            assert r[f"lr_{k}"].tobytes() == ranks[0][f"lr_{k}"].tobytes(), k


def _fm_check(ranks, want, losses, tag, n_model=2):
    close(ranks[0][f"{tag}_losses"], losses, f"{tag} losses")
    v = np.concatenate([ranks[m][f"{tag}_v"] for m in range(n_model)], axis=1)
    close(v, want["v"], f"{tag} v")
    for k in ("w", "b"):
        close(ranks[0][f"{tag}_{k}"], want[k], f"{tag} {k}")
        for r in ranks[1:]:  # w and b replicated on every rank
            assert r[f"{tag}_{k}"].tobytes() == ranks[0][f"{tag}_{k}"].tobytes(), k
    for r, rank in enumerate(ranks):  # v's block the same down a data line
        assert rank[f"{tag}_v"].tobytes() == ranks[r % n_model][f"{tag}_v"].tobytes()
        assert rank[f"{tag}_v"].shape == (D_FM, E_FM // n_model)


@pytest.mark.parametrize("n", [4, 2], ids=["mesh2x2", "mesh1x2"])
def test_tensor_parallel_fm_matches_jax(jobs, n):
    """The FM with ``v`` split by columns over ``model`` (each rank a
    contiguous [D, E/2] block), l2 on, on (2, 2) and (1, 2) meshes, equals
    the JAX step with ``{"v": P(None, "model")}`` on a (2, 2) mesh."""
    inp, out = jobs
    mesh = jax_make_mesh((2, 2), ("data", "model"), devices=jax.devices("cpu")[:4])
    params = {k: inp[f"fm_{k}"] for k in ("w", "v", "b")}
    batches = [batch_of(inp, f"fm_batch{s}") for s in range(STEPS)]
    want, losses = jax_run(JaxFM(D_FM, E_FM, l2=0.01), params, batches, mesh,
                           {"v": JP(None, "model")}, 0.1)
    _fm_check(out[n], want, losses, "fm")


def _local_mean_update(model_cls, dims, params, batch, n_data, lr, **kw):
    """What averaging each data shard's own weighted mean would give: the
    mean of the shards' gradients, applied once (the rule the port must
    not follow)."""
    import torch

    from dmlc_core_tpu_torch.convert import params_from_jax

    grads = []
    rows = BATCH // n_data
    for d in range(n_data):
        model = model_cls(*dims, device="cpu", **kw)
        model.load_state_dict(params_from_jax(params, "cpu"))
        local = {k: torch.from_numpy(v[d * rows:(d + 1) * rows]) for k, v in batch.items()}
        grads.append(model.loss_and_grads(local)[1])
    return {k: params[k] - lr * np.mean([g[k].numpy() for g in grads], axis=0)
            for k in params}


def test_tail_batch_with_uneven_padding_matches_jax(jobs):
    """A tail batch whose weight-0 padding falls unevenly on the data
    ranks (all, some and none of a rank's rows) equals JAX on LR (4,) and
    the FM (2, 2) and (1, 2): the loss is the global weighted mean. An
    average of the ranks' local means gives another update, which fails
    the same comparison."""
    inp, out = jobs
    cases = (
        ("lrtail", JaxLR(D_LR), ("w", "b"), None, 0.5, 4, (4,), ("data",)),
        ("fmtail", JaxFM(D_FM, E_FM, l2=0.01), ("w", "v", "b"), {"v": JP(None, "model")},
         0.1, 2, (2, 2), ("data", "model")),
    )
    from dmlc_core_tpu_torch.models import FactorizationMachine, LogisticRegression

    for tag, jmodel, names, rules, lr, n_data, shape, axes in cases:
        key = tag[:2]
        params = {k: inp[f"{key}_{k}"] for k in names}
        batch = batch_of(inp, tag)
        mesh = jax_make_mesh(shape, axes, devices=jax.devices("cpu")[:int(np.prod(shape))])
        want, losses = jax_run(jmodel, params, [batch], mesh, rules, lr)
        if key == "lr":
            ranks = out[4]
            close(ranks[0]["lrtail_losses"], losses, "lr tail loss")
            for k in names:
                close(ranks[0][f"lrtail_{k}"], want[k], f"lr tail {k}")
            wrong = _local_mean_update(LogisticRegression, (D_LR,), params, batch, n_data, lr)
        else:
            for n in (4, 2):
                _fm_check(out[n], want, losses, "fmtail")
            wrong = _local_mean_update(FactorizationMachine, (D_FM, E_FM), params, batch,
                                       n_data, lr, l2=0.01)
        with pytest.raises(AssertionError):
            close(wrong["w"], want["w"], f"{tag}: local means")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_matches_jax(n, capsys):
    """The port's ``dryrun_multichip(n)`` (gloo rank processes through
    the port's launcher, rowrec → mesh staging → step → sharded save and
    templated restore) from the JAX init reports the JAX run's mesh,
    steps, loss and transfer counters."""
    jax_entry.dryrun_multichip(n)
    line = [x for x in capsys.readouterr().out.splitlines()
            if x.startswith("dryrun_multichip report: ")][-1]
    import json

    want = json.loads(line[len("dryrun_multichip report: "):])
    init = {k: np.asarray(v) for k, v in JaxFM(64, 8).init(jax.random.PRNGKey(0)).items()}
    got = dryrun_multichip(n, "cpu", init=init)
    for key in ("ok", "mesh", "steps", "packed_shard_dma", "packed_shard_batches",
                "device_puts"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert got["loss"] == pytest.approx(want["loss"], abs=1.5e-4)
    assert sorted(got["puts_per_device"].values()) == sorted(want["puts_per_device"].values())
    assert got["backend"] == "gloo" and got["foreign_modules"] == []
