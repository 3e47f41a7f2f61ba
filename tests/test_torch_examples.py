"""The example ports (``dmlc_core_tpu_torch.examples``) on the CPU at small
sizes: their synthetic data equals the JAX examples' byte for byte, the
loss falls, a second run resumes from the checkpoint the first left
(criteo: from a mid-epoch position, ending on the same parameters as an
uninterrupted run, bit for bit, since both take the same batches in the
same order on the CPU), and multi-worker runs are refused."""

import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from dmlc_core_tpu_torch.checkpoint import Checkpointer
from dmlc_core_tpu_torch.examples import train_criteo_rec, train_higgs
from dmlc_core_tpu_torch.models import FactorizationMachine
from dmlc_core_tpu_torch.utils.logging import Error

REPO = Path(__file__).resolve().parent.parent


def jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def join_async_saves():
    for t in threading.enumerate():
        if t.name.startswith("ckpt-async"):
            t.join(30)


@pytest.mark.parametrize("name,rows", [("train_higgs", 500), ("train_criteo_rec", 700)])
def test_synthetic_data_matches_the_jax_examples(tmp_path, name, rows):
    port = {"train_higgs": train_higgs, "train_criteo_rec": train_criteo_rec}[name]
    port.synth(str(tmp_path / "port"), rows)
    jax_example(name).synth(str(tmp_path / "jax"), rows)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    if name == "train_criteo_rec":
        assert (tmp_path / "port.idx").read_bytes() == (tmp_path / "jax.idx").read_bytes()


def test_higgs_trains_and_resumes_on_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "higgs.libsvm")
    train_higgs.synth(path, rows=4000)
    monkeypatch.setenv("DMLC_SGD_EPOCHS", "2")
    first = train_higgs.main([path], device="cpu")
    assert first["epochs"] == [0, 1] and first["latest_step"] == 1
    assert first["losses"][1] < first["losses"][0]
    ck = Checkpointer(str(tmp_path / "higgs_ckpts_torch"))
    step, saved = ck.restore()
    assert step == 1
    for k, v in first["params"].items():
        np.testing.assert_array_equal(saved[k], v)
    monkeypatch.setenv("DMLC_SGD_EPOCHS", "3")
    second = train_higgs.main([path], device="cpu")
    assert second["epochs"] == [2] and second["latest_step"] == 2
    assert second["losses"][0] < first["losses"][0]


def test_criteo_resumes_mid_epoch_like_an_uninterrupted_run(tmp_path, monkeypatch):
    """5 full batches and a 300-row tail an epoch; the interrupted run
    dies at its 6th step, after the async save at step 4 (8192 records
    in), and the second run reads on from there."""
    rows = 5 * train_criteo_rec.B + 300
    monkeypatch.setenv("DMLC_SGD_EPOCHS", "2")
    for d in ("whole", "cut"):
        (tmp_path / d).mkdir()
        train_criteo_rec.synth(str(tmp_path / d / "c.rec"), rows)
    whole = train_criteo_rec.main([str(tmp_path / "whole" / "c.rec")], device="cpu")
    assert whole["gstep"] == 12 and whole["start_step"] is None
    losses = whole["losses"]
    assert np.mean(losses[-3:]) < np.mean(losses[:3])

    real = FactorizationMachine.sgd_step
    calls = []

    def dies_at_step_6(self, batch, lr=0.05):
        calls.append(1)
        if len(calls) == 6:
            raise KeyboardInterrupt("preempted")
        return real(self, batch, lr)

    monkeypatch.setattr(FactorizationMachine, "sgd_step", dies_at_step_6)
    with pytest.raises(KeyboardInterrupt):
        train_criteo_rec.main([str(tmp_path / "cut" / "c.rec")], device="cpu")
    join_async_saves()
    monkeypatch.setattr(FactorizationMachine, "sgd_step", real)
    resumed = train_criteo_rec.main([str(tmp_path / "cut" / "c.rec")], device="cpu")
    assert (resumed["start_step"], resumed["start_epoch"], resumed["skip"]) == \
        (4, 0, 4 * train_criteo_rec.B)
    assert resumed["gstep"] == 12
    np.testing.assert_array_equal(resumed["losses"], losses[4:])
    for k, v in whole["params"].items():
        np.testing.assert_array_equal(resumed["params"][k], v)
    # a third run starts after the last epoch and trains nothing
    again = train_criteo_rec.main([str(tmp_path / "cut" / "c.rec")], device="cpu")
    assert (again["start_step"], again["start_epoch"], again["losses"]) == (12, 2, [])


@pytest.mark.parametrize("env", [{"DMLC_NUM_WORKER": "2"},
                                 {"DMLC_TRACKER_URI": "127.0.0.1"}])
@pytest.mark.parametrize("mod", [train_higgs, train_criteo_rec])
def test_multi_worker_runs_are_refused(tmp_path, monkeypatch, mod, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(Error, match="ROADMAP.md §1 item 4"):
        mod.main([str(tmp_path / "data")], device="cpu")
    assert not (tmp_path / "data").exists()


@pytest.mark.parametrize("mod", [train_higgs, train_criteo_rec])
def test_examples_run_on_the_card_by_default(tmp_path, monkeypatch, mod):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(Error, match="torch.cuda.is_available"):
        mod.main([str(tmp_path / "data")])
