"""Whole runs of the harness on the CPU at a tiny size: a sound run is
correct, and each fault a cell can have, planted underneath the timed
path, turns ``correct`` false."""

import time

import pytest
import torch

from perfbench import run
from perfbench.tests import cells

FM_SMALL = {"config": {"num_features": 1 << 12, "train_rows": 1 << 14},
            "traffic": {"batch_size": 256, "block_rows": 1 << 12, "rotate_rows": 777,
                        "producer_batches": 8}}
SMALL = {
    "criteo_fm.rec_seq": FM_SMALL,
    "criteo_fm.libsvm": FM_SMALL,
    "higgs_lr.csv": {"config": {"train_rows": 1 << 14},
                     "traffic": {"batch_size": 512, "block_rows": 1 << 12,
                                 "rotate_rows": 1501, "producer_batches": 8}},
}
CELLS = sorted(SMALL)


def small_run(cell, trace=False, seed=2**31 + 99):
    c = cells.load(cell, SMALL[cell])
    return run.run_cell(c, seed, 0.5, trace, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = small_run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"rows_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["batch_mismatch"]["value"] == 0
    assert out["checks"]["batch_sum_mismatch"]["value"] == 0
    assert out["info"]["window_batches_summed"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(cell):
    out = small_run(cell, trace=True)
    assert out["correct"], out["checks"]
    # host-side readers find something on the CPU; device readers do not
    got = set(out["metrics"])
    assert {"wait_share", "producer_rows_per_s", "staging_host_ms", "step_host_ms"} <= got
    assert not any(k.startswith("roofline.") for k in got)
    assert "device_idle_share" not in got


def freeze(model):
    def step(batch, lr):
        return model.loss(batch).detach()

    model.sgd_step = step
    return model


def halve(model):
    orig = model.sgd_step

    def step(batch, lr):
        b = dict(batch)
        w = b["weights"].clone()
        w[w.shape[0] // 2:] = 0
        b["weights"] = w
        return orig(b, lr)

    model.sgd_step = step
    return model


class Altered:
    """A producer whose every batch has one value altered where it is
    produced (in the ring slot the pipeline stages from)."""

    def __init__(self, src):
        self.src = src
        self.ring_slots = getattr(src, "ring_slots", None)

    def __iter__(self):
        for b in self.src:
            if b.x is not None:
                b.x[0, 0] += 1.0
            else:
                b.indices[0, 0] ^= 1
            yield b

    def close(self):
        self.src.close()


class Late:
    """A producer sound through set-up's epoch that goes wrong in the
    window's epochs, where its ring has wrapped many times: ``altered``
    changes one value of every batch, ``stale`` hands every other batch
    the bytes of the one before it (a slot reused before its copy)."""

    opened = 0

    def __init__(self, src, fault):
        self.src, self.fault = src, fault
        self.ring_slots = getattr(src, "ring_slots", None)
        self.epoch = Late.opened
        Late.opened += 1

    def __iter__(self):
        prev = None
        for i, b in enumerate(self.src):
            arrays = {k: v for k, v in b.as_dict().items()}
            if self.epoch >= 1 and self.fault == "altered":
                if b.x is not None:
                    b.x[-1, -1] += 1.0
                else:
                    b.values[-1, -1] += 1.0
            elif self.epoch >= 1 and i % 2 == 1 and prev is not None:
                for k, v in arrays.items():
                    v[...] = prev[k]
            prev = {k: v.copy() for k, v in arrays.items()}
            yield b

    def close(self):
        self.src.close()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["altered", "stale"])
def test_a_fault_in_the_window_turns_correct_false(cell, fault, monkeypatch):
    c = cells.load(cell, SMALL[cell])
    import importlib

    adapter = importlib.import_module(f"perfbench.models.{c.config['model']}")
    orig = adapter.source
    Late.opened = 0
    monkeypatch.setattr(adapter, "source", lambda *a: Late(orig(*a), fault))
    out = small_run(cell)
    assert not out["correct"], out["checks"]
    assert out["info"]["window_batches_summed"] > 0
    failed = {k for k, v in out["checks"].items() if v["value"] > v["limit"]}
    # set-up was sound, so only the window's sums can see it
    assert failed == {"batch_sum_mismatch"}, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["frozen", "half", "altered"])
def test_a_fault_underneath_turns_correct_false(cell, fault, monkeypatch):
    c = cells.load(cell, SMALL[cell])
    import importlib

    adapter = importlib.import_module(f"perfbench.models.{c.config['model']}")
    if fault == "altered":
        orig = adapter.source
        monkeypatch.setattr(adapter, "source", lambda *a: Altered(orig(*a)))
    else:
        orig_build = adapter.build
        wrap = freeze if fault == "frozen" else halve
        monkeypatch.setattr(adapter, "build", lambda *a: wrap(orig_build(*a)))
    out = small_run(cell)
    assert not out["correct"], out["checks"]
    failed = {k for k, v in out["checks"].items() if v["value"] > v["limit"]}
    want = {"frozen": "change_gap", "half": "loss_gap", "altered": "batch_mismatch"}[fault]
    assert want in failed, out["checks"]


def test_batch_sums_match_on_both_sides_and_see_a_swap():
    import numpy as np

    from perfbench import reference

    rng = np.random.default_rng(4)
    want = {"indices": rng.integers(0, 1 << 20, (64, 39)).astype(np.int32),
            "values": rng.standard_normal((64, 39)).astype(np.float32),
            "labels": (rng.random(64) > 0.5).astype(np.float32),
            "weights": np.ones(64, np.float32)}
    log = run.BatchLog(want, 7, torch.device("cpu"))
    log.window = True

    class Always:
        def random(self):
            return 0.0  # keep every batch

    log.rng = Always()
    swapped = {k: v.copy() for k, v in want.items()}
    swapped["labels"][[3, 4]] = swapped["labels"][[4, 3]]
    if swapped["labels"][3] == want["labels"][3]:
        swapped["labels"][[3, 5]] = 1.0 - swapped["labels"][[3, 5]]
    wrong_type = dict(want, values=want["values"].astype(np.float64))
    for b in (want, swapped, wrong_type):
        log({k: torch.from_numpy(v) for k, v in b.items()}, 0)
    got = torch.stack(log.sums).numpy()
    assert np.array_equal(got[0], reference.batch_sums(want))
    assert not np.array_equal(got[1], got[0])
    assert got[2][log.names.index("values")] == run.BAD_SUM
