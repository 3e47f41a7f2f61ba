"""The byte and FLOP counts behind ``step_mfu`` and the rooflines, and
``u``, on small shapes."""

import numpy as np
import pytest

from perfbench import run


def metric(name):
    return run.load_metric(name)


def test_u_counts_distinct_ids_per_batch():
    idx = np.array([[1, 2], [2, 3], [5, 5], [5, 6]])
    # batches of 2 rows: {1,2,3} and {5,6}
    assert run.distinct_ids(idx, 2) == 2.5
    assert run.distinct_ids(idx, 4) == 5.0


def test_fm_step_counts():
    m = metric("step_mfu")
    b, k, e, u = 2, 3, 4, 5
    nbytes, flops = m.fm_work(b, k, e, u)
    # the batch (ids and values, labels and weights), u rows of w and v
    # read and written, b read and written
    assert nbytes == b * k * 8 + b * 8 + 2 * u * (1 + e) * 4 + 8
    fwd = 2 * b * k + 4 * b * k * e + 3 * b * e + m.LOSS_FLOPS_FWD * b
    bwd = 2 * b * k + 5 * b * k * e + m.LOSS_FLOPS_BWD * b
    assert flops == fwd + bwd + 2 * u * (1 + e) + 2


def test_lr_step_counts():
    m = metric("step_mfu")
    nbytes, flops = m.lr_work(4, 3)
    assert nbytes == 4 * 3 * 4 + 4 * 8 + 2 * 3 * 4 + 8
    assert flops == 4 * 4 * 3 + (m.LOSS_FLOPS_FWD + m.LOSS_FLOPS_BWD) * 4 + 2 * 3 + 2


@pytest.mark.parametrize("name,want", [
    ("roofline.ell_matvec_fwd", (2 * 3 * 8 + 5 * 4 + 2 * 4, 2 * 2 * 3)),
    ("roofline.ell_matvec_bwd", (2 * 3 * 8 + 2 * 4 + 5 * 4, 2 * 2 * 3)),
    ("roofline.fm_pair_fwd", (2 * 3 * 8 + 5 * 4 * 4 + 2 * 4 + 2 * 4 * 4, 4 * 2 * 3 * 4 + 3 * 2 * 4)),
    ("roofline.fm_pair_bwd", (2 * 3 * 8 + 2 * 4 + 2 * 4 * 4 + 2 * 5 * 4 * 4, 5 * 2 * 3 * 4)),
])
def test_kernel_counts_reckon_u_rows_not_d(name, want):
    m = metric(name)
    assert m.work(2, 3, 4, 5) == want
    # the table's size never enters: only u
    assert m.work(2, 3, 4, 5) != m.work(2, 3, 4, 6)


def test_roofline_share_from_a_trace():
    from perfbench.trace import Capture

    # two launches of K2 (tile + flush), 3 us each in all, inside the
    # window the spans make
    ev = [{"ph": "X", "name": "perfbench:sgd_step", "ts": 0.0, "dur": 100.0}]
    for t in (10.0, 50.0):
        ev.append({"ph": "X", "cat": "kernel", "name": "void ell_matvec_bwd_kernel<float>", "ts": t,
                   "dur": 2.0})
        ev.append({"ph": "X", "cat": "kernel", "name": "ell_matvec_bwd_flush_kernel(x)",
                   "ts": t + 2, "dur": 1.0})
    cap = Capture(ev)
    secs, events = cap.kernel(metric("roofline.ell_matvec_bwd").PARTS)
    assert events == 2 and abs(secs - 6e-6) < 1e-12
    assert abs(cap.busy_s - 6e-6) < 1e-12 and abs(cap.window_s - 1e-4) < 1e-12
    gaps = cap.gaps()
    assert len(gaps) == 3 and all(name == "sgd_step" for name, _ in gaps)
    assert abs(sum(t for _, t in gaps) - 94e-6) < 1e-12
