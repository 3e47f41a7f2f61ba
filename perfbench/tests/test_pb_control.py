"""The control that the limits were set against: the plain reference in
the program's place, computed in the precision below the configuration's
(bfloat16 for the FM, TF32 for the LR's matrix products), and the
faults a training cell can have, must each fail the cell's limits.
On the CPU at the cells' own sizes; the ``gpu`` test does the same on
the card (``python -m pytest perfbench/tests -m gpu`` there)."""

import pytest
import torch

from perfbench import control
from perfbench.tests import cells

CELLS = ("criteo_fm.libsvm", "higgs_lr.csv")


def over(reading, limits):
    return {k for k, v in reading.items() if v > limits[k]}


def check_cell(cell, device, seeds):
    c = cells.load(cell)
    for seed in seeds:
        r = control.readings(c, seed, device)
        for kind in control.KINDS:
            assert over(r[kind], c.limits), (cell, seed, kind, r[kind])


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits(cell):
    check_cell(cell, torch.device("cpu"), [2**31 + 3])


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_limits_on_the_card(cell, cuda_device):
    check_cell(cell, cuda_device, [11, 12, 13])
