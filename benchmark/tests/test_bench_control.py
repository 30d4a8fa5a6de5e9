"""The control fails each cell's comparison: the plain reference put in the
program's place, computed one precision below the configuration's (float32
with TF32 matmuls where float32 with TF32 off is stated), reads over the
limit, while the program reads under it.  At a size a CPU test run holds;
on the card at the cells' own sizes, ``benchmark/calibrate.py`` takes the
same readings."""

import pytest
import torch

from benchmark import calibrate, harness
from _small import CELLS, SEED, small


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    c = small(name, ny=61, nx=120, levels=33)
    device = torch.device("cpu")
    drv = harness.entry(c["traffic"]["entry"])(c["config"], c["traffic"],
                                                SEED, device)
    sample = harness.Reservoir(c["traffic"]["sample_calls"], SEED)
    harness.window(drv, 0.2, sample, [device])
    answers = sample.answers()
    drv.release()
    limits = c["limits"]["limits"]
    prog = calibrate.readings(*drv.check(answers, device))
    ctl = calibrate.readings(*drv.check(answers, device, "control"))
    print(name, "program", prog, "control", ctl)
    assert all(prog[k] <= limits[k] for k in limits)
    # the control has to fail one of the cell's numbers, not each
    assert any(ctl[k] > limits[k] for k in limits)
