"""The controls come out not correct at a size a test run holds: the TF32
control (the reference in the program's place, in TF32) and the program's
own bf16 profile; the program as configured comes out correct."""

import pytest
import torch

from perfbench import control, run, spec
from perfbench.tests.tiny import TINY

B = spec.benchmark()
CELLS = [w["name"] for w in B["workloads"]]
CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_tf32_control_fails(cell, seed):
    c = spec.Cell(B, cell)
    v = control.readings({**c.config, **TINY["config"]}, {**c.traffic, **TINY["traffic"]},
                         spec.generator(c.traffic["content"]), seed, CPU)
    assert v.judged and not v.passed(), v.numbers


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_profile_fails_and_float32_passes(cell):
    c = spec.Cell(B, cell)
    assert not run.run_cell(c, 11, 0.3, False, CPU, dtype="bfloat16", overrides=TINY)["correct"]
    assert run.run_cell(c, 11, 0.3, False, CPU, overrides=TINY)["correct"]


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-9], dtype=torch.float32)
    assert control.tf32_round(x).tolist() == [1.0 + 2**-10, 1.0 + 2**-10, -3.0 - 2**-9]
