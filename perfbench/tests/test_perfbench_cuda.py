"""On the card: one short run of each cell through the command, correct,
and the TF32 control not correct.  Skips without a CUDA device."""

import json
import subprocess
import sys

import pytest

from perfbench import spec

B = spec.benchmark()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_short_run_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed", str(2**31 + 3),
         "--seconds", "3", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card(card):
    import torch
    from perfbench import control
    c = spec.Cell(B, "ref8.noisy.transcode")
    for seed in (1, 2, 3):
        assert not control.readings(c.config, c.traffic, spec.generator(c.traffic["content"]),
                                    seed, torch.device("cuda", 0)).passed()
