"""Runs with the timed path broken underneath must come out not correct.

Each fault is planted in the program at a tiny size on the CPU, and the
rest of a run is the harness's own (no look for a card): a step that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced, on the encode side (transcode cells) and on
the decode side (every cell).  Every cell runs on one chip, so there is no
exchange between chips to leave out."""

import pytest
import torch

from dct3d_tpu_torch.codec import decoder, transform, turbo
from perfbench import run, spec
from perfbench.tests.tiny import TINY

B = spec.benchmark()
CPU = torch.device("cpu")


def _stale(module, name, monkeypatch, modules=()):
    real = getattr(module, name)
    first = []

    def fake(*args, **kwargs):
        out = real(*args, **kwargs)
        if not first:
            first.append(out)
        return first[0]

    for m in (module, *modules):
        monkeypatch.setattr(m, name, fake)


def _wrap(module, name, change, monkeypatch):
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: change(real(*a, **k)))


def _half(t):
    t = t.clone()
    t[t.shape[0] // 2 :] = 0
    return t


def _alter(t):
    t = t.clone()
    if t.dtype == torch.uint8:
        t[:, 0, 0] += 9
    else:
        t[0, 5] += 3
    return t


FAULTS = {
    "encode_state_unchanged": lambda mp: _stale(transform, "_quantize", mp),
    "encode_half_left_out": lambda mp: _wrap(transform, "_quantize", _half, mp),
    "encode_answer_altered": lambda mp: _wrap(transform, "_quantize", _alter, mp),
    "decode_state_unchanged": lambda mp: _stale(decoder, "_dispatch_planar4", mp, (turbo,)),
    "decode_half_left_out": lambda mp: _wrap(transform, "_finish_frames", _half, mp),
    "decode_answer_altered": lambda mp: _wrap(transform, "_finish_frames", _alter, mp),
}
CASES = [(w["name"], f) for w in B["workloads"] for f in FAULTS
         if f.startswith("decode") or spec.Cell(B, w["name"]).traffic["loop"] == "transcode"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    r = run.run_cell(spec.Cell(B, cell), 77, 0.3, False, CPU, overrides=TINY)
    assert r["correct"] is False, r["checks"]
