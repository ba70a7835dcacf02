"""The TF32 control: the reference put in the program's place and computed
in TF32, the precision just below the configurations' float32 with TF32
off (a later change that turned TF32 on would produce exactly this).

For GOPs drawn from the seed out of the cell's own content, the control's
ints are the float64 reference's quantizer applied to a TF32 product of
the cubes and the encode matrix, and its pixels a TF32 product of those
ints and the decode matrix; both are judged by checks.py as the program's
are.  On a card TF32 is cuBLAS's; on the CPU, which has none, each operand
is rounded to TF32's 10 mantissa bits and multiplied in float32 (the
products of two such operands are exact in float32).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import checks, pool, reference


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest value with a 10-bit mantissa (ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _tf32_on():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = a.to(torch.float32), b.to(torch.float32)
    if a.device.type == "cuda":
        with _tf32_on():
            return a @ b
    return tf32_round(a) @ tf32_round(b)


def readings(config: dict, traffic: dict, generate, seed: int,
             device: torch.device) -> checks.Verdict:
    """The control's numbers on ``sample_gops`` (or ``sample_requests``)
    GOPs of the cell's content, made by ``generate``."""
    b = config["codec"]
    tr = reference.Transform((b["block_w"], b["block_h"], b["block_d"]),
                             b["quant_strength"], b["quant_bias"], device)
    gop = b["block_d"]
    fpf = traffic.get("frames_per_file", traffic.get("container_frames"))
    frames = pool.Pool(generate, traffic.get("pool_frames", fpf), fpf,
                       config["height"], config["width"], seed % (1 << 63), device)
    rng = np.random.default_rng([seed % (1 << 63), 5])
    v = checks.Verdict()
    for _ in range(traffic.get("sample_gops", traffic.get("sample_requests"))):
        i, g = int(rng.integers(frames.span)), int(rng.integers(fpf // gop))
        src = frames.file(i)[g * gop : (g + 1) * gop]
        cubes = tr.cubes(torch.from_numpy(np.ascontiguousarray(src)).to(device))
        ints = tr.quantize(tf32_matmul(cubes, tr.enc).to(torch.float64))
        v.gap("int_gap", checks.int_gap(ints, tr.scaled(src), tr.bias))
        x = tf32_matmul(ints, tr.dec).to(torch.float64)
        v.gap("pixel_gap", checks.pixel_gap(tr.pixels(x), tr.unscaled(ints)))
        v.judged += 1
    return v
