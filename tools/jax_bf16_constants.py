#!/usr/bin/env python
"""Print the JAX package's bf16-profile constants that chip_smoke.py holds
the PyTorch port to (JAX_BF16_CONSTANTS).

    JAX_PLATFORMS=cpu python tools/jax_bf16_constants.py

Runs the JAX package on the CPU over chip_smoke.py's bench clip (1920x1080,
64 frames) in the bf16 profile (compute_dtype="bfloat16"), at 8x8x8 cubes
under chip_smoke.BF16_CFG and at 4x4x4 under chip_smoke.BF16_BLOCK_CFG
(both with parallel DEFLATE), and prints for each: its bits per pixel, the
PSNR of the JAX package's bf16 decode, and the sha256 of the decompressed
Exp-Golomb payload (independent of the zlib build).  Streams are encoded
one GOP at a time, which keeps the run small enough for a workstation
CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import zlib

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from dct3d_tpu import metrics  # noqa: E402
from dct3d_tpu.codec import decoder, encoder, transform  # noqa: E402
from dct3d_tpu.config import CodecConfig  # noqa: E402


def _constants(clip: np.ndarray, cfg: CodecConfig) -> dict:
    t, h, w = clip.shape
    ctx = transform.TransformContext(cfg)
    enc = encoder.StreamingEncoder(w, h, cfg, ctx)
    gop = cfg.gop_size
    data = b"".join(enc.push(clip[g : g + gop]) for g in range(0, t, gop)) + enc.finish()
    out = decoder.decode_video(data, w, h, t, cfg, ctx)
    return {"bpp": len(data) * 8 / (w * h * t), "psnr_db": metrics.psnr(clip, out),
            "digest": hashlib.sha256(zlib.decompress(data)).hexdigest()}


def main() -> None:
    clip = chip_smoke.synthetic_clip(chip_smoke.T, chip_smoke.H, chip_smoke.W)
    out = {"8x8x8": _constants(clip, CodecConfig(**chip_smoke.BF16_CFG)),
           "4x4x4": _constants(clip, CodecConfig(**chip_smoke.BF16_BLOCK_CFG))}
    print(json.dumps({"JAX_BF16_CONSTANTS": out}, indent=1))


if __name__ == "__main__":
    main()
