#!/usr/bin/env python
"""Print the JAX package's 4x4x4 constants that chip_smoke.py holds the
PyTorch port to (JAX_BLOCK_CONSTANTS).

    JAX_PLATFORMS=cpu python tools/jax_block_constants.py

Runs the JAX package on the CPU over chip_smoke.py's three 4x4x4 runs and
prints, for each, its bits per pixel and a sha256 of its content:

  bench     the bench clip (1920x1080, 64 frames) through encode_video with
            chip_smoke.BLOCK_CFG (parallel DEFLATE): the sha256 of the
            decompressed Exp-Golomb payload;
  portrait  chip_smoke.portrait_clip() (1170x2532 edge-padded to 1172x2532,
            16 frames) the same way;
  turbo     the same padded clip through encode_turbo_video with
            chip_smoke.TURBO_BLOCK_CFG (zlib-6 wire):
            chip_smoke.container_digest.

Digests hash decompressed bytes, so they do not depend on the zlib build.
Streams are encoded one GOP at a time (the reference encoder's carry
chains across pushes; turbo members are independent), which keeps the run
small enough for a workstation CPU.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from dct3d_tpu.codec import encoder, transform, turbo  # noqa: E402
from dct3d_tpu.config import CodecConfig  # noqa: E402


def _stream(clip, cfg: CodecConfig, ctx) -> bytes:
    h, w = clip.shape[1:]
    enc = encoder.StreamingEncoder(w, h, cfg, ctx)
    gop = cfg.gop_size
    return b"".join(enc.push(clip[g : g + gop])
                    for g in range(0, len(clip) - len(clip) % gop, gop)) + enc.finish()


def _constants(data: bytes, digest: str, clip) -> dict:
    t, h, w = clip.shape
    return {"bpp": len(data) * 8 / (w * h * t), "digest": digest}


def main() -> None:
    cfg = CodecConfig(**chip_smoke.BLOCK_CFG)
    ctx = transform.TransformContext(cfg)
    out = {}
    bench = chip_smoke.synthetic_clip(chip_smoke.T, chip_smoke.H, chip_smoke.W)
    data = _stream(bench, cfg, ctx)
    out["bench"] = _constants(data, hashlib.sha256(zlib.decompress(data)).hexdigest(), bench)
    del bench
    portrait = chip_smoke.portrait_clip()
    data = _stream(portrait, cfg, ctx)
    out["portrait"] = _constants(data, hashlib.sha256(zlib.decompress(data)).hexdigest(),
                                 portrait)
    tcfg = CodecConfig(**chip_smoke.TURBO_BLOCK_CFG)
    tctx = transform.TransformContext(tcfg)
    data = b"".join(turbo.encode_turbo_video(portrait[g : g + 4], tcfg, tctx)
                    for g in range(0, len(portrait), 4))
    out["turbo"] = _constants(data, chip_smoke.container_digest(data), portrait)
    print(json.dumps({"JAX_BLOCK_CONSTANTS": out}, indent=1))


if __name__ == "__main__":
    main()
