#!/usr/bin/env python
"""Print the JAX package's turbo constants that chip_smoke.py holds the
PyTorch port to (JAX_TURBO_BPP, JAX_TURBO_DIGEST).

    JAX_PLATFORMS=cpu python tools/jax_turbo_constants.py [W H T]

Encodes chip_smoke.py's bench clip (1920x1080x64 by default) with the JAX
package's encode_turbo_video under chip_smoke.TURBO_CFG on the CPU, one GOP
at a time (turbo members are independent, so their concatenation is the
container), and prints its bits per pixel and its
chip_smoke.container_digest (a hash of the decompressed streams, so it
does not depend on the zlib build).  Holding one GOP at a time keeps the
run small enough for a workstation CPU.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from dct3d_tpu.codec import transform, turbo  # noqa: E402
from dct3d_tpu.config import CodecConfig  # noqa: E402


def main(argv: list[str]) -> None:
    w, h, t = (int(a) for a in argv) if argv else (chip_smoke.W, chip_smoke.H, chip_smoke.T)
    clip = chip_smoke.synthetic_clip(t, h, w)
    cfg = CodecConfig(**chip_smoke.TURBO_CFG)
    ctx = transform.TransformContext(cfg)
    data = b"".join(turbo.encode_turbo_video(clip[g : g + 8], cfg, ctx)
                    for g in range(0, t - t % 8, 8))
    print(json.dumps({"JAX_TURBO_BPP": len(data) * 8 / (w * h * t),
                      "JAX_TURBO_DIGEST": chip_smoke.container_digest(data)}))


if __name__ == "__main__":
    main(sys.argv[1:])
