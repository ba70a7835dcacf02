#!/usr/bin/env python
"""Print the JAX package's RGB constants that chip_smoke.py holds the
port's rgb phase to (JAX_RGB_CONSTANTS).

    JAX_PLATFORMS=cpu python tools/jax_rgb_constants.py

Encodes chip_smoke.rgb_clip() (1920x1080 interleaved RGB, 16 frames) with
the JAX package's encode_rgb_video(index=True) under chip_smoke.RGB_CFG
(parallel DEFLATE-9) and encode_turbo_rgb_video under chip_smoke.TURBO_CFG
(the zlib-6 wire), and prints each container's chip_smoke.container_digest
(member frame counts and types, the inflated streams, the index bit ends)
and its bits per RGB pixel.  The compressed bytes and the sync offsets
depend on the zlib build, so they are not pinned.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from dct3d_tpu.codec.rgb_codec import encode_rgb_video  # noqa: E402
from dct3d_tpu.codec.turbo import encode_turbo_rgb_video  # noqa: E402
from dct3d_tpu.config import CodecConfig  # noqa: E402


def main() -> None:
    clip = chip_smoke.rgb_clip()
    t, h, w, _ = clip.shape
    out = {}
    for name, data in (
        ("rgb", encode_rgb_video(clip, CodecConfig(**chip_smoke.RGB_CFG), index=True)),
        ("turbo_rgb", encode_turbo_rgb_video(clip, CodecConfig(**chip_smoke.TURBO_CFG))),
    ):
        out[name] = {"bpp": len(data) * 8 / (w * h * t),
                     "digest": chip_smoke.container_digest(data)}
    print(json.dumps({"JAX_RGB_CONSTANTS": out}))


if __name__ == "__main__":
    main()
