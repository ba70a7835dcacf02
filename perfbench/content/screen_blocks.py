"""Rectangles translating over a flat background: the desktop capture the
upstream targets, a frozen copy of ``moving_blocks`` in
``dct3d_tpu_torch/io/synthetic.py`` made steady from seed to seed."""

from __future__ import annotations

import numpy as np
import torch


def generate(frames: int, height: int, width: int, seed: int,
             device: torch.device | None = None) -> np.ndarray:
    """Twelve rectangles, their widths, speeds and shades spread evenly over
    the original's ranges, each slides sideways in a lane of its own and
    wraps around the frame's edges; the seed shifts the whole picture
    sideways by a whole number of 8-pixel blocks, so every seed codes the
    same cubes in another place."""
    rng = np.random.default_rng(0)
    n_rects = 12
    lane = height // n_rects
    heights = np.linspace(min(8, lane), lane, n_rects).round().astype(int)
    widths = rng.permutation(np.linspace(8, max(9, min(width, height) // 4) - 1,
                                         n_rects).round().astype(int))
    speeds = (np.arange(n_rects) + 0.5) * 3.0 / n_rects * (-1.0) ** np.arange(n_rects)
    speeds = rng.permutation(speeds)
    shade = rng.permutation(np.linspace(64, 254, n_rects).round().astype(np.uint8))
    x0 = rng.integers(0, width, n_rects) + 8 * (seed % max(1, width // 8))
    out = np.full((frames, height, width), 32, dtype=np.uint8)
    for i in range(n_rects):
        y = i * lane + (lane - heights[i]) // 2
        for t in range(frames):
            x = int(x0[i] + speeds[i] * t) % width
            cols = (x + np.arange(widths[i])) % width
            out[t, y : y + heights[i], cols] = shade[i]
    return out
