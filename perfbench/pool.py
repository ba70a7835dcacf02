"""What every loop shares: the pool of frames that a content generator
makes once per run, and the report of a call that raised."""

from __future__ import annotations

import sys
import traceback

import numpy as np
import torch


class Pool:
    """Frames of one content kind; ``file(i)`` is a (frames_per_file, H, W)
    view starting at frame ``i % span``, so consecutive files start on other
    frames and other GOP boundaries, and no view copies."""

    def __init__(self, generate, pool_frames: int, frames_per_file: int,
                 height: int, width: int, seed: int, device: torch.device) -> None:
        if pool_frames < frames_per_file:
            raise ValueError("pool_frames is shorter than one file")
        self.frames = generate(pool_frames, height, width, seed, device)
        self.frames_per_file = frames_per_file
        self.span = pool_frames - frames_per_file + 1

    def file(self, i: int) -> np.ndarray:
        o = i % self.span
        return self.frames[o : o + self.frames_per_file]


def failed(what: str, n: int) -> None:
    """Print the traceback of the first two failed calls of a run."""
    if n <= 2:
        print(f"{what} raised:\n{traceback.format_exc()}", file=sys.stderr)
