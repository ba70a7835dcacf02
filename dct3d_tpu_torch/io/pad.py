"""Pad-and-crop policy for non-multiple-of-block geometry (copy of
``dct3d_tpu.io.pad``; tests/test_torch_host.py pins the copy to the
original).

The reference requires frame dims to be block multiples
(CaptureScreen.java:113-118).  ``encode --pad`` edge-replicates frames up to
block multiples on encode and ``decode --crop`` crops back after decode.
Edge replication keeps the pad region correlated with real content, so it
costs almost no bits and is deterministic.
"""

from __future__ import annotations

import numpy as np


def padded_geometry(width: int, height: int, block_w: int, block_h: int
                    ) -> tuple[int, int]:
    """(padded_width, padded_height): dims rounded up to block multiples."""
    return (-(-width // block_w) * block_w, -(-height // block_h) * block_h)


def pad_frames(frames: np.ndarray, block_w: int, block_h: int) -> np.ndarray:
    """Edge-replicate (T, H, W[, C]) frames up to block-multiple H/W."""
    t, h, w = frames.shape[:3]
    pw, ph = padded_geometry(w, h, block_w, block_h)
    if (pw, ph) == (w, h):
        return frames
    pad = [(0, 0), (0, ph - h), (0, pw - w)] + (
        [(0, 0)] if frames.ndim == 4 else []
    )
    return np.pad(frames, pad, mode="edge")


def crop_frames(frames: np.ndarray, width: int, height: int) -> np.ndarray:
    """Crop decoded (T, H', W'[, C]) frames back to the original geometry."""
    return frames[:, :height, :width]


def padded_stream(inner, block_w: int, block_h: int):
    """Wrap a StreamFrames so each batch is edge-padded as it flows
    through: `encode - ... --pad` keeps the pipe path's constant-RSS
    contract (pad is per-frame; nothing about it needs the whole footage
    resident).  Returns a StreamFrames subclass instance, so
    cli._frame_batches routes it unchanged; it reads from the inner
    stream at the ORIGINAL geometry and presents the padded one."""
    from .rawvideo import StreamFrames

    class _Padded(StreamFrames):
        def __init__(self):
            pw, ph = padded_geometry(
                inner.width, inner.height, block_w, block_h
            )
            super().__init__(inner.stream, pw, ph, inner.channels)

        def read_all(self) -> np.ndarray:
            return pad_frames(inner.read_all(), block_w, block_h)

        def iter_batches(self, batch_frames, max_frames=None, align=None,
                         start=0):
            for b in inner.iter_batches(batch_frames, max_frames,
                                        align=align, start=start):
                yield pad_frames(b, block_w, block_h)

    return _Padded()
