"""Synthetic video sources — the TPU-environment stand-in for CaptureScreen
(a copy of ``dct3d_tpu.io.synthetic``; tests/test_torch_host.py pins it to
the original).

The reference captures the desktop with an AWT Robot at a target fps, scales
by integer factors, and pads dimensions up to multiples of 8
(CaptureScreen.java:16-163).  A TPU pod has no display, so this module
generates deterministic test/benchmark content with the same output contract:
headerless raw frames, geometry a multiple of the block size, optional
interleaved-RGB mode (the reference's actual output format, 3 B/px —
CaptureScreen.java:135-147 — despite its README claiming grayscale).
"""

from __future__ import annotations

import numpy as np

from ..config import CodecConfig


def pad_dim(x: int, block: int) -> int:
    """Round up to a multiple of `block` (CaptureScreen.java:113-118)."""
    return x + (-x) % block


def moving_gradient(
    frames: int,
    height: int,
    width: int,
    noise: float = 4.0,
    seed: int = 0,
    rgb: bool = False,
) -> np.ndarray:
    """Deterministic moving sinusoid gradient + Gaussian noise clip.

    Spatio-temporally band-limited, so it exercises the codec's intended
    regime (energy compaction into low-frequency 3D-DCT coefficients)."""
    rng = np.random.default_rng(seed)
    tt = np.arange(frames)[:, None, None].astype(np.float64)
    yy = np.arange(height)[None, :, None].astype(np.float64)
    xx = np.arange(width)[None, None, :].astype(np.float64)
    base = (
        110.0
        + 70.0 * np.sin(2 * np.pi * (xx + 2.5 * tt) / 48.0)
        + 50.0 * np.cos(2 * np.pi * (yy + 1.5 * tt) / 36.0)
    )
    if rgb:
        phase = np.array([0.0, 2.1, 4.2])[None, None, None, :]
        base = base[..., None] * (0.8 + 0.2 * np.cos(phase + tt[..., None] / 7))
    if noise:
        base = base + rng.normal(0.0, noise, size=base.shape)
    return np.clip(base, 0, 255).astype(np.uint8)


def moving_blocks(
    frames: int, height: int, width: int, seed: int = 0
) -> np.ndarray:
    """Screen-content-like clip: rectangles translating over a background —
    approximates the desktop-capture footage the reference targets."""
    rng = np.random.default_rng(seed)
    out = np.full((frames, height, width), 32, dtype=np.uint8)
    n_rects = 12
    pos = rng.integers(0, [width, height], size=(n_rects, 2)).astype(np.float64)
    vel = rng.uniform(-3, 3, size=(n_rects, 2))
    size = rng.integers(8, max(9, min(width, height) // 4), size=(n_rects, 2))
    shade = rng.integers(64, 255, size=n_rects)
    for t in range(frames):
        for i in range(n_rects):
            x = int(pos[i, 0] + vel[i, 0] * t) % width
            y = int(pos[i, 1] + vel[i, 1] * t) % height
            w = int(size[i, 0])
            h = int(size[i, 1])
            out[t, y : y + h, x : x + w] = shade[i]
    return out


def capture(
    output_path: str,
    frames: int,
    height: int,
    width: int,
    cfg: CodecConfig | None = None,
    kind: str = "gradient",
    rgb: bool = False,
    seed: int = 0,
) -> tuple[int, int, int]:
    """Generate a clip to a raw file, padding geometry to block multiples
    like CaptureScreen does.  Returns the actual (frames, height, width)."""
    cfg = cfg or CodecConfig()
    height = pad_dim(height, cfg.block_h)
    width = pad_dim(width, cfg.block_w)
    if kind == "gradient":
        clip = moving_gradient(frames, height, width, rgb=rgb, seed=seed)
    elif kind == "blocks":
        if rgb:
            raise ValueError("blocks source is grayscale only")
        clip = moving_blocks(frames, height, width, seed=seed)
    else:
        raise ValueError(f"unknown source kind {kind!r}")
    clip.tofile(output_path)
    return frames, height, width
