"""Rate and quality arithmetic, frozen copies of ``dct3d_tpu_torch/metrics.py``."""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB between two uint8 videos or frames."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return 10.0 * np.log10(peak * peak / mse)


def bits_per_pixel(stream_bytes: int, width: int, height: int, frames: int) -> float:
    """Compressed bits per source pixel."""
    return 8.0 * stream_bytes / (width * height * frames)
