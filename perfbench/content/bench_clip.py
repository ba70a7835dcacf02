"""The bench clip of ``bench.py:56-65``, a frozen copy seeded by the run's
``--seed``: a moving gradient ``(x + y + k) & 0xFF`` XOR uniform noise in
0..15, camera-like content that puts about 0.3 bpp through the entropy
coder at 8x8x8 and quant 5."""

from __future__ import annotations

import numpy as np
import torch


def generate(frames: int, height: int, width: int, seed: int,
             device: torch.device) -> np.ndarray:
    """The noise is drawn on ``device`` by a torch.Generator seeded with
    ``seed``, in one call (bench.py draws it with numpy under the fixed seed
    12345); the frames come back to the host once."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.randint(0, 16, (frames, height, width), generator=gen,
                        device=device, dtype=torch.uint8)
    x = torch.arange(width, device=device, dtype=torch.int32)
    y = torch.arange(height, device=device, dtype=torch.int32)[:, None]
    plane = ((x + y) & 0xFF).to(torch.uint8)
    for k in range(frames):  # uint8 adds wrap: (x + y + k) & 0xFF
        out[k] ^= plane + k % 256
    return out.cpu().numpy()
