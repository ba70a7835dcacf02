"""Frame-major <-> cube-major repacking, as torch reshape + permute.

The port's counterpart of ``dct3d_tpu.codec.framing``: cubes are enumerated
GOP-major, then block row, then block column (readCubes, encoder.c:10-45;
writeCubes, decoder.c:10-46), and within a cube the layout is
[frame][row][col].  These are the plain versions of the relayout kernels K1
and K4 (ops/relayout.py), which CPU tensors take and tests compare against.
"""

from __future__ import annotations

import torch

from ..config import CodecConfig


def frames_to_cubes(frames: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """(T, H, W) -> (num_cubes, cube_size) in bitstream cube order.

    T must be a multiple of the GOP size.
    """
    t, h, w = frames.shape
    bd, bh, bw = cfg.block_d, cfg.block_h, cfg.block_w
    if t % bd:
        raise ValueError(f"frame count {t} not a multiple of GOP {bd}")
    cfg.validate_geometry(w, h)
    x = frames.reshape(t // bd, bd, h // bh, bh, w // bw, bw)
    x = x.permute(0, 2, 4, 1, 3, 5)  # (gop, by, bx, k, i, j)
    return x.reshape(-1, bd * bh * bw)


def cubes_to_frames(cubes: torch.Tensor, cfg: CodecConfig, height: int,
                    width: int) -> torch.Tensor:
    """Inverse of frames_to_cubes: (num_cubes, cube_size) -> (T, H, W)."""
    bd, bh, bw = cfg.block_d, cfg.block_h, cfg.block_w
    nbh, nbw = height // bh, width // bw
    gops = cubes.shape[0] // (nbh * nbw)
    x = cubes.reshape(gops, nbh, nbw, bd, bh, bw)
    x = x.permute(0, 3, 1, 4, 2, 5)  # (gop, k, by, i, bx, j)
    return x.reshape(gops * bd, height, width)
