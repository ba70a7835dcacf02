"""Wrappers of the relayout kernels K1 (frames -> cubes) and K4 (cubes ->
frames), csrc/relayout.cu.

They replace ``dct3d_tpu.ops.relayout.frames_to_cubes_perm`` and
``cubes_perm_to_frames`` at their public boundary: the TPU kernels work in a
sigma-permuted column order undone by one-hot matmuls, while these take and
give the natural cube order of codec/framing.py.  K1 also emits each
cube's exact integer pixel sum (the exact-DC quantizer's input) and the f32
cast; K4 also does the decoder's clamp and truncating uint8 cast.

CPU tensors take the plain versions (codec/framing.py); CUDA tensors launch
the kernel.  Both cover 8x8x8 cubes only.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..codec import framing
from ..config import CodecConfig

_CUBE8 = CodecConfig()  # the 8x8x8 cube geometry the kernels implement


def _geometry(t: int, h: int, w: int) -> int:
    if t % 8 or h % 8 or w % 8 or not t * h * w:
        raise ValueError(f"relayout needs a nonempty (8k, 8m, 8n) video, got {(t, h, w)}")
    return t // 8


def frames_to_cubes_plain(frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (same contract as frames_to_cubes)."""
    cubes = framing.frames_to_cubes(frames, _CUBE8)
    return cubes.float(), cubes.sum(1, dtype=torch.int32)


def cubes_to_frames_plain(pixels: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """Plain PyTorch version of K4 (same contract as cubes_to_frames)."""
    return framing.cubes_to_frames(
        pixels.clamp(0.0, 255.0).to(torch.uint8), _CUBE8, height, width
    )


def frames_to_cubes(frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: (T, H, W) uint8 -> ((cubes, 512) float32 pixels, (cubes,) int32
    pixel sums), cubes in bitstream order, natural intra-cube order."""
    if frames.dtype != torch.uint8 or frames.dim() != 3:
        raise ValueError("frames_to_cubes takes a (T, H, W) uint8 tensor")
    t, h, w = frames.shape
    gops = _geometry(t, h, w)
    if frames.device.type == "cpu":
        return frames_to_cubes_plain(frames)
    kernels.check_cuda("frames_to_cubes", frames)
    if frames.data_ptr() % 8:
        raise ValueError("frames_to_cubes needs 8-byte aligned frames")
    n = gops * (h // 8) * (w // 8)
    cubes = torch.empty((n, 512), dtype=torch.float32, device=frames.device)
    sums = torch.empty((n,), dtype=torch.int32, device=frames.device)
    kernels.launch("frames_to_cubes", frames.device, frames, cubes, sums,
                   gops, h, w)
    return cubes, sums


def cubes_to_frames(pixels: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """K4: (cubes, 512) float32 pixels in natural order -> clamp to
    [0, 255] -> truncating uint8 cast -> (T, H, W) frames."""
    if pixels.dtype != torch.float32 or pixels.dim() != 2 or pixels.shape[1] != 512:
        raise ValueError("cubes_to_frames takes (cubes, 512) float32 pixels")
    per_gop = (height // 8) * (width // 8)
    if not per_gop or pixels.shape[0] % per_gop:
        raise ValueError(f"{pixels.shape[0]} cubes do not tile {width}x{height} GOPs")
    gops = pixels.shape[0] // per_gop
    _geometry(8 * gops, height, width)
    if pixels.device.type == "cpu":
        return cubes_to_frames_plain(pixels, height, width)
    kernels.check_cuda("cubes_to_frames", pixels)
    frames = torch.empty((8 * gops, height, width), dtype=torch.uint8,
                         device=pixels.device)
    kernels.launch("cubes_to_frames", pixels.device, pixels, frames, gops,
                   height, width)
    return frames
