"""Wrappers of the relayout kernels K1 (frames -> cubes) and K4 (cubes ->
frames), csrc/relayout.cu, and of the turbo wire's byte transpose, K7
(plane -> wire) and K8 (wire -> plane), csrc/wire.cu.

They replace ``dct3d_tpu.ops.relayout.frames_to_cubes_perm`` and
``cubes_perm_to_frames`` at their public boundary: the TPU kernels work in a
sigma-permuted column order undone by one-hot matmuls, while these take and
give the natural cube order of codec/framing.py.  K1 also emits each
cube's exact integer pixel sum (the exact-DC quantizer's input) and the
cast to the compute dtype; K4 also does the decoder's clamp and truncating
uint8 cast.  Each has a float32 and a bfloat16 form (the bf16 profile,
``compute_dtype="bfloat16"``), launched under names of their own.

K7 and K8 replace ``dct3d_tpu.ops.relayout.plane_to_wire`` and
``wire_words`` (``wire_to_plane``): the TPU kernels transpose int32 words
and peel or pack bytes around them, because Mosaic cannot transpose bytes;
these transpose the bytes directly.

CPU tensors take the plain versions (codec/framing.py, a transpose); CUDA
tensors launch the kernel.  K1 and K4 cover 8x8x8 cubes only (``supports``);
the codec takes framing's transposes for other geometries on every device,
as the JAX package runs plain XLA there.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..codec import framing
from ..config import CodecConfig

_CUBE8 = CodecConfig()  # the 8x8x8 cube geometry the kernels implement
#: pixel dtype -> suffix of the K1 / K4 form that takes or gives it
_FORMS = {torch.float32: "", torch.bfloat16: "_bf16"}


def _form(dtype: torch.dtype) -> str:
    if dtype not in _FORMS:
        raise ValueError(f"K1 and K4 have float32 and bfloat16 forms, not {dtype}")
    return _FORMS[dtype]


def supports(cfg: CodecConfig, height: int, width: int) -> bool:
    """K1 and K4 cover the 8x8x8 cube geometry (the test of
    ``dct3d_tpu.ops.relayout.supports``)."""
    return ((cfg.block_w, cfg.block_h, cfg.block_d) == (8, 8, 8)
            and height % 8 == 0 and width % 8 == 0)


def _geometry(t: int, h: int, w: int) -> int:
    if t % 8 or h % 8 or w % 8 or not t * h * w:
        raise ValueError(f"relayout needs a nonempty (8k, 8m, 8n) video, got {(t, h, w)}")
    return t // 8


def frames_to_cubes_plain(frames: torch.Tensor, dtype: torch.dtype = torch.float32
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1 (same contract as frames_to_cubes)."""
    _form(dtype)
    cubes = framing.frames_to_cubes(frames, _CUBE8)
    return cubes.to(dtype), cubes.sum(1, dtype=torch.int32)


def cubes_to_frames_plain(pixels: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """Plain PyTorch version of K4 (same contract as cubes_to_frames)."""
    return framing.cubes_to_frames(
        pixels.clamp(0.0, 255.0).to(torch.uint8), _CUBE8, height, width
    )


def frames_to_cubes(frames: torch.Tensor, dtype: torch.dtype = torch.float32
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: (T, H, W) uint8 -> ((cubes, 512) pixels of ``dtype``, float32 or
    bfloat16 (exact either way), (cubes,) int32 pixel sums), cubes in
    bitstream order, natural intra-cube order."""
    if frames.dtype != torch.uint8 or frames.dim() != 3:
        raise ValueError("frames_to_cubes takes a (T, H, W) uint8 tensor")
    name = "frames_to_cubes" + _form(dtype)
    t, h, w = frames.shape
    gops = _geometry(t, h, w)
    if frames.device.type == "cpu":
        return frames_to_cubes_plain(frames, dtype)
    kernels.check_cuda(name, frames)
    if frames.data_ptr() % 8:
        raise ValueError(f"{name} needs 8-byte aligned frames")
    n = gops * (h // 8) * (w // 8)
    cubes = torch.empty((n, 512), dtype=dtype, device=frames.device)
    sums = torch.empty((n,), dtype=torch.int32, device=frames.device)
    kernels.launch(name, frames.device, frames, cubes, sums, gops, h, w)
    return cubes, sums


def cubes_to_frames(pixels: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """K4: (cubes, 512) float32 or bfloat16 pixels in natural order ->
    clamp to [0, 255] -> truncating uint8 cast -> (T, H, W) frames.  A
    bfloat16 value converts to float32 exactly, so the bf16 form clamps
    and truncates what the plain version does."""
    if pixels.dim() != 2 or pixels.shape[1] != 512:
        raise ValueError("cubes_to_frames takes (cubes, 512) pixels")
    name = "cubes_to_frames" + _form(pixels.dtype)
    per_gop = (height // 8) * (width // 8)
    if not per_gop or pixels.shape[0] % per_gop:
        raise ValueError(f"{pixels.shape[0]} cubes do not tile {width}x{height} GOPs")
    gops = pixels.shape[0] // per_gop
    _geometry(8 * gops, height, width)
    if pixels.device.type == "cpu":
        return cubes_to_frames_plain(pixels, height, width)
    kernels.check_cuda(name, pixels)
    kernels.check_aligned16(name, pixels)
    frames = torch.empty((8 * gops, height, width), dtype=torch.uint8,
                         device=pixels.device)
    kernels.launch(name, pixels.device, pixels, frames, gops, height, width)
    return frames


def plane_to_wire_plain(plane: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7 (same contract as plane_to_wire)."""
    return plane.t().contiguous()


def wire_to_plane_plain(wire: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8 (same contract as wire_to_plane)."""
    return wire.t().contiguous()


def _transpose_u8(name: str, x: torch.Tensor, cubes: int, hc: int) -> torch.Tensor:
    kernels.check_cuda(name, x)
    out = torch.empty((x.shape[1], x.shape[0]), dtype=torch.uint8, device=x.device)
    kernels.launch(name, x.device, x, out, cubes, hc)
    return out


def _check_u8_2d(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.uint8 or x.dim() != 2 or not x.numel():
        raise ValueError(f"{name} takes a nonempty 2-D uint8 tensor")


def plane_to_wire(plane: torch.Tensor) -> torch.Tensor:
    """K7: (cubes, hc) uint8 transport nibble plane -> (hc, cubes) uint8
    wire layout (coefficient-pair-major: wire[p, c] = plane[c, p])."""
    _check_u8_2d("plane_to_wire", plane)
    if plane.device.type == "cpu":
        return plane_to_wire_plain(plane)
    return _transpose_u8("plane_to_wire", plane, *plane.shape)


def wire_to_plane(wire: torch.Tensor) -> torch.Tensor:
    """K8: (hc, cubes) uint8 wire layout -> (cubes, hc) uint8 transport
    nibble plane, the inverse of plane_to_wire."""
    _check_u8_2d("wire_to_plane", wire)
    if wire.device.type == "cpu":
        return wire_to_plane_plain(wire)
    hc, cubes = wire.shape
    return _transpose_u8("wire_to_plane", wire, cubes, hc)
