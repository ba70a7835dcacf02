"""Wrapper of K6 (csrc/exc_pack.cu): per-group exception compaction.

Replaces ``dct3d_tpu.ops.exc_pack.compact_groups_pallas``: per group of 256
int32 values, the values outside the nibble range [-8, 7] (skipping flat
positions that are a multiple of ``dc_stride``) are listed in stream order
as (lane, value) slots, with the group's count.  CPU tensors take the plain
version, a rank by cumsum and a scatter; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import torch

from .. import kernels

GROUP = 256  # values per group


def compact_groups_plain(v2: torch.Tensor, slots: int,
                         dc_stride: int = 0) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K6 (same contract as compact_groups)."""
    g = v2.shape[0]
    exc = (v2 < -8) | (v2 > 7)
    if dc_stride:
        flat = torch.arange(g * GROUP, device=v2.device).reshape(g, GROUP)
        exc &= (flat % dc_stride) != 0
    m = exc.to(torch.int32)
    rank = torch.cumsum(m, 1, dtype=torch.int32) - m
    counts = m.sum(1, dtype=torch.int32)
    # Exceptions past the slots, and non-exceptions, land in a dump column.
    col = torch.where(exc & (rank < slots), rank, slots).to(torch.int64)
    lane = torch.arange(GROUP, dtype=torch.int32, device=v2.device).expand(g, GROUP)
    lidx = torch.zeros((g, slots + 1), dtype=torch.int32, device=v2.device)
    vals = torch.zeros((g, slots + 1), dtype=torch.int32, device=v2.device)
    lidx.scatter_(1, col, lane)
    vals.scatter_(1, col, v2)
    return (lidx[:, :slots].to(torch.uint8), vals[:, :slots].to(torch.int16),
            counts)


def compact_groups(v2: torch.Tensor, slots: int,
                   dc_stride: int = 0) -> tuple[torch.Tensor, ...]:
    """K6: (g, 256) int32 -> (lidx (g, slots) uint8, vals (g, slots) int16,
    counts (g,) int32).

    Slot s < min(counts[g], slots) of row g holds the in-group lane and the
    value (cast to int16, wrapping) of the group's s-th exception; the other
    slots are zero.  A group with more than ``slots`` exceptions keeps its
    first ``slots`` and its full count (the caller's overflow test).
    """
    if (v2.dtype != torch.int32 or v2.dim() != 2 or v2.shape[1] != GROUP
            or not v2.shape[0]):
        raise ValueError("compact_groups takes (g>0, 256) int32 values")
    if not 1 <= slots <= GROUP or dc_stride < 0:
        raise ValueError(f"compact_groups: slots {slots} not in 1..256 "
                         f"or dc_stride {dc_stride} < 0")
    if v2.device.type == "cpu":
        return compact_groups_plain(v2, slots, dc_stride)
    kernels.check_cuda("compact_groups", v2)
    kernels.check_aligned16("compact_groups", v2)
    g = v2.shape[0]
    lidx = torch.empty((g, slots), dtype=torch.uint8, device=v2.device)
    vals = torch.empty((g, slots), dtype=torch.int16, device=v2.device)
    counts = torch.empty((g,), dtype=torch.int32, device=v2.device)
    kernels.launch("compact_groups", v2.device, v2, lidx, vals, counts, g,
                   slots, dc_stride)
    return lidx, vals, counts
