"""Wrapper of K2 (csrc/group_pack.cu): level 1 of the Exp-Golomb bit pack.

Replaces ``dct3d_tpu.ops.group_pack.group_pack_values_pallas``: per group of
256 int32 coefficients, each codeword is written MSB-first at its in-group
bit offset (a prefix sum of the widths) plus the group's global bit phase,
into a zero-filled row of ``w_words`` 32-bit words.

Words travel as int32 tensors holding the uint32 bit patterns (torch on
the CPU has no uint32 shifts).  CPU tensors take the plain version, the
per-word masked sum of ``dct3d_tpu.ops.bitpack._group_pack_einsum`` written
as a scatter-add of int64 fragments; CUDA tensors launch the kernel.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import expgolomb

GROUP = 256  # codewords per level-1 group
_MASK32 = 0xFFFFFFFF


def to_word_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def group_pack_values_plain(values: torch.Tensor, phase: torch.Tensor,
                            w_words: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (same contract as group_pack_values)."""
    code, wid = expgolomb.codewords(values)
    loff = torch.cumsum(wid, 1) - wid + phase.to(torch.int64)[:, None]
    word0 = loff >> 5
    over = (loff & 31) + wid - 32  # bits spilling into word0 + 1
    c0 = torch.where(over > 0, code >> over.clamp(min=0),
                     code << (-over).clamp(min=0)) & _MASK32
    c1 = torch.where(over > 0, (code << (32 - over.clamp(min=1))) & _MASK32, 0)
    # Fragments of one word are bit-disjoint, so their sum is their OR.
    # Column w_words collects (and drops) bits past the row, as the kernel
    # drops them.
    rows = torch.zeros((values.shape[0], w_words + 1), dtype=torch.int64,
                       device=values.device)
    rows.scatter_add_(1, word0.clamp(max=w_words), c0)
    rows.scatter_add_(1, (word0 + 1).clamp(max=w_words), c1)
    return to_word_bits(rows[:, :w_words])


def group_pack_values(values: torch.Tensor, phase: torch.Tensor,
                      w_words: int) -> torch.Tensor:
    """K2: (g, 256) int32 coefficients + (g,) int32 bit phases in [0, 32)
    -> (g, w_words) int32 words (uint32 bit patterns), MSB-first.

    Codewords must be at most 32 bits wide; bits past word w_words-1 are
    dropped, so size w_words with bitpack.worst_case_w_words.
    """
    if (values.dtype != torch.int32 or values.dim() != 2
            or values.shape[1] != GROUP or not values.shape[0]):
        raise ValueError("group_pack_values takes (g>0, 256) int32 values")
    if phase.dtype != torch.int32 or phase.shape != values.shape[:1]:
        raise ValueError("group_pack_values takes (g,) int32 phases")
    if values.device.type == "cpu":
        return group_pack_values_plain(values, phase, w_words)
    kernels.check_cuda("group_pack_values", values, phase)
    out = torch.empty((values.shape[0], w_words), dtype=torch.int32,
                      device=values.device)
    kernels.launch("group_pack_values", values.device, values, phase, out,
                   values.shape[0], w_words)
    return out
