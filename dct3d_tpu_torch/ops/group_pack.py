"""Wrappers of group_bits, K2 and K5 (csrc/group_pack.cu): level 1 of the
Exp-Golomb bit pack.

group_bits replaces the per-group width sum of
``dct3d_tpu.ops.bitpack._geometry`` (XLA on the TPU): each group's codeword
bit count, the input of the group geometry's cumsum.  K2 replaces
``dct3d_tpu.ops.group_pack.group_pack_values_pallas``: per group of 256
int32 coefficients, each codeword is written MSB-first at its in-group bit
offset (a prefix sum of the widths) plus the group's global bit phase, into
a row of ``w_words`` 32-bit words.  K5 replaces ``group_pack_pallas``: the
same pack from precomputed codes and widths (``bitpack.pack_bits``).  On
the card both define only the row words that hold the group's bits, the
words K3 reads.

Words travel as int32 tensors holding the uint32 bit patterns (torch on
the CPU has no uint32 shifts).  CPU tensors take the plain versions, the
per-word masked sum of ``dct3d_tpu.ops.bitpack._group_pack_einsum`` written
as a scatter-add of int64 fragments; CUDA tensors launch the kernels.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import expgolomb

GROUP = 256  # codewords per level-1 group
_MASK32 = 0xFFFFFFFF


def _pack_plain(code: torch.Tensor, wid: torch.Tensor, phase: torch.Tensor,
                w_words: int) -> torch.Tensor:
    """(g, 256) int64 codes in [0, 2^32) and widths in [0, 32] -> (g,
    w_words) int32 words: the fragments' wrapping sum per word, as the
    kernels and the TPU kernel add them."""
    loff = torch.cumsum(wid, 1) - wid + phase.to(torch.int64)[:, None]
    word0 = loff >> 5
    over = (loff & 31) + wid - 32  # bits spilling into word0 + 1
    c0 = torch.where(over > 0, code >> over.clamp(min=0),
                     code << (-over).clamp(min=0)) & _MASK32
    c0 = torch.where(wid > 0, c0, 0)
    c1 = torch.where(over > 0, (code << (32 - over.clamp(min=1))) & _MASK32, 0)
    # Column w_words collects (and drops) bits past the row, as the kernels
    # drop them.
    rows = torch.zeros((code.shape[0], w_words + 1), dtype=torch.int64,
                       device=code.device)
    rows.scatter_add_(1, word0.clamp(max=w_words), c0)
    rows.scatter_add_(1, (word0 + 1).clamp(max=w_words), c1)
    return expgolomb.to_word_bits(rows[:, :w_words] & _MASK32)


def group_bits_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of group_bits (same contract)."""
    return expgolomb.codewords(values)[1].sum(1, dtype=torch.int32)


def group_pack_values_plain(values: torch.Tensor, phase: torch.Tensor,
                            w_words: int) -> torch.Tensor:
    """Plain PyTorch version of K2 (same contract as group_pack_values,
    with every word past a group's content zero)."""
    return _pack_plain(*expgolomb.codewords(values), phase, w_words)


def group_pack_codes_plain(code: torch.Tensor, width: torch.Tensor,
                           phase: torch.Tensor, w_words: int) -> torch.Tensor:
    """Plain PyTorch version of K5 (same contract as group_pack_codes,
    with every word past a group's content zero)."""
    return _pack_plain(code.to(torch.int64) & _MASK32, width.to(torch.int64),
                       phase, w_words)


def _check_groups(name: str, *rows: torch.Tensor) -> None:
    for t in rows:
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != GROUP
                or not t.shape[0] or t.shape != rows[0].shape):
            raise ValueError(f"{name} takes (g>0, 256) int32 tensors")


def _check_phase(name: str, phase: torch.Tensor, groups: int) -> None:
    if phase.dtype != torch.int32 or phase.shape != (groups,):
        raise ValueError(f"{name} takes (g,) int32 phases")


def group_bits(values: torch.Tensor) -> torch.Tensor:
    """(g, 256) int32 coefficients -> (g,) int32: each group's Exp-Golomb
    bit count, the sum of 2*bitlen(map(v) + 1) - 1 over its values."""
    _check_groups("group_bits", values)
    if values.device.type == "cpu":
        return group_bits_plain(values)
    kernels.check_cuda("group_bits", values)
    kernels.check_aligned16("group_bits", values)
    out = torch.empty((values.shape[0],), dtype=torch.int32, device=values.device)
    kernels.launch("group_bits", values.device, values, out, values.shape[0])
    return out


def group_pack_values(values: torch.Tensor, phase: torch.Tensor,
                      w_words: int) -> torch.Tensor:
    """K2: (g, 256) int32 coefficients + (g,) int32 bit phases in [0, 32)
    -> (g, w_words) int32 words (uint32 bit patterns), MSB-first.

    Words [0, nw) of each row are defined, nw = ceil((phase + bits) / 32)
    capped at w_words with bits = group_bits(values): exactly the words K3
    reads.  The kernel leaves the rest unwritten; the plain version zeroes
    them.  Codewords must be at most 32 bits wide; bits past word w_words-1
    are dropped, so size w_words with bitpack.worst_case_w_words.
    """
    _check_groups("group_pack_values", values)
    _check_phase("group_pack_values", phase, values.shape[0])
    if values.device.type == "cpu":
        return group_pack_values_plain(values, phase, w_words)
    kernels.check_cuda("group_pack_values", values, phase)
    kernels.check_aligned16("group_pack_values", values)
    out = torch.empty((values.shape[0], w_words), dtype=torch.int32,
                      device=values.device)
    kernels.launch("group_pack_values", values.device, values, phase, out,
                   values.shape[0], w_words)
    return out


def group_pack_codes(code: torch.Tensor, width: torch.Tensor,
                     phase: torch.Tensor, w_words: int) -> torch.Tensor:
    """K5: (g, 256) int32 codes (uint32 bit patterns, the field's payload
    right-aligned) + (g, 256) int32 widths in [0, 32] + (g,) int32 bit
    phases in [0, 32) -> (g, w_words) int32 words, MSB-first, each group
    packed at its phase; fragments are added per word with 32-bit wrap, as
    the TPU kernel adds them.

    Words [0, nw) of each row are defined, nw = ceil((phase + bits) / 32)
    capped at w_words with bits the sum of the row's widths: exactly the
    words K3 reads.  The kernel leaves the rest unwritten; the plain
    version zeroes them.  Zero-width slots write nothing; bits past word
    w_words-1 are dropped.  On the card code and width must start on a
    16-byte boundary (the kernel reads them with 16-byte loads), or
    ValueError is raised.
    """
    _check_groups("group_pack_codes", code, width)
    _check_phase("group_pack_codes", phase, code.shape[0])
    if code.device.type == "cpu":
        return group_pack_codes_plain(code, width, phase, w_words)
    kernels.check_cuda("group_pack_codes", code, width, phase)
    kernels.check_aligned16("group_pack_codes", code)
    kernels.check_aligned16("group_pack_codes", width)
    out = torch.empty((code.shape[0], w_words), dtype=torch.int32,
                      device=code.device)
    kernels.launch("group_pack_codes", code.device, code, width, phase, out,
                   code.shape[0], w_words)
    return out
