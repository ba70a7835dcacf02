"""Wrapper of K3 (csrc/splice.cu): level 2 of the Exp-Golomb bit pack.

Replaces ``dct3d_tpu.ops.splice.splice`` (and, at the same boundary, the
XLA row gather ``dct3d_tpu.ops.bitpack._place`` that the TPU runs instead):
the per-group word rows that K2 packed at their global bit phase are
OR-concatenated at their start words into one MSB-first stream, returned
as its bytes.

CPU tensors take the plain version, a scatter-OR by
``index_put_(accumulate=True)`` of bit-disjoint int64 words; CUDA tensors
launch the kernel.
"""

from __future__ import annotations

import torch

from .. import kernels


def splice_plain(groups_buf: torch.Tensor, sw: torch.Tensor,
                 gend: torch.Tensor, nwords: int) -> torch.Tensor:
    """Plain PyTorch version of K3 (same contract as splice, with every
    word past the stream zero)."""
    g, w = groups_buf.shape
    j = torch.arange(w, device=groups_buf.device)
    dst = sw.to(torch.int64)[:, None] + j
    last = (gend.to(torch.int64) - 1) >> 5  # word holding the group's last bit
    keep = (dst <= last[:, None]) & (dst < nwords)
    words = torch.zeros((nwords,), dtype=torch.int64, device=groups_buf.device)
    # Words of different groups are bit-disjoint, so accumulating ORs them.
    words.index_put_((dst[keep],), groups_buf.to(torch.int64)[keep] & 0xFFFFFFFF,
                     accumulate=True)
    shifts = torch.tensor([24, 16, 8, 0], device=groups_buf.device)
    return ((words[:, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)


def splice(groups_buf: torch.Tensor, sw: torch.Tensor, gend: torch.Tensor,
           nwords: int) -> torch.Tensor:
    """K3: (g, W) int32 group words (K2's or K5's output, carry lead
    included), (g,) int32 start words ``sw`` and (g,) int32 end bits
    ``gend`` (exclusive; the groups tile the stream, group g + 1 starting
    at bit gend[g]) -> (4 * nwords,) uint8 stream bytes.

    Only each row's words through the one holding bit gend - 1 are read.
    Stream words [0, ceil(total_bits / 32)) are each written once,
    total_bits = gend[-1]; the bits past total_bits in the last of them
    are zero, as they are in the rows.  Words past the total bit length
    are unspecified (the caller slices to the true byte count), as in the
    JAX kernel: the kernel allocates with torch.empty and leaves them
    unwritten; the plain version zeroes them.
    """
    if groups_buf.dtype != torch.int32 or groups_buf.dim() != 2 or not groups_buf.shape[0]:
        raise ValueError("splice takes (g>0, W) int32 group words")
    g = groups_buf.shape[0]
    for name, t in (("sw", sw), ("gend", gend)):
        if t.dtype != torch.int32 or t.shape != (g,):
            raise ValueError(f"splice takes (g,) int32 {name}")
    if groups_buf.device.type == "cpu":
        return splice_plain(groups_buf, sw, gend, nwords)
    kernels.check_cuda("splice", groups_buf, sw, gend)
    words = torch.empty((nwords,), dtype=torch.int32, device=groups_buf.device)
    kernels.launch("splice", groups_buf.device, groups_buf, sw, gend, words,
                   g, groups_buf.shape[1], nwords)
    return words.view(torch.uint8)
