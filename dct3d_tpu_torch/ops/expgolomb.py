"""Signed Exp-Golomb codeword math on torch tensors.

Bit format (reference: ExpGolombWriter.java:19-49, ExpGolomb.c:32-64; the
port's counterpart of ``dct3d_tpu.ops.expgolomb.codewords``):
  signed->unsigned mapping  m = 2v-1 if v > 0 else -2v
  code number               c = m + 1          (so c >= 1)
  emitted bits              c written MSB-first in a field of
                            2*bitlen(c) - 1 bits (the top bits are zeros)
"""

from __future__ import annotations

import torch


def codewords(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer values -> (code, width), both int64.

    int64 because torch on the CPU has no shifts on uint32.  bitlen(c) is
    the binary exponent from frexp, exact for every c < 2^53.
    """
    v = values.to(torch.int64)
    code = torch.where(v > 0, 2 * v - 1, -2 * v) + 1
    nbits = torch.frexp(code.to(torch.float64)).exponent.to(torch.int64)
    return code, 2 * nbits - 1


def to_word_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor with the same 32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def grouped(code: torch.Tensor, width: torch.Tensor,
            group: int = 256) -> tuple[torch.Tensor, torch.Tensor]:
    """(n,) codes in [0, 2^32) and widths -> contiguous (g, group) int32
    tensors (codes as their uint32 bit patterns), zero-padded to whole
    groups: trailing zero-width slots write no bits (K5's input)."""
    pad = (-code.numel()) % group
    code = torch.nn.functional.pad(code.to(torch.int64), (0, pad))
    width = torch.nn.functional.pad(width.to(torch.int32), (0, pad))
    return to_word_bits(code).reshape(-1, group), width.reshape(-1, group)
