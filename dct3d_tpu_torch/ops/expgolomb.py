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
