"""Device-side sparse-exception compaction for the turbo (planar) profile.

The port's counterpart of ``dct3d_tpu.ops.exceptions``.  The turbo wire
ships quantized coefficients as a packed-nibble plane plus an exception
list for values outside [-8, 7].  Values are grouped 256 to a group and K6
(ops/exc_pack.py) lists each group's exceptions in dense (g, slots) tables
that the host compacts.  One kernel covers every ``slots`` from 1 to 256,
so the JAX package's einsum and argsort routes have no counterpart here.

Groups hold at most ``slots`` exceptions; denser groups raise the overflow
flag and the encoder retries with slots=256, which cannot overflow.
"""

from __future__ import annotations

import numpy as np
import torch

from . import exc_pack

#: default exception slots per 256-value group (typical content runs
#: ~0.2-1.5% exceptions; 16 slots = 6.25% local headroom)
DEFAULT_SLOTS = 16


def compact_exceptions(values: torch.Tensor, slots: int = DEFAULT_SLOTS,
                       dc_stride: int = 0) -> tuple[torch.Tensor, ...]:
    """(n,) int32 -> dense per-group exception tables.

    Returns (lidx, vals, counts, overflow):
      lidx: (g, slots) uint8, the in-group index of each exception, slot
        order = stream order; slots >= counts[g] are zero.
      vals: (g, slots) int16, the exception values (|v| <= 5771).
      counts: (g,) int32, exceptions in each group.
      overflow: () bool tensor, some group exceeded ``slots`` (its tables
        are incomplete; retry with slots=256).

    dc_stride > 0 excludes positions with flat index % dc_stride == 0 (the
    DC coefficient of every cube), which the turbo wire ships densely.  On
    the card, values whose length is a multiple of 256 must start on a
    16-byte boundary (K6 reads it with 16-byte loads), or ValueError is
    raised; other lengths are padded into a fresh tensor first.
    """
    n = values.shape[0]
    pad = (-n) % exc_pack.GROUP
    if pad:
        # Zeros are in-nibble, never exceptions, and keep indices below n.
        values = torch.cat([values, values.new_zeros(pad)])
    lidx, vals, counts = exc_pack.compact_groups(
        values.reshape(-1, exc_pack.GROUP), slots, dc_stride)
    return lidx, vals, counts, (counts > slots).any()


def expand_exceptions_np(lidx: np.ndarray, vals: np.ndarray,
                         counts: np.ndarray, group: int = 256):
    """Host half: dense (g, slots) tables -> sorted flat (idx, val) lists."""
    slots = lidx.shape[1]
    sel = np.arange(slots)[None, :] < counts[:, None]
    gsel, ssel = np.nonzero(sel)
    idx = (gsel * group + lidx[gsel, ssel]).astype(np.int64)
    return idx, vals[gsel, ssel].astype(np.int32)
