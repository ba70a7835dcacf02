"""Analytic quantization function (copy of ``dct3d_tpu.ops.quant``;
tests/test_torch_host.py pins divisors and exact DC to the original; the
copy's exact DC also checks its cube bound).

The reference divides each coefficient by ``max(1, q * (i + j + k))`` where
(i, j, k) are the intra-cube coordinates and q = 5, then rounds
(reference: Encoder.java:75-89, encoder.c:47-58); the decoder multiplies back
(Decoder.java:82-96, decoder.c:48-59).  The DC coefficient passes unscaled via
the ``max(1, .)`` floor.

On the device the divisor never exists as a runtime op: its reciprocal is folded into
the encode matrix and the divisor itself into the decode matrix (ops/dct.py),
so quantization costs zero FLOPs beyond the transform matmul.

Note: because the quantized values are integers and the divisors are integers,
the reference's dequantization ``round(v * divisor)`` is exactly ``v * divisor``
— the round is a no-op we do not reproduce at runtime.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=None)
def quant_divisors(
    width: int, height: int, depth: int, strength: int
) -> np.ndarray:
    """float64 divisor cube, flat layout [z][y][x] (x fastest).

    divisor[z, y, x] = max(1, strength * (x + y + z)), per Encoder.java:82.
    """
    x = np.arange(width)[None, None, :]
    y = np.arange(height)[None, :, None]
    z = np.arange(depth)[:, None, None]
    d = np.maximum(1, strength * (x + y + z)).astype(np.float64)
    return np.broadcast_to(d, (depth, height, width)).reshape(-1)


#: fixed-point fraction bits of the exact DC quantizer constant
_DC_FRAC_BITS = 50


def exact_dc_quant(sums, cube: int, bias: float):
    """Exact quantized DC from exact integer cube sums (device, int32 only).

    The DC coefficient is sum(cube pixels) / sqrt(cube) with divisor
    max(1, strength*0) = 1 — the one coefficient whose quantizer gets no
    divisor slack, so a 1-ulp float32 matmul wobble can cross the 0.5
    rounding boundary and flip the value vs the float64 oracle (observed
    ~6 per 16.6M values on boundary-adversarial content, all at zigzag
    position 0).  This computes q_dc = floor(S/sqrt(cube) + bias) EXACTLY:
    K = floor(2^50/sqrt(cube)) (exact via isqrt at trace time) and the
    38..70-bit product S*K + B evaluates in 12-bit limbs — a dozen
    elementwise int32 ops on a (num_cubes,) vector, no gathers, no sqrt.

    Exactness: K truncates 1/sqrt(cube), so the fixed-point value sits
    S*delta/2^50 below the true S/sqrt(cube) with delta < 1 — up to ~2^-30
    for S near 2^20, NOT 2^-50.  floor() still agrees because the true
    value keeps its distance from the rounding boundary: for non-square
    `cube`, S/sqrt(cube) + bias is irrational for integer S > 0 and its
    boundary distance is >= ~2^-26 over this range (continued-fraction
    bound on the quadratic irrational; the float64 oracle resolves ~2^-40
    there), and for perfect-square `cube` with half-integer bias the value
    is an exact multiple of 2^-51, where delta = 0 means no error at all.
    Re-check this margin before scaling S past 2^20 or using non-quadratic
    divisor geometry.  Requires S >= 0 (pixels are uint8; a signed level
    shift would corrupt the limb split silently), bias >= 0, and cube <=
    4096 so S < 2^20; the last two raise ValueError (the original documents
    the cube bound without checking it).
    """
    if cube > 4096:
        raise ValueError(
            f"exact_dc_quant needs cube <= 4096 (sums < 2^20), got {cube}; "
            "larger cubes keep the matmul's DC (codec/transform._quantize)"
        )
    if bias < 0:
        raise ValueError(
            "exact_dc_quant requires bias >= 0 (B's limb split assumes a "
            "non-negative fixed-point constant)"
        )
    K = math.isqrt((1 << (2 * _DC_FRAC_BITS)) // cube)
    B = int(bias * (1 << _DC_FRAC_BITS))
    s1 = sums >> 10
    s0 = sums & 1023
    c = None
    carry = 0
    for j in range(6):
        kj = (K >> (12 * j)) & 4095 if j < 5 else 0
        bj = (B >> (12 * j)) & 4095 if j < 5 else 0
        kp = (K >> (12 * (j - 1))) & 4095 if j >= 1 else 0
        u = s1 * kj
        up = (s1 * kp) >> 2 if j >= 1 else 0
        limb = s0 * kj + bj + ((u & 3) << 10) + up
        if j < 4:
            carry = (limb + carry) >> 12
        elif j == 4:
            c = limb + carry
        else:
            c = c + (limb << 12)
    return c >> 2
