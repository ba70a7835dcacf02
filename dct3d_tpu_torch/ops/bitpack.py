"""Device-side parallel bit packing of Exp-Golomb codewords.

The port's counterpart of ``dct3d_tpu.ops.bitpack``.  ``pack_values`` packs
a batch of whole 256-value groups in five steps:

  1. group geometry — each group's bit count (group_bits, ops/group_pack.py)
     and start bit (one cumsum over the groups, plain torch as it is plain
     XLA in the JAX package), its start word and its bit phase within that
     word;
  2. level 1, K2 (ops/group_pack.py): each group packed at its phase, only
     the words that hold its bits defined;
  3. the carry — the previous batch's partial byte — ORed into word 0;
  4. level 2, K3 (ops/splice.py): groups placed at their start words, each
     stream word through the last bit written once (no zero fill);
  5. the tail byte (the byte holding the last bit, the next batch's carry
     source) read from the finished buffer, on the device.

``pack_bits`` packs any batch of precomputed (code, width) fields: the
carry rides as a leading pseudo-codeword and zero-width slots pad the last
group, so level 1 is K5 (codes and widths in, no carry step) and the rest
is as above.  The encoders take it for batches that are not whole groups
(4x4x4 cubes at frame sizes whose cube count per GOP is not a multiple of
4).

The JAX package caps its buffers at a bit budget to give XLA small static
shapes, flags overflow and retries.  Here both buffers have the worst-case
size (about 57 MB of group rows and 56 MB of stream per 1080p GOP), so
nothing overflows and there is no retry; the bytes are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from . import expgolomb, group_pack, splice


def max_codeword_bits(cube_size: int) -> int:
    """Worst-case Exp-Golomb field width for quantized 3D-DCT coefficients
    of 8-bit video: |c| <= 255*sqrt(cube) (orthonormal basis; divisors only
    shrink it), code number m+1 <= 2*|c|+2."""
    max_code = 2 * int(np.ceil(255.0 * np.sqrt(cube_size))) + 2
    return 2 * max_code.bit_length() - 1


def worst_case_w_words(group: int, max_width: int = 32) -> int:
    """Per-group buffer words that can never overflow."""
    return -(-group * min(max_width, 32) // 32) + 2


def stream_words(n: int, max_width: int) -> int:
    """Stream buffer words that can never overflow: a carry of at most 7
    bits, then n codewords of at most max_width bits."""
    return (7 + n * max_width + 31) // 32


def _check_batch(n: int, max_width: int) -> None:
    if not 1 <= max_width <= 32:
        raise ValueError(f"max_width {max_width} not in 1..32")
    if n * max_width >= 1 << 31:
        # Bit offsets are int32 in the kernels (a 1080p GOP is ~0.45 Gbit
        # worst case).
        raise ValueError(f"batch of {n} codewords can exceed 2^31 bits")


def geometry(v2: torch.Tensor, carry_bits: torch.Tensor,
             gbits: torch.Tensor | None = None):
    """Group bit geometry of (g, 256) values after a carry of carry_bits
    bits: (gstart, gend) int64, each group's first bit and end bit
    (exclusive).  Start word = gstart >> 5, phase = gstart & 31.  The bit
    counts come from group_bits (a kernel on the card) unless the caller
    has them already (``gbits``, group_bits of the same v2); the cumsum
    runs in int64.  On the card v2 must start on a 16-byte boundary
    (group_bits reads it with 16-byte loads), or group_bits raises
    ValueError."""
    if gbits is None:
        gbits = group_pack.group_bits(v2)
    gstart = torch.cumsum(gbits, 0, dtype=torch.int64) - gbits + carry_bits
    return gstart, gstart + gbits


def or_carry_lead(buf_groups: torch.Tensor, carry_code: torch.Tensor,
                  carry_bits: torch.Tensor) -> None:
    """OR the carry's bits into word 0 of group 0, in place.  They live at
    [0, carry_bits) of word 0 and group 0 starts at bit carry_bits, so
    nothing overlaps.  Word 0 is always among the words [0, nw) that K2
    defines in a row; words past nw hold no defined value on the card.  The shift is masked to dodge a shift by 32 when
    carry_bits == 0, which `where` discards."""
    lead = torch.where(carry_bits > 0, carry_code << ((32 - carry_bits) & 31), 0)
    buf_groups[0, :1].bitwise_or_(expgolomb.to_word_bits(lead.reshape(1)))


def _finish(buf_groups, gstart, gend, n: int, max_width: int):
    """Level 2 (K3) and the tail byte: (buf, total_bits, tail_byte, False).

    Only words [0, nw) of each row of buf_groups are read, nw the words
    through the one holding the group's bit gend - 1: K2 and K5 define no
    others on the card (the plain versions zero them).  The stream buffer's
    words [0, ceil(total_bits / 32)) are each written once, bits past
    total_bits zero; words past the total bit length are unspecified (the
    caller slices to the true byte count), and nothing zeroes them.  The
    tail byte is the byte holding bit total_bits - 1, inside those words
    (with total_bits 0 there is none, and it is unspecified).
    """
    buf = splice.splice(buf_groups, (gstart >> 5).to(torch.int32),
                        gend.to(torch.int32), stream_words(n, max_width))
    total_bits = gend[-1]
    tail_byte = buf.index_select(0, ((total_bits - 1).clamp(min=0) >> 3).reshape(1))
    return buf, total_bits, tail_byte[0].to(torch.int64), False


def pack_values(values: torch.Tensor, carry_code: torch.Tensor,
                carry_bits: torch.Tensor, max_width: int = 32,
                gbits: torch.Tensor | None = None):
    """Pack int32 coefficients after a leading partial byte.

    values: (n,) int32 with n a nonzero multiple of 256, codewords at most
    ``max_width`` (<= 32) bits.  carry_code / carry_bits: 0-d int64 tensors
    on the same device, the carry's value right-aligned in carry_bits
    (0..7) bits; the stream starts with those bits.  On the card values
    must start on a 16-byte boundary (a fresh tensor does; a view that
    starts mid-row may not), or ValueError is raised.

    Returns (buf, total_bits, tail_byte, overflow) like the JAX function:
    buf the (4 * nwords,) uint8 MSB-first stream, its words [0,
    ceil(total_bits / 32)) defined with the bits past total_bits zero, and
    words past the total bit length unspecified (the caller slices to the
    true byte count; the plain route on the CPU zeroes them); total_bits
    and tail_byte 0-d int64 tensors on the device (tail_byte is the byte
    holding bit total_bits - 1); overflow always False.  ``gbits``: the
    values' per-group bit counts when the caller has them (geometry).
    """
    n, group = values.numel(), group_pack.GROUP
    if not n or n % group:
        raise ValueError(f"pack_values needs whole {group}-value groups, got {n}")
    _check_batch(n, max_width)
    v2 = values.reshape(-1, group)
    gstart, gend = geometry(v2, carry_bits, gbits)
    buf_groups = group_pack.group_pack_values(
        v2, (gstart & 31).to(torch.int32), worst_case_w_words(group, max_width)
    )
    or_carry_lead(buf_groups, carry_code, carry_bits)
    return _finish(buf_groups, gstart, gend, n, max_width)


def pack_bits(code: torch.Tensor, width: torch.Tensor, max_width: int = 32):
    """Pack codewords from bit 0 of the stream.

    code: (n,) integer tensor, each field's payload right-aligned, in
    [0, 2^32); width: (n,) field widths in [0, max_width] (max_width
    <= 32).  Real codewords have width >= 1; zero-width slots may only lead
    (the carry pseudo-codeword) or trail, as in the JAX function: K3 relies
    on every group but the last spanning whole words.

    Returns (buf, total_bits, tail_byte, overflow) like pack_values (the
    stream's words [0, ceil(total_bits / 32)) defined, words past the
    total bit length unspecified); for n == 0, a zero buffer and zeros, as
    the JAX function returns.  On the card the codes and widths go to K5
    as fresh grouped tensors, so they need no alignment of their own.
    """
    n, group = width.numel(), group_pack.GROUP
    _check_batch(n, max_width)
    if n == 0:
        zero = torch.zeros((), dtype=torch.int64, device=width.device)
        buf = torch.zeros(4 * stream_words(0, max_width), dtype=torch.uint8,
                          device=width.device)
        return buf, zero, zero.clone(), False
    code2, wid2 = expgolomb.grouped(code, width, group)
    gbits = wid2.sum(1, dtype=torch.int64)
    gstart = torch.cumsum(gbits, 0) - gbits
    buf_groups = group_pack.group_pack_codes(
        code2, wid2, (gstart & 31).to(torch.int32),
        worst_case_w_words(group, max_width),
    )
    return _finish(buf_groups, gstart, gstart + gbits, n, max_width)
