"""Device pipeline: frames <-> quantized zigzag coefficients <-> bits.

The port's counterpart of ``dct3d_tpu.codec.transform`` (reference profile,
any cube geometry, in the cfg's ``compute_dtype``: float32 or bfloat16):

  encode step:  (T, H, W) uint8 (transport_delta: wrapping temporal
                deltas, rebuilt GOP by GOP with a mod-256 prefix sum)
                -> cubes in the compute dtype + exact int32 cube sums (K1,
                   or its bf16 form, for 8x8x8 cubes, ops/relayout.py;
                   codec/framing.py otherwise)
                -> (num_cubes, cube) @ (cube, cube) matmul in that dtype
                   [3D DCT + quantization + zigzag folded into the matrix]
                -> round half away from zero, in that dtype; exact DC
                   (ops/quant.py)
                -> Exp-Golomb bit pack (ops/bitpack.py): K2 + K3 for whole
                   256-value groups, K5 + K3 otherwise
                -> next GOP's carry, on the device
  decode step:  nibble plane + exceptions + DC -> two matmuls in the
                compute dtype, summed in it
                -> clamp, truncating cast, cubes -> frames (K4, or its bf16
                   form, for 8x8x8 cubes; framing otherwise)
                   (transport_delta: wrapping temporal deltas, GOP by GOP,
                   for the host to undo)

The large matmuls stay ``torch.matmul``, as the JAX package leaves them to
XLA.  float32 runs in full float32 (no TF32), which keeps quantized-integer
parity with the float64 oracle.  bfloat16 is the lossy fast profile: as in
the JAX package, each product returns bfloat16 and the round and the
decode's sum run in bfloat16; the products accumulate in float32 (cuBLAS's
reduced-precision split-K reduction is turned off).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CodecConfig
from ..ops import bitpack, dct, expgolomb, group_pack, quant, relayout
from . import framing

#: cfg.compute_dtype -> the torch dtype of the matrices and the matmuls
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(cfg: CodecConfig) -> torch.dtype:
    """The torch dtype of cfg.compute_dtype; raises on any other name."""
    try:
        return DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(f"compute_dtype must be one of {sorted(DTYPES)}, "
                         f"got {cfg.compute_dtype!r}") from None


def _set_precision(dtype: torch.dtype) -> None:
    """Process-wide matmul settings the dtype's parity needs: float32 turns
    TF32 off for matmuls and convolutions; bfloat16 turns off cuBLAS's
    bfloat16 reduction of split-K partial sums (XLA accumulates in
    float32)."""
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    else:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _assert_precision(dtype: torch.dtype) -> None:
    if dtype == torch.float32:
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError(
                "float32 matmul precision was lowered after the "
                "TransformContext was built; quantized-integer parity needs "
                "full float32"
            )
    elif torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction:
        raise RuntimeError(
            "bfloat16 reduced-precision reduction was turned on after the "
            "TransformContext was built; the bfloat16 profile accumulates "
            "in float32"
        )


_MATRICES = ("enc_t", "enc_t_pair", "dec_me", "dec_mo")


def host_matrices(cfg: CodecConfig) -> dict[str, torch.Tensor]:
    """The encode matrix, its pair-permuted twin (turbo profile), and the
    even/odd coefficient-row halves of the decode matrix: built in float64
    on the host (ops/dct.py), then cast once to cfg.compute_dtype (CPU
    tensors).  torch's float64 -> bfloat16 cast rounds as ml_dtypes', which
    the JAX package uses."""
    dtype = compute_dtype(cfg)
    dec = dct.decode_matrix(cfg, np.float64)
    arrays = {
        "enc_t": dct.encode_matrix(cfg, np.float64),
        "enc_t_pair": dct.encode_matrix_pair(cfg, np.float64),
        "dec_me": dec[0::2],
        "dec_mo": dec[1::2],
    }
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            for k, a in arrays.items()}


class TransformContext:
    """The constant encode/decode matrices, as tensors of the cfg's
    compute dtype on ``device``.

    ``device`` is required: "cuda" runs the kernels (and raises without a
    card), "cpu" runs their plain versions.  Building a context sets the
    dtype's matmul precision process-wide (_set_precision).
    """

    def __init__(self, cfg: CodecConfig | None, device,
                 arrays: dict[str, torch.Tensor] | None = None) -> None:
        self.cfg = cfg or CodecConfig()
        if device is None:
            raise ValueError("TransformContext needs an explicit device")
        self.device = torch.device(device)
        self.dtype = compute_dtype(self.cfg)
        _set_precision(self.dtype)
        arrays = host_matrices(self.cfg) if arrays is None else arrays
        self.enc_t, self.enc_t_pair, self.dec_me, self.dec_mo = (
            arrays[k].to(self.device, self.dtype) for k in _MATRICES
        )

    @classmethod
    def from_numpy(cls, arrays: dict[str, np.ndarray], cfg: CodecConfig | None,
                   device) -> "TransformContext":
        """A context from {"enc_t", "enc_t_pair", "dec_me", "dec_mo"}
        arrays, e.g. ``np.asarray`` of a JAX TransformContext's attributes.
        Each passes through float32, which holds a bfloat16 value
        exactly."""
        return cls(cfg, device, {k: torch.tensor(np.asarray(arrays[k], np.float32))
                                 for k in _MATRICES})


def _cubes_and_sums(frames: torch.Tensor,
                    cfg: CodecConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, H, W) uint8 -> ((num_cubes, cube) pixels in the compute dtype
    (exact: bfloat16 holds every integer up to 256), (num_cubes,) exact
    int32 pixel sums): K1 or its bf16 form where it covers the geometry,
    else framing's transpose (the route is chosen by geometry, as in the
    JAX package)."""
    t, h, w = frames.shape
    dtype = compute_dtype(cfg)
    if relayout.supports(cfg, h, w):
        return relayout.frames_to_cubes(frames, dtype)
    cubes = framing.frames_to_cubes(frames, cfg)
    return cubes.to(dtype), cubes.sum(1, dtype=torch.int32)


def _by_gop(frames: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """(T, H, W) -> (T / gop, gop, H, W) view: transport deltas restart at
    every GOP."""
    t, h, w = frames.shape
    return frames.reshape(t // cfg.gop_size, cfg.gop_size, h, w)


def _undelta_frames(frames: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """Rebuild frames shipped as wrapping uint8 temporal deltas: a mod-256
    prefix sum over each GOP's frames, kept in uint8 (wrapping adds are the
    mod)."""
    return torch.cumsum(_by_gop(frames, cfg), 1, dtype=torch.uint8).reshape(frames.shape)


def _frames_to_q(frames: torch.Tensor, enc_t: torch.Tensor,
                 cfg: CodecConfig) -> torch.Tensor:
    """Front half of every encode step: (T, H, W) uint8 frames, raw or
    transport deltas, -> (num_cubes, cube) int32 quantized coefficients in
    the column order of ``enc_t``."""
    if cfg.transport_delta:
        frames = _undelta_frames(frames, cfg)
    cubes, sums = _cubes_and_sums(frames, cfg)
    return _quantize(cubes, sums, enc_t, cfg)


def _finish_frames(pixels: torch.Tensor, cfg: CodecConfig, height: int,
                   width: int) -> torch.Tensor:
    """(num_cubes, cube) pixels in the compute dtype -> clamp to [0, 255]
    (3dDCT.cl:256-262), truncating uint8 cast (decoder.c:30), (T, H, W)
    frames: K4 or its bf16 form where it covers the geometry, else
    framing's transpose.  With transport_delta the frames leave as
    wrapping temporal deltas, GOP by GOP (the host undoes them with
    decoder._undelta)."""
    if relayout.supports(cfg, height, width):
        frames = relayout.cubes_to_frames(pixels, height, width)
    else:
        frames = framing.cubes_to_frames(pixels.clamp(0.0, 255.0).to(torch.uint8),
                                         cfg, height, width)
    if cfg.transport_delta:
        f = _by_gop(frames, cfg)
        frames = torch.cat([f[:, :1], f[:, 1:] - f[:, :-1]], 1).reshape(frames.shape)
    return frames


def _quantize(cubes: torch.Tensor, sums: torch.Tensor, enc_t: torch.Tensor,
              cfg: CodecConfig) -> torch.Tensor:
    """(num_cubes, cube) pixel cubes -> int32 quantized zigzag
    coefficients.  The product and the round run in the matrix's dtype, as
    in the JAX package: in bfloat16 the product returns bfloat16 and the
    bias add rounds to bfloat16 too (an f32 round after an upcast gives
    other ints).  DC (column 0, divisor 1) is the one coefficient where a
    1-ulp f32 wobble can cross the rounding boundary against the float64
    oracle, so it is replaced by the exact fixed-point quantizer of the
    integer cube sums (ops/quant.exact_dc_quant), for cubes of at most 4096
    pixels (sums < 2^20), the JAX package's gate."""
    _assert_precision(enc_t.dtype)
    scaled = cubes @ enc_t
    # q = sign(x)*floor(|x| + bias): round half away from zero at bias 0.5
    # (C roundf, encoder.c:53), a deadzone quantizer below it.
    q = torch.trunc(scaled + torch.copysign(scaled.new_full((), cfg.quant_bias),
                                            scaled)).to(torch.int32)
    if cfg.cube_size <= 4096:
        q[:, 0] = quant.exact_dc_quant(sums, cfg.cube_size, cfg.quant_bias)
    return q


def quantize_step(frames: torch.Tensor, ctx: TransformContext) -> torch.Tensor:
    """(T, H, W) uint8 frames -> (num_cubes, cube) int32 quantized zigzag
    coefficients, bit-identical to the float64 oracle's at test sizes.
    The frames are raw whatever cfg.transport_delta says: the host encode
    path sends them so, as the JAX package's does."""
    cubes, sums = _cubes_and_sums(frames, ctx.cfg)
    return _quantize(cubes, sums, ctx.enc_t, ctx.cfg)


class EncodedGOP(NamedTuple):
    """Device-side result of encoding one batch of frames."""

    packed: torch.Tensor  # (nbytes,) uint8, bit-concatenated codewords
    total_bits: torch.Tensor  # () int64, valid bit count in `packed`
    carry_code: torch.Tensor  # () int64, trailing partial byte, right-aligned
    carry_bits: torch.Tensor  # () int64, 0..7
    overflow: bool  # always False: buffers are worst-case sized


def encode_step(frames: torch.Tensor, ctx: TransformContext,
                carry_code: torch.Tensor, carry_bits: torch.Tensor) -> EncodedGOP:
    """Encode a (T, H, W) uint8 frame batch (transport deltas when
    cfg.transport_delta) into packed Exp-Golomb bytes.

    carry_code/carry_bits: the partial trailing byte of the previous call
    (0-d int64 tensors on the device, value right-aligned in carry_bits
    bits), continuing the bitstream across GOPs like the C encoder's buffer
    carry (encoder.c:266-271).  The returned carry is computed on the
    device, so consecutive GOPs chain without a host round trip.

    Batches of whole 256-value groups take bitpack.pack_values (K2 + K3).
    Others (4x4x4 cubes at a cube count per GOP that is not a multiple of
    4) take bitpack.pack_bits (K5 + K3), with the carry as a leading
    pseudo-codeword, as the JAX package does.
    """
    q = _frames_to_q(frames, ctx.enc_t, ctx.cfg).reshape(-1)
    max_width = bitpack.max_codeword_bits(ctx.cfg.cube_size)
    if q.numel() % group_pack.GROUP == 0:
        packed, total_bits, tail_byte, overflow = bitpack.pack_values(
            q, carry_code, carry_bits, max_width=max_width)
    else:
        code, width = expgolomb.codewords(q)
        packed, total_bits, tail_byte, overflow = bitpack.pack_bits(
            torch.cat([carry_code.reshape(1), code]),
            torch.cat([carry_bits.reshape(1), width]), max_width=max_width)
    rem = total_bits % 8
    new_code = torch.where(rem > 0, tail_byte >> (8 - rem), 0)
    return EncodedGOP(packed, total_bits, new_code, rem, overflow)


def _dequant_matmul(ce: torch.Tensor, co: torch.Tensor, dec_me: torch.Tensor,
                    dec_mo: torch.Tensor) -> torch.Tensor:
    """Inverse transform as even-coefficient + odd-coefficient half matmuls,
    summed in that order like the JAX package's every decode path (so the
    pixels stay within its <= 1 LSB envelope).  The ints are cast to the
    matrices' dtype first; each product returns that dtype and the sum is
    taken in it (in bfloat16 both round: not one product over the whole
    cube, nor a float32 sum)."""
    _assert_precision(dec_me.dtype)
    return ce.to(dec_me.dtype) @ dec_me + co.to(dec_mo.dtype) @ dec_mo


def planar4_to_frames(plane: torch.Tensor, exc_idx: torch.Tensor,
                      exc_val: torch.Tensor, dc: torch.Tensor,
                      ctx: TransformContext, height: int,
                      width: int) -> torch.Tensor:
    """Decode step from the packed-nibble plane -> (T, H, W) uint8 frames.

    plane: (cubes * cube / 2,) uint8, two coefficients per byte (low nibble =
    even index), sign-extended from 4 bits.  exc_idx (int64) / exc_val
    (int32): flat coefficient index and true value of every non-DC value
    outside [-8, 7].  dc: (cubes,) int32 dense DC, spliced as column 0 of
    the even half (decoder._split_dc_flat).
    """
    hc = ctx.cfg.cube_size // 2
    half = plane.shape[0]
    b = plane.to(torch.int32)
    # One slot past the plane takes the other parity's exceptions and is
    # cut off: a sync-free split (boolean masks would wait for the device).
    lo = torch.empty(half + 1, dtype=torch.int32, device=plane.device)
    hi = torch.empty(half + 1, dtype=torch.int32, device=plane.device)
    lo[:half] = ((b & 0xF) ^ 8) - 8
    hi[:half] = (((b >> 4) & 0xF) ^ 8) - 8
    odd = (exc_idx & 1) == 1
    lo.index_put_((torch.where(odd, half, exc_idx >> 1),), exc_val)
    hi.index_put_((torch.where(odd, exc_idx >> 1, half),), exc_val)
    lo2 = lo[:half].reshape(-1, hc)
    lo2[:, 0] = dc
    pixels = _dequant_matmul(lo2, hi[:half].reshape(-1, hc), ctx.dec_me,
                             ctx.dec_mo)
    return _finish_frames(pixels, ctx.cfg, height, width)
