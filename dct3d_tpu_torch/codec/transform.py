"""Device pipeline: frames <-> quantized zigzag coefficients <-> bits.

The port's counterpart of ``dct3d_tpu.codec.transform`` (reference profile,
float32, any cube geometry):

  encode step:  (T, H, W) uint8 (transport_delta: wrapping temporal
                deltas, rebuilt GOP by GOP with a mod-256 prefix sum)
                -> f32 cubes + exact int32 cube sums (K1 for 8x8x8 cubes,
                   ops/relayout.py; codec/framing.py otherwise)
                -> (num_cubes, cube) @ (cube, cube) f32 matmul
                   [3D DCT + quantization + zigzag folded into the matrix]
                -> round half away from zero, exact DC (ops/quant.py)
                -> Exp-Golomb bit pack (ops/bitpack.py): K2 + K3 for whole
                   256-value groups, K5 + K3 otherwise
                -> next GOP's carry, on the device
  decode step:  nibble plane + exceptions + DC -> two f32 matmuls
                -> clamp, truncating cast, cubes -> frames (K4 for 8x8x8
                   cubes, framing otherwise) (transport_delta: wrapping
                   temporal deltas, GOP by GOP, for the host to undo)

The large matmuls stay ``torch.matmul``, as the JAX package leaves them to
XLA; full float32 (no TF32) keeps quantized-integer parity with the
float64 oracle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import CodecConfig
from ..ops import bitpack, dct, expgolomb, group_pack, quant, relayout
from . import framing


def _full_f32() -> None:
    """Turn TF32 off for matmuls and convolutions (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _assert_full_f32() -> None:
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 matmul precision was lowered after the TransformContext "
            "was built; quantized-integer parity needs full float32"
        )


def _check_supported(cfg: CodecConfig) -> None:
    """Raise NotImplementedError for configurations the port lacks yet
    (each names its ROADMAP Queue 1 item)."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "only compute_dtype='float32' (ROADMAP Queue 1: bf16 profile)"
        )


_MATRICES = ("enc_t", "enc_t_pair", "dec_me", "dec_mo")


def host_matrices(cfg: CodecConfig) -> dict[str, np.ndarray]:
    """The float32 encode matrix, its pair-permuted twin (turbo profile),
    and the even/odd coefficient-row halves of the decode matrix, built in
    float64 on the host (ops/dct.py)."""
    dec = dct.decode_matrix(cfg, np.float32)
    return {
        "enc_t": dct.encode_matrix(cfg, np.float32),
        "enc_t_pair": dct.encode_matrix_pair(cfg, np.float32),
        "dec_me": np.ascontiguousarray(dec[0::2]),
        "dec_mo": np.ascontiguousarray(dec[1::2]),
    }


class TransformContext:
    """The constant encode/decode matrices, as float32 tensors on ``device``.

    ``device`` is required: "cuda" runs the kernels (and raises without a
    card), "cpu" runs their plain versions.  Building a context turns TF32
    off process-wide.
    """

    def __init__(self, cfg: CodecConfig | None, device,
                 arrays: dict[str, np.ndarray] | None = None) -> None:
        self.cfg = cfg or CodecConfig()
        _check_supported(self.cfg)
        if device is None:
            raise ValueError("TransformContext needs an explicit device")
        self.device = torch.device(device)
        _full_f32()
        arrays = host_matrices(self.cfg) if arrays is None else arrays
        self.enc_t, self.enc_t_pair, self.dec_me, self.dec_mo = (
            torch.tensor(np.asarray(arrays[k], np.float32), device=self.device)
            for k in _MATRICES
        )

    @classmethod
    def from_numpy(cls, arrays: dict[str, np.ndarray], cfg: CodecConfig | None,
                   device) -> "TransformContext":
        """A context from {"enc_t", "enc_t_pair", "dec_me", "dec_mo"}
        arrays, e.g. ``np.asarray`` of a JAX TransformContext's
        attributes."""
        return cls(cfg, device, arrays)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``; to a card through pinned memory
    with a non-blocking copy on the current stream.  Read-only arrays (views
    of decompressed bytes) are copied, never aliased."""
    arr = np.ascontiguousarray(arr)
    if device.type == "cuda":
        host = torch.empty(arr.shape, dtype=getattr(torch, arr.dtype.name),
                           pin_memory=True)
        host.numpy()[...] = arr
        return host.to(device, non_blocking=True)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def _cubes_and_sums(frames: torch.Tensor,
                    cfg: CodecConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(T, H, W) uint8 -> ((num_cubes, cube) f32 pixels, (num_cubes,) exact
    int32 pixel sums): K1 where it covers the geometry, else framing's
    transpose (the route is chosen by geometry, as in the JAX package)."""
    t, h, w = frames.shape
    if relayout.supports(cfg, h, w):
        return relayout.frames_to_cubes(frames)
    cubes = framing.frames_to_cubes(frames, cfg)
    return cubes.float(), cubes.sum(1, dtype=torch.int32)


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
    """(num_cubes, cube) f32 pixels -> clamp to [0, 255] (3dDCT.cl:256-262),
    truncating uint8 cast (decoder.c:30), (T, H, W) frames: K4 where it
    covers the geometry, else framing's transpose.  With transport_delta
    the frames leave as wrapping temporal deltas, GOP by GOP (the host
    undoes them with decoder._undelta)."""
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
    """(num_cubes, cube) f32 pixel cubes -> int32 quantized zigzag
    coefficients.  DC (column 0, divisor 1) is the one coefficient where a
    1-ulp f32 wobble can cross the rounding boundary against the float64
    oracle, so it is replaced by the exact fixed-point quantizer of the
    integer cube sums (ops/quant.exact_dc_quant), for cubes of at most 4096
    pixels (sums < 2^20), the JAX package's gate."""
    _assert_full_f32()
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
    pixels stay within its <= 1 LSB envelope)."""
    _assert_full_f32()
    return ce.to(torch.float32) @ dec_me + co.to(torch.float32) @ dec_mo


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
