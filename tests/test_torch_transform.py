"""The port's device steps (codec/transform.py) against the JAX package's
and the float64 oracle, on the CPU.

Quantized ints must be equal (0 flips measured at these sizes; at 1080p an
f32 path flips about one AC coefficient in 2M at .5 boundaries, checked on
the card by chip_smoke.py).  Decoded pixels may differ by 1 LSB on < 1% of
pixels: the port's two f32 matmuls sum in another order than XLA's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import config as j_config
from dct3d_tpu import oracle
from dct3d_tpu.codec import decoder as j_decoder
from dct3d_tpu.codec import framing as j_framing
from dct3d_tpu.codec import transform as j_transform
from dct3d_tpu_torch.codec import decoder, transform
from dct3d_tpu_torch.config import CodecConfig
from dct3d_tpu_torch.ops import relayout

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def contexts():
    return (transform.TransformContext(None, "cpu"),
            j_transform.TransformContext(j_config.CodecConfig()))


def _noise(t, h, w, seed=11):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w), dtype=np.uint8)


CLIPS = {
    "suite": lambda: synthetic_video(16, 64, 64),
    "noise": lambda: _noise(8, 128, 128),
}


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_quantize_equals_jax_and_oracle(clip, contexts):
    frames = CLIPS[clip]()
    ctx, jctx = contexts
    q = transform.quantize_step(torch.from_numpy(frames), ctx).numpy()
    jq = np.asarray(j_transform.quantize_step(jnp.asarray(frames), jctx.enc_t,
                                              cfg=jctx.cfg))
    assert q.dtype == np.int32
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(q, oracle.quantized_coefficients(frames, jctx.cfg))


@pytest.mark.parametrize("carry", [(0, 0), (1, 1), (0x55, 7)])
def test_encode_step_equals_jax(carry, contexts):
    """Packed bits, total bits and the device-side next carry of one GOP."""
    ctx, jctx = contexts
    frames = synthetic_video(8, 32, 64, seed=4)
    gop = transform.encode_step(torch.from_numpy(frames), ctx,
                                torch.tensor(carry[0]), torch.tensor(carry[1]))
    nbytes = -(-int(gop.total_bits) // 8)
    jgop = j_transform.encode_step(
        jnp.asarray(frames), jctx.enc_t, jnp.uint32(carry[0]), jnp.int32(carry[1]),
        max_bytes=jctx.max_packed_bytes_worst_case(frames.size), cfg=jctx.cfg,
        tight=False)
    assert int(gop.total_bits) == int(jgop.total_bits)
    assert (int(gop.carry_code), int(gop.carry_bits)) == (
        int(jgop.carry_code), int(jgop.carry_bits))
    np.testing.assert_array_equal(gop.packed.numpy()[:nbytes],
                                  np.asarray(jgop.packed)[:nbytes])


def _planar(frames, jctx):
    """(plane, exc_idx, exc_val) of a clip's quantized ints, as the C
    decoder hands them over (nibbles, values outside [-8, 7] listed)."""
    q = oracle.quantized_coefficients(frames, jctx.cfg).reshape(-1)
    nib = (q & 0xF).astype(np.uint8)
    plane = nib[0::2] | (nib[1::2] << 4)
    idx = np.flatnonzero((q < -8) | (q > 7)).astype(np.int32)
    return plane, idx, q[idx]


@pytest.mark.parametrize("clip", sorted(CLIPS))
def test_decode_step_pixels_match_jax(clip, contexts):
    frames = CLIPS[clip]()
    ctx, jctx = contexts
    t, h, w = frames.shape
    planar = _planar(frames, jctx)
    got = decoder._dispatch_planar4(planar, ctx, h, w).numpy()
    want = np.asarray(j_decoder._dispatch_planar4(planar, jctx, jctx.cfg, h, w))
    assert got.dtype == np.uint8 and got.shape == frames.shape
    d = np.abs(got.astype(np.int16) - want)
    print(f"{clip}: {int((d > 0).sum())} of {d.size} pixels differ, max {int(d.max())}")
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_split_dc_flat_equals_jax():
    rng = np.random.default_rng(2)
    plane = rng.integers(0, 256, 4 * 256, dtype=np.uint8)
    idx = np.array([0, 3, 512, 700, 1536], np.int32)
    val = np.array([900, -20, -9, 40, 77], np.int32)
    got = decoder._split_dc_flat(plane, idx, val, 512)
    want = j_decoder._split_dc_flat(plane, idx, val, 512)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_lowered_matmul_precision_raises(contexts):
    ctx, _ = contexts
    frames = torch.from_numpy(synthetic_video(8, 16, 16))
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="float32"):
            transform.quantize_step(frames, ctx)
    finally:
        torch.set_float32_matmul_precision("highest")
    assert transform.quantize_step(frames, ctx).shape == (4, 512)


@pytest.mark.parametrize("cfg", [
    CodecConfig(compute_dtype="bfloat16"),
    CodecConfig(transport_delta=True),
], ids=["bf16", "transport_delta"])
def test_context_scope_guards(cfg):
    """Both contexts build.  bf16: its matrices are bfloat16 and equal the
    JAX context's, and quantize_step's ints equal the JAX package's bf16
    ints.  transport_delta: its device steps take and give wrapping
    temporal deltas: the front half rebuilds the frames GOP by GOP (the
    ints equal quantize_step's on the raw frames), and _finish_frames
    emits one GOP's deltas as the JAX package's does."""
    if cfg.compute_dtype != "float32":
        ctx = transform.TransformContext(cfg, "cpu")
        jctx = j_transform.TransformContext(j_config.CodecConfig(compute_dtype="bfloat16"))
        for k in ("enc_t", "enc_t_pair", "dec_me", "dec_mo"):
            assert getattr(ctx, k).dtype == torch.bfloat16
            np.testing.assert_array_equal(getattr(ctx, k).float().numpy(),
                                          np.asarray(getattr(jctx, k)).astype(np.float32))
        frames = _noise(16, 32, 48)
        np.testing.assert_array_equal(
            transform.quantize_step(torch.from_numpy(frames), ctx).numpy(),
            np.asarray(j_transform.quantize_step(jnp.asarray(frames), jctx.enc_t,
                                                 cfg=jctx.cfg)))
        return
    ctx = transform.TransformContext(cfg, "cpu")
    frames = _noise(16, 32, 48)
    delta = np.concatenate([
        np.concatenate([g[:1], np.diff(g, axis=0)]) for g in (frames[:8], frames[8:])])
    q = transform._frames_to_q(torch.from_numpy(delta), ctx.enc_t, cfg)
    np.testing.assert_array_equal(q.numpy(), transform.quantize_step(
        torch.from_numpy(frames), ctx).numpy())
    np.testing.assert_array_equal(
        transform._undelta_frames(torch.from_numpy(delta), cfg).numpy(), frames)
    jcfg = j_config.CodecConfig(transport_delta=True)
    pixels = np.random.default_rng(6).uniform(-40.0, 300.0, (6 * 4, 512)).astype(np.float32)
    got = transform._finish_frames(torch.from_numpy(pixels), cfg, 48, 32)
    want = j_transform._finish_frames(jnp.asarray(pixels), jcfg, 48, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(decoder._undelta(got.numpy(), cfg),
                                  j_decoder._undelta(np.asarray(want), jcfg))


def test_context_needs_device():
    with pytest.raises(ValueError, match="device"):
        transform.TransformContext(None, None)


ALT_BLOCKS = {"4x4x4": (4, 4, 4), "8x8x4": (8, 8, 4)}


@pytest.mark.parametrize("clip", sorted(CLIPS))
@pytest.mark.parametrize("block", sorted(ALT_BLOCKS))
def test_alternate_blocks_quantize_and_decode_equal_jax(block, clip):
    """Alternate blocks take framing's transposes on every device (K1 and
    K4 cover 8x8x8 cubes only, as the TPU kernels do): ints equal the JAX
    package's, and the decode step's pixels its within 1 LSB."""
    blocks = dict(zip(("block_w", "block_h", "block_d"), ALT_BLOCKS[block]))
    cfg, jcfg = CodecConfig(**blocks), j_config.CodecConfig(**blocks)
    assert not relayout.supports(cfg, 64, 64) and relayout.supports(CodecConfig(), 64, 64)
    ctx, jctx = transform.TransformContext(cfg, "cpu"), j_transform.TransformContext(jcfg)
    frames = CLIPS[clip]()
    cubes, sums = transform._cubes_and_sums(torch.from_numpy(frames), cfg)
    want = np.asarray(j_framing.frames_to_cubes(jnp.asarray(frames), jcfg))
    np.testing.assert_array_equal(cubes.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(sums.numpy(), want.astype(np.int64).sum(1))
    q = transform.quantize_step(torch.from_numpy(frames), ctx).numpy()
    np.testing.assert_array_equal(
        q, np.asarray(j_transform.quantize_step(jnp.asarray(frames), jctx.enc_t, cfg=jcfg)))
    t, h, w = frames.shape
    planar = _planar(frames, jctx)
    got = decoder._dispatch_planar4(planar, ctx, h, w).numpy()
    want = np.asarray(j_decoder._dispatch_planar4(planar, jctx, jcfg, h, w))
    d = np.abs(got.astype(np.int16) - want)
    assert got.shape == frames.shape and d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("block", sorted(ALT_BLOCKS))
def test_alternate_blocks_finish_frames_equal_jax(block):
    """Clamp, truncating cast and cubes -> frames at the alternate blocks,
    against the JAX package's _finish_frames."""
    blocks = dict(zip(("block_w", "block_h", "block_d"), ALT_BLOCKS[block]))
    cfg, jcfg = CodecConfig(**blocks), j_config.CodecConfig(**blocks)
    h, w = 3 * cfg.block_h, 5 * cfg.block_w  # two GOPs of 3 x 5 cubes
    pixels = np.random.default_rng(6).uniform(-40.0, 300.0, (2 * 3 * 5, cfg.cube_size))
    pixels = pixels.astype(np.float32)
    pixels[:, :4] = (-0.5, 0.999, 254.999, 255.0)
    got = transform._finish_frames(torch.from_numpy(pixels), cfg, h, w)
    want = j_transform._finish_frames(jnp.asarray(pixels), jcfg, h, w)
    assert got.dtype == torch.uint8 and got.shape == (2 * cfg.block_d, h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
