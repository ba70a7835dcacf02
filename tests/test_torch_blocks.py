"""The alternate block profiles (4x4x4 and 8x8x4 cubes) of the port against
the JAX package's, end to end, on the CPU.

A 36x36 clip at 4x4x4 has 81 cubes per GOP, so its batches are not whole
256-value groups and take pack_bits (K5 + K3, the carry as a
pseudo-codeword); 64x64 clips are whole groups and take pack_values (K2 +
K3), as every 8x8x4 batch does (256-value cubes).  Streams and turbo
containers are byte-equal to the JAX package's, each package decodes the
other's, and range decode equals the slice.

The quantized ints equal the JAX package's.  Both differ from the float64
oracle only at exact rounding ties, which small cubes make common (the
4-point DCT's zero-frequency weight is 1/2, so many coefficients are exact
multiples of 1/2); the seeds are ones where the JAX encoder's fused program
and its quantize_step round those ties alike.
"""

import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import config as j_config
from dct3d_tpu import oracle
from dct3d_tpu.codec import decoder as j_decoder
from dct3d_tpu.codec import encoder as j_encoder
from dct3d_tpu.codec import turbo as j_turbo
from dct3d_tpu.ops import dct as j_dct
from dct3d_tpu_torch import (
    CodecConfig, StreamingEncoder, TransformContext, crop_frames,
    decode_frame_range, decode_turbo_container, decode_turbo_range,
    decode_video, encode_turbo_video, encode_video, pad_frames,
)
from dct3d_tpu_torch.codec import transform
from dct3d_tpu_torch.ops import bitpack
from dct3d_tpu_torch.parallel import multihost

torch.set_num_threads(2)

T = 16
# id -> (block_w, block_h, block_d), height, width, the pack route
CASES = {
    "4x4x4-36x36": ((4, 4, 4), 36, 36, "pack_bits"),
    "4x4x4-64x64": ((4, 4, 4), 64, 64, "pack_values"),
    "8x8x4-64x64": ((8, 8, 4), 64, 64, "pack_values"),
}


def _cfgs(dims, **kw):
    blocks = dict(zip(("block_w", "block_h", "block_d"), dims))
    return CodecConfig(**blocks, **kw), j_config.CodecConfig(**blocks, **kw)


@pytest.fixture(scope="module")
def runs():
    """Per case: the clip, a CPU context, the port's and the JAX package's
    streams (serial and parallel DEFLATE), the port's index, and the pack
    functions the port's encode steps called."""
    out = {}
    real = {name: getattr(bitpack, name) for name in ("pack_bits", "pack_values")}
    for case, (dims, h, w, _) in CASES.items():
        clip = synthetic_video(T, h, w, seed=9)
        cfg, jcfg = _cfgs(dims)
        ctx = TransformContext(cfg, "cpu")
        called = []
        for name, fn in real.items():
            setattr(bitpack, name,
                    lambda *a, _fn=fn, _name=name, **k: called.append(_name) or _fn(*a, **k))
        try:
            r = {"clip": clip, "cfg": cfg, "jcfg": jcfg, "ctx": ctx}
            for workers in (0, 2):
                enc = StreamingEncoder(w, h, CodecConfig(**{**vars(cfg), "deflate_workers": workers}), ctx)
                r["port", workers] = enc.push(clip) + enc.finish()
                r["index", workers] = (enc.gop_bit_ends, enc.gop_sync_offsets)
                r["jax", workers] = j_encoder.encode_video(
                    clip, j_config.CodecConfig(**{**vars(jcfg), "deflate_workers": workers}))
        finally:
            for name, fn in real.items():
                setattr(bitpack, name, fn)
        r["routes"] = called
        out[case] = r
    return out


@pytest.mark.parametrize("case", CASES)
def test_stream_equals_jax(runs, case):
    r = runs[case]
    assert r["port", 0] == r["jax", 0]
    assert r["port", 2] == r["jax", 2]
    ends, syncs = r["index", 2]
    assert ends == r["index", 0][0] and len(ends) == T // r["cfg"].gop_size
    assert syncs is not None and len(syncs) == len(ends)


@pytest.mark.parametrize("case", CASES)
def test_pack_route(runs, case):
    """Every GOP took the pack function its batch shape calls for."""
    route = CASES[case][3]
    assert runs[case]["routes"] == [route] * (2 * T // runs[case]["cfg"].gop_size)


@pytest.mark.parametrize("case", CASES)
def test_ints_held_to_oracle(runs, case):
    """The port's ints equal the float64 oracle's except at rounding ties
    (float64 value within 1e-6 of k + 1/2)."""
    r = runs[case]
    q = transform.quantize_step(torch.from_numpy(r["clip"]), r["ctx"]).numpy()
    want = oracle.quantized_coefficients(r["clip"], r["jcfg"])
    cubes = oracle._cubes(r["clip"], r["jcfg"]).astype(np.float64)
    x = cubes @ j_dct.encode_matrix(r["jcfg"], np.float64)
    diff = q != want
    assert np.all(np.abs(np.abs(x[diff]) % 1 - 0.5) < 1e-6)
    assert np.abs(q - want).max() <= 1


@pytest.mark.parametrize("case", CASES)
def test_cross_decode(runs, case):
    """Each package decodes the other's stream to its own pixels; the two
    packages' pixels agree within 1 LSB on < 1% of pixels."""
    r = runs[case]
    dims, h, w, _ = CASES[case]
    port_own = decode_video(r["port", 0], w, h, T, r["cfg"], r["ctx"])
    np.testing.assert_array_equal(
        decode_video(r["jax", 2], w, h, T, r["cfg"], r["ctx"]), port_own)
    jax_own = j_decoder.decode_video(r["jax", 0], w, h, T, r["jcfg"])
    np.testing.assert_array_equal(
        j_decoder.decode_video(r["port", 2], w, h, T, r["jcfg"]), jax_own)
    d = np.abs(port_own.astype(np.int16) - jax_own)
    assert port_own.shape == r["clip"].shape
    assert d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("indexed", [True, False], ids=["index", "scan"])
@pytest.mark.parametrize("frame_range", [(0, 16), (3, 13), (4, 8), (9, 10)])
@pytest.mark.parametrize("case", CASES)
def test_decode_frame_range_equals_slice(runs, case, indexed, frame_range):
    r = runs[case]
    _, h, w, _ = CASES[case]
    start, stop = frame_range
    full = decode_video(r["port", 2], w, h, T, r["cfg"], r["ctx"])
    ends, syncs = r["index", 2]
    kw = {"positions": [0] + ends[:-1], "sync_offsets": syncs} if indexed else {}
    got = decode_frame_range(r["port", 2], w, h, start, stop, r["cfg"], r["ctx"], **kw)
    np.testing.assert_array_equal(got, full[start:stop])


def test_padded_odd_geometry_round_trip():
    """An odd frame size edge-replicated to 4x4 blocks (io/pad.py), encoded
    and decoded by both packages to the same stream and pixels, cropped
    back."""
    cfg, jcfg = _cfgs((4, 4, 4))
    clip = synthetic_video(8, 34, 33, seed=9)
    padded = pad_frames(clip, 4, 4)
    assert padded.shape == (8, 36, 36)
    data = encode_video(padded, cfg, device="cpu")
    assert data == j_encoder.encode_video(padded, jcfg)
    out = crop_frames(decode_video(data, 36, 36, 8, cfg, device="cpu"), 33, 34)
    assert out.shape == clip.shape
    jout = j_decoder.decode_video(data, 36, 36, 8, jcfg)[:, :34, :33]
    d = np.abs(out.astype(np.int16) - jout)
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def _smooth_clip(t, h, w, seed):
    """A moving gradient with mild noise: few nibble exceptions at 4x4x4,
    so every GOP ships as a turbo member (the suite clip's noise sends
    4x4x4 GOPs to the reference-profile fallback)."""
    rng = np.random.default_rng(seed)
    tt, yy, xx = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    return ((xx + 2 * yy + 3 * tt) // 2 + rng.integers(0, 3, (t, h, w))).astype(np.uint8)


@pytest.mark.parametrize("dims,h,w", [((4, 4, 4), 36, 36), ((8, 8, 4), 64, 64)],
                         ids=["4x4x4-36x36", "8x8x4-64x64"])
def test_turbo_blocks_equal_jax(dims, h, w):
    """Turbo containers at the alternate blocks: one turbo member per GOP,
    bytes equal to the JAX package's, pixels identical to the reference
    profile's decode, range decode equal to the slice.  At 36x36 the 81
    cubes per GOP give K6 a partial group and K7/K8 an odd cube count."""
    cfg, jcfg = _cfgs(dims, turbo_codec="zlib")
    ctx = TransformContext(cfg, "cpu")
    clip = _smooth_clip(T, h, w, seed=4)
    data = encode_turbo_video(clip, cfg, ctx)
    assert data == j_turbo.encode_turbo_video(clip, jcfg)
    members = multihost.split_members(data)
    assert [m[2] for m in members] == [j_turbo.MEMBER_TURBO] * (T // cfg.gop_size)
    ref = decode_video(encode_video(clip, cfg, ctx), w, h, T, cfg, ctx)
    np.testing.assert_array_equal(decode_turbo_container(data, w, h, cfg, ctx), ref)
    np.testing.assert_array_equal(decode_turbo_range(data, w, h, 3, 13, cfg, ctx), ref[3:13])
    np.testing.assert_array_equal(j_turbo.decode_turbo_container(data, w, h, jcfg),
                                  j_decoder.decode_video(encode_video(clip, cfg, ctx),
                                                         w, h, T, jcfg))


def test_turbo_block4_odd_group_count():
    """The JAX package's regression (tests/test_turbo.py): block-4
    geometries where w*h*gop % 256 != 0 encode (this clip's GOPs fall back
    to reference-profile members), match the reference profile's pixels,
    and the container equals the JAX package's."""
    cfg, jcfg = _cfgs((4, 4, 4))
    ctx = TransformContext(cfg, "cpu")
    video = synthetic_video(8, 36, 36, seed=73)
    ref = decode_video(encode_video(video, cfg, ctx), 36, 36, 8, cfg, ctx)
    data = encode_turbo_video(video, cfg, ctx)
    assert data == j_turbo.encode_turbo_video(video, jcfg)
    np.testing.assert_array_equal(decode_turbo_container(data, 36, 36, cfg, ctx), ref)
