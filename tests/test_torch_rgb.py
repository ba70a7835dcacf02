"""The port's RGB codecs (codec/rgb_codec.py, the turbo RGB functions of
codec/turbo.py) against the JAX package's.

Containers are byte-equal to the JAX package's on the same seeded clip;
each package decodes the other's container exactly as its own; the port's
container decodes to the per-channel library decodes exactly, and stays
within 1 LSB of the JAX decode on < 1% of pixels.  Runs the port's plain
versions on the CPU.
"""

import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import config as j_config
from dct3d_tpu.codec import auto as j_auto
from dct3d_tpu.codec import rgb_codec as j_rgb_codec
from dct3d_tpu.codec import turbo as j_turbo
from dct3d_tpu_torch import (
    CodecConfig, TransformContext, decode_auto, decode_auto_range, decode_rgb_range,
    decode_rgb_video, decode_turbo_rgb_range, decode_turbo_rgb_video, decode_video,
    encode_rgb_video, encode_turbo_rgb_video, encode_turbo_video, encode_video, psnr,
)
from dct3d_tpu_torch.codec import rgb_codec, turbo
from dct3d_tpu_torch.parallel import multihost
from dct3d_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

T, H, W = 16, 32, 48


@pytest.fixture(scope="module")
def clip():
    return np.stack([synthetic_video(T, H, W, seed=s) for s in (11, 12, 13)], axis=-1)


@pytest.fixture(scope="module")
def ctx():
    return TransformContext(CodecConfig(deflate_workers=2, turbo_codec="zlib"), "cpu")


@pytest.fixture(scope="module")
def boxes(clip, ctx):
    """(port, JAX) containers of each form."""
    jcfg = j_config.CodecConfig(deflate_workers=2, turbo_codec="zlib")
    return {
        "rgb": (encode_rgb_video(clip, ctx.cfg, ctx),
                j_rgb_codec.encode_rgb_video(clip, jcfg)),
        "rgb_index": (encode_rgb_video(clip, ctx.cfg, ctx, index=True),
                      j_rgb_codec.encode_rgb_video(clip, jcfg, index=True)),
        "turbo_rgb": (encode_turbo_rgb_video(clip, ctx.cfg, ctx),
                      j_turbo.encode_turbo_rgb_video(clip, jcfg)),
    }


def _near(a, b):
    d = np.abs(a.astype(np.int16) - b)
    assert a.shape == b.shape and d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("form", ["rgb", "rgb_index", "turbo_rgb"])
def test_container_equals_jax(boxes, form):
    data, jdata = boxes[form]
    assert data == jdata
    types = [m[2] for m in multihost.split_members(data)]
    assert types == {"rgb": [1, 2, 3], "rgb_index": [1, 4, 2, 4, 3, 4],
                     "turbo_rgb": [6, 6, 7, 7, 8, 8]}[form]


@pytest.mark.parametrize("form", ["rgb", "rgb_index", "turbo_rgb"])
def test_decode_equals_channel_decodes_and_jax(clip, ctx, boxes, form):
    """The RGB decode equals the three channel streams decoded one by one
    with the grayscale decoder; each package decodes the other's container
    as its own; ranges equal the slices; decode_auto routes by tags."""
    data, _ = boxes[form]
    if form == "turbo_rgb":
        got = decode_turbo_rgb_video(data, W, H, ctx=ctx)
        parts = [turbo.decode_turbo_container(data, W, H, ctx=ctx, member_type=t)
                 for t in turbo.MEMBER_TURBO_RGB]
        jgot = j_turbo.decode_turbo_rgb_video(data, W, H, j_config.CodecConfig())
    else:
        got = decode_rgb_video(data, W, H, ctx=ctx)
        streams = [m for m in multihost.split_members(data) if m[2] != multihost.MEMBER_INDEX]
        parts = [decode_video(p, W, H, f, ctx=ctx) for f, p, _ in streams]
        jgot = j_rgb_codec.decode_rgb_video(data, W, H)
    np.testing.assert_array_equal(got, np.stack(parts, axis=-1))
    _near(got, jgot)
    np.testing.assert_array_equal(decode_auto(data, W, H, ctx=ctx), got)
    _near(decode_auto(data, W, H, ctx=ctx), j_auto.decode_auto(data, W, H))
    for a, b in [(0, 16), (3, 13), (8, 9)]:
        rng = decode_auto_range(data, W, H, a, b, ctx=ctx)
        np.testing.assert_array_equal(rng, got[a:b])
        fn = decode_turbo_rgb_range if form == "turbo_rgb" else decode_rgb_range
        np.testing.assert_array_equal(fn(data, W, H, a, b, ctx=ctx), got[a:b])
    assert psnr(clip, got) > 30.0


def test_index_members_make_channels_scan_free(clip, ctx, boxes, monkeypatch):
    """With index=True each channel decodes from its index: no boundary
    scan of any kind."""
    from dct3d_tpu_torch.codec import entropy

    want = decode_rgb_video(boxes["rgb"][0], W, H, ctx=ctx)
    for name in ("scan_values", "speculative_positions", "speculative_planar4_chunks"):
        monkeypatch.setattr(entropy, name, lambda *a, _n=name, **k: (_ for _ in ()).throw(
            AssertionError(_n)))
    np.testing.assert_array_equal(decode_rgb_video(boxes["rgb_index"][0], W, H, ctx=ctx), want)
    np.testing.assert_array_equal(decode_rgb_range(boxes["rgb_index"][0], W, H, 9, 15, ctx=ctx),
                                  want[9:15])


def test_turbo_rgb_channel_fallback_equals_jax(ctx):
    """quant 0 on noise: turbo-RGB channel GOPs fall back to RGB channel
    members (types 1/2/3) per GOP, as in the JAX package, and decode to
    the reference-profile RGB pixels."""
    rng = np.random.default_rng(4)
    clip = rng.integers(0, 256, (16, 16, 16, 3), dtype=np.uint8)
    clip[8:] = 100  # a still GOP stays turbo
    cfg = CodecConfig(quant_strength=0, turbo_codec="zlib")
    c0 = TransformContext(cfg, "cpu")
    data = encode_turbo_rgb_video(clip, cfg, c0)
    assert data == j_turbo.encode_turbo_rgb_video(
        clip, j_config.CodecConfig(quant_strength=0, turbo_codec="zlib"))
    types = [m[2] for m in multihost.split_members(data)]
    assert types == [1, 6, 2, 7, 3, 8]
    assert turbo.is_turbo_rgb_container(multihost.split_members(data))
    want = decode_rgb_video(encode_rgb_video(clip, cfg, c0), 16, 16, ctx=c0)
    np.testing.assert_array_equal(decode_turbo_rgb_video(data, 16, 16, ctx=c0), want)


def test_errors_and_refusals(clip, ctx, boxes):
    with pytest.raises(ValueError, match="RGB"):
        encode_rgb_video(clip[..., 0], ctx=ctx)
    with pytest.raises(ValueError, match="shorter"):
        encode_turbo_rgb_video(clip[:7], ctx=ctx)
    mesh = make_mesh(2, 1, [torch.device("cpu")] * 2)
    for fn in (encode_rgb_video, encode_turbo_rgb_video):
        # A mesh aligns to whole mesh steps: 8 frames are none on a 2-GOP axis.
        with pytest.raises(ValueError, match="shorter than one 16-frame step"):
            fn(clip[:8], ctx=ctx, mesh=mesh)
        with pytest.raises(ValueError, match="device"):
            fn(clip)
    gray = multihost._member(encode_video(clip[..., 0], ctx=ctx), T)
    with pytest.raises(ValueError, match="3 channel members"):
        decode_rgb_video(gray, W, H, ctx=ctx)
    with pytest.raises(ValueError, match="missing channels"):
        decode_turbo_rgb_video(encode_turbo_video(clip[..., 0], ctx.cfg, ctx), W, H, ctx=ctx)
    with pytest.raises(EOFError):
        decode_rgb_range(boxes["rgb"][0], W, H, 8, 17, ctx=ctx)
    members = multihost.split_members(boxes["rgb_index"][0])
    for a, b in zip(rgb_codec._collect_channels(members), j_rgb_codec._collect_channels(members)):
        assert a == b
