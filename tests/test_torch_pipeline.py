"""The port's encode/decode main path against the JAX package, end to end.

Streams are byte-equal to the JAX encoder's (and the float64 oracle's) at
test sizes, carries chain across GOPs, and each package decodes the
other's streams.  Runs the port's plain versions on the CPU.
"""

import zlib

import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import config as j_config
from dct3d_tpu import oracle
from dct3d_tpu.codec import decoder as j_decoder
from dct3d_tpu.codec import encoder as j_encoder
from dct3d_tpu_torch import CodecConfig, StreamingEncoder, TransformContext
from dct3d_tpu_torch import decode_frame_range, decode_video, encode_video

torch.set_num_threads(2)

T, H, W = 24, 64, 64  # three GOPs, so carries chain


@pytest.fixture(scope="module")
def clip():
    return synthetic_video(T, H, W, seed=9)


@pytest.fixture(scope="module")
def ctx():
    return TransformContext(None, "cpu")


@pytest.fixture(scope="module")
def streams(clip, ctx):
    """Port and JAX streams, serial and parallel DEFLATE, with the port's
    index (GOP bit ends and sync offsets)."""
    out = {}
    for workers in (0, 2):
        enc = StreamingEncoder(W, H, CodecConfig(deflate_workers=workers), ctx)
        out["port", workers] = enc.push(clip) + enc.finish()
        out["index", workers] = (enc.gop_bit_ends, enc.gop_sync_offsets)
        out["jax", workers] = j_encoder.encode_video(
            clip, j_config.CodecConfig(deflate_workers=workers))
    return out


def test_serial_stream_equals_jax_and_oracle(clip, streams):
    assert streams["port", 0] == streams["jax", 0]
    assert streams["port", 0] == oracle.encode(clip, j_config.CodecConfig())


def test_parallel_stream_equals_jax(streams):
    assert streams["port", 2] == streams["jax", 2]
    assert zlib.decompress(streams["port", 2]) == zlib.decompress(streams["port", 0])
    ends, syncs = streams["index", 2]
    assert ends == streams["index", 0][0] and len(ends) == T // 8
    assert syncs is not None and len(syncs) == T // 8
    assert streams["index", 0][1] is None


def test_encode_video_equals_streaming_encoder(clip, ctx, streams):
    assert encode_video(clip, ctx=ctx) == streams["port", 0]
    # Frame counts are truncated to whole GOPs.
    assert encode_video(clip[:20], ctx=ctx) == encode_video(clip[:16], ctx=ctx)


def test_gop_bit_ends_equal_jax(clip, streams):
    enc = j_encoder.StreamingEncoder(W, H, j_config.CodecConfig())
    enc.push(clip)
    enc.finish()
    assert streams["index", 0][0] == enc.gop_bit_ends


def test_cross_decode(clip, ctx, streams):
    """The port decodes the JAX stream to exactly its own stream's pixels
    (the streams are byte-equal), the JAX package decodes the port's, and
    port pixels stay within 1 LSB of JAX pixels on < 1% of pixels."""
    port_own = decode_video(streams["port", 0], W, H, T, ctx=ctx)
    port_of_jax = decode_video(streams["jax", 0], W, H, T, ctx=ctx)
    np.testing.assert_array_equal(port_of_jax, port_own)
    jax_of_port = j_decoder.decode_video(streams["port", 0], W, H, T)
    jax_own = j_decoder.decode_video(streams["jax", 0], W, H, T)
    np.testing.assert_array_equal(jax_of_port, jax_own)
    d = np.abs(port_own.astype(np.int16) - jax_own)
    assert d.max() <= 1 and (d > 0).mean() < 0.01
    assert port_own.shape == clip.shape


def test_parallel_stream_decodes_to_serial_pixels(ctx, streams):
    ends, syncs = streams["index", 2]
    got = decode_video(streams["port", 2], W, H, T, ctx=ctx,
                       positions=[0] + ends[:-1], sync_offsets=syncs)
    np.testing.assert_array_equal(got, decode_video(streams["port", 0], W, H, T, ctx=ctx))


@pytest.mark.parametrize("indexed", [True, False], ids=["index", "scan"])
@pytest.mark.parametrize("frame_range", [(0, 24), (3, 13), (8, 16), (17, 24), (9, 10)])
def test_decode_frame_range_equals_slice(ctx, streams, indexed, frame_range):
    start, stop = frame_range
    full = decode_video(streams["port", 2], W, H, T, ctx=ctx)
    ends, syncs = streams["index", 2]
    kw = {"positions": [0] + ends[:-1], "sync_offsets": syncs} if indexed else {}
    got = decode_frame_range(streams["port", 2], W, H, start, stop, ctx=ctx, **kw)
    np.testing.assert_array_equal(got, full[start:stop])


def test_encoder_continues_a_jax_carry(clip, ctx):
    """A port encoder started from a JAX encoder's carry writes exactly the
    JAX stream's payload from the carry's byte on."""
    jenc = j_encoder.StreamingEncoder(W, H, j_config.CodecConfig())
    whole = zlib.decompress(jenc.push(clip) + jenc.finish())
    # Split after the first GOP that ends inside a byte (a nonzero carry).
    split = 8 * next(k + 1 for k, e in enumerate(jenc.gop_bit_ends) if e % 8)
    assert split < T
    first = j_encoder.StreamingEncoder(W, H, j_config.CodecConfig())
    first.push(clip[:split])
    carry = tuple(int(c) for c in first._carry)
    first.finish()
    enc = StreamingEncoder(W, H, ctx=ctx, carry=carry)
    rest = zlib.decompress(enc.push(clip[split:]) + enc.finish())
    assert rest == whole[first.gop_bit_ends[-1] // 8 :]


def test_truncated_and_corrupt_streams_raise(ctx, streams):
    with pytest.raises(EOFError):
        decode_video(streams["port", 0], W, H, T + 8, ctx=ctx)
    with pytest.raises(ValueError, match="corrupt"):
        decode_video(b"\x78\xda garbage", W, H, T, ctx=ctx)
    with pytest.raises(ValueError, match="range"):
        decode_frame_range(streams["port", 0], W, H, 5, 5, ctx=ctx)
    assert decode_video(streams["port", 0], W, H, 7, ctx=ctx).shape == (0, H, W)


@pytest.mark.parametrize("kwargs", [
    {"cfg": CodecConfig(compute_dtype="bfloat16")},
    {"cfg": CodecConfig(transport_delta=True)},
], ids=["bf16", "transport_delta"])
def test_scope_guards_raise(kwargs):
    frames = np.zeros((8, 16, 16), np.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        encode_video(frames, device="cpu", **kwargs)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode_video(b"", 16, 16, 8, device="cpu", **kwargs)


def test_device_pack_false_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        StreamingEncoder(16, 16, device="cpu", device_pack=False)


def test_entry_points_need_a_device():
    frames = np.zeros((8, 16, 16), np.uint8)
    with pytest.raises(ValueError, match="device"):
        encode_video(frames)
    with pytest.raises(ValueError, match="device"):
        decode_video(b"", 16, 16, 8)
