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
def test_scope_guards_raise(clip, ctx, streams, kwargs):
    """Both guards are gone.  bf16: in both sinks the stream equals the
    JAX package's bf16 encode byte for byte and decodes to its bf16
    pixels.  transport_delta: the delta wire leaves the stream and the
    pixels as they are (tests/test_pipeline.py:241), in both sinks, equal
    to the JAX package's delta encode."""
    if kwargs["cfg"].compute_dtype != "float32":
        for workers in (0, 2):
            cfg = CodecConfig(deflate_workers=workers, compute_dtype="bfloat16")
            jcfg = j_config.CodecConfig(deflate_workers=workers, compute_dtype="bfloat16")
            data = encode_video(clip, cfg, device="cpu")
            assert data == j_encoder.encode_video(clip, jcfg)
            np.testing.assert_array_equal(decode_video(data, W, H, T, cfg, device="cpu"),
                                          j_decoder.decode_video(data, W, H, T, jcfg))
        return
    for workers in (0, 2):
        cfg = CodecConfig(deflate_workers=workers, transport_delta=True)
        enc = StreamingEncoder(W, H, cfg, device="cpu")
        data = enc.push(clip) + enc.finish()
        assert data == streams["port", workers]
        assert (enc.gop_bit_ends, enc.gop_sync_offsets) == streams["index", workers]
        assert data == j_encoder.encode_video(
            clip, j_config.CodecConfig(deflate_workers=workers, transport_delta=True))
    np.testing.assert_array_equal(decode_video(data, W, H, T, device="cpu", **kwargs),
                                  decode_video(data, W, H, T, ctx=ctx))


@pytest.mark.parametrize("workers", [0, 2])
def test_device_pack_false_raises(clip, ctx, streams, workers):
    """device_pack=False is ported: the host Exp-Golomb encode of the
    card's ints equals the device-packed payload and the JAX package's
    host path byte for byte (tests/test_pipeline.py:130).  Like the JAX
    host path it records no GOP bit ends and marks no sync points (ROADMAP
    Queue 3, R5)."""
    enc = StreamingEncoder(W, H, CodecConfig(deflate_workers=workers), ctx, device_pack=False)
    data = enc.push(clip) + enc.finish()
    jenc = j_encoder.StreamingEncoder(W, H, j_config.CodecConfig(deflate_workers=workers),
                                      device_pack=False)
    assert data == jenc.push(clip) + jenc.finish()
    assert zlib.decompress(data) == zlib.decompress(streams["port", 0])
    if workers == 0:
        assert data == streams["port", 0]
    assert enc.gop_bit_ends == jenc.gop_bit_ends == []
    assert enc.gop_sync_offsets is None and jenc.gop_sync_offsets is None
    assert enc.frames_encoded == T


BLOCK4 = {"block_w": 4, "block_h": 4, "block_d": 4}


@pytest.mark.parametrize("bits", range(8))
@pytest.mark.parametrize("blocks", ["8x8x8", "4x4x4"])
def test_host_encode_equals_device_after_carries(blocks, bits):
    """After a carry of 0..7 bits, the host encode writes the device pack's
    stream, at 8x8x8 and at 4x4x4 cubes on a geometry whose GOPs end in
    partial 256-value groups (K5's route)."""
    cfg = CodecConfig(**(BLOCK4 if blocks == "4x4x4" else {}))
    h, w = (36, 36) if blocks == "4x4x4" else (H, W)
    if blocks == "4x4x4":
        assert (h * w * cfg.gop_size) % 256  # partial groups
    frames = synthetic_video(16, h, w, seed=bits)
    ctx = TransformContext(cfg, "cpu")
    carry = (int(np.random.default_rng(bits).integers(0, 1 << bits)), bits)
    out = []
    for device_pack in (True, False):
        enc = StreamingEncoder(w, h, cfg, ctx, carry=carry, device_pack=device_pack)
        out.append(enc.push(frames) + enc.finish())
    assert out[0] == out[1]


def test_entry_points_need_a_device():
    frames = np.zeros((8, 16, 16), np.uint8)
    with pytest.raises(ValueError, match="device"):
        encode_video(frames)
    with pytest.raises(ValueError, match="device"):
        decode_video(b"", 16, 16, 8)
