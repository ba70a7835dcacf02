"""The port's container layer against the JAX package's: the indexed D3MH
container decoders, decode_auto / decode_auto_range, the streaming
encoder and decoder, and the index check (R1) the JAX package lacks.

Mirrors the single-device cases of tests/test_index.py, test_range.py and
test_parallel_inflate.py.  Runs the port's plain versions on the CPU.
Port pixels equal the port's own decode exactly; against the JAX decoder
they stay within 1 LSB on < 1% of pixels (the f32 matmuls sum in
different orders), and each package decodes the other's bytes exactly as
its own.
"""

import zlib

import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import config as j_config
from dct3d_tpu.codec import auto as j_auto
from dct3d_tpu.codec import decoder as j_decoder
from dct3d_tpu.codec import encoder as j_encoder
from dct3d_tpu.codec import rgb_codec as j_rgb_codec
from dct3d_tpu.codec import turbo as j_turbo
from dct3d_tpu.parallel import multihost as j_multihost
from dct3d_tpu_torch import (
    CodecConfig, StreamingDecoder, StreamingEncoder, TransformContext,
    decode_auto, decode_auto_range, decode_stream, decode_video,
    encode_stream, encode_turbo_video, encode_video,
)
from dct3d_tpu_torch.codec import entropy
from dct3d_tpu_torch.parallel import multihost

torch.set_num_threads(2)

T, H, W = 24, 48, 64  # three GOPs


@pytest.fixture(scope="module")
def ctx():
    return TransformContext(CodecConfig(deflate_workers=2), "cpu")


@pytest.fixture(scope="module")
def clip():
    return synthetic_video(T, H, W, seed=3)


def _container(clip, cfg, ctx):
    """The CLI's default container: a temporal member of the stream, then
    its v2 index member."""
    enc = StreamingEncoder(W, H, cfg, ctx)
    data = enc.push(clip) + enc.finish()
    return (multihost._member(data, enc.frames_encoded)
            + multihost.make_index_member(enc.gop_bit_ends, enc.gop_sync_offsets),
            data, enc)


@pytest.fixture(scope="module")
def box(clip, ctx):
    cfg = CodecConfig(deflate_workers=2)
    data, stream, enc = _container(clip, cfg, ctx)
    jenc = j_encoder.StreamingEncoder(W, H, j_config.CodecConfig(deflate_workers=2))
    jstream = jenc.push(clip) + jenc.finish()
    jdata = (j_multihost._member(jstream, jenc.frames_encoded)
             + j_multihost.make_index_member(jenc.gop_bit_ends, jenc.gop_sync_offsets))
    return {"data": data, "stream": stream, "ends": enc.gop_bit_ends,
            "syncs": enc.gop_sync_offsets, "frames": enc.frames_encoded,
            "jdata": jdata, "jframes": jenc.frames_encoded,
            "plain": decode_video(stream, W, H, T, ctx=ctx),
            "jax_plain": j_decoder.decode_video(jstream, W, H, T)}


def _near(a, b):
    d = np.abs(a.astype(np.int16) - b)
    assert a.shape == b.shape and d.max() <= 1 and (d > 0).mean() < 0.01


def _no_scan(monkeypatch):
    """Make any serial boundary scan fail the test."""
    monkeypatch.setattr(entropy, "scan_values", lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("scanned")))


def test_container_equals_jax(box):
    assert box["data"] == box["jdata"]
    assert box["frames"] == box["jframes"] == T
    ipay = multihost.split_members(box["data"])[1][1]
    assert multihost.parse_index(ipay) == box["ends"]
    assert multihost.parse_index_syncs(ipay) == box["syncs"]
    assert len(box["syncs"]) == T // 8


def test_multihost_container_uses_index(box, ctx, monkeypatch):
    """One-member container: indexed (scan-free) decode equals the plain
    decode of the stream; the JAX decoder reads the port's container as
    its own."""
    _no_scan(monkeypatch)
    got = multihost.decode_multihost_container(box["data"], W, H, ctx=ctx)
    np.testing.assert_array_equal(got, box["plain"])
    monkeypatch.undo()
    jgot = j_multihost.decode_multihost_container(box["data"], W, H)
    np.testing.assert_array_equal(jgot, box["jax_plain"])
    _near(got, jgot)


def test_two_member_container_decodes_members_concurrently(clip, box, ctx):
    """Two default containers concatenated: the members decode on two
    threads sharing one context, equal to decoding them one by one and to
    the JAX decode of the same bytes."""
    cfg = CodecConfig(deflate_workers=2)
    second, stream2, _ = _container(clip[:16], cfg, ctx)
    data = box["data"] + second
    got = multihost.decode_multihost_container(data, W, H, workers=2, ctx=ctx)
    want = np.concatenate([box["plain"], decode_video(stream2, W, H, 16, ctx=ctx)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, multihost.decode_multihost_container(data, W, H, workers=1, ctx=ctx))
    _near(got, j_multihost.decode_multihost_container(data, W, H))
    for a, b in [(0, 40), (3, 30), (20, 28), (25, 40), (10, 26)]:
        np.testing.assert_array_equal(
            multihost.decode_container_range(data, W, H, a, b, ctx=ctx), got[a:b])
    with pytest.raises(EOFError):
        multihost.decode_container_range(data, W, H, 39, 41, ctx=ctx)


def test_torn_index_member_falls_back(box, ctx):
    torn = box["data"][:-31]  # into the v1 bit ends, past the v2 syncs
    assert multihost.parse_index(multihost.split_members(torn)[-1][1]) is None
    np.testing.assert_array_equal(
        multihost.decode_multihost_container(torn, W, H, ctx=ctx), box["plain"])
    np.testing.assert_array_equal(
        multihost.decode_container_range(torn, W, H, 5, 21, ctx=ctx), box["plain"][5:21])
    _near(multihost.decode_multihost_container(torn, W, H, ctx=ctx),
          j_multihost.decode_multihost_container(torn, W, H))


def test_stale_index_falls_back_to_scan(clip, box, ctx):
    """R1: an index from another stream of the same GOP count whose last
    bit end lies past this payload is not trusted; the decode scans and
    gives the plain pixels.  The same index inside a container too."""
    noisy = np.random.default_rng(5).integers(0, 256, clip.shape, dtype=np.uint8)
    _, _, other = _container(noisy, CodecConfig(deflate_workers=2), ctx)
    assert other.gop_bit_ends[-1] > 8 * len(zlib.decompress(box["stream"]))
    stale = multihost.gop_positions(other.gop_bit_ends, 3, 8, T)
    got = decode_video(box["stream"], W, H, T, ctx=ctx, positions=stale,
                       index_end=other.gop_bit_ends[-1])
    np.testing.assert_array_equal(got, box["plain"])
    data = (multihost._member(box["stream"], T)
            + multihost.make_index_member(other.gop_bit_ends))
    np.testing.assert_array_equal(
        multihost.decode_multihost_container(data, W, H, ctx=ctx), box["plain"])
    np.testing.assert_array_equal(
        multihost.decode_container_range(data, W, H, 9, 23, ctx=ctx), box["plain"][9:23])


def test_container_errors_equal_jax(box, ctx):
    idx_only = multihost.make_index_member([1, 2])
    for fn in (multihost.decode_multihost_container, j_multihost.decode_multihost_container):
        with pytest.raises(ValueError, match="no decodable stream members"):
            fn(idx_only, 8, 8, **({"ctx": ctx} if fn is multihost.decode_multihost_container
                                  else {}))
    rgb = np.stack([synthetic_video(8, 16, 16, seed=s) for s in (1, 2, 3)], axis=-1)
    data = j_rgb_codec.encode_rgb_video(rgb)
    with pytest.raises(ValueError, match="RGB channel members"):
        multihost.decode_multihost_container(data, 16, 16, ctx=ctx)
    mixed = multihost._member(b"x", 8, 5) + box["data"]
    with pytest.raises(ValueError, match="non-temporal"):
        multihost.decode_container_range(mixed, W, H, 0, 8, ctx=ctx)
    with pytest.raises(ValueError, match="range"):
        multihost.decode_container_range(box["data"], W, H, 5, 5, ctx=ctx)


@pytest.fixture(scope="module")
def forms(clip, box, ctx):
    """Every form the port writes, with the JAX package's bytes of each."""
    jcfg = j_config.CodecConfig()
    return {
        "raw": (encode_video(clip, CodecConfig(), ctx), j_encoder.encode_video(clip, jcfg)),
        "temporal": (box["data"], box["jdata"]),
        "member": (multihost._member(box["stream"], T), None),
        "turbo": (encode_turbo_video(clip, CodecConfig(turbo_codec="zlib"), ctx),
                  j_turbo.encode_turbo_video(clip, j_config.CodecConfig(turbo_codec="zlib"))),
    }


@pytest.mark.parametrize("form", ["raw", "temporal", "member", "turbo"])
def test_decode_auto_routes_like_jax(forms, box, ctx, form):
    data, jdata = forms[form]
    if jdata is not None:
        assert data == jdata
    frames = T if form == "raw" else None
    got = decode_auto(data, W, H, frames, ctx=ctx)
    np.testing.assert_array_equal(got, box["plain"])
    _near(got, j_auto.decode_auto(data, W, H, frames))
    # frames truncates a container's result; a raw stream's count is cut
    # to whole GOPs first.
    np.testing.assert_array_equal(decode_auto(data, W, H, 12, ctx=ctx),
                                  got[: 8 if form == "raw" else 12])
    for a, b in [(3, 11), (0, 24), (17, 24)]:
        rng = decode_auto_range(data, W, H, a, b, ctx=ctx)
        np.testing.assert_array_equal(rng, got[a:b])
        _near(rng, j_auto.decode_auto_range(data, W, H, a, b))


def test_decode_auto_refuses_what_is_not_ported(clip, forms, ctx):
    """RGB and turbo-RGB containers of the JAX package route to the port's
    RGB decoders (ported since): (T, H, W, 3) pixels within 1 LSB of the
    JAX decode_auto's, ranges equal to the slices.  What no encoder
    writes, or a call with no device, still raises."""
    rgb = np.stack([synthetic_video(8, 16, 16, seed=s) for s in (4, 5, 6)], axis=-1)
    jcfg = j_config.CodecConfig(turbo_codec="zlib")
    for data in (j_rgb_codec.encode_rgb_video(rgb, jcfg),
                 j_turbo.encode_turbo_rgb_video(rgb, jcfg)):
        got = decode_auto(data, 16, 16, ctx=ctx)
        assert got.shape == rgb.shape
        _near(got, j_auto.decode_auto(data, 16, 16))
        np.testing.assert_array_equal(decode_auto_range(data, 16, 16, 2, 7, ctx=ctx), got[2:7])
    with pytest.raises(ValueError, match="headerless"):
        decode_auto(forms["raw"][0], W, H, ctx=ctx)
    with pytest.raises(ValueError, match="unrecognized"):
        decode_auto(multihost._member(b"x", 8, 9), W, H, ctx=ctx)
    with pytest.raises(ValueError, match="device"):
        decode_auto(forms["raw"][0], W, H, T)


@pytest.mark.parametrize("workers", [0, 2])
def test_encode_stream_equals_jax(clip, workers):
    cfg = CodecConfig(deflate_workers=workers)
    ctx = TransformContext(cfg, "cpu")
    batches = [clip[:16], clip[16:]]
    got = b"".join(encode_stream(iter(batches), W, H, cfg, ctx))
    assert got == b"".join(j_encoder.encode_stream(
        iter(batches), W, H, j_config.CodecConfig(deflate_workers=workers)))
    assert got == encode_video(clip, cfg, ctx)


def test_frames_encoded_counts_like_jax(clip, ctx):
    enc = StreamingEncoder(W, H, ctx=ctx)
    jenc = j_encoder.StreamingEncoder(W, H)
    counts = []
    for batch in (clip[:8], clip[8:24]):
        enc.push(batch)
        jenc.push(batch)
        counts.append((enc.frames_encoded, jenc.frames_encoded))
    enc.finish()
    jenc.finish()
    assert counts == [(8, 8), (24, 24)]
    stats = enc.timer.as_dict()
    # sink_push: the drainer's hand-off of each GOP to the sink; deflate:
    # the serial sink's compress of each GOP's bytes, then of the final byte.
    assert stats["dispatch"]["calls"] == stats["sink_push"]["calls"] == 3
    assert stats["deflate"]["calls"] == 4


@pytest.mark.parametrize("chunk", [50, 1 << 20])
def test_decode_stream_equals_decode_video(box, ctx, chunk):
    """decode_stream (StreamingDecoder on try_read_planar4 and the device
    step of decode_video) gives decode_video's pixels, GOP by GOP, and
    stays within 1 LSB of the JAX decode_stream (its int32 route)."""
    stream = box["stream"]
    chunks = [stream[i : i + chunk] for i in range(0, len(stream), chunk)]
    batches = list(decode_stream(iter(chunks), W, H, T, ctx=ctx))
    assert [b.shape[0] for b in batches] == [8, 8, 8]
    got = np.concatenate(batches)
    np.testing.assert_array_equal(got, box["plain"])
    jgot = np.concatenate(list(j_decoder.decode_stream(iter(chunks), W, H, T)))
    _near(got, jgot)
    with pytest.raises(EOFError):
        list(decode_stream(iter(chunks[:-1] if chunk == 50 else [stream[:-200]]),
                           W, H, T, ctx=ctx))


def test_streaming_decoder_batches(box, ctx):
    dec = StreamingDecoder(W, H, ctx=ctx, gops_per_batch=2)
    assert dec.try_decode() is None
    dec.feed(box["stream"])
    dec.feed_eof()
    out = [dec.try_decode(), dec.try_decode(), dec.try_decode()]
    assert [o.shape[0] for o in out[:2]] == [16, 8] and out[2] is None
    np.testing.assert_array_equal(np.concatenate(out[:2]), box["plain"])


@pytest.mark.parametrize("chunk", [97, 1 << 20])
def test_transport_delta_containers_and_streaming_decode(clip, box, chunk):
    """The delta wire leaves every container as it is: the turbo container
    equals the plain one and the JAX package's delta one (tests/
    test_turbo.py:163); the streaming decoder and the container decoders
    undo the device's deltas GOP by GOP to the plain pixels."""
    cfg = CodecConfig(deflate_workers=2, transport_delta=True, turbo_codec="zlib")
    dctx = TransformContext(cfg, "cpu")
    plain_cfg = CodecConfig(turbo_codec="zlib")
    tdata = encode_turbo_video(clip, cfg, dctx)
    assert tdata == encode_turbo_video(clip, plain_cfg, device="cpu")
    assert tdata == j_turbo.encode_turbo_video(
        clip, j_config.CodecConfig(transport_delta=True, turbo_codec="zlib"))
    np.testing.assert_array_equal(decode_auto(tdata, W, H, ctx=dctx), box["plain"])
    np.testing.assert_array_equal(decode_auto_range(tdata, W, H, 5, 21, ctx=dctx),
                                  box["plain"][5:21])
    np.testing.assert_array_equal(decode_auto(box["data"], W, H, ctx=dctx), box["plain"])
    stream = box["stream"]
    chunks = [stream[i : i + chunk] for i in range(0, len(stream), chunk)]
    got = np.concatenate(list(decode_stream(iter(chunks), W, H, T, cfg, dctx)))
    np.testing.assert_array_equal(got, box["plain"])
    dec = StreamingDecoder(W, H, cfg, dctx, gops_per_batch=3)
    dec.feed(stream)
    dec.feed_eof()
    np.testing.assert_array_equal(dec.try_decode(), box["plain"])


def test_gop_positions_from_port_ends_equal_scan(box):
    payload = np.frombuffer(zlib.decompress(box["stream"]), np.uint8)
    pos, cpg = 0, W * H * 8
    for e in box["ends"]:
        pos = entropy.scan_values(payload, cpg, pos)
        assert pos == e
    assert multihost.gop_positions(box["ends"], 3, 8, T) == [0] + box["ends"][:2]
