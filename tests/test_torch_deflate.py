"""The DEFLATE engine of ops/deflate.py (its plain version, which the card's
kernels equal byte for byte: tests/test_torch_cuda.py) and the stream layout
of codec/entropy.py's device sink, fed the plain engine's spans (the sink
itself deflates CUDA tensors only)."""

import zlib

import numpy as np
import pytest
import torch

from dct3d_tpu_torch import CodecConfig, encode_video
from dct3d_tpu_torch.codec import entropy
from dct3d_tpu_torch.io.synthetic import moving_blocks
from dct3d_tpu_torch.ops import deflate

torch.set_num_threads(2)


def inflate_raw(span: bytes) -> bytes:
    d = zlib.decompressobj(-zlib.MAX_WBITS)
    return d.decompress(span) + d.flush()


def bench_clip(t: int, h: int, w: int, seed: int = 3) -> np.ndarray:
    """bench.py's clip: a moving gradient XOR uniform noise in 0..15."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 16, (t, h, w), dtype=np.uint8)
    ramp = np.arange(w)[None, None] + np.arange(h)[None, :, None] + np.arange(t)[:, None, None]
    return noise ^ (ramp & 0xFF).astype(np.uint8)


def push_plain(sink: entropy.DeviceDeflateSink, buf: np.ndarray, bits: int,
               level: int) -> bytes:
    """What ``sink.push_gop`` adds for a GOP after its sync boundary, with
    the driver running the plain engine in place of the card's kernels."""
    span, total, s1, s2, tail = deflate.Deflater(level)(torch.from_numpy(buf),
                                                        torch.tensor(bits))
    return sink.append_span(span, total, s1, s2, tail)


def stream_bytes(clip: np.ndarray) -> np.ndarray:
    """The Exp-Golomb bytes the encoder deflates for ``clip``."""
    return np.frombuffer(zlib.decompress(encode_video(clip, device="cpu")), np.uint8)


@pytest.fixture(scope="module")
def content():
    """128 KiB of the bench clip's stream and of screen content's."""
    return {
        "bench": stream_bytes(bench_clip(16, 192, 256))[: 1 << 17],
        "screen": stream_bytes(moving_blocks(16, 360, 640, seed=1))[: 1 << 17],
    }


def _cases():
    rng = np.random.default_rng(11)
    half = rng.integers(0, 256, 32768, dtype=np.uint8)
    return {
        "empty": np.zeros(0, np.uint8),
        "one": np.array([7], np.uint8),
        "two": np.array([7, 7], np.uint8),
        "three": np.array([1, 2, 3], np.uint8),
        "run258": np.full(258, 0xFF, np.uint8),
        "run259": np.full(259, 0xFF, np.uint8),
        "far": np.concatenate([half, half]),
        "random": rng.integers(0, 256, 150_000, dtype=np.uint8),
    }


CASES = _cases()


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_engine_round_trips(name, level):
    x = CASES[name]
    span, s1, s2 = deflate.deflate_plain(x, level)
    assert inflate_raw(span.tobytes()) == x.tobytes()
    assert deflate.adler32_of(s1, s2, len(x)) == zlib.adler32(x.tobytes())
    # the span ends with an empty stored block, byte-aligned
    assert span[-4:].tobytes() == b"\x00\x00\xff\xff"


def test_match_at_window_distance():
    """A copy of 32768 bytes is found at distance exactly 32768, across the
    segment boundary, and its first bytes start a match there."""
    x = CASES["far"]
    mlen, mdist = deflate.matches_plain(x, 9)
    assert mdist[32768] == 32768 and mlen[32768] == 258
    tokens = deflate.parse_plain(x, mlen, mdist, 9)
    assert ((tokens >> 16 >= 3) & ((tokens & 0xFFFF) == 32768)).any()


@pytest.mark.parametrize("level", [0, 6, 9])
def test_incompressible_bytes_go_stored(level):
    """Random bytes cost at most 5 bytes per stored block of 65535 (and the
    5 of the closing empty block), whatever the level."""
    x = CASES["random"]
    span, _, _ = deflate.deflate_plain(x, level)
    assert len(span) <= len(x) + 5 * -(-len(x) // deflate.STORED_MAX) + 5
    assert span[0] & 0b111 == 0  # BFINAL 0, BTYPE 00: stored


@pytest.mark.parametrize("level", [1, 6, 9])
@pytest.mark.parametrize("kind", ["bench", "screen"])
def test_plain_engine_round_trips_content(content, kind, level):
    x = content[kind]
    span, _, _ = deflate.deflate_plain(x, level)
    assert inflate_raw(span.tobytes()) == x.tobytes()


@pytest.mark.parametrize("level", [6, 9])
@pytest.mark.parametrize("kind", ["bench", "screen"])
def test_size_within_half_a_percent_of_zlib_sink(content, kind, level):
    """The device sink's stream is at most 1.005 times the parallel zlib
    sink's at the same level, on the same GOP."""
    x = content[kind]
    packed = np.concatenate([x, np.zeros(1, np.uint8)])
    zsink = entropy.ParallelDeflateSink(level, 1)
    zsink.gop_boundary()
    zdata = zsink.push_packed(packed, 8 * len(x)) + zsink.finish()
    zsink.close()
    dsink = entropy.DeviceDeflateSink(level)
    dsink.gop_boundary()
    ddata = push_plain(dsink, packed, 8 * len(x), level) + dsink.finish()
    assert zlib.decompress(ddata) == zlib.decompress(zdata)
    assert len(ddata) <= 1.005 * len(zdata)


def test_huffman_lengths_are_limited_and_complete():
    """Fibonacci frequencies want codes of 30 bits; the limit cuts them to
    15 and the Kraft sum stays exactly 1."""
    freq = [1, 1]
    while len(freq) < 30:
        freq.append(freq[-1] + freq[-2])
    lengths = deflate.huffman_lengths(freq, 15)
    assert max(lengths) == 15
    assert sum(2.0 ** -x for x in lengths) == 1.0
    lengths = deflate.huffman_lengths([0, 5, 0], 15)
    assert lengths == [1, 1, 0]  # one used symbol still gets a complete code


def _gops(seed: int, n_gops: int):
    """A bit stream cut into GOPs at bit ends that are not byte-aligned, as
    the device step hands them over: each GOP's buffer starts at the byte
    that holds its first bit and carries the previous GOP's partial byte."""
    rng = np.random.default_rng(seed)
    stream = stream_bytes(bench_clip(16, 64, 96, seed))
    stream = np.concatenate([stream, rng.integers(0, 256, 8, dtype=np.uint8)])
    ends = np.sort(rng.choice(np.arange(8, 8 * (len(stream) - 8)), n_gops, replace=False))
    out, done = [], 0
    for end in ends:
        a = done // 8
        out.append((stream[a:].copy(), int(end) - 8 * a))
        done = int(end)
    return stream, out


def test_device_sink_layout_on_cpu():
    """Header, per-GOP sync offsets that parallel_inflate takes, the payload
    of zlib's sinks, the final byte, and the adler32."""
    stream, gops = _gops(5, 4)
    dsink = entropy.DeviceDeflateSink(9)
    zsink = entropy.ParallelDeflateSink(9, 2)
    dout, zout = [], []
    for buf, bits in gops:
        dsink.gop_boundary()
        zsink.gop_boundary()
        dout.append(push_plain(dsink, buf, bits, 9))
        zout.append(zsink.push_packed(buf, bits))
    assert (dsink.carry_code, dsink.carry_bits) == (zsink.carry_code, zsink.carry_bits)
    data = b"".join(dout) + dsink.finish()
    zdata = b"".join(zout) + zsink.finish()
    zsink.close()
    dsink.close()
    assert data[:2] == b"\x78\xda"
    assert zlib.decompress(data) == zlib.decompress(zdata)  # adler32 checked too
    syncs = dsink.sync_offsets()
    assert len(syncs) == 4 and syncs[0] == 2
    assert entropy.parallel_inflate(data, syncs) == zlib.decompress(data)
    for a, b in zip(syncs, syncs[1:]):  # each GOP's span inflates alone
        assert len(inflate_raw(data[a:b])) > 0


def test_device_sink_refuses_cpu_tensors():
    """The device sink deflates only on the card: CPU tensors take the zlib
    sinks, which make_sink picks for them."""
    _, gops = _gops(6, 1)
    buf, bits = gops[0]
    sink = entropy.DeviceDeflateSink(6)
    with pytest.raises(ValueError, match="CUDA"):
        sink.push_gop(torch.from_numpy(buf), torch.tensor(bits))
    assert sink.timer.calls.get("deflate", 0) == 0


@pytest.mark.parametrize("sink", ["serial", "parallel"])
def test_zlib_sinks_push_gop_equals_push_packed(sink):
    """A zlib sink's GOP entry point on CPU tensors writes the bytes of the
    GOP's boundary and ``push_packed`` of its bytes through the partial last
    byte, counts one ``sink_push`` stage a GOP (the GOP's whole bytes) and
    neither ``device_wait`` nor ``d2h``."""
    stream, gops = _gops(8, 4)

    def make():
        return entropy.DeflateSink(9) if sink == "serial" else entropy.ParallelDeflateSink(9, 2)

    a, b = make(), make()
    got, want = [], []
    for buf, bits in gops:
        data, total = a.push_gop(torch.from_numpy(buf), torch.tensor(bits))
        assert total == bits
        got.append(data)
        b.gop_boundary()
        want.append(b.push_packed(buf[: bits // 8 + 1], bits))
    got.append(a.finish())
    want.append(b.finish())
    assert b"".join(got) == b"".join(want)
    assert a.sync_offsets() == b.sync_offsets()
    assert a.timer.calls["sink_push"] == len(gops)
    assert a.timer.bytes["sink_push"] == sum(bits // 8 for _, bits in gops)
    assert not {"device_wait", "d2h"} & set(a.timer.calls)
    a.close()
    b.close()


def test_empty_device_sink_is_a_valid_stream():
    sink = entropy.DeviceDeflateSink(9)
    sink.carry_code, sink.carry_bits = 5, 3
    data = sink.finish()
    assert zlib.decompress(data) == bytes([5 << 5]) and sink.sync_offsets() is None


@pytest.mark.parametrize("workers,device,want", [
    (0, "cuda", entropy.DeflateSink),
    (0, None, entropy.DeflateSink),
    (-1, None, entropy.ParallelDeflateSink),
    (-1, "cpu", entropy.ParallelDeflateSink),
    (3, "cpu", entropy.ParallelDeflateSink),
    (-1, "cuda", entropy.DeviceDeflateSink),
    (3, "cuda", entropy.DeviceDeflateSink),
])
def test_make_sink_picks_by_device_and_workers(workers, device, want):
    sink = entropy.make_sink(CodecConfig(deflate_workers=workers), device=device)
    assert type(sink) is want
    sink.close()


def test_streaming_encoder_on_cpu_keeps_the_zlib_sinks():
    """The CPU encoder (the tests' byte parity with the JAX package) and
    the host path never take the device sink."""
    from dct3d_tpu_torch import StreamingEncoder

    for workers in (0, -1):
        for device_pack in (True, False):
            enc = StreamingEncoder(64, 48, CodecConfig(deflate_workers=workers),
                                   device="cpu", device_pack=device_pack)
            assert not isinstance(enc.sink, entropy.DeviceDeflateSink)
            enc.finish()


def wire_plane_bytes(n: int) -> np.ndarray:
    """The first ``n`` bytes of the bench clip's turbo wire plane (GOP 0)."""
    from dct3d_tpu_torch import encode_turbo_video
    from dct3d_tpu_torch.parallel.multihost import split_members

    data = encode_turbo_video(bench_clip(8, 64, 96), CodecConfig(turbo_codec="zlib"),
                              device="cpu")
    payload = split_members(data)[0][1]
    a = int(np.frombuffer(payload[:4], "<u4")[0])
    plane = np.frombuffer(zlib.decompress(payload[16 : 16 + a]), np.uint8)
    return np.tile(plane, -(-n // len(plane)))[:n]


@pytest.mark.parametrize("level", range(-1, 10))
def test_zlib_stream_frames_a_span(level):
    """zlib_stream wraps a plain-engine span of a few KiB of the turbo wire
    plane in zlib's header for the level, ``03 00`` and the adler32 from the
    span's sums: zlib.decompress (which checks the adler32) reads it back."""
    x = wire_plane_bytes(6000)
    out, info = deflate.deflate(torch.from_numpy(x), torch.tensor(8 * len(x)), level)
    nout, s1, s2 = (int(info[k]) for k in (deflate.I_OUT_BYTES, deflate.I_S1, deflate.I_S2))
    stream = deflate.zlib_stream(out[:nout].numpy().tobytes(), level, s1, s2, len(x))
    assert deflate.zlib_header(level) == zlib.compress(b"x", level)[:2] == stream[:2]
    assert stream[-6:-4] == b"\x03\x00"
    assert zlib.decompress(stream) == x.tobytes()


def test_default_level_reads_as_six():
    """Level -1 is zlib's default, 6, for the engine, the header and the
    driver (the CLI's ``--zlib-level -1`` on the card); other levels outside
    0-9 raise."""
    x = wire_plane_bytes(5000)
    bits = torch.tensor(8 * len(x))
    out, info = deflate.deflate(torch.from_numpy(x), bits, -1)
    out6, info6 = deflate.deflate(torch.from_numpy(x), bits, 6)
    assert torch.equal(info, info6)
    assert torch.equal(out[: int(info[deflate.I_OUT_BYTES])],
                       out6[: int(info6[deflate.I_OUT_BYTES])])
    assert deflate.zlib_header(-1) == zlib.compress(b"", -1)[:2] == deflate.zlib_header(6)
    assert deflate.Deflater(-1)(torch.from_numpy(x), bits) == deflate.Deflater(6)(
        torch.from_numpy(x), bits)
    for bad in (-2, 10):
        with pytest.raises(ValueError, match="not 0-9"):
            deflate.zlib_level(bad)


def test_turbo_member_from_a_finished_plane_stream():
    """_member_payload given the plane's finished stream ships it as the
    first stream and compresses the other three as from the plane: with
    zlib's own stream the payload is the host route's byte for byte; with
    a plain-engine stream it parses to the same plane and exceptions."""
    from dct3d_tpu_torch.codec import turbo

    cfg = CodecConfig(turbo_codec="zlib", zlib_level=6)
    rng = np.random.default_rng(5)
    cubes = 40
    plane = rng.integers(0, 3, (256, cubes), dtype=np.uint8)
    dc = rng.integers(-300, 300, cubes).astype(np.int16)
    idx = np.sort(rng.choice(cubes * 512, 30, replace=False))
    idx = idx[idx % 512 != 0]
    val = rng.integers(8, 90, idx.size).astype(np.int16)
    host = turbo._member_payload(plane, dc, idx, val, cfg, wire=True)
    flat = plane.reshape(-1)
    assert turbo._member_payload(None, dc, idx, val, cfg,
                                 plane_stream=zlib.compress(flat.tobytes(), 6)) == host
    out, info = deflate.deflate(torch.from_numpy(flat), torch.tensor(8 * flat.size), 6)
    nout, s1, s2 = (int(info[k]) for k in (deflate.I_OUT_BYTES, deflate.I_S1, deflate.I_S2))
    card = turbo._member_payload(None, dc, idx, val, cfg, plane_stream=deflate.zlib_stream(
        out[:nout].numpy().tobytes(), 6, s1, s2, flat.size))
    assert card[16:] != host[16:]
    for a, b in zip(turbo._parse_payload(card, 512, wire=True),
                    turbo._parse_payload(host, 512, wire=True)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
@pytest.mark.parametrize("workers", [0, -1])
def test_turbo_encoder_on_cpu_keeps_host_compression(codec, workers):
    """A CPU turbo encode never takes the card's DEFLATE: no ``deflate``
    stage, no launch, and the plane's stream is the host's."""
    from dct3d_tpu_torch import TurboEncoder, kernels
    from dct3d_tpu_torch.codec import turbo

    cfg = CodecConfig(turbo_codec=codec, deflate_workers=workers, zlib_level=6)
    kernels.LAUNCHES.clear()
    enc = TurboEncoder(96, 64, cfg, device="cpu")
    data = enc.push(bench_clip(16, 64, 96)) + enc.finish()
    assert not enc._card_deflate
    assert "deflate" not in enc.timer.calls and not kernels.LAUNCHES["deflate"]
    for _, payload, _ in turbo.split_members(data):
        a = int(np.frombuffer(payload[:4], "<u4")[0])
        first = payload[16 : 16 + a]
        assert first == turbo._compress(turbo._decompress(first), cfg)
