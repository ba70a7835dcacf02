"""The port's sharded and multi-host layer (dct3d_tpu_torch.parallel)
against the JAX package's, on the CPU.

The JAX side runs as tests/test_sharding.py runs it, on the eight virtual
CPU devices of tests/conftest.py; the port's meshes repeat
torch.device("cpu"), so every shard runs the kernels' plain versions one
after the other.  The mesh invariant holds both ways: a sharded stream is
byte-identical to the single-device one (the JAX package's and the
port's), and sharded pixels equal the single-device decode's.  Mirrors
tests/test_sharding.py test by test.
"""

import os
import subprocess
import sys
import zlib
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import CodecConfig as JConfig
from dct3d_tpu import encode_video as j_encode_video
from dct3d_tpu.codec import turbo as j_turbo
from dct3d_tpu.codec.encoder import StreamingEncoder as JStreamingEncoder
from dct3d_tpu.parallel import mesh as j_mesh
from dct3d_tpu.parallel import multihost as j_multihost
from dct3d_tpu.parallel.sharding import ShardedDecoder as JShardedDecoder
from dct3d_tpu.parallel.sharding import ShardedEncoder as JShardedEncoder
from dct3d_tpu_torch import CodecConfig, decode_video, encode_video, psnr
from dct3d_tpu_torch.codec import entropy, turbo
from dct3d_tpu_torch.codec.encoder import StreamingEncoder
from dct3d_tpu_torch.parallel import dryrun, multihost, sharding
from dct3d_tpu_torch.parallel.mesh import GOP_AXIS, TILE_AXIS, make_mesh, single_device_mesh
from dct3d_tpu_torch.parallel.sharding import ShardedDecoder, ShardedEncoder

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def cpu_mesh(gop, tile):
    return make_mesh(gop=gop, tile=tile, devices=[CPU] * (gop * tile))


def jax_mesh(gop, tile):
    return j_mesh.make_mesh(gop=gop, tile=tile, devices=jax.devices()[: gop * tile])


def both_sharded(clip, gop, tile, cfg_kw=None, pushes=None):
    """(port encoder, its bytes, JAX encoder, its bytes) of the same clip
    on (gop, tile) meshes, pushed in pieces of `pushes` frames."""
    cfg_kw = cfg_kw or {}
    h, w = clip.shape[1:]
    step = pushes or clip.shape[0]
    out = []
    for enc in (ShardedEncoder(w, h, cpu_mesh(gop, tile), CodecConfig(**cfg_kw)),
                JShardedEncoder(w, h, jax_mesh(gop, tile), JConfig(**cfg_kw))):
        data = b"".join(enc.push(clip[i : i + step]) for i in range(0, clip.shape[0], step))
        out += [enc, data + enc.finish()]
    return out


@pytest.mark.parametrize("gop,tile", [(1, 1), (4, 1), (1, 4), (4, 2), (2, 4)])
def test_sharded_encode_matches_single_device(gop, tile):
    """The port's sharded stream equals the JAX sharded encoder's and the
    JAX single-device encode_video's, byte for byte, with the same bit
    ends."""
    clip = synthetic_video(8 * gop * 2, 64, 64, seed=7)
    enc, got, jenc, jgot = both_sharded(clip, gop, tile)
    assert got == jgot == j_encode_video(clip, JConfig())
    assert enc.gop_bit_ends == jenc.gop_bit_ends
    assert len(enc.gop_bit_ends) == clip.shape[0] // 8
    assert enc.gop_sync_offsets is None and jenc.gop_sync_offsets is None


def test_sharded_encode_multiple_pushes():
    clip = synthetic_video(8 * 2 * 3, 64, 64, seed=8)
    enc, got, jenc, jgot = both_sharded(clip, 2, 2, pushes=16)
    assert got == jgot == j_encode_video(clip, JConfig())
    assert enc.gop_bit_ends == jenc.gop_bit_ends
    assert enc.frames_encoded == clip.shape[0]


@pytest.mark.parametrize("cfg_kw", [
    dict(quant_strength=0, pack_bits_per_value=2),  # the JAX per-group overflow
    dict(stream_bits_per_value=1),  # the JAX stream-buffer overflow
], ids=["quant0_tight_groups", "tight_stream"])
def test_sharded_tight_configs_equal_jax(cfg_kw):
    """The configs that drive the JAX encoder's overflow retries (the port's
    buffers are worst-case, so it never retries): equal bytes all round."""
    clip = synthetic_video(16, 64, 64, seed=41)
    enc, got, jenc, jgot = both_sharded(clip, 2, 2, cfg_kw)
    assert got == jgot == j_encode_video(clip, JConfig(**cfg_kw))
    assert enc.gop_bit_ends == jenc.gop_bit_ends


@pytest.mark.parametrize("h,w", [(24, 64), (12, 20)], ids=["whole_groups", "partial_groups"])
def test_sharded_block4_equal_single_device(h, w):
    """4x4x4 cubes on a (2, 3) mesh: tile shards of whole 256-value groups
    (K2's route), and of 5 cubes a GOP (320 values), which take pack_bits
    with the phase pseudo-codeword (K5's route): the stream equals the
    single-device ones."""
    kw = dict(block_w=4, block_h=4, block_d=4)
    clip = synthetic_video(16, h, w, seed=44)
    enc = ShardedEncoder(w, h, cpu_mesh(2, 3), CodecConfig(**kw))
    got = enc.push(clip) + enc.finish()
    assert got == encode_video(clip, CodecConfig(**kw), device="cpu") \
        == j_encode_video(clip, JConfig(**kw))


def test_sharded_encode_noise_equal_jax():
    """Noise over the JAX encoder's stream budget (its ladder climbs): the
    same bytes as the JAX sharded and single-device encoders."""
    noise = np.random.default_rng(3).integers(0, 256, (32, 64, 64), dtype=np.uint8)
    enc, got, jenc, jgot = both_sharded(noise, 2, 2)
    assert jenc._ladder.level > 0
    assert got == jgot == j_encode_video(noise, JConfig())


@pytest.mark.parametrize("workers", [0, 2], ids=["serial_sink", "parallel_sink"])
def test_sharded_sinks(workers):
    """Serial sink: the single-device bytes.  Parallel sink: it marks one
    sync point a mesh step, so the bytes are the JAX sharded encoder's and
    the inflated payload the single-device one's; the step-granularity
    sync offsets equal JAX's."""
    clip = synthetic_video(32, 64, 64, seed=13)
    enc, got, jenc, jgot = both_sharded(clip, 2, 1, dict(deflate_workers=workers))
    assert got == jgot
    want = encode_video(clip, CodecConfig(deflate_workers=workers), device="cpu")
    if workers == 0:
        assert got == want
    else:
        assert zlib.decompress(got) == zlib.decompress(want)
    assert enc.gop_sync_offsets == jenc.gop_sync_offsets
    assert (enc.gop_sync_offsets is None) == (workers == 0)


def test_mesh_validation(monkeypatch):
    with pytest.raises(ValueError):
        make_mesh(gop=3, tile=3, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        ShardedEncoder(64, 60, cpu_mesh(2, 2))  # no whole block rows a tile
    with pytest.raises(ValueError):
        ShardedDecoder(64, 60, cpu_mesh(2, 2))
    m = make_mesh(tile=2, devices=[CPU] * 8)
    assert m.shape == {GOP_AXIS: 4, TILE_AXIS: 2} and m.distinct_devices == [CPU]
    assert single_device_mesh(CPU).shape == {GOP_AXIS: 1, TILE_AXIS: 1}
    # No card: the default mesh raises instead of falling back to the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (make_mesh, single_device_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()


@pytest.mark.parametrize("gop,tile", [(2, 2), (8, 1), (1, 8)])
def test_sharded_decode_roundtrip(gop, tile):
    """Sharded pixels equal the port's single-device decode and the JAX
    sharded decode."""
    clip = synthetic_video(8 * gop, 64, 64, seed=9)
    data = j_encode_video(clip, JConfig())
    got = ShardedDecoder(64, 64, cpu_mesh(gop, tile), CodecConfig()).decode(data, clip.shape[0])
    np.testing.assert_array_equal(got, decode_video(data, 64, 64, clip.shape[0], device="cpu"))
    np.testing.assert_array_equal(
        got, JShardedDecoder(64, 64, jax_mesh(gop, tile), JConfig()).decode(data, clip.shape[0]))
    assert psnr(clip, got) > 30.0


def test_sharded_decoder_streams_multi_step():
    """Four mesh steps through the parallel entropy stage: the single-device
    pixels; a tail that does not fill a step is not decoded."""
    clip = synthetic_video(72, 64, 64, seed=31)
    data = j_encode_video(clip, JConfig())
    dec = ShardedDecoder(64, 64, cpu_mesh(2, 1), CodecConfig())
    got = dec.decode(data, 72)
    assert got.shape == (64, 64, 64)
    np.testing.assert_array_equal(got, decode_video(data, 64, 64, 64, device="cpu"))


def test_sharded_decode_stream_bounded_window():
    """decode_stream yields per-step batches at O(step) memory: the inflate
    window's high-water mark stays under half the payload."""
    clip = synthetic_video(8 * 2 * 12, 64, 64, seed=41)
    data = j_encode_video(clip, JConfig())
    want = decode_video(data, 64, 64, clip.shape[0], device="cpu")
    win = entropy.InflateWindow(data, chunk_bytes=1024)
    dec = ShardedDecoder(64, 64, cpu_mesh(2, 1), CodecConfig(), entropy_workers=2)
    batches = list(dec.decode_stream(data, clip.shape[0], _window=win))
    assert [b.shape[0] for b in batches] == [16] * 12
    np.testing.assert_array_equal(np.concatenate(batches), want)
    assert win.max_held < len(zlib.decompress(data)) // 2, win.max_held


def test_sharded_decode_stream_indexed_and_serial():
    """The indexed route (no scan), the serial loop (the sharded decoder's
    route without the native library, forced by hiding it), a stale index
    (scanned instead) and a truncated stream."""
    clip = synthetic_video(8 * 2 * 3, 64, 64, seed=43)
    enc = StreamingEncoder(64, 64, CodecConfig(), device="cpu")
    stream = enc.push(clip) + enc.finish()
    jenc = JStreamingEncoder(64, 64, JConfig())
    assert jenc.push(clip) + jenc.finish() == stream
    positions = multihost.gop_positions(enc.gop_bit_ends, 6, 8, 48)
    want = decode_video(stream, 64, 64, 48, device="cpu")
    dec = ShardedDecoder(64, 64, cpu_mesh(2, 1), CodecConfig())
    np.testing.assert_array_equal(dec.decode(stream, 48, positions=positions), want)
    np.testing.assert_array_equal(
        dec.decode(stream, 48, positions=[p + 1 for p in positions],
                   index_end=enc.gop_bit_ends[-1] + 8 * len(stream)), want)
    with mock.patch.object(sharding, "native", mock.Mock(load=lambda: None)):
        np.testing.assert_array_equal(dec.decode(stream, 48), want)
    with pytest.raises(EOFError):
        dec.decode(zlib.compress(zlib.decompress(stream)[:-200]), 48)


@pytest.mark.parametrize("gop,tile", [(2, 2), (4, 2)])
def test_turbo_sharded_equal_jax(gop, tile):
    """Turbo on a mesh: the port's members equal the JAX sharded and the
    port's single-device containers (zlib and zstd wires); the sharded
    decode's pixels equal the single-device decode's."""
    clip = synthetic_video(8 * gop * 2, 64, 64, seed=21)
    for codec in ("zlib", "zstd"):
        cfg, jcfg = CodecConfig(turbo_codec=codec), JConfig(turbo_codec=codec)
        enc = turbo.TurboShardedEncoder(64, 64, cpu_mesh(gop, tile), cfg)
        got = enc.push(clip) + enc.finish()
        jenc = j_turbo.TurboShardedEncoder(64, 64, jax_mesh(gop, tile), jcfg)
        assert got == jenc.push(clip) + jenc.finish()
        assert got == turbo.encode_turbo_video(clip, cfg, device="cpu")
    want = turbo.decode_turbo_container(got, 64, 64, cfg, device="cpu")
    dec = turbo.TurboShardedDecoder(64, 64, cpu_mesh(gop, tile), cfg)
    np.testing.assert_array_equal(dec.decode(got), want)
    # Three GOPs on a 2-GOP axis: one step, then the single-device tail.
    tail = turbo.encode_turbo_video(clip[:24], cfg, device="cpu")
    np.testing.assert_array_equal(
        turbo.TurboShardedDecoder(64, 64, cpu_mesh(2, tile), cfg).decode(tail), want[:24])


def test_turbo_sharded_fallback_and_overflow_equal_single_device():
    """Quant 0 floods the exception tables: every shard overflows its 16
    slots (the step reruns at 256) and GOPs fall back to reference-profile
    members; the container equals the single-device one and decodes on the
    mesh to the same pixels."""
    clip = synthetic_video(16, 64, 64, seed=22)
    cfg = CodecConfig(quant_strength=0)
    got = turbo.TurboShardedEncoder(64, 64, cpu_mesh(2, 2), cfg).push(clip)
    assert got == turbo.encode_turbo_video(clip, cfg, device="cpu")
    assert got == j_turbo.encode_turbo_video(clip, JConfig(quant_strength=0))
    np.testing.assert_array_equal(
        turbo.TurboShardedDecoder(64, 64, cpu_mesh(2, 2), cfg).decode(got),
        turbo.decode_turbo_container(got, 64, 64, cfg, device="cpu"))


def test_turbo_sharded_block4_partial_groups():
    """4x4x4 tile shards of 320 values end in a partial exception group:
    each shard's tables are expanded on their own, so the members still
    equal the single-device ones (every member turbo, with exceptions).
    R7: the JAX sharded encoder offsets the later tiles' exceptions by the
    padded group count and writes other members, which decode to other
    pixels on most of the clip (ROADMAP Queue 3)."""
    kw = dict(block_w=4, block_h=4, block_d=4, turbo_codec="zlib", quant_strength=20)
    clip = synthetic_video(16, 12, 20, seed=45)
    cfg = CodecConfig(**kw)
    got = turbo.TurboShardedEncoder(20, 12, cpu_mesh(2, 3), cfg).push(clip)
    want = turbo.encode_turbo_video(clip, cfg, device="cpu")
    assert got == want == j_turbo.encode_turbo_video(clip, JConfig(**kw))
    members = multihost.split_members(got)
    assert [m[2] for m in members] == [turbo.MEMBER_TURBO] * 4
    assert all(turbo._parse_payload(m[1], 64, True, True)[2].size for m in members)
    want_px = turbo.decode_turbo_container(want, 20, 12, cfg, device="cpu")
    np.testing.assert_array_equal(
        turbo.TurboShardedDecoder(20, 12, cpu_mesh(2, 3), cfg).decode(got), want_px)
    jgot = j_turbo.TurboShardedEncoder(20, 12, jax_mesh(2, 3), JConfig(**kw)).push(clip)
    assert jgot != want
    jpx = j_turbo.decode_turbo_container(jgot, 20, 12, JConfig(**kw)).astype(np.int32)
    assert (jpx != want_px).mean() > 0.5


def test_multihost_single_process_equals_sharded():
    """One process: encode_multihost is the sharded member, byte for byte
    the JAX package's, and decodes; the gather returns its input."""
    clip = synthetic_video(32, 64, 64, seed=11)
    data = multihost.encode_multihost(clip, 64, 64, 32, cpu_mesh(2, 1), CodecConfig())
    assert data == j_multihost.encode_multihost(clip, 64, 64, 32, jax_mesh(2, 1), JConfig())
    members = multihost.split_members(data)
    assert [m[0] for m in members] == [32]
    assert members[0][1] == j_encode_video(clip, JConfig())
    assert psnr(clip, multihost.decode_multihost_container(data, 64, 64, device="cpu")) > 30.0
    assert multihost.gather_ordered_bytes(b"abc") == b"abc"
    multihost.initialize(None, 1)  # one process: nothing to join


@pytest.mark.parametrize("turbo_on,index", [(False, False), (False, True), (True, False)],
                         ids=["reference", "reference_index", "turbo"])
def test_multihost_encodes_tail_gops(turbo_on, index):
    """A span that does not fill the gop mesh axis keeps its tail GOPs as
    a member of their own: the JAX package's container, byte for byte."""
    clip = synthetic_video(24, 64, 64, seed=25)  # 3 GOPs on a 2-GOP axis
    got = multihost.encode_local_members(clip, 64, 64, cpu_mesh(2, 1), CodecConfig(),
                                         index=index, turbo=turbo_on)
    want = j_multihost.encode_local_members(clip, 64, 64, jax_mesh(2, 1), JConfig(),
                                            index=index, turbo=turbo_on)
    assert got == want
    members = multihost.split_members(got)
    if turbo_on:
        assert [m[0] for m in members] == [8, 8, 8]
        out = turbo.decode_turbo_container(got, 64, 64, device="cpu")
    else:
        assert [(m[0], m[2]) for m in members if m[2] == 0] == [(16, 0), (8, 0)]
        assert len(members) == (4 if index else 2)
        out = multihost.decode_multihost_container(got, 64, 64, device="cpu")
    assert out.shape == (24, 64, 64) and psnr(clip, out) > 30.0


def test_multihost_two_process_simulation(tmp_path):
    """A real two-process gloo run (python -m
    dct3d_tpu_torch.parallel.multihost_sim --device cpu): exit 0, its own
    checks passed, and each temporal member of rank 0's container is the
    JAX package's encode_video of that member's frames."""
    from dct3d_tpu.io import synthetic as j_synthetic

    out = str(tmp_path / "sim.d3v")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "dct3d_tpu_torch.parallel.multihost_sim",
         "--device", "cpu", "--out", out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=280,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "MULTIHOST SIM PASSED" in r.stdout
    clip = j_synthetic.moving_gradient(40, 64, 64, seed=3)
    with open(out, "rb") as f:
        members = multihost.split_members(f.read())
    assert [(m[0], m[2]) for m in members] == [(16, 0), (8, 0), (16, 0)]
    a0 = 0
    for frames, payload, _ in members:
        assert payload == j_encode_video(clip[a0 : a0 + frames], JConfig())
        a0 += frames


def test_dryrun_multichip_against_oracle():
    """dryrun_multichip(4, "cpu") at 640x368 passes its own checks, and its
    pixels are within 1 LSB of the float64 oracle's decode on < 1 %."""
    from dct3d_tpu import oracle

    r = dryrun.dryrun_multichip(4, "cpu")
    t, h, w = r["frames"].shape
    assert (r["mesh"], (h, w)) == ((2, 2), (368, 640))
    ref = oracle.decode(r["stream"], w, h, t, JConfig())
    diff = np.abs(r["pixels"].astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())


def test_sharded_720p_one_step():
    """One (4, 2) mesh step at 1280x720 (14,400 cubes a GOP) pins the shard
    boundary arithmetic at real cube counts: the stream equals the port's
    single-device stream byte for byte, and carries the JAX package's
    single-device ints but at f32 rounding ties, where torch's CPU sgemm
    and XLA's round a handful of the 29.5M values otherwise (as cuBLAS does
    not: PERF.md)."""
    clip = synthetic_video(32, 720, 1280, seed=90)
    enc = ShardedEncoder(1280, 720, cpu_mesh(4, 2), CodecConfig(zlib_level=1))
    got = enc.push(clip) + enc.finish()
    assert got == encode_video(clip, CodecConfig(zlib_level=1), device="cpu")
    want = j_encode_video(clip, JConfig(zlib_level=1))

    def ints(data):
        return entropy.decode_values(np.frombuffer(zlib.decompress(data), np.uint8),
                                     clip.size)[0]

    a, b = ints(got), ints(want)
    diff = np.flatnonzero(a != b)
    assert diff.size <= 16, diff.size
    from dct3d_tpu_torch.codec import framing
    from dct3d_tpu_torch.ops import dct

    cfg = CodecConfig()
    enc64 = dct.encode_matrix(cfg, np.float64)
    per_gop = 1280 * 720 * 8
    for i in diff:
        g, c, j = i // per_gop, (i % per_gop) // 512, i % 512
        cubes = framing.frames_to_cubes(torch.from_numpy(clip[8 * g : 8 * g + 8]), cfg)
        x = float(cubes[c].double().numpy() @ enc64[:, j])
        assert abs(abs(x) % 1 - 0.5) < 1e-4, (i, a[i], b[i], x)
        assert abs(a[i] - b[i]) == 1
