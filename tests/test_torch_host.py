"""The PyTorch port's host modules against the JAX package's originals.

The port (dct3d_tpu_torch) carries its own copies of the NumPy host code it
needs, because importing dct3d_tpu loads jax; these tests pin each copy to
its original, and check that the port never imports jax.
"""

import ast
import dataclasses
import io
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import config as j_config
from dct3d_tpu import metrics as j_metrics
from dct3d_tpu import profiling as j_profiling
from dct3d_tpu.codec import checkpoint as j_checkpoint
from dct3d_tpu.codec import decoder as j_decoder
from dct3d_tpu.codec import entropy as j_entropy
from dct3d_tpu.codec import transform as j_transform
from dct3d_tpu.codec import turbo as j_turbo
from dct3d_tpu.io import pad as j_pad
from dct3d_tpu.io import png as j_png
from dct3d_tpu.io import rawvideo as j_rawvideo
from dct3d_tpu.io import render as j_render
from dct3d_tpu.io import rgb as j_rgb
from dct3d_tpu.io import synthetic as j_synthetic
from dct3d_tpu.io import y4m as j_y4m
from dct3d_tpu.ops import dct as j_dct
from dct3d_tpu.ops import exceptions as j_exceptions
from dct3d_tpu.ops import quant as j_quant
from dct3d_tpu.ops import zigzag as j_zigzag
from dct3d_tpu.parallel import multihost as j_multihost
from dct3d_tpu_torch import config, metrics, profiling
from dct3d_tpu_torch.codec import checkpoint, decoder, encoder, entropy, transform, turbo
from dct3d_tpu_torch.io import pad, png, rawvideo, render, rgb, synthetic, y4m
from dct3d_tpu_torch.ops import dct, exceptions, quant, zigzag
from dct3d_tpu_torch.parallel import multihost

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dct3d_tpu_torch")


def test_config_defaults_equal():
    ours, theirs = config.CodecConfig(), j_config.CodecConfig()
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("stream_budget_bits_per_value", "gop_size", "cube_size",
                 "face_size"):
        assert getattr(ours, prop) == getattr(theirs, prop)
    assert ours.cubes_per_gop(64, 48) == theirs.cubes_per_gop(64, 48)


@pytest.mark.parametrize("dims", [(8, 8, 8), (4, 4, 4), (8, 4, 2)])
def test_zigzag_tables_equal(dims):
    for fn in ("diagonal_slices", "zigzag_flat_indices",
               "inverse_zigzag_flat_indices"):
        a, b = getattr(zigzag, fn)(*dims), getattr(j_zigzag, fn)(*dims)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


BLOCKS = {"8x8x8": (8, 8, 8), "4x4x4": (4, 4, 4), "8x8x4": (8, 8, 4)}


def _by_block(values):
    """pytest params over BLOCKS x values; the 8x8x8 cases keep the bare
    value as their id."""
    return [pytest.param(dims, v, id=str(v) if name == "8x8x8" else f"{name}-{v}")
            for name, dims in BLOCKS.items() for v in values]


@pytest.mark.parametrize("dims,strength", _by_block([1, 5, 10]))
def test_quant_divisors_equal(dims, strength):
    np.testing.assert_array_equal(quant.quant_divisors(*dims, strength),
                                  j_quant.quant_divisors(*dims, strength))


@pytest.mark.parametrize("dims,strength", _by_block([1, 5, 10]))
def test_dct_matrices_bit_equal(dims, strength):
    blocks = dict(zip(("block_w", "block_h", "block_d"), dims))
    cfg = config.CodecConfig(quant_strength=strength, **blocks)
    jcfg = j_config.CodecConfig(quant_strength=strength, **blocks)
    for fn in ("encode_matrix", "encode_matrix_pair", "decode_matrix"):
        a, b = getattr(dct, fn)(cfg), getattr(j_dct, fn)(jcfg)
        assert a.dtype == b.dtype == np.float32
        assert a.shape == (cfg.cube_size, cfg.cube_size)
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dims,bias", _by_block([0.5, 0.3]))
def test_exact_dc_quant_agrees(dims, bias):
    """The copied exact-DC quantizer on torch int32 sums equals the
    original on NumPy, and floor(S/sqrt(cube) + bias), on 100k sums."""
    cube = int(np.prod(dims))
    sums = np.random.default_rng(3).integers(0, cube * 255 + 1, 100_000)
    sums[:2] = (0, cube * 255)
    got = quant.exact_dc_quant(torch.from_numpy(sums.astype(np.int32)), cube, bias)
    assert got.dtype == torch.int32
    want = j_quant.exact_dc_quant(sums.astype(np.int64), cube, bias)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.floor(sums / np.sqrt(float(cube)) + bias).astype(np.int64))


def test_exact_dc_quant_checks_its_cube_bound():
    """Above 4096 pixels the cube sums can pass 2^20 and the fixed-point
    product its limbs, so the port's copy refuses (the original documents
    the bound without checking it) and _quantize keeps the matmul's DC
    there, as the JAX package's gate does."""
    sums = torch.zeros(3, dtype=torch.int32)
    assert quant.exact_dc_quant(sums, 4096, 0.5).shape == (3,)
    with pytest.raises(ValueError, match="4096"):
        quant.exact_dc_quant(sums, 4097, 0.5)
    cfg = config.CodecConfig(block_w=16, block_h=16, block_d=32)
    cubes = torch.full((2, cfg.cube_size), 255.0)
    enc_t = torch.zeros((cfg.cube_size, 1))
    enc_t[:, 0] = 1.0 / np.sqrt(cfg.cube_size)
    q = transform._quantize(cubes, cubes.sum(1).to(torch.int32), enc_t, cfg)
    assert q.tolist() == [[round(255 * np.sqrt(cfg.cube_size))]] * 2


def test_pad_copy_equals_original():
    """io/pad.py's copy against dct3d_tpu.io.pad, on odd and even sizes,
    with and without a channel axis."""
    rng = np.random.default_rng(4)
    for shape, block in (((3, 5, 7), 4), ((2, 8, 8), 8), ((2, 6, 9, 3), 8), ((1, 2532, 1170), 4)):
        frames = rng.integers(0, 256, shape, dtype=np.uint8)
        assert pad.padded_geometry(shape[2], shape[1], block, block) == \
            j_pad.padded_geometry(shape[2], shape[1], block, block)
        got, want = pad.pad_frames(frames, block, block), j_pad.pad_frames(frames, block, block)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        np.testing.assert_array_equal(pad.crop_frames(got, shape[2], shape[1]), frames)
        np.testing.assert_array_equal(pad.crop_frames(got, 3, 2), j_pad.crop_frames(want, 3, 2))
    assert pad.padded_geometry(1170, 2532, 4, 4) == (1172, 2532)


def test_metrics_equal():
    a = synthetic_video(8, 16, 16, seed=1)
    b = synthetic_video(8, 16, 16, seed=2)
    assert metrics.psnr(a, b) == j_metrics.psnr(a, b)
    assert metrics.psnr(a, a) == float("inf")
    assert metrics.bits_per_pixel(1234, 64, 48, 8) == j_metrics.bits_per_pixel(1234, 64, 48, 8)


def test_context_from_jax_arrays_equals_own_build():
    """A context built from a JAX TransformContext's arrays is bit-identical
    to the port's own float64 host build, and encodes identical streams."""
    jctx = j_transform.TransformContext(j_config.CodecConfig())
    arrays = {k: np.asarray(getattr(jctx, k))
              for k in ("enc_t", "enc_t_pair", "dec_me", "dec_mo")}
    from_jax = transform.TransformContext.from_numpy(arrays, None, "cpu")
    own = transform.TransformContext(None, "cpu")
    for k in arrays:
        a, b = getattr(from_jax, k), getattr(own, k)
        assert a.dtype == b.dtype == torch.float32
        assert a.numpy().tobytes() == b.numpy().tobytes()
    clip = synthetic_video(8, 32, 32)
    assert encoder.encode_video(clip, ctx=from_jax) == encoder.encode_video(clip, ctx=own)


def _exception_tables(seed: int, slots: int = 16):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, slots + 3, 50).astype(np.int32)
    lidx = np.sort(rng.integers(0, 256, (50, slots)), axis=1).astype(np.uint8)
    vals = rng.integers(-5771, 5772, (50, slots)).astype(np.int16)
    return lidx, vals, counts


@pytest.mark.parametrize("seed", [0, 1])
def test_expand_exceptions_equal(seed):
    tables = _exception_tables(seed)
    for a, b in zip(exceptions.expand_exceptions_np(*tables),
                    j_exceptions.expand_exceptions_np(*tables)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(turbo._expand_pair(*tables, 512), j_turbo._expand_pair(*tables, 512)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_member_framing_equal():
    for name in ("MEMBER_MAGIC", "MEMBER_TEMPORAL", "MEMBER_RED", "MEMBER_GREEN",
                 "MEMBER_BLUE", "MEMBER_INDEX", "_MAX_MEMBER_FRAMES"):
        assert getattr(multihost, name) == getattr(j_multihost, name), name
    data = b"".join([multihost._member(b"abc", 8), multihost._member(b"", 16, 5),
                     multihost._member(bytes(range(200)), 8, 4)])
    assert data == b"".join([j_multihost._member(b"abc", 8), j_multihost._member(b"", 16, 5),
                             j_multihost._member(bytes(range(200)), 8, 4)])
    assert multihost.split_members(data) == j_multihost.split_members(data)
    with pytest.raises(ValueError, match="D3MH"):
        multihost.split_members(b"XXXX" + data)
    with pytest.raises(ValueError, match="2\\^24"):
        multihost._member(b"", 1 << 24)


def test_turbo_constants_and_workers_equal():
    assert turbo.MEMBER_TURBO == j_turbo.MEMBER_TURBO
    assert turbo.FALLBACK_EXC_FRAC == j_turbo.FALLBACK_EXC_FRAC
    assert turbo._ZSTD_MAGIC == j_turbo._ZSTD_MAGIC
    assert turbo._FALLBACK_TYPE == j_turbo._FALLBACK_TYPE
    assert turbo._REF_TYPES == j_turbo._REF_TYPES
    assert exceptions.DEFAULT_SLOTS == j_exceptions.DEFAULT_SLOTS
    for w in (-1, 0, 1, 5):
        assert entropy.resolve_workers(w) == j_entropy.resolve_workers(w)


@pytest.mark.parametrize("wire", [True, False])
def test_member_payload_roundtrip_equal(wire):
    """_member_payload and _parse_payload equal the originals on one GOP's
    worth of random tables, in both layouts."""
    rng = np.random.default_rng(5)
    cubes = 40
    plane = rng.integers(0, 256, (cubes, 256), dtype=np.uint8)
    plane_in = np.ascontiguousarray(plane.T) if wire else plane.reshape(-1)
    dc = rng.integers(-5771, 5772, cubes).astype(np.int16)
    idx = np.sort(rng.choice(cubes * 512, 300, replace=False)).astype(np.int64)
    val = rng.integers(-5771, 5772, 300).astype(np.int32)
    cfg = config.CodecConfig(turbo_codec="zlib")
    payload = turbo._member_payload(plane_in, dc, idx, val, cfg, wire=wire)
    assert payload == j_turbo._member_payload(
        plane_in, dc, idx, val, j_config.CodecConfig(turbo_codec="zlib"), wire=wire)
    for split in ([False, True] if wire else [False]):
        for a, b in zip(turbo._parse_payload(payload, 512, wire, split),
                        j_turbo._parse_payload(payload, 512, wire, split)):
            np.testing.assert_array_equal(a, b)


def test_index_helpers_equal():
    """The index member, its parsers (whole, v1-only, torn), gop_positions,
    container_kind, host_frame_span and _temporal_streams against the
    originals."""
    ends, syncs = [5, 123456789, 2**40], [2, 900, 70_000]
    for s in (None, syncs, syncs[:2]):
        assert multihost.make_index_member(ends, s) == j_multihost.make_index_member(ends, s)
    for payload in (multihost.split_members(multihost.make_index_member(ends, syncs))[0][1],
                    multihost.split_members(multihost.make_index_member(ends))[0][1],
                    b"", b"\x03\x00", struct.pack("<I", 3) + b"\x00" * 20,
                    struct.pack("<I", 0)):
        assert multihost.parse_index(payload) == j_multihost.parse_index(payload)
        assert multihost.parse_index_syncs(payload) == j_multihost.parse_index_syncs(payload)
    for args in (([10, 20], 3, 8, 24), ([10, 20, 30], 3, 8, 24), ([10, 20, 30], 2, 8, 0),
                 ([], 1, 8, 0), ([7, 9], 2, 4, 8)):
        assert multihost.gop_positions(*args) == j_multihost.gop_positions(*args)
    cfg, jcfg = config.CodecConfig(), j_config.CodecConfig()
    for total, count in ((0, 1), (64, 3), (71, 4), (200, 7)):
        for p in range(count):
            assert multihost.host_frame_span(total, cfg, p, count) == \
                j_multihost.host_frame_span(total, jcfg, p, count)
    m, idx = multihost._member, multihost.make_index_member([9, 17], [2, 5])
    for members in ([(8, b"a", 0), (0, idx[16:], 4), (16, b"b", 0)],
                    [(8, b"r", 1), (8, b"g", 2), (8, b"b", 3)],
                    [(8, b"r", 1), (0, b"", 4), (8, b"g", 2), (8, b"b", 3)],
                    [(8, b"x", 5), (8, b"y", 0)], [(8, b"x", 9)], []):
        assert multihost.container_kind(members) == j_multihost.container_kind(members)
    for tagged in ([m(b"a", 8), idx, m(b"b", 16)], [idx, m(b"a", 8)]):
        data = multihost.split_members(b"".join(tagged))
        assert multihost._temporal_streams(data) == j_multihost._temporal_streams(data)
    assert multihost.IndexInfo._fields == j_multihost.IndexInfo._fields
    for bad in ([(8, b"x", 5), (8, b"y", 0)], [(0, idx[16:], 4)]):
        for mod in (multihost, j_multihost):
            with pytest.raises(ValueError):
                mod._temporal_streams(bad)


def test_is_turbo_rgb_container_equal():
    assert turbo.MEMBER_TURBO_RGB == j_turbo.MEMBER_TURBO_RGB
    for types in ([6, 7, 8], [6, 1, 7, 8], [1, 2, 3], [1, 1, 2, 2, 3, 3], [5, 0],
                  [6, 7, 8, 4], [], [0], [6, 9]):
        members = [(8, b"", t) for t in types]
        assert turbo.is_turbo_rgb_container(members) == j_turbo.is_turbo_rgb_container(members)


@pytest.mark.parametrize("chunk", [1, 97, 1 << 20])
def test_inflate_source_equals_original(chunk):
    """InflateSource fed in chunks: the same planar4 GOPs, the same
    refusals while a GOP is not buffered, as the original's."""
    clip = synthetic_video(24, 32, 40, seed=2)
    data = encoder.encode_video(clip, device="cpu")
    n = 32 * 40 * 8
    ours, theirs = entropy.InflateSource(), j_entropy.InflateSource()
    got, want = [], []
    for i in range(0, len(data) + chunk, chunk):
        part = data[i : i + chunk]
        for src, out in ((ours, got), (theirs, want)):
            if part:
                src.feed(part)
            else:
                src.feed_eof()
            while (r := src.try_read_planar4(n)) is not None:
                out.append(r)
        assert len(got) == len(want)
    assert len(got) == 3
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert ours.try_read_planar4(n) is None
    with pytest.raises(ValueError, match="corrupt"):
        entropy.InflateSource().feed(b"\x78\xda garbage")


def _values(seed: int, n: int) -> np.ndarray:
    """Mostly small ints with wide outliers up to the 2^24 magnitudes of
    27-bit and longer codewords."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-4, 5, n)
    wide = rng.random(n) < 0.05
    v[wide] = rng.integers(-(1 << 24), 1 << 24, int(wide.sum()))
    return v.astype(np.int32)


@pytest.mark.parametrize("bitpos", range(8))
def test_encode_values_equals_original(bitpos):
    for n in (0, 1, 255, 4099):
        vals = _values(bitpos + n, n)
        assert entropy.encode_values(vals, bitpos) == j_entropy.encode_values(vals, bitpos)


@pytest.mark.parametrize("workers", [0, 2])
def test_push_values_equals_original(workers):
    """Both sinks after carries of every length: the same bytes, carry and
    sync offsets as the originals' push_values."""
    cfg, jcfg = config.CodecConfig(deflate_workers=workers), j_config.CodecConfig(
        deflate_workers=workers)
    ours, theirs = entropy.make_sink(cfg), j_entropy.make_sink(jcfg)
    got, want = [], []
    for k in range(9):
        vals = _values(k, 1000 + 37 * k)
        got.append(ours.push_values(vals))
        want.append(theirs.push_values(vals))
        assert (ours.carry_code, ours.carry_bits) == (theirs.carry_code, theirs.carry_bits)
    got.append(ours.finish())
    want.append(theirs.finish())
    assert b"".join(got) == b"".join(want)
    assert ours.sync_offsets() == theirs.sync_offsets()
    ours.close()
    theirs.close()


@pytest.mark.parametrize("bitpos", [0, 3, 7])
def test_decode_values_equals_original(bitpos):
    """decode_values (C eg_decode) at every bit phase: the original's ints
    and end position, and EOFError on a truncated stream as the original
    raises."""
    vals = _values(bitpos, 4099)
    data, nbits = entropy.encode_values(vals, bitpos)
    got, end = entropy.decode_values(data, vals.size, bitpos)
    want, jend = j_entropy.decode_values(data, vals.size, bitpos)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vals)
    assert end == jend == nbits
    short = data[: len(data) // 2]
    for fn in (entropy.decode_values, j_entropy.decode_values):
        with pytest.raises(EOFError):
            fn(short, vals.size, bitpos)


@pytest.mark.parametrize("chunk", [64, 1 << 20])
def test_inflate_window_equals_original(chunk):
    """InflateWindow: the same pumps, spans, scans, drops, end bits and
    high-water mark as the original; corrupt input raises ValueError."""
    clip = synthetic_video(24, 32, 40, seed=3)
    data = encoder.encode_video(clip, device="cpu")
    n = 32 * 40 * 8
    ours, theirs = entropy.InflateWindow(data, chunk), j_entropy.InflateWindow(data, chunk)
    pos = [0, 0]
    for win, k in ((ours, 0), (theirs, 1)):
        for _ in range(3):
            pos[k] = win.scan(n, pos[k], 2 * n)
            win.drop_before(pos[k])
    assert pos[0] == pos[1]
    assert ours.end_bit == theirs.end_bit and ours.max_held == theirs.max_held
    for a, b in ((ours.array(pos[0] - 5), theirs.array(pos[1] - 5)),
                 (ours.array(0, 100), theirs.array(0, 100))):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    assert ours.ensure_bit(1 << 40) is theirs.ensure_bit(1 << 40) is False
    assert ours.pump() is theirs.pump() is False
    with pytest.raises(ValueError, match="corrupt"):
        entropy.InflateWindow(b"\x78\xda garbage").pump()


@pytest.mark.parametrize("indexed", [False, True], ids=["scan", "index"])
def test_parallel_chunks_bounded_equals_original(indexed):
    """parallel_chunks_bounded over an InflateWindow: the original's chunk
    values and end positions, in order, from a scan or an index; a
    truncated stream raises EOFError in both."""
    clip = synthetic_video(40, 32, 40, seed=4)
    enc = encoder.StreamingEncoder(40, 32, config.CodecConfig(), device="cpu")
    data = enc.push(clip) + enc.finish()
    n = 32 * 40 * 8
    positions = multihost.gop_positions(enc.gop_bit_ends, 5, 8, 40) if indexed else None
    got = list(entropy.parallel_chunks_bounded(
        entropy.InflateWindow(data, 256), n, 5, entropy.decode_values, 2, positions))
    want = list(j_entropy.parallel_chunks_bounded(
        j_entropy.InflateWindow(data, 256), n, 5, j_entropy.decode_values, 2, positions))
    assert [g[1] for g in got] == [w[1] for w in want] == enc.gop_bit_ends
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
    import zlib

    cut = zlib.compress(zlib.decompress(data)[:-300])
    for mod in (entropy, j_entropy):
        with pytest.raises(EOFError):
            list(mod.parallel_chunks_bounded(mod.InflateWindow(cut), n, 5,
                                             mod.decode_values, 2, positions))


def test_speculative_helpers_equal_original():
    """The tuning constants, and _pack_vals_into at every nibble offset
    and length parity, equal the originals'."""
    for name in ("_SPEC_REC_CAP", "_SPEC_CKPT_SHIFT", "_SPEC_MIN_SEG", "_SPEC_INTERLEAVE",
                 "_SPEC_SEG_FACTOR"):
        assert getattr(entropy, name) == getattr(j_entropy, name), name
    rng = np.random.default_rng(12)
    for d0 in range(4):
        for n in (0, 1, 2, 7, 64):
            vals = rng.integers(-20, 20, n).astype(np.int32)
            plane = rng.integers(0, 256, 40, dtype=np.uint8)
            a, b = plane.copy(), plane.copy()
            entropy._pack_vals_into(a, d0, vals)
            j_entropy._pack_vals_into(b, d0, vals)
            np.testing.assert_array_equal(a, b)


def test_undelta_equals_original():
    """One GOP: the original's uint8 cumsum; several GOPs: the original
    GOP by GOP (the deltas restart at every GOP); a cfg without
    transport_delta leaves the frames as they are."""
    cfg, jcfg = (config.CodecConfig(transport_delta=True),
                 j_config.CodecConfig(transport_delta=True))
    frames = np.random.default_rng(13).integers(0, 256, (24, 8, 16), dtype=np.uint8)
    np.testing.assert_array_equal(decoder._undelta(frames[:8], cfg),
                                  j_decoder._undelta(frames[:8], jcfg))
    np.testing.assert_array_equal(
        decoder._undelta(frames, cfg),
        np.concatenate([j_decoder._undelta(frames[g : g + 8], jcfg) for g in (0, 8, 16)]))
    assert decoder._undelta(frames, config.CodecConfig()) is frames
    np.testing.assert_array_equal(encoder._deltas(decoder._undelta(frames[:8], cfg)),
                                  frames[:8])


def test_resume_info_equals_original(tmp_path):
    """Complete, torn-header, torn-payload and foreign tails."""
    m = multihost._member
    body = m(b"abc", 8) + m(b"", 16, 5) + m(b"x" * 40, 8, 4)
    for tail in (b"", b"D3MH\x01", m(b"y" * 30, 8)[:-7], b"XXXX" + bytes(20)):
        p = str(tmp_path / "f")
        with open(p, "wb") as f:
            f.write(body + tail)
        assert checkpoint.resume_info(p) == j_checkpoint.resume_info(p) == (32, len(body))


def test_stage_timer_equals_original():
    """The same stages give the same bytes, calls and keys; seconds are
    wall time and only checked for presence."""
    ours, theirs = profiling.StageTimer(), j_profiling.StageTimer()
    for t in (ours, theirs):
        for name, nbytes in (("dispatch", 100), ("deflate", 40), ("dispatch", 50), ("wait", 0)):
            with t.stage(name, nbytes):
                pass
    a, b = ours.as_dict(), theirs.as_dict()
    assert list(a) == list(b) == ["deflate", "dispatch", "wait"]
    for k in a:
        assert {f: a[k][f] for f in ("bytes", "calls")} == {f: b[k][f] for f in ("bytes", "calls")}
        assert set(a[k]) == set(b[k])
    assert json.loads(ours.report()).keys() == a.keys()


def test_rawvideo_copy_equals_original(tmp_path):
    clip = np.random.default_rng(6).integers(0, 256, (21, 8, 12), dtype=np.uint8)
    p = str(tmp_path / "v.raw")
    rawvideo.write_video(p, clip)
    assert rawvideo.frame_count(p, 12, 8) == j_rawvideo.frame_count(p, 12, 8) == 21
    for frames in (None, 5, 40):
        np.testing.assert_array_equal(rawvideo.read_video(p, 12, 8, frames),
                                      j_rawvideo.read_video(p, 12, 8, frames))
    np.testing.assert_array_equal(rawvideo.read_video(p, 4, 4, channels=3),
                                  j_rawvideo.read_video(p, 4, 4, channels=3))
    for kw in ({}, {"align": 4}, {"max_frames": 13, "align": 4}, {"start": 4, "align": 2}):
        a = list(rawvideo.iter_frame_batches(p, 12, 8, 8, **kw))
        b = list(j_rawvideo.iter_frame_batches(p, 12, 8, 8, **kw))
        assert [x.shape for x in a] == [y.shape for y in b]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    raw = clip.tobytes() + b"\x01" * 50
    for kw in ({"align": 4}, {"align": 4, "start": 4}, {"max_frames": 10, "align": 2, "start": 4}):
        a = list(rawvideo.StreamFrames(io.BytesIO(raw), 12, 8).iter_batches(8, **kw))
        b = list(j_rawvideo.StreamFrames(io.BytesIO(raw), 12, 8).iter_batches(8, **kw))
        assert [x.shape for x in a] == [y.shape for y in b]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(rawvideo.StreamFrames(io.BytesIO(raw), 12, 8).read_all(),
                                  j_rawvideo.StreamFrames(io.BytesIO(raw), 12, 8).read_all())
    # padded_stream: the same padded batches and geometry.
    a = pad.padded_stream(rawvideo.StreamFrames(io.BytesIO(raw), 12, 8), 8, 8)
    b = j_pad.padded_stream(j_rawvideo.StreamFrames(io.BytesIO(raw), 12, 8), 8, 8)
    assert isinstance(a, rawvideo.StreamFrames) and (a.width, a.height) == (b.width, b.height)
    for x, y in zip(a.iter_batches(8, align=4), b.iter_batches(8, align=4)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("chroma", ["420jpeg", "422", "444", "mono"])
def test_y4m_copy_equals_original(tmp_path, chroma):
    from test_footage import _write_y4m

    clip = synthetic_video(5, 16, 24, seed=8)
    p = str(tmp_path / "v.y4m")
    _write_y4m(p, clip, chroma)
    assert y4m.probe_y4m(p) == j_y4m.probe_y4m(p)
    for frames in (None, 3):
        a, b = y4m.read_y4m(p, frames), j_y4m.read_y4m(p, frames)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
    if chroma == "mono":
        with pytest.raises(ValueError, match="Cmono"):
            y4m.read_y4m_rgb(p)
    else:
        np.testing.assert_array_equal(y4m.read_y4m_rgb(p)[0], j_y4m.read_y4m_rgb(p)[0])
    rgb = np.random.default_rng(9).integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    for mod, name in ((y4m, "a"), (j_y4m, "b")):
        mod.write_y4m(str(tmp_path / f"{name}.y4m"), clip, fps=25.0)
        mod.write_y4m_rgb(str(tmp_path / f"{name}c.y4m"), rgb)
    for x in ("", "c"):
        assert (tmp_path / f"a{x}.y4m").read_bytes() == (tmp_path / f"b{x}.y4m").read_bytes()


@pytest.mark.parametrize("color", ["gray", "rgb"])
def test_png_copy_equals_original(tmp_path, color):
    """Every scanline filter through the port's native unfilter, the
    palette and alpha colour types, sequences and the gray conversion."""
    from test_footage import _write_filtered_png

    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (12, 20) if color == "gray" else (12, 20, 3), dtype=np.uint8)
    seq = tmp_path / "seq"
    seq.mkdir()
    for f in range(5):
        p = str(seq / f"f{f}.png")
        _write_filtered_png(p, img, f)
        np.testing.assert_array_equal(png.read_png(p), j_png.read_png(p))
        np.testing.assert_array_equal(png.read_png(p), img)
    for gray in (True, False):
        np.testing.assert_array_equal(png.read_png_sequence(str(seq), 3, gray),
                                      j_png.read_png_sequence(str(seq), 3, gray))
    assert png.list_sequence(str(seq / "*.png")) == j_png.list_sequence(str(seq / "*.png"))
    with pytest.raises(ValueError, match="filter"):
        png._unfilter(b"\x07" + bytes(20), 1, 20, 1)


def test_synthetic_rgb_render_copies_equal_original(tmp_path):
    kw = {"noise": 4.0, "seed": 3}
    np.testing.assert_array_equal(synthetic.moving_gradient(4, 16, 24, **kw),
                                  j_synthetic.moving_gradient(4, 16, 24, **kw))
    np.testing.assert_array_equal(synthetic.moving_gradient(4, 16, 24, rgb=True),
                                  j_synthetic.moving_gradient(4, 16, 24, rgb=True))
    np.testing.assert_array_equal(synthetic.moving_blocks(4, 16, 24, 5),
                                  j_synthetic.moving_blocks(4, 16, 24, 5))
    for mod, name in ((synthetic, "a"), (j_synthetic, "b")):
        shape = mod.capture(str(tmp_path / f"{name}.raw"), 4, 30, 21, kind="blocks", seed=2)
        assert shape == (4, 32, 24)
    assert (tmp_path / "a.raw").read_bytes() == (tmp_path / "b.raw").read_bytes()
    clip = np.random.default_rng(11).integers(0, 256, (3, 8, 8, 3), dtype=np.uint8)
    for a, b in zip(rgb.split_array(clip), j_rgb.split_array(clip)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(rgb.mix_array(*rgb.split_array(clip)), clip)
    src = str(tmp_path / "c.rgb")
    clip.tofile(src)
    outs = rgb.split_file(src, str(tmp_path / "p"))
    want = j_rgb.split_file(src, str(tmp_path / "q"))
    for a, b in zip(outs, want):
        assert open(a, "rb").read() == open(b, "rb").read()
    rgb.mix_files(str(tmp_path / "p"), str(tmp_path / "m.rgb"))
    assert (tmp_path / "m.rgb").read_bytes() == clip.tobytes()
    gray = str(tmp_path / "a.raw")
    assert render.video_stats(gray, 24, 32) == j_render.video_stats(gray, 24, 32)
    a = render.render_frames(gray, 24, 32, str(tmp_path / "ra"), frames=[1, 9])
    b = j_render.render_frames(gray, 24, 32, str(tmp_path / "rb"), frames=[1, 9])
    assert [open(x, "rb").read() for x in a] == [open(x, "rb").read() for x in b]
    assert [os.path.basename(x)[2:] for x in a] == [os.path.basename(x)[2:] for x in b]


def _port_modules():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_port_imports_no_jax_subprocess():
    """Importing every module of the port loads neither jax nor the JAX
    package."""
    mods = []
    for path in _port_modules():
        rel = os.path.relpath(path, ROOT)[: -len(".py")].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dct3d_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert {"dct3d_tpu_torch.parallel", "dct3d_tpu_torch.parallel.multihost",
            "dct3d_tpu_torch.codec.turbo", "dct3d_tpu_torch.ops.exc_pack",
            "dct3d_tpu_torch.ops.exceptions", "dct3d_tpu_torch.io",
            "dct3d_tpu_torch.io.pad", "dct3d_tpu_torch.cli",
            "dct3d_tpu_torch.__main__", "dct3d_tpu_torch.codec.auto",
            "dct3d_tpu_torch.profiling", "dct3d_tpu_torch.io.rawvideo",
            "dct3d_tpu_torch.io.png", "dct3d_tpu_torch.io.y4m",
            "dct3d_tpu_torch.io.synthetic", "dct3d_tpu_torch.io.rgb",
            "dct3d_tpu_torch.io.render", "dct3d_tpu_torch.codec.rgb_codec",
            "dct3d_tpu_torch.codec.checkpoint", "dct3d_tpu_torch.parallel.mesh",
            "dct3d_tpu_torch.parallel.sharding", "dct3d_tpu_torch.parallel.dryrun",
            "dct3d_tpu_torch.parallel.multihost_sim"} <= set(mods)
    assert len(mods) >= 39


def test_cli_runs_without_jax_subprocess(tmp_path):
    """``python -m dct3d_tpu_torch`` encodes, inspects and decodes on the
    CPU in a process that never loads jax or the JAX package."""
    src = str(tmp_path / "src.raw")
    synthetic_video(8, 16, 16, seed=1).tofile(src)
    code = (
        "import sys\n"
        "from dct3d_tpu_torch.cli import main\n"
        f"assert main(['encode', {src!r}, {src + '.d3'!r}, '16', '16', '--device', 'cpu']) == 0\n"
        f"assert main(['info', {src + '.d3'!r}]) == 0\n"
        f"assert main(['decode', {src + '.d3'!r}, {src + '.out'!r}, '16', '16',"
        " '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dct3d_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert os.path.getsize(src + ".out") == 8 * 16 * 16


@pytest.mark.parametrize("path", sorted(_port_modules()) + [os.path.join(ROOT, "chip_smoke.py")],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_source_imports_no_jax(path):
    """AST scan: no import statement of the port (or of chip_smoke.py)
    names jax or the JAX package, not even inside a function."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "dct3d_tpu"), (path, n)
