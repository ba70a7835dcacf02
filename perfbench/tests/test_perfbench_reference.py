"""The plain reference against the port's CPU path at small sizes (tests,
unlike the reference, may import the port)."""

import numpy as np
import pytest
import torch

from dct3d_tpu_torch import CodecConfig, TransformContext, encode_turbo_video
from dct3d_tpu_torch.codec import entropy, transform
from dct3d_tpu_torch.ops import dct, zigzag
from perfbench import checks, reference, spec, sut
from perfbench.tests.tiny import TINY

bench_clip = spec.generator("bench_clip")

CPU = torch.device("cpu")


@pytest.mark.parametrize("block", [(8, 8, 8), (4, 4, 4), (8, 8, 4)])
def test_matrices_and_zigzag_equal_the_port(block):
    cfg = CodecConfig(block_w=block[0], block_h=block[1], block_d=block[2])
    tr = reference.Transform(block, 5, 0.5, CPU)
    assert np.array_equal(tr.enc.numpy(), dct.encode_matrix(cfg, np.float64))
    assert np.array_equal(tr.dec.numpy(), dct.decode_matrix(cfg, np.float64))
    assert np.array_equal(reference._zigzag(*block), zigzag.zigzag_flat_indices(*block))


def test_cubes_round_trip():
    tr = reference.Transform((8, 8, 8), 5, 0.5, CPU)
    f = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (16, 24, 32), np.uint8))
    assert torch.equal(tr.frames(tr.cubes(f), 16, 24, 32), f)


@pytest.mark.parametrize("bitpos", [0, 3, 7])
def test_eg_decode_against_the_port_encoder(bitpos):
    rng = np.random.default_rng(bitpos)
    vals = rng.integers(-5771, 5772, 20000).astype(np.int32)
    vals[rng.random(vals.size) < 0.5] = 0
    payload, nbits = entropy.encode_values(vals, bitpos=bitpos)
    got, end = reference.eg_decode(payload, bitpos, vals.size, 8 * len(payload), CPU)
    assert np.array_equal(got.numpy(), vals) and end == nbits
    with pytest.raises(ValueError):
        reference.eg_decode(payload, bitpos, vals.size, nbits // 2, CPU)


def test_reference_ints_equal_the_port_quantizer():
    cfg = CodecConfig()
    ctx = TransformContext(cfg, "cpu")
    clip = bench_clip(8, 48, 64, 3, CPU)
    tr = reference.Transform((8, 8, 8), 5, 0.5, CPU)
    q = transform.quantize_step(torch.from_numpy(clip), ctx)
    assert checks.int_gap(q, tr.scaled(clip), 0.5) < 1e-3
    assert torch.equal(tr.quantize(tr.scaled(clip)), q.to(torch.int64))


@pytest.mark.parametrize("name", ["ref-8x8x8-1080p", "turbo-8x8x8-1080p"])
def test_container_reader_reads_the_ints_the_port_wrote(name):
    bench = spec.benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == name)
    config = {**spec._load_json(f"{spec.ROOT}/{entry['file']}"), **TINY["config"]}
    codec = sut.Codec(config, CPU)
    clip = bench_clip(32, 48, 64, 9, CPU)
    enc = codec.encode(clip, lambda name: torch.profiler.record_function(name))
    tr = reference.Transform((8, 8, 8), 5, 0.5, CPU)
    v = checks.Verdict()
    reader = checks.ContainerReader(enc.data, codec.profile, 32, 64, 48, tr, v)
    for g in range(4):
        q = transform.quantize_step(torch.from_numpy(clip[8 * g : 8 * g + 8]), codec.ctx)
        assert torch.equal(reader.ints(g), q.to(torch.int64))
    assert v.numbers["structure"] == 0


def test_turbo_ints_parse_a_port_member():
    cfg = CodecConfig(turbo_codec="zlib", zlib_level=6)
    clip = bench_clip(8, 48, 64, 4, CPU)
    data = encode_turbo_video(clip, cfg, device="cpu")
    (kind, frames, payload), = reference.split_members(data)
    q = transform.quantize_step(torch.from_numpy(clip), TransformContext(cfg, "cpu"))
    assert kind == reference.TURBO and frames == 8
    assert torch.equal(reference.turbo_ints(payload, 48, 512), q.to(torch.int64))


def test_a_zstd_wire_is_refused():
    zstd = pytest.importorskip("zstandard")
    with pytest.raises(ValueError, match="zstd"):
        reference.inflate(zstd.ZstdCompressor().compress(b"x" * 100))


def test_gaps():
    p = torch.tensor([3, -2, 0, 1])
    x = torch.tensor([2.9, -2.5, 0.2, 1.6], dtype=torch.float64)
    assert checks.int_gap(p, x, 0.5) == pytest.approx(0.1)
    pix = torch.tensor([0, 255, 10], dtype=torch.uint8)
    assert checks.pixel_gap(pix, torch.tensor([-40.0, 300.0, 10.99], dtype=torch.float64)) == 0
    assert checks.pixel_gap(pix, torch.tensor([1.25, 255.0, 9.5], dtype=torch.float64)) == 0.5
