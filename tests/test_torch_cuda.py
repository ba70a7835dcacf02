"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a GPU.  On a machine with one,
run ``python -m pytest --noconftest tests/test_torch_cuda.py -q``: the
file imports neither jax nor tests/conftest.py (which does), so it runs
where only the port's dependencies are installed.  The shapes are small and
ragged (block columns that do not fill a thread block's run of 16);
chip_smoke.py covers the 1080p shapes of the main path.
"""

import numpy as np
import pytest
import torch

from dct3d_tpu_torch import (
    decode_turbo_container, decode_video, encode_turbo_video, encode_video,
    kernels,
)
from dct3d_tpu_torch.ops import bitpack, exc_pack, group_pack, relayout, splice

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


def synthetic_video(t, h, w, seed):
    """Moving gradient + noise, uint8 (T, H, W)."""
    rng = np.random.default_rng(seed)
    t_, y, x = np.meshgrid(np.arange(t), np.arange(h), np.arange(w), indexing="ij")
    base = x + 2 * y + 3 * t_
    return ((base + rng.integers(0, 24, (t, h, w))) & 0xFF).astype(np.uint8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 24, 72), (8, 40, 264)])
def test_relayout_kernels_equal_plain(dev, shape):
    t, h, w = shape
    frames = synthetic_video(t, h, w, seed=3)
    cubes, sums = relayout.frames_to_cubes(torch.from_numpy(frames).to(dev))
    p_cubes, p_sums = relayout.frames_to_cubes_plain(torch.from_numpy(frames))
    assert torch.equal(cubes.cpu(), p_cubes) and torch.equal(sums.cpu(), p_sums)
    pixels = torch.from_numpy(
        np.random.default_rng(1).uniform(-30, 290, p_cubes.shape).astype(np.float32))
    got = relayout.cubes_to_frames(pixels.to(dev), h, w)
    assert torch.equal(got.cpu(), relayout.cubes_to_frames_plain(pixels, h, w))


@pytest.mark.parametrize("carry_bits", range(8))
def test_bitpack_kernels_equal_plain(dev, carry_bits):
    rng = np.random.default_rng(carry_bits)
    vals = rng.integers(-5770, 5771, (37, 256)).astype(np.int32)
    vals[rng.random(vals.shape) < 0.5] = 0
    v2 = torch.from_numpy(vals).to(dev)
    code = torch.tensor(int(rng.integers(0, 1 << carry_bits)), device=dev)
    bits = torch.tensor(carry_bits, device=dev)
    gstart, gend = bitpack.geometry(v2, bits)
    phase = (gstart & 31).to(torch.int32)
    k2 = group_pack.group_pack_values(v2, phase, 218)
    assert torch.equal(k2.cpu(), group_pack.group_pack_values_plain(v2.cpu(), phase.cpu(), 218))
    bitpack.or_carry_lead(k2, code, bits)
    sw, ge = (gstart >> 5).to(torch.int32), gend.to(torch.int32)
    nwords = bitpack.stream_words(v2.numel(), 27)
    k3 = splice.splice(k2, sw, ge, nwords)
    assert torch.equal(k3.cpu(), splice.splice_plain(k2.cpu(), sw.cpu(), ge.cpu(), nwords))


def test_codec_on_card_equals_cpu(dev):
    """Stream bytes equal the CPU path's; pixels within 1 LSB on < 1%; every
    kernel launched."""
    clip = synthetic_video(24, 48, 72, seed=8)
    kernels.LAUNCHES.clear()
    data = encode_video(clip, device=dev)
    out = decode_video(data, 72, 48, 24, device=dev)
    assert all(kernels.LAUNCHES[k] > 0 for k in (
        "frames_to_cubes", "group_pack_values", "splice", "cubes_to_frames"))
    assert data == encode_video(clip, device="cpu")
    d = np.abs(out.astype(np.int16) - decode_video(data, 72, 48, 24, device="cpu"))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("groups,slots,dc_stride", [
    (37, 16, 512), (37, 256, 512), (300, 16, 0), (300, 4, 96), (5, 1, 64),
])
def test_compact_groups_kernel_equals_plain(dev, groups, slots, dc_stride):
    """K6, tables compared whole (both zero the padding slots), on content
    dense enough that many groups overflow 16 slots."""
    rng = np.random.default_rng(groups + slots)
    vals = np.where(rng.random((groups, 256)) < 0.1,
                    rng.integers(-5771, 5772, (groups, 256)),
                    rng.integers(-8, 8, (groups, 256))).astype(np.int32)
    v2 = torch.from_numpy(vals)
    got = exc_pack.compact_groups(v2.to(dev), slots, dc_stride)
    want = exc_pack.compact_groups_plain(v2, slots, dc_stride)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("cubes", [1, 37, 128, 300, 1023])
def test_wire_kernels_equal_plain(dev, cubes):
    """K7 and K8, including cube counts that leave edge tiles and rows that
    are not a multiple of 4 bytes."""
    plane = torch.from_numpy(
        np.random.default_rng(cubes).integers(0, 256, (cubes, 256), dtype=np.uint8))
    wire = relayout.plane_to_wire(plane.to(dev))
    assert torch.equal(wire.cpu(), relayout.plane_to_wire_plain(plane))
    back = relayout.wire_to_plane(wire)
    assert torch.equal(back.cpu(), plane)


def test_turbo_on_card_equals_cpu(dev):
    """Turbo container bytes equal the CPU path's; pixels identical to the
    card's reference-profile decode; K6, K7 and K8 launched."""
    clip = synthetic_video(24, 48, 72, seed=8)
    kernels.LAUNCHES.clear()
    data = encode_turbo_video(clip, device=dev)
    out = decode_turbo_container(data, 72, 48, device=dev)
    assert all(kernels.LAUNCHES[k] > 0 for k in (
        "frames_to_cubes", "compact_groups", "plane_to_wire", "wire_to_plane",
        "cubes_to_frames"))
    assert data == encode_turbo_video(clip, device="cpu")
    ref = decode_video(encode_video(clip, device=dev), 72, 48, 24, device=dev)
    assert np.array_equal(out, ref)
