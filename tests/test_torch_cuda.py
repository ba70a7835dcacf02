"""The port's CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test skips without a GPU.  On a machine with one,
run ``python -m pytest --noconftest tests/test_torch_cuda.py -q``: the
file imports neither jax nor tests/conftest.py (which does), so it runs
where only the port's dependencies are installed.  The shapes are small and
ragged (block columns that do not fill a thread block's run of 16);
chip_smoke.py covers the 1080p shapes of the main path.
"""

import struct
import zlib

import numpy as np
import pytest
import torch

from dct3d_tpu_torch import (
    CodecConfig, StreamingEncoder, TransformContext, TurboEncoder, decode_turbo_container,
    decode_video, encode_turbo_video, encode_video, kernels,
)
from dct3d_tpu_torch.codec import entropy, framing, transform, turbo
from dct3d_tpu_torch.ops import (
    bitpack, dct, deflate, exc_pack, expgolomb, group_pack, relayout, splice,
)
from dct3d_tpu_torch.parallel import multihost

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


@pytest.mark.parametrize("shape", [(8, 8, 8), (16, 24, 72), (8, 40, 264), (8, 136, 200)])
def test_relayout_bf16_kernels_equal_plain(dev, shape):
    """The bf16 forms of K1 and K4 (the bf16 profile) against their plain
    versions, byte for byte, at block columns that fill no run of 16 (200
    wide: 25); K4 over clamp and truncation edges; each under its own
    launch name."""
    t, h, w = shape
    frames = synthetic_video(t, h, w, seed=3)
    kernels.LAUNCHES.clear()
    cubes, sums = relayout.frames_to_cubes(torch.from_numpy(frames).to(dev), torch.bfloat16)
    p_cubes, p_sums = relayout.frames_to_cubes_plain(torch.from_numpy(frames), torch.bfloat16)
    assert cubes.dtype == torch.bfloat16
    assert torch.equal(cubes.cpu(), p_cubes) and torch.equal(sums.cpu(), p_sums)
    pixels = torch.from_numpy(
        np.random.default_rng(1).uniform(-30, 290, p_cubes.shape).astype(np.float32))
    pixels[:, :6] = torch.tensor([-0.5, 0.99609375, 254.0, 255.0, 256.0, 127.5])
    pixels = pixels.bfloat16()
    got = relayout.cubes_to_frames(pixels.to(dev), h, w)
    assert torch.equal(got.cpu(), relayout.cubes_to_frames_plain(pixels, h, w))
    assert kernels.LAUNCHES["frames_to_cubes_bf16"] == kernels.LAUNCHES["cubes_to_frames_bf16"] == 1
    assert not kernels.LAUNCHES["frames_to_cubes"] and not kernels.LAUNCHES["cubes_to_frames"]


@pytest.mark.parametrize("block", [8, 4], ids=["8x8x8", "4x4x4"])
def test_bf16_codec_on_card_equals_cpu(dev, block):
    """The bf16 profile on the card within chip_smoke.py's bf16 bounds: the
    stream carries the card's ints, which differ from the plain CPU bf16
    quantize's in at most 10 per million (cuBLAS sums the float32 products
    in another order, which can move a bf16 rounding); pixels within 1 LSB
    of the CPU's bf16 decode of the same stream on < 1%; at 8x8x8 the bf16
    forms of K1 and K4 run, never the float32 ones."""
    cfg = CodecConfig(compute_dtype="bfloat16", block_w=block, block_h=block, block_d=block)
    clip = synthetic_video(16, 256, 256, seed=8)
    kernels.LAUNCHES.clear()
    data = encode_video(clip, cfg, device=dev)
    out = decode_video(data, 256, 256, 16, cfg, device=dev)
    bf16_forms = kernels.LAUNCHES["frames_to_cubes_bf16"] > 0 and \
        kernels.LAUNCHES["cubes_to_frames_bf16"] > 0
    assert bf16_forms == (block == 8)
    assert not kernels.LAUNCHES["frames_to_cubes"] and not kernels.LAUNCHES["cubes_to_frames"]
    gops = torch.from_numpy(clip).split(cfg.gop_size)
    ctx, cpu = TransformContext(cfg, dev), TransformContext(cfg, "cpu")
    q = torch.cat([transform.quantize_step(f.to(dev), ctx).cpu() for f in gops])
    np.testing.assert_array_equal(_stream_ints(data, clip.size), q.reshape(-1).numpy())
    q_cpu = torch.cat([transform.quantize_step(f, cpu) for f in gops])
    assert int((q != q_cpu).sum()) <= 10e-6 * q.numel()
    d = np.abs(out.astype(np.int16) - decode_video(data, 256, 256, 16, cfg, cpu))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def _stream_bytes(total_bits: int) -> int:
    """Bytes of the stream words K3 defines: words [0, ceil(total_bits /
    32)); the words past them are unspecified."""
    return 4 * -(-total_bits // 32)


def _defined(phase, bits, w_words):
    """(g, w_words) mask of the words K2 defines and K3 reads: those that
    hold the group's bits, up to w_words."""
    nw = ((phase.to(torch.int64) + bits + 31) >> 5).clamp(max=w_words)
    return torch.arange(w_words)[None, :] < nw[:, None]


@pytest.mark.parametrize("carry_bits", range(8))
def test_bitpack_kernels_equal_plain(dev, carry_bits):
    rng = np.random.default_rng(carry_bits)
    vals = rng.integers(-5770, 5771, (37, 256)).astype(np.int32)
    vals[rng.random(vals.shape) < 0.5] = 0
    v2 = torch.from_numpy(vals).to(dev)
    code = torch.tensor(int(rng.integers(0, 1 << carry_bits)), device=dev)
    bits = torch.tensor(carry_bits, device=dev)
    gstart, gend = bitpack.geometry(v2, bits)
    assert torch.equal(group_pack.group_bits(v2).cpu(), group_pack.group_bits_plain(v2.cpu()))
    phase = (gstart & 31).to(torch.int32)
    k2 = group_pack.group_pack_values(v2, phase, 218)
    p2 = group_pack.group_pack_values_plain(v2.cpu(), phase.cpu(), 218)
    defined = _defined(phase.cpu(), (gend - gstart).cpu(), 218)
    assert torch.equal(k2.cpu()[defined], p2[defined])
    bitpack.or_carry_lead(k2, code, bits)
    sw, ge = (gstart >> 5).to(torch.int32), gend.to(torch.int32)
    nwords = bitpack.stream_words(v2.numel(), 27)
    k3 = splice.splice(k2, sw, ge, nwords)
    want = splice.splice_plain(k2.cpu(), sw.cpu(), ge.cpu(), nwords)
    n = _stream_bytes(int(ge[-1]))  # the stream words K3 defines
    assert torch.equal(k3.cpu()[:n], want[:n])


@pytest.mark.parametrize("groups", [1, 7, 9, 801])
@pytest.mark.parametrize("w_words", [218, 186, 8])
def test_group_pack_values_kernel_contract(dev, groups, w_words):
    """group_bits byte-equal to its plain version, and K2's output
    contract, at group counts that leave a partial block of eight groups:
    the words that hold a group's bits equal the plain version's (bits past
    w_words dropped alike at w_words 8), and the kernel leaves every later
    word as it found it."""
    from dct3d_tpu_torch import kernels

    rng = np.random.default_rng(groups + w_words)
    vals = rng.integers(-5770, 5771, (groups, 256)).astype(np.int32)
    vals[rng.random(vals.shape) < 0.7] = 0
    v2 = torch.from_numpy(vals)
    bits = group_pack.group_bits(v2.to(dev))
    assert torch.equal(bits.cpu(), group_pack.group_bits_plain(v2))
    phase = torch.from_numpy(rng.integers(0, 32, groups).astype(np.int32))
    out = torch.full((groups, w_words), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    kernels.launch("group_pack_values", dev, v2.to(dev), phase.to(dev), out, groups, w_words)
    torch.cuda.synchronize()
    defined = _defined(phase, bits.cpu().to(torch.int64), w_words)
    want = group_pack.group_pack_values_plain(v2, phase, w_words)
    assert torch.equal(out.cpu()[defined], want[defined])
    assert (out.cpu()[~defined] == 0x5A5A5A5A).all()


@pytest.mark.parametrize("groups,w_words", [(1, 8), (3, 258), (300, 34), (257, 186)])
def test_group_pack_codes_kernel_equals_plain(dev, groups, w_words):
    """K5's output contract on random 32-bit codes (bits above the width
    included: both versions add the fragments), widths 0..32 at every
    phase, and narrow rows that drop bits past w_words - 1: the words that
    hold a group's bits equal the plain version's, and the kernel leaves
    every later word of the row as it found it."""
    rng = np.random.default_rng(groups)
    wid = rng.integers(0, 33, (groups, 256)).astype(np.int32)
    wid[0, :33] = np.arange(33)
    code = rng.integers(0, 1 << 32, (groups, 256), dtype=np.uint64).astype(np.uint32)
    phase = (np.arange(groups) % 32).astype(np.int32)
    args = [torch.from_numpy(a) for a in (code.view(np.int32), wid, phase)]
    out = torch.full((groups, w_words), 0x5A5A5A5A, dtype=torch.int32, device=dev)
    kernels.launch("group_pack_codes", dev, *(a.to(dev) for a in args), out, groups, w_words)
    torch.cuda.synchronize()
    defined = _defined(args[2], args[1].to(torch.int64).sum(1), w_words)
    want = group_pack.group_pack_codes_plain(*args, w_words)
    assert torch.equal(out.cpu()[defined], want[defined])
    assert (out.cpu()[~defined] == 0x5A5A5A5A).all()


def _zero_tail(rng, aligned: bool):
    """Codewords whose bits end word-aligned or not, then a whole group of
    zero-width slots (the last group holds no bits)."""
    while True:
        code, width = expgolomb.codewords(torch.from_numpy(
            rng.integers(-40, 41, 302).astype(np.int32)))
        if (int(width.sum()) % 32 == 0) == aligned:
            pad = torch.zeros(300, dtype=torch.int64)
            return torch.cat([code, pad]), torch.cat([width, pad])


def _aligned_total(rng, n: int):
    """n codewords whose bits total a multiple of 32."""
    while True:
        code, width = expgolomb.codewords(torch.from_numpy(
            rng.integers(-40, 41, n).astype(np.int32)))
        if int(width.sum()) % 32 == 0:
            return code, width


def _splice_batches(case: str, rng) -> list:
    """(code, width) batches of pack_bits for the K3 contract cases."""
    def with_carry(n, bits):
        code, width = expgolomb.codewords(torch.from_numpy(
            rng.integers(-2040, 2041, n).astype(np.int32)))
        return (torch.cat([torch.tensor([int(rng.integers(0, 1 << bits))]), code]),
                torch.cat([torch.tensor([bits]), width]))
    return {
        "zero_tail_unaligned": lambda: [_zero_tail(rng, False)],
        "zero_tail_aligned": lambda: [_zero_tail(rng, True)],
        "one_group": lambda: [with_carry(200, 5)],
        "last_group_one_codeword": lambda: [with_carry(256 * 3, 3)],
        "n1_after_carries_0_7": lambda: [with_carry(1, bits) for bits in range(8)],
        "total_multiple_of_32": lambda: [_aligned_total(rng, 1000)],
    }[case]()


@pytest.mark.parametrize("case", [
    "zero_tail_unaligned", "zero_tail_aligned", "one_group", "last_group_one_codeword",
    "n1_after_carries_0_7", "total_multiple_of_32", "groups_64801"])
def test_splice_kernel_contract(dev, case):
    """K3's output contract, launched into a stream buffer pre-filled with
    0x5A5A5A5A: words [0, ceil(total_bits / 32)) equal the plain
    version's, every later word stays as it was.  Group rows come from the
    plain K5 (pack_bits' level 1) or, at 64,801 groups, from K2 on the
    card, poisoned past the words each row defines."""
    rng = np.random.default_rng(len(case))
    if case == "groups_64801":
        vals = rng.integers(-3, 4, (64_801, 256)).astype(np.int32)
        v2 = torch.from_numpy(vals).to(dev)
        gstart, gend = bitpack.geometry(v2, torch.tensor(3, device=dev))
        rows = torch.full((64_801, 218), 0x5A5A5A5A, dtype=torch.int32, device=dev)
        kernels.launch("group_pack_values", dev, v2, (gstart & 31).to(torch.int32), rows,
                       64_801, 218)
        batches = [(rows, gstart, gend, bitpack.stream_words(vals.size, 27))]
    else:
        batches = []
        for code, width in _splice_batches(case, rng):
            code2, wid2 = expgolomb.grouped(code, width)
            gbits = wid2.sum(1, dtype=torch.int64)
            gstart = torch.cumsum(gbits, 0) - gbits
            phase = (gstart & 31).to(torch.int32)
            rows = group_pack.group_pack_codes_plain(code2, wid2, phase, 258)
            rows[~_defined(phase, gbits, 258)] = 0x5A5A5A5A
            batches.append((rows.to(dev), gstart, gstart + gbits,
                            bitpack.stream_words(code.numel(), 32)))
    for rows, gstart, gend, nwords in batches:
        sw, ge = (gstart >> 5).to(torch.int32).to(dev), gend.to(torch.int32).to(dev)
        out = torch.full((nwords,), 0x5A5A5A5A, dtype=torch.int32, device=dev)
        kernels.launch("splice", dev, rows, sw, ge, out, rows.shape[0], rows.shape[1], nwords)
        torch.cuda.synchronize()
        n = _stream_bytes(int(ge[-1]))
        want = splice.splice_plain(rows.cpu(), sw.cpu(), ge.cpu(), nwords)
        got = out.cpu().view(torch.uint8)
        assert torch.equal(got[:n], want[:n])
        assert (out.cpu()[n // 4:] == 0x5A5A5A5A).all()
        if case.startswith("zero_tail"):  # the geometry the case names
            assert int(ge[-1]) == int(gstart[-1]) and rows.shape[0] == 3
            assert (int(ge[-1]) % 32 == 0) == (case == "zero_tail_aligned")
        elif case == "total_multiple_of_32":
            assert int(ge[-1]) % 32 == 0


@pytest.mark.parametrize("n", [1, 255, 256, 257, 70_001])
def test_pack_bits_kernels_equal_plain(dev, n):
    """pack_bits (K5 + K3) with a carry pseudo-codeword of 0..7 bits, on the
    card and on the CPU: stream bytes, total bits and tail byte."""
    rng = np.random.default_rng(n)
    vals = torch.from_numpy(rng.integers(-2040, 2041, n).astype(np.int32))
    for bits in range(8):
        code, width = expgolomb.codewords(vals)
        code = torch.cat([torch.tensor([int(rng.integers(0, 1 << bits))]), code])
        width = torch.cat([torch.tensor([bits]), width])
        want = bitpack.pack_bits(code, width, 23)
        got = bitpack.pack_bits(code.to(dev), width.to(dev), 23)
        n = _stream_bytes(int(want[1]))  # the stream words K3 defines
        assert torch.equal(got[0].cpu()[:n], want[0][:n])
        assert int(got[1]) == int(want[1]) and int(got[2]) == int(want[2])


def _stream_ints(data: bytes, n: int) -> np.ndarray:
    """The n quantized ints a reference-profile stream carries (the C
    decoder's nibble plane with its exceptions put back)."""
    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    plane, idx, val, _ = entropy.decode_values_planar4(raw, n)
    ints = np.stack([(plane & 0xF).astype(np.int32), (plane >> 4).astype(np.int32)], 1)
    ints = ((ints ^ 8) - 8).reshape(-1)
    ints[idx] = val
    return ints


@pytest.mark.parametrize("dims,h,w", [((4, 4, 4), 36, 36), ((4, 4, 4), 48, 64), ((8, 8, 4), 48, 72)])
def test_alternate_blocks_on_card_equal_cpu(dev, dims, h, w):
    """Alternate blocks on the card: the stream carries exactly the card's
    quantized ints, which differ from the CPU's only at rounding ties
    (common in small cubes: many coefficients are exact multiples of 1/2,
    and the two f32 matmuls round them apart); where the ints agree, the
    streams are equal.  Pixels within 1 LSB of the CPU decode on < 1%;
    36x36 at 4x4x4 packs with K5, the others with K2; K1 and K4 do not
    run."""
    cfg = CodecConfig(**dict(zip(("block_w", "block_h", "block_d"), dims)))
    clip = synthetic_video(16, h, w, seed=8)
    kernels.LAUNCHES.clear()
    data = encode_video(clip, cfg, device=dev)
    out = decode_video(data, w, h, 16, cfg, device=dev)
    k5 = h * w * cfg.gop_size % 256 != 0  # values per GOP, not whole groups
    assert kernels.LAUNCHES["splice"] > 0
    assert (kernels.LAUNCHES["group_pack_codes"] > 0) == k5
    assert (kernels.LAUNCHES["group_pack_values"] > 0) != k5
    assert (kernels.LAUNCHES["group_bits"] > 0) != k5
    assert not kernels.LAUNCHES["frames_to_cubes"] and not kernels.LAUNCHES["cubes_to_frames"]
    # GOP by GOP, as the encoder quantizes: the card's matmul may round a
    # tie otherwise for another row count.
    gops = torch.from_numpy(clip).split(cfg.gop_size)
    q = torch.cat([transform.quantize_step(f.to(dev), TransformContext(cfg, dev)).cpu()
                   for f in gops])
    np.testing.assert_array_equal(_stream_ints(data, clip.size), q.reshape(-1).numpy())
    q_cpu = torch.cat([transform.quantize_step(f, TransformContext(cfg, "cpu")) for f in gops])
    x = (framing.frames_to_cubes(torch.from_numpy(clip), cfg).double()
         @ torch.from_numpy(dct.encode_matrix(cfg, np.float64)))
    diff = q != q_cpu
    assert (((x.abs() % 1) - 0.5).abs()[diff] < 1e-3).all()
    assert (data == encode_video(clip, cfg, device="cpu")) == (not diff.any())
    d = np.abs(out.astype(np.int16) - decode_video(data, w, h, 16, cfg, device="cpu"))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_codec_on_card_equals_cpu(dev):
    """Stream bytes equal the CPU path's; pixels within 1 LSB on < 1%; every
    kernel launched."""
    clip = synthetic_video(24, 48, 72, seed=8)
    kernels.LAUNCHES.clear()
    data = encode_video(clip, device=dev)
    out = decode_video(data, 72, 48, 24, device=dev)
    assert all(kernels.LAUNCHES[k] > 0 for k in (
        "frames_to_cubes", "group_bits", "group_pack_values", "splice", "cubes_to_frames"))
    assert data == encode_video(clip, device="cpu")
    d = np.abs(out.astype(np.int16) - decode_video(data, 72, 48, 24, device="cpu"))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("groups,slots,dc_stride", [
    (37, 16, 512), (37, 256, 512), (300, 16, 0), (300, 4, 96), (5, 1, 64),
] + [(g, s, d) for g in (1, 801) for s in (1, 16, 255, 256) for d in (0, 512, 64, 96)])
def test_compact_groups_kernel_equals_plain(dev, groups, slots, dc_stride):
    """K6, tables compared whole (both zero the padding slots), on content
    dense enough that many groups overflow 16 slots; 1 and 801 groups leave
    a partial block of eight groups, at slots 1..256 and DC strides of
    none, powers of two and one that is not."""
    rng = np.random.default_rng(groups + slots)
    vals = np.where(rng.random((groups, 256)) < 0.1,
                    rng.integers(-5771, 5772, (groups, 256)),
                    rng.integers(-8, 8, (groups, 256))).astype(np.int32)
    v2 = torch.from_numpy(vals)
    got = exc_pack.compact_groups(v2.to(dev), slots, dc_stride)
    want = exc_pack.compact_groups_plain(v2, slots, dc_stride)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("entry", [
    "pack_values", "geometry", "group_pack_values", "compact_exceptions", "compact_groups",
    "group_pack_codes"])
def test_misaligned_view_raises(dev, entry):
    """group_bits, K2, K5 and K6 read their inputs with 16-byte loads: a
    contiguous view that starts 4 bytes into its storage raises ValueError
    at each entry point that reaches them, and launches nothing."""
    from dct3d_tpu_torch.ops import exceptions

    flat = torch.zeros(2 * 256 + 1, dtype=torch.int32, device=dev)[1:]
    v2 = flat.reshape(-1, 256)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    calls = {
        "pack_values": lambda: bitpack.pack_values(flat, zero, zero, 27),
        "geometry": lambda: bitpack.geometry(v2, zero),
        "group_pack_values": lambda: group_pack.group_pack_values(
            v2, torch.zeros(2, dtype=torch.int32, device=dev), 218),
        "compact_exceptions": lambda: exceptions.compact_exceptions(flat, 16, 512),
        "compact_groups": lambda: exc_pack.compact_groups(v2, 16, 512),
        "group_pack_codes": lambda: group_pack.group_pack_codes(
            v2, torch.zeros((2, 256), dtype=torch.int32, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev), 258),
    }
    kernels.LAUNCHES.clear()
    with pytest.raises(ValueError, match="16-byte"):
        calls[entry]()
    assert not any(kernels.LAUNCHES.values())


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


#: the turbo wire of `encode --turbo` on the card: its plane deflated there
TURBO_CARD = CodecConfig(turbo_codec="zlib", zlib_level=6, deflate_workers=-1)


def assert_turbo_members_match(card: bytes, cpu: bytes) -> None:
    """Member by member: the same member types and frame counts; each turbo
    member's four length-prefixed streams inflate with zlib.decompress to
    the CPU member's raw streams (the card's plane stream is valid zlib,
    not zlib's bytes); any other member equal byte for byte."""
    a, b = multihost.split_members(card), multihost.split_members(cpu)
    assert [m[::2] for m in a] == [m[::2] for m in b]
    for (_, pa, kind), (_, pb, _) in zip(a, b):
        if kind not in (turbo.MEMBER_TURBO, *turbo.MEMBER_TURBO_RGB):
            assert pa == pb
            continue
        la, lb = struct.unpack_from("<IIII", pa), struct.unpack_from("<IIII", pb)
        assert 16 + sum(la) == len(pa) and 16 + sum(lb) == len(pb)
        oa = ob = 16
        for x, y in zip(la, lb):
            assert zlib.decompress(pa[oa : oa + x]) == zlib.decompress(pb[ob : ob + y])
            oa, ob = oa + x, ob + y


def test_turbo_on_card_equals_cpu(dev):
    """Turbo container bytes equal the CPU path's; pixels identical to the
    card's reference-profile decode; K6, K7 and K8 launched.  With the
    CLI's wire (the plane deflated on the card) the members carry the CPU
    path's streams and decode to the same pixels, and DEFLATE launched."""
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
    card = encode_turbo_video(clip, TURBO_CARD, device=dev)
    assert kernels.LAUNCHES["deflate"] > 0
    assert_turbo_members_match(card, encode_turbo_video(clip, TURBO_CARD, device="cpu"))
    assert np.array_equal(decode_turbo_container(card, 72, 48, device=dev), out)


def test_turbo_parity_on_card_without_deflate_workers(dev):
    """deflate_workers=0 keeps host zlib on the card: the turbo container
    equals the CPU path's byte for byte, and DEFLATE never launches."""
    clip = synthetic_video(24, 48, 72, seed=8)
    cfg = CodecConfig(turbo_codec="zlib", zlib_level=6, deflate_workers=0)
    kernels.LAUNCHES.clear()
    enc = TurboEncoder(72, 48, cfg, device=dev)
    data = enc.push(clip) + enc.finish()
    assert data == encode_turbo_video(clip, cfg, device="cpu")
    assert not kernels.LAUNCHES["deflate"] and "deflate" not in enc.timer.calls


def test_turbo_card_deflate_counts_per_gop(dev, monkeypatch):
    """On the card one DEFLATE launch, one ``deflate`` stage (the plane's
    bytes in) and one ``deflate_out`` stage a GOP, and host zlib compresses
    three streams a member, not four; a CPU encode of the same frames
    counts no ``deflate`` stage and no launch."""
    clip = synthetic_video(32, 48, 72, seed=8)
    calls = []
    compress = zlib.compress

    def counted(data, level=-1):
        calls.append(len(data))
        return compress(data, level)

    monkeypatch.setattr(zlib, "compress", counted)
    for d, gops in ((dev, 4), ("cpu", 0)):
        kernels.LAUNCHES.clear()
        calls.clear()
        enc = TurboEncoder(72, 48, TURBO_CARD, device=d)
        data = enc.push(clip) + enc.finish()
        assert kernels.LAUNCHES["deflate"] == gops
        assert enc.timer.calls.get("deflate", 0) == enc.timer.calls.get("deflate_out", 0) == gops
        assert enc.timer.bytes.get("deflate", 0) == gops * 8 * 48 * 72 // 2
        assert len(calls) == (3 if gops else 4) * 4
        assert [m[2] for m in multihost.split_members(data)] == [turbo.MEMBER_TURBO] * 4


def test_turbo_card_members_pass_the_benchmark_reference(dev):
    """Every member the card writes reads with perfbench/reference.py (its
    own zlib ``inflate`` of each stream and ``turbo_ints``) to the ints of
    the member host zlib writes from the card's step (deflate_workers 0;
    this noisy content has rounding ties where the CPU's ints differ), on
    content with exceptions in every GOP."""
    import dataclasses

    from perfbench import reference

    rng = np.random.default_rng(17)
    clip = (synthetic_video(24, 64, 96, seed=17) ^ rng.integers(0, 64, (24, 64, 96))
            ).astype(np.uint8)
    card = multihost.split_members(encode_turbo_video(clip, TURBO_CARD, device=dev))
    host = multihost.split_members(encode_turbo_video(
        clip, dataclasses.replace(TURBO_CARD, deflate_workers=0), device=dev))
    assert [m[2] for m in card] == [turbo.MEMBER_TURBO] * 3
    for (_, p, _), (_, q, _) in zip(card, host):
        assert p[16:] != q[16:]
        got = reference.turbo_ints(p, 64 * 96 * 8 // 512, 512)
        assert torch.equal(got, reference.turbo_ints(q, 64 * 96 * 8 // 512, 512))
        assert (got[:, 1:].abs() > 7).any()  # the exception streams are not empty


def test_cli_round_trip_on_card_equals_cpu(dev, tmp_path):
    """`python -m dct3d_tpu_torch encode/decode` with default flags on the
    card: the indexed container carries the --device cpu one's payload and
    index bit ends, its DEFLATE written on the card (its sync offsets good
    for parallel_inflate), decode needs no frame count, pixels within 1 LSB
    of the CPU's on < 1%, and the main path's kernels launched."""
    from dct3d_tpu_torch import cli
    from dct3d_tpu_torch.parallel import multihost

    clip = synthetic_video(24, 48, 72, seed=8)
    src = str(tmp_path / "src.raw")
    clip.tofile(src)
    out = {}
    for d in ("cuda", "cpu"):
        kernels.LAUNCHES.clear()
        enc, dec = str(tmp_path / f"{d}.d3v"), str(tmp_path / f"{d}.raw")
        assert cli.main(["encode", src, enc, "72", "48", "--device", d]) == 0
        assert cli.main(["decode", enc, dec, "72", "48", "--device", d]) == 0
        out[d] = (open(enc, "rb").read(), np.fromfile(dec, np.uint8), dict(kernels.LAUNCHES))
    card, cpu = (multihost.split_members(out[d][0]) for d in ("cuda", "cpu"))
    assert out["cuda"][0][:4] == b"D3MH" and [m[:1] + m[2:] for m in card] == \
        [m[:1] + m[2:] for m in cpu]
    assert zlib.decompress(card[0][1]) == zlib.decompress(cpu[0][1])
    assert multihost.parse_index(card[1][1]) == multihost.parse_index(cpu[1][1])
    syncs = multihost.parse_index_syncs(card[1][1])
    assert entropy.parallel_inflate(card[0][1], syncs) == zlib.decompress(card[0][1])
    assert all(out["cuda"][2].get(k, 0) > 0 for k in (
        "frames_to_cubes", "group_bits", "group_pack_values", "splice", "cubes_to_frames",
        "deflate"))
    assert not any(out["cpu"][2].values())
    d = np.abs(out["cuda"][1].astype(np.int16) - out["cpu"][1])
    assert out["cuda"][1].size == clip.size and d.max() <= 1 and (d > 0).mean() < 0.01


def test_two_members_decoded_at_once_on_card(dev):
    """decode_multihost_container decodes the members of a two-member
    container on two threads that share one context on the card: the
    pixels equal decoding the members one by one."""
    from dct3d_tpu_torch.parallel import multihost

    ctx = TransformContext(CodecConfig(deflate_workers=2), dev)
    parts = []
    for seed in (8, 9):
        clip = synthetic_video(24, 48, 72, seed=seed)
        enc = StreamingEncoder(72, 48, ctx.cfg, ctx)
        stream = enc.push(clip) + enc.finish()
        parts.append(multihost._member(stream, 24)
                     + multihost.make_index_member(enc.gop_bit_ends, enc.gop_sync_offsets))
    data = b"".join(parts)
    together = multihost.decode_multihost_container(data, 72, 48, workers=2, ctx=ctx)
    one_by_one = np.concatenate([multihost.decode_multihost_container(p, 72, 48, ctx=ctx)
                                 for p in parts])
    np.testing.assert_array_equal(together, one_by_one)
    np.testing.assert_array_equal(
        together, multihost.decode_multihost_container(data, 72, 48, workers=1, ctx=ctx))
    cpu = multihost.decode_multihost_container(
        data, 72, 48, workers=2, ctx=TransformContext(ctx.cfg, torch.device("cpu")))
    d = np.abs(together.astype(np.int16) - cpu)
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_wrapping_uint8_cumsum_on_card(dev):
    """The transport-delta rebuild, torch.cumsum in uint8 on the card,
    wraps mod 256 exactly as numpy's uint8 cumsum does, GOP by GOP."""
    rng = np.random.default_rng(21)
    deltas = rng.integers(0, 256, (16, 40, 72), dtype=np.uint8)
    got = transform._undelta_frames(torch.from_numpy(deltas).to(dev), CodecConfig())
    want = np.concatenate([np.cumsum(deltas[g : g + 8], axis=0, dtype=np.uint8)
                           for g in (0, 8)])
    assert got.dtype == torch.uint8 and np.array_equal(got.cpu().numpy(), want)


def test_delta_and_host_encode_on_card_equal_cpu(dev):
    """transport_delta and the host encode (device_pack=False) on the card
    write the CPU path's plain stream; the delta decode on the card gives
    the card's plain decode exactly."""
    clip = synthetic_video(24, 48, 72, seed=8)
    plain = encode_video(clip, device="cpu")
    dcfg = CodecConfig(transport_delta=True)
    kernels.LAUNCHES.clear()
    assert encode_video(clip, dcfg, device=dev) == plain
    assert kernels.LAUNCHES["frames_to_cubes"] > 0 and kernels.LAUNCHES["splice"] > 0
    enc = StreamingEncoder(72, 48, device=dev, device_pack=False)
    assert enc.push(clip) + enc.finish() == plain
    assert decode_video(plain, 72, 48, 24, dcfg, device=dev).tobytes() == \
        decode_video(plain, 72, 48, 24, device=dev).tobytes()


def test_speculative_decode_on_card_equals_cpu(dev, monkeypatch):
    """decode_video with no positions (the fused speculative decode, its
    segment minimum lowered to this payload) and decode_frame_range's
    prefix skip on the card equal the indexed decode on the card; pixels
    within 1 LSB of the CPU's on < 1%."""
    monkeypatch.setattr(entropy, "_SPEC_MIN_SEG", 2048)
    clip = synthetic_video(48, 64, 96, seed=9)
    enc = StreamingEncoder(96, 64, device="cpu")
    data = enc.push(clip) + enc.finish()
    positions = [0] + enc.gop_bit_ends[:-1]
    indexed = decode_video(data, 96, 64, 48, device=dev, positions=positions)
    np.testing.assert_array_equal(decode_video(data, 96, 64, 48, device=dev), indexed)
    from dct3d_tpu_torch import decode_frame_range

    np.testing.assert_array_equal(
        decode_frame_range(data, 96, 64, 19, 41, device=dev, entropy_workers=16),
        indexed[19:41])
    d = np.abs(indexed.astype(np.int16) - decode_video(data, 96, 64, 48, device="cpu"))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


def test_rgb_and_checkpoint_on_card_equal_cpu(dev, tmp_path):
    """RGB, turbo-RGB and checkpointed containers written on the card
    equal the CPU path's bytes, and turbo-RGB ones with the plane deflated
    on the card carry its streams member by member; the RGB decodes on the
    card equal their per-channel decodes on the card."""
    from dct3d_tpu_torch import (
        CheckpointingEncoder, decode_rgb_video, decode_turbo_rgb_video, encode_rgb_video,
        encode_turbo_rgb_video,
    )

    rgb = np.stack([synthetic_video(16, 48, 72, seed=s) for s in (1, 2, 3)], axis=-1)
    cfg = CodecConfig(turbo_codec="zlib")
    box = encode_rgb_video(rgb, cfg, index=True, device=dev)
    assert box == encode_rgb_video(rgb, cfg, index=True, device="cpu")
    tbox = encode_turbo_rgb_video(rgb, cfg, device=dev)
    assert tbox == encode_turbo_rgb_video(rgb, cfg, device="cpu")
    tcard = encode_turbo_rgb_video(rgb, TURBO_CARD, device=dev)
    assert_turbo_members_match(tcard, encode_turbo_rgb_video(rgb, TURBO_CARD, device="cpu"))
    got = decode_rgb_video(box, 72, 48, cfg, device=dev)
    for c in range(3):
        np.testing.assert_array_equal(
            got[..., c], decode_video(encode_video(rgb[..., c], cfg, device="cpu"), 72, 48, 16,
                                      cfg, device=dev))
    np.testing.assert_array_equal(decode_turbo_rgb_video(tbox, 72, 48, cfg, device=dev), got)
    np.testing.assert_array_equal(decode_turbo_rgb_video(tcard, 72, 48, cfg, device=dev), got)
    files = []
    for k, d in enumerate((dev, "cpu")):
        p = str(tmp_path / f"{k}.d3v")
        with CheckpointingEncoder(p, 72, 48, cfg, checkpoint_gops=1, index=True,
                                  device=d) as ck:
            ck.push(rgb[..., 0])
        files.append(open(p, "rb").read())
    assert files[0] == files[1]


@pytest.mark.parametrize("blocks", [8, 4], ids=["8x8x8", "4x4x4"])
def test_sharded_on_card_equals_single_device(dev, blocks):
    """A (2, 3) mesh of the one card: the sharded stream (4x4x4: tile
    shards of 5 cubes a GOP, not whole groups, so K5 with the phase
    pseudo-codeword) and pixels equal one device's, and turbo's too; the
    sharded turbo encoder keeps host zlib with deflate workers (the same
    bytes), where one device deflates the plane on the card (the same
    streams)."""
    from dct3d_tpu_torch.codec import turbo
    from dct3d_tpu_torch.parallel.mesh import make_mesh
    from dct3d_tpu_torch.parallel.sharding import ShardedDecoder, ShardedEncoder

    cfg = CodecConfig(block_w=blocks, block_h=blocks, block_d=blocks, turbo_codec="zlib")
    h, w = 3 * blocks, 5 * blocks
    clip = synthetic_video(4 * cfg.gop_size, h, w, seed=8)
    mesh = make_mesh(2, 3, [dev] * 6)
    ctx = TransformContext(cfg, dev)
    enc = ShardedEncoder(w, h, mesh, cfg)
    data = enc.push(clip) + enc.finish()
    assert data == encode_video(clip, cfg, ctx)
    out = ShardedDecoder(w, h, mesh, cfg).decode(data, clip.shape[0])
    np.testing.assert_array_equal(out, decode_video(data, w, h, clip.shape[0], cfg, ctx))
    tdata = turbo.TurboShardedEncoder(w, h, mesh, cfg).push(clip)
    assert tdata == encode_turbo_video(clip, cfg, ctx)
    tcfg = CodecConfig(block_w=blocks, block_h=blocks, block_d=blocks, turbo_codec="zlib",
                       deflate_workers=-1)
    assert turbo.TurboShardedEncoder(w, h, mesh, tcfg).push(clip) == tdata
    assert_turbo_members_match(encode_turbo_video(clip, tcfg, ctx), tdata)
    np.testing.assert_array_equal(turbo.TurboShardedDecoder(w, h, mesh, cfg).decode(tdata), out)


def _deflate_input(name: str) -> np.ndarray:
    rng = np.random.default_rng(13)
    if name == "empty":
        return np.zeros(0, np.uint8)
    if name in ("one", "three"):
        return np.arange(1, 2 if name == "one" else 4, dtype=np.uint8)
    if name.startswith("run"):
        return np.full(int(name[3:]), 0xFF, np.uint8)
    if name == "far":
        half = rng.integers(0, 256, 32768, dtype=np.uint8)
        return np.concatenate([half, half, half[:1000]])
    if name == "random":
        return rng.integers(0, 256, 70_000, dtype=np.uint8)
    clip = (synthetic_video(16, 128, 512, seed=4) if name == "stream" else
            np.repeat(np.repeat(synthetic_video(16, 16, 64, seed=5) & 0xE0, 8, 1), 8, 2))
    raw = np.frombuffer(zlib.decompress(encode_video(clip, device="cpu")), np.uint8)
    return raw[: 256 * 1024]


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("name", ["empty", "one", "three", "run258", "run259", "far",
                                  "random", "stream", "blocks"])
def test_deflate_kernels_equal_plain(dev, name, level):
    """ops/deflate.py on the card equals its plain version byte for byte
    (inputs up to 256 KiB, in a buffer with a partial byte and slack after
    the GOP), with the adler32 sums, the bit count and the partial byte in
    its record; the span inflates to the input."""
    x = _deflate_input(name)
    rng = np.random.default_rng(len(x))
    buf = np.concatenate([x, rng.integers(0, 256, 64, dtype=np.uint8)])
    bits = 8 * len(x) + 5
    kernels.LAUNCHES.clear()
    out, info = deflate.deflate(torch.from_numpy(buf).to(dev),
                                torch.tensor(bits, dtype=torch.int64, device=dev), level)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["deflate"] == 1
    info = info.cpu().tolist()
    span = out[: info[deflate.I_OUT_BYTES]].cpu().numpy()
    want, s1, s2 = deflate.deflate_plain(x, level)
    assert np.array_equal(span, want)
    assert info[: deflate.I_TAIL + 1] == [bits, len(want), s1, s2, int(buf[len(x)])]
    d = zlib.decompressobj(-zlib.MAX_WBITS)
    assert d.decompress(span.tobytes()) + d.flush() == x.tobytes()


def bench_clip_1080p() -> np.ndarray:
    """Two 1080p GOPs of the bench clip: a moving gradient XOR 0-15 noise."""
    rng = np.random.default_rng(12345)
    x, y = np.arange(1920), np.arange(1080)[:, None]
    return np.stack([(rng.integers(0, 16, (1080, 1920)) ^ ((x + y + k) & 0xFF)).astype(np.uint8)
                     for k in range(16)])


def test_deflate_full_1080p_gops_round_trip(dev):
    """Two 1080p GOPs of the bench clip, as the encode step leaves them on
    the card (the second after the first's carry): each span inflates to
    its GOP's bytes, one workspace reused."""
    clip = bench_clip_1080p()
    ctx = TransformContext(CodecConfig(), dev)
    code = torch.zeros((), dtype=torch.int64, device=dev)
    carry = (code, code.clone())
    ws = None
    for g in range(2):
        step = transform.encode_step(torch.from_numpy(clip[8 * g : 8 * g + 8]).to(dev), ctx,
                                     *carry)
        carry = (step.carry_code, step.carry_bits)
        ws = ws or deflate.Workspace(step.packed.numel(), dev)
        out, info = deflate.deflate(step.packed, step.total_bits, 9, ws)
        torch.cuda.synchronize()
        n = int(step.total_bits) // 8
        span = out[: int(info[deflate.I_OUT_BYTES])].cpu().numpy().tobytes()
        raw = step.packed[:n].cpu().numpy().tobytes()
        d = zlib.decompressobj(-zlib.MAX_WBITS)
        assert d.decompress(span) + d.flush() == raw and len(span) < n // 3


def test_device_sink_container_on_card(dev, monkeypatch):
    """A StreamingEncoder container made on the card (deflate_workers -1)
    carries the payload of the card's serial-sink stream and decodes with
    decode_auto to the frames of the parallel zlib sink's container of the
    same payload, in at most 1.005 times its bytes; one DEFLATE launch and
    one ``deflate`` stage a GOP, and zlib's compressor never runs."""
    from dct3d_tpu_torch import decode_auto
    from dct3d_tpu_torch.parallel import multihost

    clip = synthetic_video(48, 96, 128, seed=6)

    def refuse(*args, **kwargs):
        raise AssertionError("zlib's compressor ran on the card's path")

    kernels.LAUNCHES.clear()
    enc = StreamingEncoder(128, 96, CodecConfig(deflate_workers=-1), device=dev)
    with monkeypatch.context() as m:
        m.setattr(zlib, "compressobj", refuse)
        m.setattr(zlib, "compress", refuse)
        stream = enc.push(clip) + enc.finish()
    assert kernels.LAUNCHES["deflate"] == 6 and enc.timer.calls["deflate"] == 6
    assert isinstance(enc.sink, entropy.DeviceDeflateSink)
    payload = zlib.decompress(stream)
    assert payload == zlib.decompress(encode_video(clip, device=dev))
    # the parallel zlib sink's stream of the same GOPs
    raw = np.frombuffer(payload + bytes(8), np.uint8)
    zsink, parts, done = entropy.ParallelDeflateSink(9, 2), [], 0
    for end in enc.gop_bit_ends:
        zsink.gop_boundary()
        parts.append(zsink.push_packed(raw[done // 8 :].copy(), end - done // 8 * 8))
        done = end
    zstream = b"".join(parts) + zsink.finish()
    zsink.close()
    assert zlib.decompress(zstream) == payload
    data = multihost._member(stream, 48) + multihost.make_index_member(
        enc.gop_bit_ends, enc.gop_sync_offsets)
    zdata = multihost._member(zstream, 48) + multihost.make_index_member(
        enc.gop_bit_ends, zsink.sync_offsets())
    assert len(data) <= 1.005 * len(zdata)
    np.testing.assert_array_equal(decode_auto(data, 128, 96, device=dev),
                                  decode_auto(zdata, 128, 96, device=dev))


def test_default_zlib_level_on_card(dev):
    """A reference encode at ``zlib_level=-1`` (zlib's default, 6) through
    the device sink writes a stream that inflates to the CPU encoder's
    payload at the same level, with the card's DEFLATE launched."""
    clip = synthetic_video(16, 48, 64, seed=9)
    cfg = CodecConfig(zlib_level=-1, deflate_workers=-1)
    kernels.LAUNCHES.clear()
    enc = StreamingEncoder(64, 48, cfg, device=dev)
    stream = enc.push(clip) + enc.finish()
    assert isinstance(enc.sink, entropy.DeviceDeflateSink)
    assert kernels.LAUNCHES["deflate"] == 2
    assert zlib.decompress(stream) == zlib.decompress(encode_video(clip, cfg, device="cpu"))


def test_staging_copies_on_card(dev):
    """fetch of card tensors equals their .cpu(), in pinned memory, with one
    ``d2h`` stage of their bytes; the reused buffer is pinned and reads
    what it is given; a zlib sink's GOP entry point on the card counts
    ``device_wait`` and ``d2h`` and writes the CPU's bytes."""
    from dct3d_tpu_torch import staging
    from dct3d_tpu_torch.profiling import StageTimer

    tensors = [torch.arange(1000, device=dev, dtype=torch.int32),
               torch.full((7, 3), 5, device=dev, dtype=torch.uint8)]
    timer = StageTimer()
    got = staging.fetch(tensors, timer)
    for g, t in zip(got, tensors):
        np.testing.assert_array_equal(g, t.cpu().numpy())
    assert timer.calls["d2h"] == 1 and timer.bytes["d2h"] == 4000 + 21
    buf = staging.HostBuffer()
    assert buf.read(tensors[0], 10).tolist() == list(range(10))
    assert buf._buf.is_pinned()
    raw = _deflate_input("stream")[:50_000]
    packed = np.concatenate([raw, np.zeros(1, np.uint8)])
    card, cpu = entropy.DeflateSink(6), entropy.DeflateSink(6)
    got = card.push_gop(torch.from_numpy(packed).to(dev),
                        torch.tensor(8 * len(raw) - 3, device=dev))
    want = cpu.push_gop(torch.from_numpy(packed), torch.tensor(8 * len(raw) - 3))
    assert got == want and card.finish() == cpu.finish()
    assert card.timer.calls["device_wait"] == card.timer.calls["d2h"] == 1
    assert not {"device_wait", "d2h"} & set(cpu.timer.calls)


def test_device_sink_counts_stages_per_gop(dev):
    """One ``deflate`` and one ``deflate_out`` stage a GOP, none on finish,
    with the GOP's bytes in and the span's bytes out; the stream inflates to
    the GOPs' bytes and the final byte."""
    raw = _deflate_input("stream")[: 96 * 1024]
    buf = np.concatenate([raw, np.zeros(8, np.uint8)])
    ends = [8 * 20000 + 3, 8 * 61000 + 6, 8 * len(raw) + 1]
    sink, spans, done = entropy.DeviceDeflateSink(6), [], 0
    for end in ends:
        a = done // 8
        got, total = sink.push_gop(torch.from_numpy(buf[a:].copy()).to(dev),
                                   torch.tensor(end - 8 * a, device=dev))
        assert total == end - 8 * a
        spans.append(got)
        done = end
    data = b"".join(spans) + sink.finish()
    sink.close()
    assert sink.timer.calls["deflate"] == 3 and sink.timer.calls["deflate_out"] == 3
    assert sink.timer.calls["sink_push"] == 3 and len(sink.sync_offsets()) == 3
    assert sink.timer.bytes["deflate"] == sum((e - d // 8 * 8) // 8 for e, d in
                                              zip(ends, [0] + ends[:-1]))
    assert sink.timer.bytes["deflate_out"] == sum(map(len, spans)) - 2  # the header is the sink's
    assert zlib.decompress(data)[: len(raw)] == raw.tobytes()
    assert entropy.parallel_inflate(data, sink.sync_offsets()) == zlib.decompress(data)


REF8_CARD = CodecConfig(zlib_level=9, deflate_workers=-1)  # the benchmark's ref8 codec


@pytest.fixture(scope="module")
def container_1080p():
    """``bench_clip_1080p`` in the indexed container the CLI's default
    encode writes on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    enc = StreamingEncoder(1920, 1080, REF8_CARD, device=torch.device("cuda"))
    stream = enc.push(bench_clip_1080p()) + enc.finish()
    return multihost._member(stream, 16) + multihost.make_index_member(
        enc.gop_bit_ends, enc.gop_sync_offsets)


def _decode_case(case: str, dev, request):
    """(decode, GOPs it lands): one decode of each kind a landing serves."""
    from dct3d_tpu_torch import decode_auto, decode_auto_range

    if case == "reference_1080p":
        data = request.getfixturevalue("container_1080p")
        return lambda: decode_auto(data, 1920, 1080, cfg=REF8_CARD, device=dev), 2
    clip = synthetic_video(24, 48, 72, seed=8)
    if case == "transport_delta":
        data = encode_video(clip, device="cpu")
        dcfg = CodecConfig(transport_delta=True)
        return lambda: decode_video(data, 72, 48, 24, dcfg, device=dev), 3
    if case == "turbo":
        data = encode_turbo_video(clip, TURBO_CARD, device=dev)
        return lambda: decode_turbo_container(data, 72, 48, TURBO_CARD, device=dev), 3
    enc = StreamingEncoder(72, 48, CodecConfig(deflate_workers=2), device=dev)
    stream = enc.push(clip) + enc.finish()
    data = multihost._member(stream, 24) + multihost.make_index_member(
        enc.gop_bit_ends, enc.gop_sync_offsets)
    return lambda: decode_auto_range(data, 72, 48, 9, 19, device=dev), 2  # GOPs 1 and 2


@pytest.mark.parametrize("case", ["reference_1080p", "transport_delta", "turbo", "seek"])
def test_direct_landing_equals_staged(dev, monkeypatch, request, case):
    """Each whole-output decode gives the same bytes when its GOPs land
    straight in the pinned output as when they go through staging copies
    (the cap forced to 0), and ``LANDED`` counts its GOPs under the route
    taken.  The delta decode also equals the plain decode."""
    from dct3d_tpu_torch import staging

    decode, gops = _decode_case(case, dev, request)
    staging.LANDED.clear()
    direct = decode()
    assert dict(staging.LANDED) == {"direct": gops}
    with monkeypatch.context() as m:
        m.setattr(staging, "LANDING_CAP", 0)
        staged = decode()
    assert dict(staging.LANDED) == {"direct": gops, "staged": gops}
    assert direct.dtype == np.uint8 and direct.tobytes() == staged.tobytes()
    if case == "transport_delta":
        clip_data = encode_video(synthetic_video(24, 48, 72, seed=8), device="cpu")
        assert direct.tobytes() == decode_video(clip_data, 72, 48, 24, device=dev).tobytes()


def test_landing_reuses_its_pinned_block_and_never_aliases(dev, container_1080p):
    """A held output stays as it was while a second decode of the same size
    runs (it lands in another block); once the first output is gone, the
    next decode lands in the block it freed."""
    from dct3d_tpu_torch import decode_auto

    ctx = TransformContext(REF8_CARD, dev)
    first = decode_auto(container_1080p, 1920, 1080, cfg=REF8_CARD, ctx=ctx)
    assert isinstance(first.base, torch.Tensor) and first.base.is_pinned()
    kept = first.copy()
    second = decode_auto(container_1080p, 1920, 1080, cfg=REF8_CARD, ctx=ctx)
    second[...] = 0
    np.testing.assert_array_equal(first, kept)
    assert not np.shares_memory(first, second)
    block = first.ctypes.data
    del first
    third = decode_auto(container_1080p, 1920, 1080, cfg=REF8_CARD, ctx=ctx)
    assert third.ctypes.data == block
    np.testing.assert_array_equal(third, kept)
