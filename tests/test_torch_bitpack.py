"""The port's Exp-Golomb bit pack (K2 and K5 level 1, K3 level 2,
pack_values and pack_bits) against the JAX package's, with exact equality
throughout.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode, and pack_values through its XLA path.  On the CPU the
port's wrappers run their plain versions; the CUDA kernels are checked on
the card by chip_smoke.py and tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct3d_tpu.ops import bitpack as j_bitpack
from dct3d_tpu.ops import expgolomb as j_expgolomb
from dct3d_tpu.ops.group_pack import GB, group_pack_pallas, group_pack_values_pallas
from dct3d_tpu_torch.ops import bitpack, expgolomb, group_pack, splice

torch.set_num_threads(2)

BOUND = 5770  # |quantized 8x8x8 coefficient| <= 255*sqrt(512): 27-bit codewords
N = 6 * 256  # values per packed batch
MAX_WIDTH = bitpack.max_codeword_bits(512)
W_WORDS = bitpack.worst_case_w_words(256, MAX_WIDTH)
OUT_BYTES = 4 * bitpack.stream_words(N, MAX_WIDTH)
RANGES = [0, 1, 7, 300, BOUND]  # max |v|: all-zero up to the codeword bound


def _values(max_abs: int, n: int = N, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed + max_abs)
    v = rng.integers(-max_abs, max_abs + 1, n).astype(np.int32)
    if max_abs:
        v[rng.random(n) < 0.05] = max_abs * rng.choice([-1, 1])
    return v


def test_constants_match_jax():
    assert MAX_WIDTH == j_bitpack.max_codeword_bits(512) == 27
    assert W_WORDS == j_bitpack.worst_case_w_words(256, 27) == 218


def test_codewords_match_numpy_twin():
    v = np.concatenate([np.arange(-BOUND, BOUND + 1),
                        [-(1 << 20), (1 << 20), -(1 << 29), (1 << 29) - 1]]).astype(np.int32)
    code, width = expgolomb.codewords(torch.from_numpy(v))
    want_code, want_width = j_expgolomb.codewords_np(v)
    np.testing.assert_array_equal(code.numpy(), want_code.astype(np.int64))
    np.testing.assert_array_equal(width.numpy(), want_width.astype(np.int64))


@functools.lru_cache(maxsize=None)
def _jax_group_pack():
    return jax.jit(functools.partial(group_pack_values_pallas, w_words=W_WORDS,
                                     interpret=True))


@pytest.mark.parametrize("max_abs", RANGES)
def test_group_pack_plain_matches_pallas(max_abs):
    """K2's plain version against the Pallas kernel (interpret mode), over
    the words each group writes, at random phases.  The plain version zeroes
    every word past those: on the card K2 defines only words [0, nw), and a
    change to either route has to keep that contract."""
    g = 4
    vals = _values(max_abs, g * 256).reshape(g, 256)
    phase = np.random.default_rng(max_abs).integers(0, 32, g).astype(np.int32)
    got = group_pack.group_pack_values(torch.from_numpy(vals),
                                       torch.from_numpy(phase), W_WORDS)
    assert got.dtype == torch.int32 and got.shape == (g, W_WORDS)
    want = np.asarray(_jax_group_pack()(jnp.asarray(vals), jnp.asarray(phase)))
    _, wid = j_expgolomb.codewords_np(vals.reshape(-1))
    gbits = wid.astype(np.int64).reshape(g, 256).sum(1)
    words = (phase + gbits + 31) >> 5  # words each group writes
    got_u = got.numpy().view(np.uint32)
    for i in range(g):
        np.testing.assert_array_equal(got_u[i, : words[i]], want[i, : words[i]])
        assert not got_u[i, words[i]:].any()


@functools.lru_cache(maxsize=None)
def _jax_packers():
    values = jax.jit(lambda v, c, b: j_bitpack.pack_values(
        v, c, b, OUT_BYTES, max_width=MAX_WIDTH))
    bits = jax.jit(lambda c, w: j_bitpack.pack_bits(
        c, w, OUT_BYTES, impl="pallas_interpret", max_width=MAX_WIDTH))
    return values, bits


@pytest.mark.parametrize("max_abs", RANGES)
@pytest.mark.parametrize("carry_bits", range(8))
def test_pack_values_matches_jax(carry_bits, max_abs):
    """pack_values' plain path against JAX pack_values (XLA) and against
    pack_bits with the Pallas splice kernel (interpret mode, carry as a
    pseudo-codeword): buf through the last partial byte, total_bits and
    tail_byte."""
    vals = _values(max_abs)
    carry_code = (0x5A >> (8 - carry_bits)) if carry_bits else 0
    buf, total, tail, overflow = bitpack.pack_values(
        torch.from_numpy(vals), torch.tensor(carry_code), torch.tensor(carry_bits),
        max_width=MAX_WIDTH)
    assert not overflow and buf.dtype == torch.uint8
    total, tail = int(total), int(tail)
    nbytes = -(-total // 8)
    assert not buf[nbytes:].any()

    pack_values_j, pack_bits_j = _jax_packers()
    jbuf, jtotal, jtail, jovf = pack_values_j(
        jnp.asarray(vals), jnp.uint32(carry_code), jnp.int32(carry_bits))
    assert (total, tail, bool(jovf)) == (int(jtotal), int(jtail), False)
    np.testing.assert_array_equal(buf.numpy()[:nbytes], np.asarray(jbuf)[:nbytes])

    code, width = j_expgolomb.codewords_np(vals)
    code = np.concatenate([[np.uint32(carry_code)], code])
    width = np.concatenate([[np.int32(carry_bits)], width.astype(np.int32)])
    pbuf, ptotal, ptail, _ = pack_bits_j(code, width)
    assert (total, tail) == (int(ptotal), int(ptail))
    np.testing.assert_array_equal(buf.numpy()[:nbytes], np.asarray(pbuf)[:nbytes])


def test_splice_plain_places_groups_at_start_words():
    """K3's plain version ORs the boundary word two groups share and keeps
    each group's interior words (hand-built two-group stream)."""
    rows = torch.zeros((2, 4), dtype=torch.int32)
    rows[0, :2] = torch.tensor([0x7FFFFFFF, -0x10000000])  # bits 1..35
    rows[1, :2] = torch.tensor([0x0FFFFFFF, 0x00000000])   # bits 36..63
    out = splice.splice(rows, torch.tensor([0, 1], dtype=torch.int32),
                        torch.tensor([36, 64], dtype=torch.int32), 3)
    want = bytes.fromhex("7fffffff" "ffffffff" "00000000")
    assert out.numpy().tobytes() == want


@pytest.mark.parametrize("n", [0, 100, 257])
def test_pack_values_rejects_partial_groups(n):
    with pytest.raises(ValueError):
        bitpack.pack_values(torch.zeros(n, dtype=torch.int32),
                            torch.tensor(0), torch.tensor(0))


def _codes(seed: int, g: int, max_wid: int = 27):
    """K5 inputs as the JAX test of group_pack_pallas builds them: narrow
    widths with 2% wide codewords, trailing zero-width pad slots in the last
    group, random phases.  Codes are random 32-bit words (bits above the
    width included, which the kernels add as the TPU kernel does) or, with
    masked=True below, real payloads."""
    rng = np.random.default_rng(seed)
    wid = rng.integers(1, 5, (g, 256)).astype(np.int32)
    hot = rng.random((g, 256)) < 0.02
    wid[hot] = rng.integers(15, max_wid + 1, hot.sum())
    wid[-1, 100:] = 0
    code = rng.integers(0, 1 << 32, (g, 256), dtype=np.uint64).astype(np.uint32)
    code[wid == 0] = 0
    phase = rng.integers(0, 32, g).astype(np.int32)
    return code, wid, phase


def _k5(code, wid, phase, w_words):
    return group_pack.group_pack_codes(
        torch.from_numpy(code.view(np.int32)), torch.from_numpy(wid),
        torch.from_numpy(phase), w_words).numpy().view(np.uint32)


@pytest.mark.parametrize("masked", [False, True], ids=["raw", "masked"])
def test_group_pack_codes_plain_matches_pallas(masked):
    """K5's plain version against the Pallas kernel in interpret mode at
    w_words 34 (the JAX package's budget width), GB + 3 groups."""
    code, wid, phase = _codes(1, GB + 3)
    if masked:
        code &= ((np.uint64(1) << wid.astype(np.uint64)) - np.uint64(1)).astype(np.uint32)
    want = np.asarray(jax.jit(functools.partial(group_pack_pallas, w_words=34,
                                                interpret=True))(
        jnp.asarray(code), jnp.asarray(wid), jnp.asarray(phase)))
    np.testing.assert_array_equal(_k5(code, wid, phase, 34), want)


@pytest.mark.parametrize("max_wid", [27, 32])
def test_group_pack_codes_plain_matches_einsum_worst_case(max_wid):
    """K5's plain version against the JAX einsum at the worst-case width,
    where the JAX package never runs its Pallas kernel; 32-bit fields at
    every phase included."""
    code, wid, phase = _codes(2, GB + 3, max_wid)
    wid[0, :33] = np.arange(33)  # widths 0..32 back to back
    phase[:32] = np.arange(32)
    code[wid == 0] = 0
    w_words = bitpack.worst_case_w_words(256, max_wid)
    want = np.asarray(jax.jit(j_bitpack._group_pack_einsum, static_argnums=3)(
        code, wid, phase, w_words))
    np.testing.assert_array_equal(_k5(code, wid, phase, w_words), want)


@functools.lru_cache(maxsize=None)
def _jax_pack_bits(impl: str, out_bytes: int):
    return jax.jit(lambda c, w: j_bitpack.pack_bits(c, w, out_bytes, impl=impl))


def _check_pack_bits(code: np.ndarray, width: np.ndarray, out_bytes=None) -> int:
    """The port's pack_bits (plain route) against JAX pack_bits (XLA level
    2 and the Pallas splice in interpret mode, into out_bytes, by default
    the stream's bytes + 8) and pack_bits_np: bytes through the last
    partial byte, total bits, tail byte; the plain route zeroes past the
    stream.  Returns total_bits."""
    buf, total, tail, overflow = bitpack.pack_bits(
        torch.from_numpy(code.astype(np.int64)), torch.from_numpy(width), 32)
    total, tail = int(total), int(tail)
    nbytes = -(-total // 8)
    assert not overflow and not buf[nbytes:].any()
    ref, ref_bits = j_bitpack.pack_bits_np(code, width)
    assert total == ref_bits and tail == int(ref[-1])
    assert buf.numpy()[:nbytes].tobytes() == ref.tobytes()
    for impl in ("xla", "pallas_interpret"):
        jbuf, jtotal, jtail, jovf = _jax_pack_bits(impl, out_bytes or nbytes + 8)(code, width)
        assert (int(jtotal), int(jtail), bool(jovf)) == (total, tail, False)
        np.testing.assert_array_equal(np.asarray(jbuf)[:nbytes], ref)
    return total


def _with_carry(vals: np.ndarray, carry_bits: int, carry_code: int):
    code, width = j_expgolomb.codewords_np(vals.astype(np.int32))
    return (np.concatenate([[np.uint32(carry_code)], code]),
            np.concatenate([[np.int32(carry_bits)], width.astype(np.int32)]))


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 257, 4099, 70_001])
def test_pack_bits_matches_jax_and_numpy(n):
    """pack_bits with a carry pseudo-codeword of 0..7 bits against JAX
    pack_bits (XLA level 2 and the Pallas splice in interpret mode) and
    pack_bits_np: bytes through the last partial byte, total bits, tail
    byte, zeros past the stream."""
    rng = np.random.default_rng(n)
    vals = rng.integers(-5771, 5772, n).astype(np.int32)
    carry_bits = n % 8
    carry_code = int(rng.integers(0, 1 << carry_bits)) if carry_bits else 0
    _check_pack_bits(*_with_carry(vals, carry_bits, carry_code))


def _edge_batch(case: str):
    """(code, width) of pack_bits at the level-2 edge geometries: a whole
    trailing group of zero-width slots after codewords that end at an
    unaligned or a word-aligned bit; one codeword after a carry of 0..7
    bits; a total bit count that is a multiple of 32."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("n1_carry"):
        bits = int(case[-1])
        return _with_carry(rng.integers(-300, 301, 1), bits, int(rng.integers(0, 1 << bits)))
    while True:
        vals = rng.integers(-40, 41, 302 if case.startswith("zero_tail") else 1000)
        code, width = _with_carry(vals, 0, 0)
        if (int(width.sum()) % 32 == 0) == (case != "zero_tail_unaligned"):
            break
    if case.startswith("zero_tail"):
        pad = np.zeros(300, np.int32)  # slots 603..  fill group 2 whole
        return np.concatenate([code, pad.view(np.uint32)]), np.concatenate([width, pad])
    return code, width


EDGE_CASES = (["zero_tail_unaligned", "zero_tail_aligned", "total_multiple_of_32"]
              + [f"n1_carry{b}" for b in range(8)])


@pytest.mark.parametrize("case", EDGE_CASES)
def test_pack_bits_edge_geometries_match_jax(case):
    """The edge geometries of level 2 (K3's owner-writes splice leans on
    them): pack_bits against JAX pack_bits (XLA and the Pallas splice in
    interpret mode) and pack_bits_np over the stream bytes."""
    code, width = _edge_batch(case)
    total = _check_pack_bits(code, width, out_bytes=64 if case.startswith("n1") else None)
    if case.startswith("zero_tail"):
        assert code.size > 512 and not width[512:].any()  # group 2 holds no bits
        assert (total % 32 == 0) == (case == "zero_tail_aligned")
    elif case == "total_multiple_of_32":
        assert total % 32 == 0


@pytest.mark.parametrize("carry_bits", [0, 2, 4, 6])
def test_pack_values_total_multiple_of_32_matches_jax(carry_bits):
    """pack_values at a total bit count (carry included) that is a
    multiple of 32, so the stream ends at a word boundary: against JAX
    pack_values and pack_bits with the Pallas splice (interpret mode), over
    the stream bytes, total_bits and tail_byte."""
    vals = _values(7, seed=carry_bits)
    _, width = j_expgolomb.codewords_np(vals)
    # Turning a 0 into a 1 adds 2 bits; widths are odd, so the sum is even.
    zeros = np.flatnonzero(vals == 0)
    need = ((-carry_bits - int(width.astype(np.int64).sum())) % 32) // 2
    assert zeros.size >= need
    vals[zeros[:need]] = 1
    carry_code = (0x5A >> (8 - carry_bits)) if carry_bits else 0
    buf, total, tail, _ = bitpack.pack_values(
        torch.from_numpy(vals), torch.tensor(carry_code), torch.tensor(carry_bits),
        max_width=MAX_WIDTH)
    total, tail = int(total), int(tail)
    assert total % 32 == 0
    nbytes = total // 8
    pack_values_j, pack_bits_j = _jax_packers()
    jbuf, jtotal, jtail, _ = pack_values_j(
        jnp.asarray(vals), jnp.uint32(carry_code), jnp.int32(carry_bits))
    assert (total, tail) == (int(jtotal), int(jtail))
    np.testing.assert_array_equal(buf.numpy()[:nbytes], np.asarray(jbuf)[:nbytes])
    pbuf, ptotal, ptail, _ = pack_bits_j(*_with_carry(vals, carry_bits, carry_code))
    assert (total, tail) == (int(ptotal), int(ptail))
    np.testing.assert_array_equal(buf.numpy()[:nbytes], np.asarray(pbuf)[:nbytes])


@pytest.mark.parametrize("carry_bits", [0, 3, 7])
def test_pack_values_equals_pack_bits_on_whole_groups(carry_bits):
    """pack_values (carry as a bit offset, K2) and pack_bits (carry as a
    pseudo-codeword, K5) give the same stream on whole groups."""
    rng = np.random.default_rng(carry_bits)
    vals = rng.integers(-2000, 2000, 1536).astype(np.int32)
    carry_code = int(rng.integers(0, 1 << carry_bits)) if carry_bits else 0
    code, width = expgolomb.codewords(torch.from_numpy(vals))
    a = bitpack.pack_values(torch.from_numpy(vals), torch.tensor(carry_code),
                            torch.tensor(carry_bits), MAX_WIDTH)
    b = bitpack.pack_bits(torch.cat([torch.tensor([carry_code]), code]),
                          torch.cat([torch.tensor([carry_bits]), width]), MAX_WIDTH)
    assert int(a[1]) == int(b[1]) and int(a[2]) == int(b[2])
    nbytes = -(-int(a[1]) // 8)
    assert torch.equal(a[0][:nbytes], b[0][:nbytes])


def test_pack_bits_empty_and_limits():
    """n == 0 gives the JAX function's zeros; widths over 32 bits and
    batches that could pass 2^31 bits are refused."""
    buf, total, tail, overflow = bitpack.pack_bits(
        torch.zeros(0, dtype=torch.int64), torch.zeros(0, dtype=torch.int64))
    assert not buf.any() and int(total) == 0 and int(tail) == 0 and not overflow
    one = torch.ones(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="max_width"):
        bitpack.pack_bits(one, one, max_width=33)
    with pytest.raises(ValueError, match="2\\^31"):
        bitpack.pack_bits(one.expand(1 << 26), one.expand(1 << 26), max_width=32)


def test_group_pack_codes_rejects_bad_shapes():
    g = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError, match="256"):
        group_pack.group_pack_codes(g, g[:1], torch.zeros(2, dtype=torch.int32), 8)
    with pytest.raises(ValueError, match="phases"):
        group_pack.group_pack_codes(g, g, torch.zeros(3, dtype=torch.int32), 8)


@pytest.mark.parametrize("max_abs", RANGES)
@pytest.mark.parametrize("carry_bits", range(8))
def test_group_bits_matches_jax_geometry(carry_bits, max_abs):
    """group_bits' plain route against gbits of the JAX package's
    _geometry, and geometry's int64 start and end bits against its gstart
    and gstart + gbits after a carry of carry_bits bits."""
    vals = _values(max_abs).reshape(-1, 256)
    got = group_pack.group_bits(torch.from_numpy(vals))
    assert got.dtype == torch.int32 and got.shape == (vals.shape[0],)
    _, wid = j_expgolomb.codewords_np(vals.reshape(-1))
    gbits, gstart, total, *_ = j_bitpack._geometry(
        jnp.asarray(wid.astype(np.int32).reshape(vals.shape)), jnp.int32(carry_bits), W_WORDS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(gbits))
    start, end = bitpack.geometry(torch.from_numpy(vals), torch.tensor(carry_bits))
    assert start.dtype == end.dtype == torch.int64
    np.testing.assert_array_equal(start.numpy(), np.asarray(gstart))
    np.testing.assert_array_equal(end.numpy(), np.asarray(gstart) + np.asarray(gbits))
    assert int(end[-1]) == int(total)


def test_geometry_takes_group_bits_kernel_off_the_cpu(monkeypatch):
    """For a tensor that is not on the CPU (meta here), geometry and
    pack_values' level 1 take the kernel route and never the plain
    versions.  kernels.launch is replaced by a recorder and the CUDA
    checks are dropped, so that the kernel route runs on meta tensors."""
    from dct3d_tpu_torch import kernels

    calls = []
    monkeypatch.setattr(kernels, "launch", lambda name, *a: calls.append(name))
    monkeypatch.setattr(kernels, "check_cuda", lambda *a: None)
    monkeypatch.setattr(kernels, "check_aligned16", lambda *a: None)
    for name in ("group_bits_plain", "group_pack_values_plain"):
        monkeypatch.setattr(group_pack, name, lambda *a: pytest.fail("plain route"))
    v2 = torch.empty((3, 256), dtype=torch.int32, device="meta")
    start, end = bitpack.geometry(v2, torch.zeros((), dtype=torch.int64, device="meta"))
    assert calls == ["group_bits"] and start.dtype == torch.int64
    group_pack.group_pack_values(v2, torch.empty(3, dtype=torch.int32, device="meta"),
                                 W_WORDS)
    assert calls == ["group_bits", "group_pack_values"]


@pytest.mark.parametrize("route", ["geometry", "pack_values", "pack_bits"])
def test_cpu_tensors_never_launch(monkeypatch, route):
    """CPU tensors take the plain versions: kernels.launch is never
    reached."""
    from dct3d_tpu_torch import kernels

    monkeypatch.setattr(kernels, "launch", lambda *a: pytest.fail("launched"))
    vals = torch.from_numpy(_values(300))
    zero = torch.tensor(0)
    if route == "geometry":
        bitpack.geometry(vals.reshape(-1, 256), zero)
    elif route == "pack_values":
        bitpack.pack_values(vals, torch.tensor(3), torch.tensor(2), MAX_WIDTH)
    else:
        bitpack.pack_bits(*expgolomb.codewords(vals[:1000]), MAX_WIDTH)


def test_group_bits_rejects_bad_shapes():
    with pytest.raises(ValueError, match="256"):
        group_pack.group_bits(torch.zeros((2, 255), dtype=torch.int32))
    with pytest.raises(ValueError, match="256"):
        group_pack.group_bits(torch.zeros((0, 256), dtype=torch.int32))
