"""The port's Exp-Golomb bit pack (K2 level 1, K3 level 2, pack_values)
against the JAX package's, with exact equality throughout.

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
from dct3d_tpu.ops.group_pack import group_pack_values_pallas
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
    the words each group writes, at random phases."""
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
