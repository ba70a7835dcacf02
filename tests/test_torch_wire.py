"""The turbo profile's kernels, K6 (exception compaction), K7 (plane ->
wire) and K8 (wire -> plane), against the JAX package's Pallas kernels.

The port's wrappers run their plain PyTorch versions on CPU tensors; the
JAX side runs the Pallas kernels in interpret mode, as the JAX package's own
tests do.  Inputs come from a numpy seed; every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dct3d_tpu.ops import exc_pack as j_exc_pack
from dct3d_tpu.ops import exceptions as j_exceptions
from dct3d_tpu.ops import relayout as j_relayout
from dct3d_tpu_torch.ops import exc_pack, exceptions, relayout

torch.set_num_threads(2)

GROUPS = 300  # not a multiple of the Pallas kernel's 256-group grid block


def _values(n: int, seed: int, frac: float = 0.03) -> np.ndarray:
    """Mostly in-nibble values, a fraction of them out to |v| <= 5771, and
    a DC-like outlier every 512 values."""
    rng = np.random.default_rng(seed)
    vals = np.where(rng.random(n) < frac, rng.integers(-5771, 5772, n),
                    rng.integers(-8, 8, n)).astype(np.int32)
    vals[::512] = 4096
    return vals


@pytest.fixture(scope="module")
def groups():
    return _values(GROUPS * 256, seed=11).reshape(GROUPS, 256)


@pytest.mark.parametrize("slots", [1, 4, 16, 256])
@pytest.mark.parametrize("dc_stride", [0, 512, 64, 96])
def test_compact_groups_equals_pallas(groups, slots, dc_stride):
    """K6's plain version against compact_groups_pallas(interpret=True):
    counts exactly, and every valid slot (s < min(count, slots)) exactly."""
    lidx, vals, counts = exc_pack.compact_groups(torch.from_numpy(groups), slots,
                                                 dc_stride)
    j_lidx, j_vals, j_counts = (np.asarray(a) for a in j_exc_pack.compact_groups_pallas(
        jnp.asarray(groups), slots, dc_stride=dc_stride, interpret=True))
    np.testing.assert_array_equal(counts.numpy(), j_counts)
    valid = np.arange(slots)[None, :] < np.minimum(j_counts, slots)[:, None]
    assert valid.any() and (slots == 256 or (j_counts > slots).any())
    np.testing.assert_array_equal(lidx.numpy()[valid], j_lidx[valid])
    np.testing.assert_array_equal(vals.numpy()[valid], j_vals[valid])
    # Padding slots are zero, as the Pallas kernel leaves them.
    assert not lidx.numpy()[~valid].any() and not vals.numpy()[~valid].any()


@pytest.mark.parametrize("n", [4096, 5000, 300 * 256 + 17])
@pytest.mark.parametrize("dc_stride", [0, 512])
def test_compact_exceptions_equals_jax(n, dc_stride):
    """compact_exceptions (pad to whole groups, K6, overflow) against the
    JAX package's kernel route, and the expanded lists against numpy."""
    vals = _values(n, seed=n)
    lidx, v, counts, ovf = exceptions.compact_exceptions(
        torch.from_numpy(vals), slots=16, dc_stride=dc_stride)
    want = j_exceptions.compact_exceptions(
        jnp.asarray(vals), slots=16, dc_stride=dc_stride, impl="pallas_interpret")
    for got, w in zip((lidx, v, counts, ovf), want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
    if not bool(ovf):
        idx, val = exceptions.expand_exceptions_np(lidx.numpy(), v.numpy(),
                                                   counts.numpy())
        mask = (vals < -8) | (vals > 7)
        if dc_stride:
            mask[::dc_stride] = False
        np.testing.assert_array_equal(idx, np.flatnonzero(mask))
        np.testing.assert_array_equal(val, vals[mask])


def test_compact_exceptions_overflow_flag():
    vals = np.full(1024, 100, np.int32)  # every value an exception
    *_, ovf = exceptions.compact_exceptions(torch.from_numpy(vals), slots=16)
    assert ovf.dtype == torch.bool and bool(ovf)
    lidx, v, counts, ovf = exceptions.compact_exceptions(torch.from_numpy(vals), slots=256)
    assert not bool(ovf) and counts.tolist() == [256] * 4
    assert lidx[0].tolist() == list(range(256)) and (v == 100).all()


@pytest.mark.parametrize("cubes", [1, 37, 128, 300])
def test_plane_to_wire_equals_pallas(cubes):
    plane = np.random.default_rng(cubes).integers(0, 256, (cubes, 256), dtype=np.uint8)
    got = relayout.plane_to_wire(torch.from_numpy(plane))
    want = np.asarray(j_relayout.plane_to_wire(jnp.asarray(plane), interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.is_contiguous() and got.shape == (256, cubes)


@pytest.mark.parametrize("cubes", [1, 37, 128, 300])
def test_wire_to_plane_equals_pallas(cubes):
    """K8 against wire_words(interpret=True) viewed as bytes (the word rows
    are the plane's bytes, little-endian) and against wire_to_plane."""
    wire = np.random.default_rng(cubes + 1).integers(0, 256, (256, cubes), dtype=np.uint8)
    got = relayout.wire_to_plane(torch.from_numpy(wire)).numpy()
    words = np.asarray(j_relayout.wire_words(jnp.asarray(wire), interpret=True))
    np.testing.assert_array_equal(got, words.astype("<i4").view(np.uint8).reshape(cubes, 256))
    np.testing.assert_array_equal(
        got, np.asarray(j_relayout.wire_to_plane(jnp.asarray(wire), interpret=True)))
    np.testing.assert_array_equal(relayout.plane_to_wire(torch.from_numpy(got)).numpy(), wire)


@pytest.mark.parametrize("call", [
    lambda: exc_pack.compact_groups(torch.zeros((4, 128), dtype=torch.int32), 16),
    lambda: exc_pack.compact_groups(torch.zeros((4, 256), dtype=torch.int64), 16),
    lambda: exc_pack.compact_groups(torch.zeros((4, 256), dtype=torch.int32), 0),
    lambda: exc_pack.compact_groups(torch.zeros((4, 256), dtype=torch.int32), 257),
    lambda: relayout.plane_to_wire(torch.zeros((4, 256), dtype=torch.int32)),
    lambda: relayout.wire_to_plane(torch.zeros((256,), dtype=torch.uint8)),
], ids=["width", "dtype", "slots0", "slots257", "k7dtype", "k8dim"])
def test_wrappers_reject_bad_input(call):
    with pytest.raises(ValueError):
        call()
