"""The port's relayout ops (K1 frames -> cubes, K4 cubes -> frames) against
the JAX package's Pallas relayout kernels, run in interpret mode on the CPU.

The TPU kernels emit cubes in a sigma-permuted column order; the port's
contract is the natural order, so column c of the port equals column
sigma[c] of the TPU kernel's output.  On the CPU the port's wrappers run
their plain versions; the CUDA kernels are checked on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import config as j_config
from dct3d_tpu.codec import framing as j_framing
from dct3d_tpu.ops import relayout as j_relayout
from dct3d_tpu_torch.codec import framing
from dct3d_tpu_torch.config import CodecConfig
from dct3d_tpu_torch.ops import relayout

torch.set_num_threads(2)

T, H, W = 16, 64, 128  # two GOPs


@pytest.fixture(scope="module")
def frames():
    return synthetic_video(T, H, W, seed=5)


def test_frames_to_cubes_matches_pallas_perm(frames):
    cubes, sums = relayout.frames_to_cubes(torch.from_numpy(frames))
    assert cubes.dtype == torch.float32 and sums.dtype == torch.int32
    perm = np.asarray(j_relayout.frames_to_cubes_perm(jnp.asarray(frames),
                                                      interpret=True))
    sigma = j_relayout.sigma()
    np.testing.assert_array_equal(cubes.numpy(), perm[:, sigma].astype(np.float32))
    np.testing.assert_array_equal(sums.numpy(), perm.astype(np.int64).sum(1))


def test_cubes_to_frames_matches_pallas_inverse(frames):
    """K4 (clamp, truncating cast, cubes -> frames) on f32 pixels, against
    the TPU inverse relayout of the same clamped bytes in sigma order."""
    rng = np.random.default_rng(6)
    n = (T // 8) * (H // 8) * (W // 8)
    pixels = rng.uniform(-40.0, 300.0, (n, 512)).astype(np.float32)
    pixels[:, :4] = (-0.5, 0.999, 254.999, 255.0)
    got = relayout.cubes_to_frames(torch.from_numpy(pixels), H, W)
    assert got.dtype == torch.uint8 and got.shape == (T, H, W)
    natural = np.clip(pixels, 0.0, 255.0).astype(np.uint8)
    inv = j_relayout.inv_sigma()
    want = np.asarray(j_relayout.cubes_perm_to_frames(
        jnp.asarray(natural[:, inv]), height=H, width=W, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_relayout_round_trip(frames):
    cubes, _ = relayout.frames_to_cubes(torch.from_numpy(frames))
    back = relayout.cubes_to_frames(cubes, H, W)
    np.testing.assert_array_equal(back.numpy(), frames)


@pytest.mark.parametrize("shape", [(8, 16, 24), (16, 64, 128), (8, 8, 8)])
def test_framing_matches_jax(shape):
    frames = synthetic_video(*shape, seed=7)
    cfg, jcfg = CodecConfig(), j_config.CodecConfig()
    t, h, w = shape
    ours = framing.frames_to_cubes(torch.from_numpy(frames), cfg)
    want = np.asarray(j_framing.frames_to_cubes(jnp.asarray(frames), jcfg))
    np.testing.assert_array_equal(ours.numpy(), want)
    back = framing.cubes_to_frames(ours, cfg, h, w)
    np.testing.assert_array_equal(back.numpy(), frames)


@pytest.mark.parametrize("shape", [(7, 16, 16), (8, 12, 16), (8, 16, 20), (0, 16, 16)])
def test_frames_to_cubes_rejects_bad_geometry(shape):
    with pytest.raises(ValueError):
        relayout.frames_to_cubes(torch.zeros(shape, dtype=torch.uint8))


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is neither on the CPU nor on a card is refused, not
    routed to the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        relayout.frames_to_cubes(torch.zeros((8, 8, 8), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        relayout.cubes_to_frames(torch.zeros((1, 512), device="meta"), 8, 8)


def test_cubes_to_frames_rejects_bad_input():
    with pytest.raises(ValueError):
        relayout.cubes_to_frames(torch.zeros((3, 512)), 16, 16)
    with pytest.raises(ValueError):
        relayout.cubes_to_frames(torch.zeros((4, 512), dtype=torch.float64), 16, 16)
