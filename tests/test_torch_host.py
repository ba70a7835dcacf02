"""The PyTorch port's host modules against the JAX package's originals.

The port (dct3d_tpu_torch) carries its own copies of the NumPy host code it
needs, because importing dct3d_tpu loads jax; these tests pin each copy to
its original, and check that the port never imports jax.
"""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import config as j_config
from dct3d_tpu import metrics as j_metrics
from dct3d_tpu.codec import entropy as j_entropy
from dct3d_tpu.codec import transform as j_transform
from dct3d_tpu.codec import turbo as j_turbo
from dct3d_tpu.io import pad as j_pad
from dct3d_tpu.ops import dct as j_dct
from dct3d_tpu.ops import exceptions as j_exceptions
from dct3d_tpu.ops import quant as j_quant
from dct3d_tpu.ops import zigzag as j_zigzag
from dct3d_tpu.parallel import multihost as j_multihost
from dct3d_tpu_torch import config, metrics
from dct3d_tpu_torch.codec import encoder, entropy, transform, turbo
from dct3d_tpu_torch.io import pad
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
    assert turbo._FALLBACK_TYPE.items() <= j_turbo._FALLBACK_TYPE.items()
    assert turbo._REF_TYPES <= j_turbo._REF_TYPES
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
            "dct3d_tpu_torch.io.pad"} <= set(mods)
    assert len(mods) >= 23


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
