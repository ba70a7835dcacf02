"""The port's checkpointing encoder (codec/checkpoint.py) against the JAX
package's (the cases of tests/test_checkpoint.py).

Files and ``.meta`` sidecars are byte-equal to the JAX encoder's; a
checkpoint begun by either package resumes in the other, torn tail and
all, to the bytes of an uninterrupted JAX encode.  Runs the port's plain
versions on the CPU.
"""

import os

import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import config as j_config
from dct3d_tpu.codec import checkpoint as j_checkpoint
from dct3d_tpu_torch import (
    CheckpointingEncoder, CodecConfig, TransformContext, decode_turbo_container, psnr,
    resume_info,
)
from dct3d_tpu_torch.parallel import multihost
from dct3d_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

T, H, W = 48, 32, 32


@pytest.fixture(scope="module")
def clip():
    return synthetic_video(T, H, W, seed=20)


KINDS = {
    "reference": ({}, {"checkpoint_gops": 2}),
    "index": ({}, {"checkpoint_gops": 2, "index": True}),
    "turbo": ({"turbo_codec": "zlib"}, {"checkpoint_gops": 2, "turbo": True}),
}


def _port(path, kind, **kw):
    cfg_kw, enc_kw = KINDS[kind]
    return CheckpointingEncoder(path, W, H, CodecConfig(**cfg_kw), device="cpu",
                                **{**enc_kw, **kw})


def _jax(path, kind, **kw):
    cfg_kw, enc_kw = KINDS[kind]
    return j_checkpoint.CheckpointingEncoder(path, W, H, j_config.CodecConfig(**cfg_kw),
                                             **{**enc_kw, **kw})


def _crash(enc, clip):
    """Push clip then stop as a crash would: a torn member on disk, no
    close."""
    enc.push(clip)
    enc._f.write(b"D3MHgarbage-torn-member")
    enc._f.flush()
    enc._f.close()


@pytest.fixture(scope="module")
def uninterrupted(clip, tmp_path_factory):
    """The JAX encoder's uninterrupted file and sidecar of each kind."""
    d = tmp_path_factory.mktemp("ck")
    out = {}
    for kind in KINDS:
        p = str(d / kind)
        with _jax(p, kind) as enc:
            enc.push(clip)
        out[kind] = (open(p, "rb").read(), open(p + ".meta", "rb").read())
    return out


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_uninterrupted_equals_jax(clip, tmp_path, uninterrupted, kind):
    p = str(tmp_path / "v")
    with _port(p, kind) as enc:
        enc.push(clip)
    assert (open(p, "rb").read(), open(p + ".meta", "rb").read()) == uninterrupted[kind]
    assert resume_info(p) == j_checkpoint.resume_info(p) == (T, os.path.getsize(p))


@pytest.mark.parametrize("first,second", [("jax", "port"), ("port", "jax"), ("port", "port")])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_resume_across_packages(clip, tmp_path, uninterrupted, kind, first, second):
    """A crash after 24 frames (a torn member on disk) in one package, the
    resume in the other: the file equals the uninterrupted JAX encode."""
    p = str(tmp_path / "v")
    _crash({"jax": _jax, "port": _port}[first](p, kind), clip[:24])
    assert resume_info(p) == j_checkpoint.resume_info(p)
    assert resume_info(p)[0] == (24 if kind == "turbo" else 16)
    with {"jax": _jax, "port": _port}[second](p, kind) as enc:
        assert enc.frames_done == resume_info(p)[0]
        enc.push(clip[enc.frames_done:])
    assert (open(p, "rb").read(), open(p + ".meta", "rb").read()) == uninterrupted[kind]


def test_resumed_file_decodes(clip, tmp_path):
    p = str(tmp_path / "v")
    _crash(_port(p, "index"), clip[:32])
    with _port(p, "index") as enc:
        assert enc.frames_done == 32
        enc.push(clip[32:])
    data = open(p, "rb").read()
    assert [m[2] for m in multihost.split_members(data)] == [0, 4] * 3
    ctx = TransformContext(CodecConfig(), "cpu")
    out = multihost.decode_multihost_container(data, W, H, ctx=ctx)
    assert out.shape == clip.shape and psnr(clip, out) > 30.0
    tp = str(tmp_path / "t")
    with _port(tp, "turbo") as enc:
        enc.push(clip)
    tout = decode_turbo_container(open(tp, "rb").read(), W, H, device="cpu")
    np.testing.assert_array_equal(tout, out)


def test_resume_refuses_other_parameters(clip, tmp_path):
    """A semantic change refuses to resume, in either package, for a file
    begun by the other; effort knobs do not."""
    p = str(tmp_path / "v")
    with _jax(p, "turbo") as enc:
        enc.push(clip[:16])
    with CheckpointingEncoder(p, W, H, CodecConfig(turbo_codec="zlib", zlib_level=3,
                                                   deflate_workers=2, turbo_zstd_level=9),
                              checkpoint_gops=2, turbo=True, device="cpu") as enc:
        assert enc.frames_done == 16
        enc.push(clip[16:])
    assert decode_turbo_container(open(p, "rb").read(), W, H, device="cpu").shape == clip.shape
    for cls, cfg in ((CheckpointingEncoder, CodecConfig(quant_strength=9)),
                     (j_checkpoint.CheckpointingEncoder, j_config.CodecConfig(quant_strength=9))):
        kw = {"device": "cpu"} if cls is CheckpointingEncoder else {}
        with pytest.raises(ValueError, match="resume parameters differ"):
            cls(p, W, H, cfg, checkpoint_gops=2, turbo=True, **kw)
    meta = {"cfg": {"zlib_level": 1, "quant_strength": 5}, "width": 8}
    assert CheckpointingEncoder._semantic(meta) == \
        j_checkpoint.CheckpointingEncoder._semantic(meta)


def test_missing_file_mesh_and_device(tmp_path):
    assert resume_info(str(tmp_path / "none")) == (0, 0)
    mesh = make_mesh(2, 1, [torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="not a multiple of the mesh gop axis"):
        CheckpointingEncoder(str(tmp_path / "m"), W, H, checkpoint_gops=3, mesh=mesh)
    with pytest.raises(ValueError, match="device"):
        CheckpointingEncoder(str(tmp_path / "d"), W, H)
    with _port(str(tmp_path / "g"), "reference") as enc:
        with pytest.raises(ValueError, match="multiple"):
            enc.push(np.zeros((4, H, W), np.uint8))
