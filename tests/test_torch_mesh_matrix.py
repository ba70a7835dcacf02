"""The port's feature matrix on a device mesh: --rgb, --checkpoint-every
and --turbo --checkpoint-every compose with a mesh, in the library and on
the command line (``--device cpu --mesh GxT``), and every container and
file equals the JAX package's byte for byte.  Mirrors
tests/test_mesh_matrix.py and the CLI cases of tests/test_sharding.py.

The port's meshes repeat torch.device("cpu"); the JAX side runs on the
virtual CPU devices of tests/conftest.py.  A sharded encoder's output
equals the single-device encoder's (with the parallel DEFLATE sink, the
JAX sharded encoder's), so the port's mesh output is held to the JAX
single-device files where that is the same thing, and to the JAX mesh's
where it is not.
"""

import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import CodecConfig as JConfig
from dct3d_tpu import cli as jcli
from dct3d_tpu import encode_video as j_encode_video
from dct3d_tpu.codec import checkpoint as j_checkpoint
from dct3d_tpu.codec import rgb_codec as j_rgb_codec
from dct3d_tpu.codec import turbo as j_turbo
from dct3d_tpu.io import rawvideo
from dct3d_tpu_torch import CodecConfig, cli
from dct3d_tpu_torch.codec.checkpoint import CheckpointingEncoder
from dct3d_tpu_torch.codec.rgb_codec import decode_rgb_video, encode_rgb_video
from dct3d_tpu_torch.codec.turbo import decode_turbo_rgb_video, encode_turbo_rgb_video
from dct3d_tpu_torch.parallel.mesh import make_mesh
from dct3d_tpu_torch.parallel.sharding import ShardedEncoder

torch.set_num_threads(2)

CPU = ["--device", "cpu"]


def rgb_clip(t=16, h=64, w=64, seed=5):
    return np.stack([synthetic_video(t, h, w, seed=seed + k) for k in range(3)], axis=-1)


def cpu_mesh(gop, tile):
    return make_mesh(gop=gop, tile=tile, devices=[torch.device("cpu")] * (gop * tile))


@pytest.fixture
def mesh22():
    return cpu_mesh(2, 2)


@pytest.fixture
def mesh21():
    return cpu_mesh(2, 1)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_rgb_mesh_byte_identical(mesh22):
    clip = rgb_clip()
    got = encode_rgb_video(clip, CodecConfig(), mesh=mesh22)
    assert got == j_rgb_codec.encode_rgb_video(clip, JConfig())
    out = decode_rgb_video(got, 64, 64, device="cpu")
    assert out.shape == clip.shape


def test_rgb_mesh_with_index_byte_identical(mesh21):
    clip = rgb_clip(seed=9)
    got = encode_rgb_video(clip, CodecConfig(), index=True, mesh=mesh21)
    assert got == j_rgb_codec.encode_rgb_video(clip, JConfig(), index=True)


def test_turbo_rgb_mesh_byte_identical(mesh22):
    clip = rgb_clip(seed=7)
    got = encode_turbo_rgb_video(clip, CodecConfig(), mesh=mesh22)
    want = j_turbo.encode_turbo_rgb_video(clip, JConfig())
    assert got == want
    np.testing.assert_array_equal(
        decode_turbo_rgb_video(got, 64, 64, device="cpu"),
        decode_turbo_rgb_video(encode_turbo_rgb_video(clip, CodecConfig(), device="cpu"),
                               64, 64, device="cpu"))


def test_checkpoint_mesh_byte_identical(tmp_path, mesh22):
    """Members from the sharded encoder equal the single-device members
    when the checkpoint interval is whole mesh steps."""
    clip = synthetic_video(32, 64, 64, seed=30)
    a, b = str(tmp_path / "a.d3mh"), str(tmp_path / "b.d3mh")
    with j_checkpoint.CheckpointingEncoder(a, 64, 64, JConfig(), checkpoint_gops=2) as enc:
        enc.push(clip)
    with CheckpointingEncoder(b, 64, 64, CodecConfig(), checkpoint_gops=2,
                              mesh=mesh22) as enc:
        enc.push(clip)
    assert _read(a) == _read(b)
    assert _read(a + ".meta") == _read(b + ".meta")


def test_checkpoint_resume_across_mesh_change(tmp_path, mesh21):
    """Half on a mesh, half on one device: the JAX package's uninterrupted
    file."""
    clip = synthetic_video(32, 64, 64, seed=31)
    a, b = str(tmp_path / "a.d3mh"), str(tmp_path / "b.d3mh")
    with j_checkpoint.CheckpointingEncoder(a, 64, 64, JConfig(), checkpoint_gops=2) as enc:
        enc.push(clip)
    with CheckpointingEncoder(b, 64, 64, CodecConfig(), checkpoint_gops=2,
                              mesh=mesh21) as enc:
        enc.push(clip[:16])
    with CheckpointingEncoder(b, 64, 64, CodecConfig(), checkpoint_gops=2,
                              device="cpu") as enc:
        assert enc.frames_done == 16
        enc.push(clip[16:])
    assert _read(a) == _read(b)


def test_turbo_checkpoint_mesh_byte_identical(tmp_path, mesh21):
    clip = synthetic_video(32, 64, 64, seed=32)
    a, b = str(tmp_path / "a.d3t"), str(tmp_path / "b.d3t")
    with j_checkpoint.CheckpointingEncoder(a, 64, 64, JConfig(), checkpoint_gops=2,
                                           turbo=True) as enc:
        enc.push(clip)
    with CheckpointingEncoder(b, 64, 64, CodecConfig(), checkpoint_gops=2, turbo=True,
                              mesh=mesh21) as enc:
        enc.push(clip)
    assert _read(a) == _read(b)


def test_checkpoint_mesh_push_alignment_error(tmp_path, mesh21):
    clip = synthetic_video(8, 64, 64, seed=33)
    with CheckpointingEncoder(str(tmp_path / "x.d3mh"), 64, 64, CodecConfig(),
                              checkpoint_gops=2, mesh=mesh21) as enc:
        with pytest.raises(ValueError, match="multiple of 16"):
            enc.push(clip)


def test_checkpoint_mesh_rejects_misaligned_interval(tmp_path, mesh21):
    with pytest.raises(ValueError, match="not a multiple of"):
        CheckpointingEncoder(str(tmp_path / "x.d3mh"), 64, 64, CodecConfig(),
                             checkpoint_gops=3, mesh=mesh21)


def test_checkpoint_mesh_rejects_misaligned_resume(tmp_path, mesh21):
    """A file that stopped mid mesh step cannot resume on the mesh: the
    constructor says so."""
    clip = synthetic_video(24, 64, 64, seed=50)
    p = str(tmp_path / "v.d3mh")
    with CheckpointingEncoder(p, 64, 64, CodecConfig(), checkpoint_gops=1,
                              device="cpu") as enc:
        enc.push(clip)  # 3 GOPs: not a whole 2-GOP mesh step
    with pytest.raises(ValueError, match="resume without --mesh"):
        CheckpointingEncoder(p, 64, 64, CodecConfig(), checkpoint_gops=2, mesh=mesh21)


def test_sharded_encoder_noise_over_several_pushes(mesh21):
    """Noise pushed a step at a time (the JAX encoder climbs its budget
    ladder here; the port's buffers are worst-case): the single-device
    bytes."""
    noise = np.random.default_rng(0).integers(0, 256, (48, 64, 64), dtype=np.uint8)
    enc = ShardedEncoder(64, 64, mesh21, CodecConfig())
    chunks = [enc.push(noise[i : i + 16]) for i in range(0, 48, 16)]
    chunks.append(enc.finish())
    assert b"".join(chunks) == j_encode_video(noise, JConfig(stream_bits_per_value=6))


def test_turbo_checkpoint_mesh_resumes_at_any_gop(tmp_path, mesh21):
    """Turbo members are independent per GOP: a mesh resume from a point
    that is no whole mesh step, with an interval that is none either, takes
    whole steps on the sharded encoder and the GOP tail on one device; the
    file is the JAX package's uninterrupted one."""
    clip = synthetic_video(48, 64, 64, seed=51)
    a, b = str(tmp_path / "a.d3t"), str(tmp_path / "b.d3t")
    with j_checkpoint.CheckpointingEncoder(a, 64, 64, JConfig(), checkpoint_gops=3,
                                           turbo=True) as enc:
        enc.push(clip)
    with CheckpointingEncoder(b, 64, 64, CodecConfig(), checkpoint_gops=3, turbo=True,
                              device="cpu") as enc:
        enc.push(clip[:24])
    with CheckpointingEncoder(b, 64, 64, CodecConfig(), checkpoint_gops=3, turbo=True,
                              mesh=mesh21) as enc:
        assert enc.frames_done == 24
        enc.push(clip[24:])  # one mesh step and a GOP tail
    assert _read(a) == _read(b)


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_cli")
    gray, srgb = str(d / "g.raw"), str(d / "c.rgb")
    rawvideo.write_video(gray, synthetic_video(32, 64, 64, seed=40))
    rgb_clip(t=16, seed=41).tofile(srgb)
    return d, gray, srgb


@pytest.mark.parametrize("flags,jax_mesh", [
    (["--rgb", "--deflate-workers", "0"], False),
    (["--rgb", "--mesh", "2x2"], True),  # the parallel sink: one sync a step
    (["--checkpoint-every", "2", "--deflate-workers", "0"], False),
    (["--turbo", "--checkpoint-every", "2"], False),
    (["--mesh", "2x2", "--parity"], False),
    (["--mesh", "2x1", "--parity", "--index"], False),
    (["--mesh", "2x1"], True),  # the default container: parallel sink
    (["--turbo", "--turbo-codec", "zlib", "--mesh", "4x1"], False),
], ids=["rgb_serial", "rgb_parallel", "checkpoint", "turbo_checkpoint", "parity",
        "parity_index", "default", "turbo"])
def test_cli_mesh_matrix(sources, tmp_path, flags, jax_mesh):
    """`encode --device cpu --mesh GxT` writes the JAX CLI's file (and
    sidecars): its single-device file, or its mesh file where the parallel
    sink marks one sync a mesh step; the port decodes it with and without
    --mesh to the same pixels as the JAX file's single-device decode."""
    d, gray, srgb = sources
    src = srgb if "--rgb" in flags else gray
    port_flags = flags if "--mesh" in flags else [*flags, "--mesh", "2x1"]
    jax_flags = flags if jax_mesh else [f for f in flags if f != "--mesh"
                                        and not (f[0].isdigit() and "x" in f)]
    a, b = str(tmp_path / "j.bin"), str(tmp_path / "p.bin")
    assert jcli.main(["encode", src, a, "64", "64", *jax_flags]) == 0
    assert cli.main(["encode", src, b, "64", "64", *port_flags, *CPU]) == 0
    assert _read(a) == _read(b)
    for side in (".idx", ".meta"):
        assert (tmp_path / f"j.bin{side}").exists() == (tmp_path / f"p.bin{side}").exists()
        if (tmp_path / f"j.bin{side}").exists():
            assert _read(a + side) == _read(b + side)
    geo = ["64", "64"] + (["32"] if "--parity" in flags and "--index" not in flags else [])
    rgb = ["--rgb"] if "--rgb" in flags else []
    outs = []
    for extra in ([], ["--mesh", "2x2"]):
        out = str(tmp_path / f"d{len(extra)}.raw")
        assert cli.main(["decode", b, out, *geo, *rgb, *extra, *CPU]) == 0
        outs.append(_read(out))
    j_out = str(tmp_path / "j.raw")
    assert jcli.main(["decode", a, j_out, *geo, *rgb]) == 0
    assert outs[0] == outs[1] == _read(j_out)


def test_cli_mesh_decode_routes(sources, tmp_path, capsys):
    """--range ignores the mesh with a note; a container of several stream
    members decodes host-parallel with a note; a member whose frames do not
    fill whole mesh steps decodes on one device with a note; a raw stream
    with an .idx sidecar decodes on the mesh.  Every route writes the JAX
    CLI's single-device pixels."""
    d, gray, _ = sources
    box, j_box = str(tmp_path / "box"), str(tmp_path / "jbox")
    assert cli.main(["encode", gray, box, "64", "64", *CPU]) == 0
    assert jcli.main(["encode", gray, j_box, "64", "64"]) == 0
    want = str(tmp_path / "want.raw")
    assert jcli.main(["decode", j_box, want, "64", "64"]) == 0
    full = rawvideo.read_video(want, 64, 64)
    out = str(tmp_path / "o.raw")
    capsys.readouterr()
    assert cli.main(["decode", box, out, "64", "64", "--range", "3:21", "--mesh", "2x1",
                     *CPU]) == 0
    assert "ignoring --mesh" in capsys.readouterr().err
    np.testing.assert_array_equal(rawvideo.read_video(out, 64, 64), full[3:21])
    two = str(tmp_path / "two")
    with open(two, "wb") as f:
        f.write(_read(box) * 2)
    assert cli.main(["decode", two, out, "64", "64", "--mesh", "2x1", *CPU]) == 0
    assert "single-stream" in capsys.readouterr().err
    np.testing.assert_array_equal(rawvideo.read_video(out, 64, 64), np.concatenate([full] * 2))
    assert cli.main(["decode", box, out, "64", "64", "--mesh", "3x1", *CPU]) == 0
    assert "don't fill whole 24-frame mesh steps" in capsys.readouterr().err
    np.testing.assert_array_equal(rawvideo.read_video(out, 64, 64), full)
    raw = str(tmp_path / "raw")
    assert cli.main(["encode", gray, raw, "64", "64", "--parity", "--index", *CPU]) == 0
    assert cli.main(["decode", raw, out, "64", "64", "--mesh", "1x2", *CPU]) == 0
    np.testing.assert_array_equal(rawvideo.read_video(out, 64, 64), full)


def test_cli_mesh_too_many_devices(sources, tmp_path, capsys, monkeypatch):
    """On CUDA a mesh needs G*T cards: with one, `--mesh 2x1` exits 2 with
    the JAX CLI's message before any device work; a malformed spec exits 2
    on the CPU too."""
    _, gray, _ = sources
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cli.main(["encode", gray, str(tmp_path / "x"), "64", "64", "--mesh", "2x1"]) == 2
    assert "--mesh 2x1 needs 2 devices, found 1" in capsys.readouterr().err
    assert cli.main(["encode", gray, str(tmp_path / "x"), "64", "64", "--mesh", "0x2",
                     *CPU]) == 2
    assert "--mesh expects GxT" in capsys.readouterr().err


def test_cli_turbo_checkpoint_mesh_keeps_gop_tail(tmp_path):
    """The CLI does not step-truncate turbo checkpoint encodes on a mesh:
    56 frames = 3 mesh steps + 1 GOP tail, the JAX CLI's single-device
    container (all 7 GOPs)."""
    clip = synthetic_video(56, 64, 64, seed=52)
    src = str(tmp_path / "g.raw")
    rawvideo.write_video(src, clip)
    a, b = str(tmp_path / "a.d3t"), str(tmp_path / "b.d3t")
    assert jcli.main(["encode", src, a, "64", "64", "--turbo", "--checkpoint-every", "2"]) == 0
    assert cli.main(["encode", src, b, "64", "64", "--turbo", "--checkpoint-every", "2",
                     "--mesh", "2x1", *CPU]) == 0
    assert _read(a) == _read(b)


def test_turbo_decode_bad_mesh_exits_2(sources, tmp_path, capsys, monkeypatch):
    """R6: decoding a turbo container with a --mesh that cannot be built
    exits 2 with the mesh's message (the JAX CLI passes None on to
    TurboShardedDecoder and dies with an AttributeError), on a one-card
    machine and with a malformed spec; a buildable mesh decodes to the
    single-device pixels."""
    _, gray, _ = sources
    box = str(tmp_path / "t.d3t")
    assert cli.main(["encode", gray, box, "64", "64", "--turbo", *CPU]) == 0
    out = str(tmp_path / "o.raw")
    with pytest.raises(AttributeError):
        jcli.main(["decode", box, out, "64", "64", "--mesh", "64x1"])
    assert cli.main(["decode", box, out, "64", "64", "--mesh", "0x1", *CPU]) == 2
    assert "--mesh expects GxT" in capsys.readouterr().err
    assert cli.main(["decode", box, out, "64", "64", "--mesh", "2x2", *CPU]) == 0
    want = str(tmp_path / "w.raw")
    assert cli.main(["decode", box, want, "64", "64", *CPU]) == 0
    assert _read(out) == _read(want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    capsys.readouterr()
    assert cli.main(["decode", box, out, "64", "64", "--mesh", "2x1"]) == 2
    assert "--mesh 2x1 needs 2 devices, found 1" in capsys.readouterr().err


def test_transport_delta_mesh_warns_and_keeps_bytes(sources, tmp_path, capsys):
    """--transport-delta on a mesh: a warning, and the file without it."""
    _, gray, _ = sources
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    assert cli.main(["encode", gray, a, "64", "64", "--mesh", "2x1", *CPU]) == 0
    capsys.readouterr()
    assert cli.main(["encode", gray, b, "64", "64", "--mesh", "2x1", "--transport-delta",
                     *CPU]) == 0
    assert "ships raw frames" in capsys.readouterr().err
    assert _read(a) == _read(b)
