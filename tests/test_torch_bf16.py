"""The port's bf16 profile (``compute_dtype="bfloat16"``) against the JAX
package's, on the CPU.

The JAX package rounds bfloat16 at fixed places: each matmul returns
bfloat16, the encode's bias add and the decode's sum of the two halves
run in bfloat16.  The port rounds at the same places, so at these sizes
every tensor, stream, container and pixel below is byte-equal to the JAX
package's (the tolerance is equality; the two CPU backends' float32
accumulations gave the same bfloat16 products on every input here).  Two
tests pin the routes that do not: rounding in float32 after an upcast, and
summing the decode's halves in float32.  Runs the port's plain versions
on the CPU; the cards' kernels are held to them in tests/test_torch_cuda.py
and chip_smoke.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import synthetic_video
from dct3d_tpu import cli as jcli
from dct3d_tpu import config as j_config
from dct3d_tpu.codec import decoder as j_decoder
from dct3d_tpu.codec import encoder as j_encoder
from dct3d_tpu.codec import rgb_codec as j_rgb_codec
from dct3d_tpu.codec import transform as j_transform
from dct3d_tpu.codec import turbo as j_turbo
from dct3d_tpu.parallel import mesh as j_mesh
from dct3d_tpu.parallel.sharding import ShardedEncoder as JShardedEncoder
from dct3d_tpu_torch import (
    CheckpointingEncoder, CodecConfig, StreamingEncoder, TransformContext,
    decode_rgb_video, decode_turbo_container, decode_video, encode_rgb_video,
    encode_turbo_video, encode_video, pad_frames, psnr,
)
from dct3d_tpu_torch import cli
from dct3d_tpu_torch.codec import transform
from dct3d_tpu_torch.parallel import multihost
from dct3d_tpu_torch.parallel.mesh import make_mesh
from dct3d_tpu_torch.parallel.sharding import ShardedDecoder, ShardedEncoder

torch.set_num_threads(2)

BF16 = {"compute_dtype": "bfloat16"}
MATRICES = ("enc_t", "enc_t_pair", "dec_me", "dec_mo")
BLOCKS = {"8x8x8": (8, 8, 8), "4x4x4": (4, 4, 4), "8x8x4": (8, 8, 4)}


def _blocks(name):
    return dict(zip(("block_w", "block_h", "block_d"), BLOCKS[name]))


def _cfgs(**kw):
    """(port, JAX) configs of the bf16 profile."""
    return CodecConfig(**BF16, **kw), j_config.CodecConfig(**BF16, **kw)


def _noise(t, h, w, seed=11):
    return np.random.default_rng(seed).integers(0, 256, (t, h, w), dtype=np.uint8)


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_context_matrices_equal_jax(block):
    """The port casts its float64 matrices to bfloat16 once; each equals
    the JAX context's (an ml_dtypes cast), value for value."""
    cfg, jcfg = _cfgs(**_blocks(block))
    ctx, jctx = TransformContext(cfg, "cpu"), j_transform.TransformContext(jcfg)
    for k in MATRICES:
        assert getattr(ctx, k).dtype == torch.bfloat16
        np.testing.assert_array_equal(getattr(ctx, k).float().numpy(),
                                      np.asarray(getattr(jctx, k)).astype(np.float32))
    arrays = {k: np.asarray(getattr(jctx, k)) for k in MATRICES}
    from_jax = TransformContext.from_numpy(arrays, cfg, "cpu")
    assert all(torch.equal(getattr(from_jax, k), getattr(ctx, k)) for k in MATRICES)


@pytest.mark.parametrize("bias", [0.5, 0.3])
def test_quantize_equals_jax(bias):
    """quantize_step's ints equal the JAX package's bf16 ints, on noise and
    on the suite's clip, with the reference rounding and a deadzone."""
    cfg, jcfg = _cfgs(quant_bias=bias)
    ctx, jctx = TransformContext(cfg, "cpu"), j_transform.TransformContext(jcfg)
    for frames in (_noise(8, 128, 128), synthetic_video(16, 64, 64)):
        q = transform.quantize_step(torch.from_numpy(frames), ctx).numpy()
        want = np.asarray(j_transform.quantize_step(jnp.asarray(frames), jctx.enc_t, cfg=jcfg))
        np.testing.assert_array_equal(q, want)


def test_reduced_precision_reduction_raises():
    """A bf16 context turns cuBLAS's bf16 split-K reduction off
    process-wide; turned back on, the next matmul of the profile raises,
    as a lowered float32 precision does for the f32 profile."""
    ctx = TransformContext(CodecConfig(**BF16), "cpu")
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    frames = torch.from_numpy(synthetic_video(8, 16, 16))
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        with pytest.raises(RuntimeError, match="reduced-precision"):
            transform.quantize_step(frames, ctx)
        with pytest.raises(RuntimeError, match="reduced-precision"):
            transform._dequant_matmul(torch.zeros((1, 256), dtype=torch.int32),
                                      torch.zeros((1, 256), dtype=torch.int32),
                                      ctx.dec_me, ctx.dec_mo)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    assert transform.quantize_step(frames, ctx).shape == (4, 512)


def test_round_in_bf16_not_after_an_upcast():
    """The bias add rounds to bfloat16 (jnp.dot of two bf16 arrays returns
    bf16, and the add stays in it): rounding in float32 after an upcast of
    the same products gives other ints on the same input."""
    cfg = CodecConfig(**BF16)
    ctx = TransformContext(cfg, "cpu")
    frames = torch.from_numpy(_noise(8, 128, 128))
    cubes, _ = transform._cubes_and_sums(frames, cfg)
    scaled = (cubes @ ctx.enc_t).float()
    upcast = torch.trunc(scaled + torch.copysign(torch.tensor(0.5), scaled)).to(torch.int32)
    q = transform.quantize_step(frames, ctx)
    differ = (upcast[:, 1:] != q[:, 1:]).sum()
    assert 0 < int(differ) < q.numel() // 100


def test_dequant_matmul_equals_jax():
    """Two bf16 products, each rounded to bf16, then a bf16 add: equal to
    the JAX package's _dequant_matmul; one float32 sum of both halves,
    rounded once, differs."""
    cfg, jcfg = _cfgs()
    ctx, jctx = TransformContext(cfg, "cpu"), j_transform.TransformContext(jcfg)
    rng = np.random.default_rng(5)
    ce, co = (rng.integers(-8, 8, (192, 256)).astype(np.int32) for _ in range(2))
    ce[:, 0] = rng.integers(0, 5772, 192)  # DC: above 256 its bf16 cast rounds
    ce[rng.random(ce.shape) < 0.02] = rng.integers(-600, 600)
    got = transform._dequant_matmul(torch.from_numpy(ce), torch.from_numpy(co),
                                    ctx.dec_me, ctx.dec_mo)
    want = j_transform._dequant_matmul(jnp.asarray(ce), jnp.asarray(co), jctx.dec_me,
                                       jctx.dec_mo)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    fused = (torch.from_numpy(ce).float() @ ctx.dec_me.float()
             + torch.from_numpy(co).float() @ ctx.dec_mo.float()).bfloat16()
    assert not torch.equal(fused, got)


#: geometry -> (frames, height, width, blocks); "4x4x4_partial" pads 26x42
#: to 28x44: 77 cubes a GOP, 19.25 groups of 256 values (pack_bits, K5)
STREAMS = {"8x8x8": (24, 64, 64, "8x8x8"), "4x4x4": (16, 48, 64, "4x4x4"),
           "4x4x4_partial": (16, 26, 42, "4x4x4")}


def _clip(geometry, seed=9):
    t, h, w, _ = STREAMS[geometry]
    clip = synthetic_video(t, h, w, seed=seed)
    return pad_frames(clip, 4, 4) if geometry.endswith("partial") else clip


@pytest.mark.parametrize("workers", [0, 2])
@pytest.mark.parametrize("geometry", sorted(STREAMS))
def test_streams_and_pixels_equal_jax(geometry, workers):
    """encode_video's bf16 stream equals the JAX package's, in both sinks,
    and decodes to the JAX package's bf16 pixels."""
    clip = _clip(geometry)
    t, h, w = clip.shape
    cfg, jcfg = _cfgs(deflate_workers=workers, **_blocks(STREAMS[geometry][3]))
    data = encode_video(clip, cfg, device="cpu")
    assert data == j_encoder.encode_video(clip, jcfg)
    np.testing.assert_array_equal(decode_video(data, w, h, t, cfg, device="cpu"),
                                  j_decoder.decode_video(data, w, h, t, jcfg))


def test_bf16_stream_decodes_with_f32_within_0_7_db():
    """The bf16 stream stays reference-decodable: the float32 decoder's
    pixels lie within 0.7 dB of the float32 stream's PSNR
    (tests/test_pipeline.py:308), as do the bf16 decoder's."""
    clip = synthetic_video(16, 64, 64)
    data = encode_video(clip, CodecConfig(**BF16), device="cpu")
    f32 = psnr(clip, decode_video(encode_video(clip, device="cpu"), 64, 64, 16, device="cpu"))
    for cfg in (CodecConfig(), CodecConfig(**BF16)):
        assert f32 - psnr(clip, decode_video(data, 64, 64, 16, cfg, device="cpu")) < 0.7


@pytest.mark.parametrize("codec", ["zlib", "zstd"])
def test_turbo_containers_equal_jax(codec):
    """Turbo containers in bf16 equal the JAX package's byte for byte, and
    decode to the bf16 reference profile's pixels, in both packages."""
    if codec == "zstd":
        pytest.importorskip("zstandard")
    clip = synthetic_video(24, 64, 64, seed=9)
    cfg, jcfg = _cfgs(turbo_codec=codec)
    ctx = TransformContext(cfg, "cpu")
    data = encode_turbo_video(clip, cfg, ctx)
    assert data == j_turbo.encode_turbo_video(clip, jcfg)
    ref = decode_video(encode_video(clip, cfg, ctx), 64, 64, 24, cfg, ctx)
    np.testing.assert_array_equal(decode_turbo_container(data, 64, 64, cfg, ctx), ref)
    np.testing.assert_array_equal(j_turbo.decode_turbo_container(data, 64, 64, jcfg), ref)


def test_transport_delta_and_host_encode():
    """In bf16 the delta wire leaves the stream as it is, and so does the
    host Exp-Golomb encode (device_pack=False); both equal the JAX
    package's routes byte for byte, and the delta decode its pixels."""
    clip = synthetic_video(24, 64, 64, seed=3)
    cfg, jcfg = _cfgs()
    plain = encode_video(clip, cfg, device="cpu")
    dcfg, jdcfg = _cfgs(transport_delta=True)
    enc = StreamingEncoder(64, 64, dcfg, device="cpu")
    delta = enc.push(clip) + enc.finish()
    assert delta == plain == j_encoder.encode_video(clip, jdcfg)
    np.testing.assert_array_equal(decode_video(delta, 64, 64, 24, dcfg, device="cpu"),
                                  j_decoder.decode_video(delta, 64, 64, 24, jdcfg))
    enc = StreamingEncoder(64, 64, cfg, device="cpu", device_pack=False)
    host = enc.push(clip) + enc.finish()
    jenc = j_encoder.StreamingEncoder(64, 64, jcfg, device_pack=False)
    assert host == plain == jenc.push(clip) + jenc.finish()


def test_mesh_stream_equals_single_device():
    """A (2, 3) CPU mesh in bf16 (each tile shard quantizes a third of a
    GOP's rows) writes the single device's stream, which is the JAX
    package's sharded stream, and decodes to the single device's pixels."""
    clip = synthetic_video(32, 48, 64, seed=4)
    cfg, jcfg = _cfgs()
    mesh = make_mesh(gop=2, tile=3, devices=[torch.device("cpu")] * 6)
    enc = ShardedEncoder(64, 48, mesh, cfg)
    data = enc.push(clip) + enc.finish()
    import jax

    jenc = JShardedEncoder(64, 48, j_mesh.make_mesh(gop=2, tile=3, devices=jax.devices()[:6]),
                           jcfg)
    assert data == encode_video(clip, cfg, device="cpu") == jenc.push(clip) + jenc.finish()
    np.testing.assert_array_equal(ShardedDecoder(64, 48, mesh, cfg).decode(data, 32),
                                  decode_video(data, 64, 48, 32, cfg, device="cpu"))


def test_rgb_equals_jax():
    """An RGB container in bf16 equals the JAX package's and decodes to
    its pixels."""
    clip = np.stack([synthetic_video(16, 32, 48, seed=s) for s in (11, 12, 13)], axis=-1)
    cfg, jcfg = _cfgs(deflate_workers=2)
    data = encode_rgb_video(clip, cfg, device="cpu", index=True)
    assert data == j_rgb_codec.encode_rgb_video(clip, jcfg, index=True)
    np.testing.assert_array_equal(decode_rgb_video(data, 48, 32, cfg, device="cpu"),
                                  j_rgb_codec.decode_rgb_video(data, 48, 32, jcfg))


@pytest.fixture
def bf16_checkpoint(tmp_path):
    """A checkpointed bf16 container written by the port's CLI (the JAX
    CLI's file), its source and the JAX CLI's no-flag decode of it."""
    clip = synthetic_video(24, 32, 48, seed=6)
    src, box = str(tmp_path / "src.raw"), str(tmp_path / "ck.p")
    clip.tofile(src)
    flags = ["48", "32", "--checkpoint-every", "2", "--dtype", "bf16"]
    assert cli.main(["encode", src, box, *flags, "--device", "cpu"]) == 0
    jbox = str(tmp_path / "ck.j")
    assert jcli.main(["encode", src, jbox, *flags]) == 0
    assert open(box, "rb").read() == open(jbox, "rb").read()
    jdec = str(tmp_path / "j.raw")
    assert jcli.main(["decode", jbox, jdec]) == 0
    return src, box, np.fromfile(jdec, np.uint8)


def test_checkpoint_meta_decodes_in_bf16(bf16_checkpoint, tmp_path):
    """The .meta sidecar records compute_dtype, so a decode with no flags
    builds a bf16 decoder: the JAX CLI's pixels, not the f32 decoder's."""
    src, box, want = bf16_checkpoint
    assert '"compute_dtype": "bfloat16"' in open(box + ".meta").read()
    out = str(tmp_path / "p.raw")
    assert cli.main(["decode", box, out, "--device", "cpu"]) == 0
    got = np.fromfile(out, np.uint8)
    np.testing.assert_array_equal(got, want)
    f32 = multihost.decode_multihost_container(open(box, "rb").read(), 48, 32, CodecConfig(),
                                               ctx=TransformContext(CodecConfig(), "cpu"))
    assert not np.array_equal(f32.reshape(-1), got)


def test_checkpoint_resume_under_other_dtype_refuses(bf16_checkpoint):
    """A resume under --dtype float32 (library and CLI, as in the JAX
    package) refuses: compute_dtype is part of the resume's parameters."""
    src, box, _ = bf16_checkpoint
    with pytest.raises(ValueError, match="resume parameters differ"):
        CheckpointingEncoder(box, 48, 32, CodecConfig(), device="cpu")
    with pytest.raises(ValueError, match="resume parameters differ"):
        cli.main(["encode", src, box, "48", "32", "--checkpoint-every", "2", "--dtype",
                  "float32", "--device", "cpu"])
    size = os.path.getsize(box)
    assert cli.main(["encode", src, box, "48", "32", "--checkpoint-every", "2", "--dtype",
                     "bf16", "--device", "cpu"]) == 0
    assert os.path.getsize(box) == size
