#!/usr/bin/env python
"""Smoke run of the PyTorch port (dct3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — reference-profile encode and decode of the
bench clip (1920x1080, 64 frames = 8 GOPs) — through its public entry
points, and checks on the card:

  1. device   the card, its power limit, torch and CUDA versions;
  2. build    nvcc builds the four kernels (csrc/) into one library;
  3. kernels  K1-K4 at one 1080p GOP's main-path shapes are byte-equal to
              their plain PyTorch versions run on the CPU copy of the same
              input, plus an adversarial bit-pack case (|v| <= 5770, 27-bit
              codewords, carries 1..7); median CUDA-event times of each
              kernel and of its plain version run on the card;
  4. encode   encode_video with the parallel and the serial DEFLATE sink;
              GOP 0's quantized ints against float64 on the card;
  5. decode   decode_video of both streams with the encoder's index; GOP 0
              against the plain decode on the CPU; bpp and PSNR against the
              content figures of the JAX package's bench record;
  6. timing   encode and decode fps, end to end and device-only.

Each phase prints one JSON line.  Any failed check raises, and the script
exits non-zero without printing a result; with no card it fails in phase 1.
The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.  Imports torch, numpy and dct3d_tpu_torch,
never jax or the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
import zlib

import numpy as np
import torch

import dct3d_tpu_torch as port
from dct3d_tpu_torch import kernels
from dct3d_tpu_torch.codec import decoder, entropy, framing, transform
from dct3d_tpu_torch.ops import bitpack, dct, group_pack, relayout, splice

W, H, T = 1920, 1080, 64
# Content figures of the bench clip in BENCH_r05.json (bytes-only: any
# correct encoder of the same frames reproduces them).
BPP_REF, PSNR_REF = 0.3123, 32.82


def synthetic_clip(t: int, h: int, w: int) -> np.ndarray:
    """Moving gradient + noise: the bench clip (copied from bench.py:56-65)."""
    rng = np.random.default_rng(12345)
    x = np.arange(w, dtype=np.uint32)
    y = np.arange(h, dtype=np.uint32)[:, None]
    frames = np.empty((t, h, w), np.uint8)
    for k in range(t):
        frames[k] = ((x[None, :] + y + k) & 0xFF).astype(np.uint8)
    noise = (rng.integers(0, 16, size=frames.shape, dtype=np.uint8)).astype(np.uint8)
    return frames ^ noise


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def median_ms(fn, reps: int = 15) -> float:
    """Median CUDA-event time of fn() on the current stream, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.cpu().double() - b.cpu().double()).abs().max())


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit(phase="device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.load()
    emit(phase="build", seconds=time.perf_counter() - t0)


def phase_kernels(gop0: np.ndarray, ctx, card: str) -> list[dict]:
    """K1-K4 on the card against their plain versions on the CPU."""
    dev = ctx.device
    rows = []

    def row(name, source, replaces, err, ms, plain_ms):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms})
        emit(phase="kernels", kernel=name, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, card=card)

    frames = torch.from_numpy(gop0).to(dev)
    cubes, sums = relayout.frames_to_cubes(frames)
    p_cubes, p_sums = relayout.frames_to_cubes_plain(frames.cpu())
    check(torch.equal(cubes.cpu(), p_cubes) and torch.equal(sums.cpu(), p_sums),
          "K1 frames_to_cubes differs from its plain version")
    row("frames_to_cubes", "dct3d_tpu_torch/csrc/relayout.cu",
        "dct3d_tpu/ops/relayout.py:216", max_abs_err(cubes, p_cubes),
        median_ms(lambda: relayout.frames_to_cubes(frames)),
        median_ms(lambda: relayout.frames_to_cubes_plain(frames)))

    q = transform._quantize(cubes, sums, ctx.enc_t, ctx.cfg)
    v2 = q.reshape(-1, group_pack.GROUP)
    max_width = bitpack.max_codeword_bits(ctx.cfg.cube_size)
    w_words = bitpack.worst_case_w_words(group_pack.GROUP, max_width)
    nwords = bitpack.stream_words(v2.numel(), max_width)

    def pack_pair(v2, code, bits):
        """K2 then K3 on the card and on the CPU from identical inputs."""
        code = torch.tensor(code, dtype=torch.int64, device=dev)
        bits = torch.tensor(bits, dtype=torch.int64, device=dev)
        gstart, gend = bitpack.geometry(v2, bits)
        phase = (gstart & 31).to(torch.int32)
        k2 = group_pack.group_pack_values(v2, phase, w_words)
        p2 = group_pack.group_pack_values_plain(v2.cpu(), phase.cpu(), w_words)
        check(torch.equal(k2.cpu(), p2), "K2 group_pack_values differs from its plain version")
        bitpack.or_carry_lead(k2, code, bits)
        sw, ge = (gstart >> 5).to(torch.int32), gend.to(torch.int32)
        k3 = splice.splice(k2, sw, ge, nwords)
        p3 = splice.splice_plain(k2.cpu(), sw.cpu(), ge.cpu(), nwords)
        check(torch.equal(k3.cpu(), p3), "K3 splice differs from its plain version")
        return phase, k2, sw, ge, k3, p2, p3

    phase, k2, sw, ge, k3, p2, p3 = pack_pair(v2, 0, 0)
    row("group_pack_values", "dct3d_tpu_torch/csrc/group_pack.cu",
        "dct3d_tpu/ops/group_pack.py:125", max_abs_err(k2, p2),
        median_ms(lambda: group_pack.group_pack_values(v2, phase, w_words)),
        median_ms(lambda: group_pack.group_pack_values_plain(v2, phase, w_words)))
    row("splice", "dct3d_tpu_torch/csrc/splice.cu", "dct3d_tpu/ops/splice.py:129",
        max_abs_err(k3, p3),
        median_ms(lambda: splice.splice(k2, sw, ge, nwords)),
        median_ms(lambda: splice.splice_plain(k2, sw, ge, nwords)))

    # Adversarial bit pack: every codeword up to the 27-bit bound, carries
    # 1..7 with random carry codes, over one GOP's shape.
    rng = np.random.default_rng(7)
    bound = 5770
    for bits in range(1, 8):
        vals = rng.integers(-bound, bound + 1, v2.shape, dtype=np.int32)
        vals[rng.random(v2.shape) < 0.1] = bound * rng.choice([-1, 1])
        pack_pair(torch.from_numpy(vals).to(dev), int(rng.integers(0, 1 << bits)), bits)
    emit(phase="kernels", adversarial="K2+K3 byte-equal, |v|<=5770, carries 1..7")

    pixels = transform._dequant_matmul(
        v2.reshape(q.shape[0], -1, 2)[..., 0], v2.reshape(q.shape[0], -1, 2)[..., 1],
        ctx.dec_me, ctx.dec_mo)
    k4 = relayout.cubes_to_frames(pixels, H, W)
    p4 = relayout.cubes_to_frames_plain(pixels.cpu(), H, W)
    check(torch.equal(k4.cpu(), p4), "K4 cubes_to_frames differs from its plain version")
    row("cubes_to_frames", "dct3d_tpu_torch/csrc/relayout.cu",
        "dct3d_tpu/ops/relayout.py:258", max_abs_err(k4, p4),
        median_ms(lambda: relayout.cubes_to_frames(pixels, H, W)),
        median_ms(lambda: relayout.cubes_to_frames_plain(pixels, H, W)))
    return rows


def quant_flips(gop0: np.ndarray, ctx) -> dict:
    """Port's quantized ints of GOP 0 against float64 on the card (the
    oracle's math: cubes @ E in float64, round half away from zero)."""
    frames = torch.from_numpy(gop0).to(ctx.device)
    q = transform.quantize_step(frames, ctx)
    enc64 = torch.from_numpy(dct.encode_matrix(ctx.cfg, np.float64)).to(ctx.device)
    x = framing.frames_to_cubes(frames, ctx.cfg).double() @ enc64
    ref = torch.trunc(x + torch.copysign(x.new_full((), 0.5), x)).to(torch.int32)
    diff = q != ref
    dc, ac = int(diff[:, 0].sum()), int(diff[:, 1:].sum())
    per_m = 1e6 * ac / diff[:, 1:].numel()
    check(dc == 0, f"{dc} DC flips against float64")
    check(per_m <= 1.0, f"{ac} AC flips against float64 ({per_m:.3f} per 1M)")
    return {"coefficients": diff.numel(), "dc_flips": dc, "ac_flips": ac,
            "ac_flips_per_1m": per_m}


def encode_clip(clip: np.ndarray, cfg, ctx):
    """encode_video's body, keeping the encoder's index."""
    enc = port.StreamingEncoder(W, H, cfg, ctx)
    data = enc.push(clip) + enc.finish()
    return data, enc.gop_bit_ends, enc.gop_sync_offsets


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    card, smi = phase_device()
    phase_build()

    clip = synthetic_clip(T, H, W)
    cfg_par = port.CodecConfig(deflate_workers=-1)
    cfg_ser = port.CodecConfig()
    ctx = port.TransformContext(cfg_ser, "cuda")
    ctx_par = port.TransformContext(cfg_par, "cuda")
    rows = phase_kernels(clip[:8], ctx, card)

    # Main path: encode, then decode, through the public entry points.
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    par, ends_par, syncs = encode_clip(clip, cfg_par, ctx_par)
    enc_s = time.perf_counter() - t0
    ser, ends, _ = encode_clip(clip, cfg_ser, ctx)
    positions = [0] + ends[:-1]
    t0 = time.perf_counter()
    out_par = port.decode_video(par, W, H, T, cfg_par, ctx_par,
                                positions=positions, sync_offsets=syncs)
    dec_s = time.perf_counter() - t0
    out_ser = port.decode_video(ser, W, H, T, cfg_ser, ctx, positions=positions)
    launches = dict(kernels.LAUNCHES)

    check(ends_par == ends, "GOP bit ends differ between the two sinks")
    check(port.encode_video(clip, cfg_ser, ctx) == ser
          and port.encode_video(clip, cfg_par, ctx_par) == par,
          "encode_video differs from the StreamingEncoder stream")
    check(zlib.decompress(par) == zlib.decompress(ser),
          "parallel and serial sinks carry different payloads")
    flips = quant_flips(clip[:8], ctx)
    for r in rows:
        r["launches"] = launches.get(r["name"], 0)
        check(r["launches"] > 0, f"kernel {r['name']} never ran on the main path")
    emit(phase="encode", bytes_parallel=len(par), bytes_serial=len(ser),
         launches=launches, **flips)

    check(np.array_equal(out_par, out_ser), "the two streams decode differently")
    cpu_gop0 = port.decode_frame_range(ser, W, H, 0, 8, cfg_ser, device="cpu",
                                       positions=positions)
    d = np.abs(out_ser[:8].astype(np.int16) - cpu_gop0)
    mismatch = float((d > 0).mean())
    check(int(d.max()) <= 1 and mismatch < 0.01,
          f"GPU decode vs plain CPU decode: max {int(d.max())}, rate {mismatch}")
    bpp = port.bits_per_pixel(len(par), W, H, T)
    psnr = port.psnr(clip, out_par)
    check(abs(bpp - BPP_REF) <= 0.0005, f"bpp {bpp} vs {BPP_REF}")
    check(abs(psnr - PSNR_REF) <= 0.02, f"psnr {psnr} vs {PSNR_REF}")
    emit(phase="decode", bpp=bpp, psnr_db=psnr, gop0_max_abs_diff=int(d.max()),
         gop0_mismatch_rate=mismatch)

    # Timing: best of 3 end-to-end runs; device-only runs on resident input.
    enc_best = min([enc_s] + [_timed(lambda: encode_clip(clip, cfg_par, ctx_par))
                              for _ in range(2)])
    dec_best = min([dec_s] + [_timed(lambda: port.decode_video(
        par, W, H, T, cfg_par, ctx_par, positions=positions, sync_offsets=syncs))
        for _ in range(2)])
    frames_dev = torch.from_numpy(clip).to("cuda")
    zero = torch.zeros((), dtype=torch.int64, device="cuda")

    def encode_device():
        carry = (zero, zero)
        for g in range(0, T, 8):
            gop = transform.encode_step(frames_dev[g : g + 8], ctx, *carry)
            carry = (gop.carry_code, gop.carry_bits)

    raw = np.frombuffer(zlib.decompress(ser), np.uint8)
    planes = []
    for p in positions:
        plane, ei, ev, _ = entropy.decode_values_planar4(raw, W * H * 8, p)
        dc, ei, ev = decoder._split_dc_flat(plane, ei, ev, 512)
        planes.append([torch.from_numpy(a).to("cuda")
                       for a in (plane, ei.astype(np.int64), ev, dc)])

    def decode_device():
        for pl in planes:
            transform.planar4_to_frames(*pl, ctx, H, W)

    enc_dev_ms = median_ms(encode_device, reps=5)
    dec_dev_ms = median_ms(decode_device, reps=5)
    emit(phase="timing", card=smi, frames=T, width=W, height=H,
         encode_fps=T / enc_best, decode_fps=T / dec_best,
         encode_device_fps=T / (enc_dev_ms / 1e3),
         decode_device_fps=T / (dec_dev_ms / 1e3))

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
