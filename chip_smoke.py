#!/usr/bin/env python
"""Smoke run of the PyTorch port (dct3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's two main paths — reference-profile and turbo-profile
encode and decode of the bench clip (1920x1080, 64 frames = 8 GOPs) —
through their public entry points, and checks on the card:

  1. device   the card, its power limit, torch and CUDA versions;
  2. build    nvcc builds the seven kernels (csrc/, one nvcc per source, in
              parallel) into one library;
  3. kernels  K1-K4 and K6-K8 at one 1080p GOP's main-path shapes are
              byte-equal to their plain PyTorch versions run on the CPU copy
              of the same input, plus adversarial cases: bit pack with
              |v| <= 5770, 27-bit codewords and carries 1..7; exception
              tables of groups holding more than 16 exceptions (overflow,
              then the 256-slot retry); median CUDA-event times of each
              kernel and of its plain version run on the card;
  4. encode   encode_video with the parallel and the serial DEFLATE sink;
              GOP 0's quantized ints against float64 on the card;
  5. decode   decode_video of both streams with the encoder's index; GOP 0
              against the plain decode on the CPU; bpp and PSNR against the
              content figures of the JAX package's bench record;
  6. turbo    encode_turbo_video, decode_turbo_container and
              decode_turbo_range on the zlib-6 wire: pixels identical to the
              reference decode, the range equal to the slice, GOP 0's member
              against the plain CPU path, the container's content against
              the JAX package's (constants below), the zstd wire where the
              zstandard module imports, and the per-GOP reference-profile
              fallback at quant 0 on a small clip;
  7. timing   encode and decode fps of both profiles, end to end and
              device-only.

Each main path runs with the launch counts set to 0 just before it and read
just after; every kernel of the path must have launched.

Each phase prints one JSON line.  Any failed check raises, and the script
exits non-zero without printing a result; with no card it fails in phase 1.
The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.  Imports torch, numpy and dct3d_tpu_torch,
never jax or the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import struct
import subprocess
import time
import zlib

import numpy as np
import torch

import dct3d_tpu_torch as port
from dct3d_tpu_torch import kernels
from dct3d_tpu_torch.codec import decoder, entropy, framing, transform, turbo
from dct3d_tpu_torch.ops import (
    bitpack, dct, exc_pack, exceptions, group_pack, relayout, splice,
)
from dct3d_tpu_torch.parallel import multihost

W, H, T = 1920, 1080, 64
# Content figures of the bench clip in BENCH_r05.json (bytes-only: any
# correct encoder of the same frames reproduces them).
BPP_REF, PSNR_REF = 0.3123, 32.82
TURBO_ZSTD_BPP_REF = 0.2289  # BENCH_r05.json turbo_bpp (default zstd-3 wire)

# The turbo main path's configuration: the zlib-6 wire of `encode --turbo`.
TURBO_CFG = {"deflate_workers": -1, "turbo_codec": "zlib", "zlib_level": 6}
# The JAX package's turbo container of the bench clip under TURBO_CFG:
# its bpp and container_digest, printed by
#   JAX_PLATFORMS=cpu python tools/jax_turbo_constants.py
JAX_TURBO_BPP = 0.21424653983410494
JAX_TURBO_DIGEST = "603c6366b5486bfbeaca5e35758cf8eb98f966d669b8d7d9f337fd642b44dd30"
# Column order of the pair-permuted encode matrix (dct.encode_matrix_pair).
PAIR = np.concatenate([np.arange(0, 512, 2), np.arange(1, 512, 2)])


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


def small_clip(t: int, h: int, w: int, seed: int) -> np.ndarray:
    """Moving sinusoids + Gaussian noise (the test suite's clip,
    tests/conftest.py synthetic_video)."""
    rng = np.random.default_rng(seed)
    tt = np.arange(t)[:, None, None]
    yy = np.arange(h)[None, :, None]
    xx = np.arange(w)[None, None, :]
    base = (96.0 + 64.0 * np.sin(2 * np.pi * (xx + 3 * tt) / 32.0)
            + 48.0 * np.cos(2 * np.pi * (yy + 2 * tt) / 24.0))
    return np.clip(base + rng.normal(0, 6.0, size=(t, h, w)), 0, 255).astype(np.uint8)


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


def add_row(rows: list, card: str, name: str, source: str, replaces: str,
            err: float, ms: float, plain_ms: float) -> None:
    rows.append({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms})
    emit(phase="kernels", kernel=name, max_abs_err=err, ms=ms,
         plain_ms=plain_ms, card=card)


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
        add_row(rows, card, name, source, replaces, err, ms, plain_ms)

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


def phase_turbo_kernels(gop0: np.ndarray, ctx, card: str) -> list[dict]:
    """K6-K8 on the card against their plain versions on the CPU."""
    dev = ctx.device
    rows = []
    frames = torch.from_numpy(gop0).to(dev)
    cubes, sums = relayout.frames_to_cubes(frames)
    qp = transform._quantize(cubes, sums, ctx.enc_t_pair, ctx.cfg)
    v2 = qp.reshape(-1, exc_pack.GROUP)

    def k6(v2, slots, dc_stride):
        got = exc_pack.compact_groups(v2, slots, dc_stride)
        want = exc_pack.compact_groups_plain(v2.cpu(), slots, dc_stride)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              f"K6 compact_groups differs from its plain version "
              f"(slots {slots}, dc_stride {dc_stride})")
        return max(max_abs_err(g, w) for g, w in zip(got, want))

    err = max(k6(v2, 16, 512), k6(v2, 256, 512), k6(v2, 16, 0))
    # Adversarial: ~10% exceptions, ~25 per group, overflow 16 slots; the
    # 256-slot retry lists them all.
    rng = np.random.default_rng(8)
    adv = torch.from_numpy(np.where(
        rng.random(v2.shape) < 0.1, rng.integers(-5771, 5772, v2.shape),
        rng.integers(-8, 8, v2.shape)).astype(np.int32)).to(dev)
    *_, ovf = exceptions.compact_exceptions(adv.reshape(-1), slots=16, dc_stride=512)
    *_, counts, ovf256 = exceptions.compact_exceptions(adv.reshape(-1), slots=256,
                                                       dc_stride=512)
    check(bool(ovf) and not bool(ovf256),
          "adversarial groups did not overflow 16 slots, or overflowed 256")
    err = max(err, k6(adv, 16, 512), k6(adv, 256, 512))
    emit(phase="kernels", adversarial="K6 byte-equal on groups of up to "
         f"{int(counts.max())} exceptions: overflow at 16 slots, retry at 256")
    add_row(rows, card, "compact_groups", "dct3d_tpu_torch/csrc/exc_pack.cu",
            "dct3d_tpu/ops/exc_pack.py:62", err,
            median_ms(lambda: exc_pack.compact_groups(v2, 16, 512)),
            median_ms(lambda: exc_pack.compact_groups_plain(v2, 16, 512)))

    plane = turbo._plane_and_tables(qp, 16).plane.reshape(-1, 256)
    wire = relayout.plane_to_wire(plane)
    p_wire = relayout.plane_to_wire_plain(plane.cpu())
    check(torch.equal(wire.cpu(), p_wire), "K7 plane_to_wire differs from its plain version")
    add_row(rows, card, "plane_to_wire", "dct3d_tpu_torch/csrc/wire.cu",
            "dct3d_tpu/ops/relayout.py:97", max_abs_err(wire, p_wire),
            median_ms(lambda: relayout.plane_to_wire(plane)),
            median_ms(lambda: relayout.plane_to_wire_plain(plane)))
    back = relayout.wire_to_plane(wire)
    p_back = relayout.wire_to_plane_plain(wire.cpu())
    check(torch.equal(back.cpu(), p_back), "K8 wire_to_plane differs from its plain version")
    check(torch.equal(back, plane), "K7 then K8 does not give the plane back")
    add_row(rows, card, "wire_to_plane", "dct3d_tpu_torch/csrc/wire.cu",
            "dct3d_tpu/ops/relayout.py:146", max_abs_err(back, p_back),
            median_ms(lambda: relayout.wire_to_plane(wire)),
            median_ms(lambda: relayout.wire_to_plane_plain(wire)))
    return rows


def container_digest(data: bytes) -> str:
    """sha256 over each member's frame count and type and its payload's
    decompressed streams, so it does not depend on the compressor's build."""
    h = hashlib.sha256()
    for t, payload, mtype in multihost.split_members(data):
        h.update(struct.pack("<II", t, mtype))
        if mtype == turbo.MEMBER_TURBO:
            o = 16
            for n in struct.unpack_from("<IIII", payload, 0):
                h.update(turbo._decompress(payload[o : o + n]))
                o += n
        else:
            h.update(zlib.decompress(payload))
    return h.hexdigest()


def turbo_gop0(gop0: np.ndarray, ctx, data: bytes) -> dict:
    """GOP 0: turbo ints equal quantize_step's in pair order on the card;
    the card's member equals the one the plain CPU versions build from the
    card's ints; against the whole plain CPU path from the same frames,
    every differing int lies within 1e-3 of a rounding tie."""
    frames = torch.from_numpy(gop0).to(ctx.device)
    cubes, sums = relayout.frames_to_cubes(frames)
    qp = transform._quantize(cubes, sums, ctx.enc_t_pair, ctx.cfg)
    check(torch.equal(qp, transform.quantize_step(frames, ctx)[:, PAIR]),
          "turbo ints differ from quantize_step's in pair order")
    t, payload, mtype = multihost.split_members(data)[0]
    card_member = multihost._member(payload, t, mtype)
    gop = turbo._plane_and_tables(qp.cpu(), 16, wire=True)  # plain K6, K7
    idx, val = turbo._expand_pair(gop.lidx, gop.vals, gop.counts, 512)
    plain = turbo._pick_member(
        gop0, turbo._member_payload(gop.plane.numpy(), gop.dc.numpy(), idx, val,
                                    ctx.cfg, wire=True),
        idx.size, 8, turbo.MEMBER_TURBO, ctx.cfg, ctx, lambda: None)
    check(plain == card_member,
          "GOP 0's member differs from the plain versions' on the same ints")
    cpu_ctx = port.TransformContext(ctx.cfg, "cpu")
    cpu_member = port.encode_turbo_video(gop0, ctx.cfg, cpu_ctx)
    c_cubes, c_sums = relayout.frames_to_cubes(frames.cpu())
    q_cpu = transform._quantize(c_cubes, c_sums, cpu_ctx.enc_t_pair, ctx.cfg)
    x = (framing.frames_to_cubes(frames.cpu(), ctx.cfg).double()
         @ torch.from_numpy(dct.encode_matrix_pair(ctx.cfg, np.float64)))
    diff = qp.cpu() != q_cpu
    worst = float(((x.abs() % 1) - 0.5).abs()[diff].max()) if diff.any() else 0.0
    check(worst < 1e-3, f"card and CPU ints differ {worst} from a rounding tie")
    check((cpu_member == card_member) == (not diff.any()),
          "GOP 0's member vs the plain CPU path disagrees with their ints")
    return {"gop0_member_equals_plain_on_card_ints": True,
            "gop0_member_equals_cpu_path": cpu_member == card_member,
            "gop0_ints_differing_from_cpu_path": int(diff.sum()),
            "gop0_worst_distance_from_tie": worst}


def turbo_quant0(dev) -> dict:
    """quant 0 on a small clip whose noisy GOPs fall back to
    reference-profile members and whose still gradient GOP stays turbo;
    the mixed container decodes to the reference profile's pixels."""
    cfg0 = port.CodecConfig(quant_strength=0, **TURBO_CFG)
    ctx0 = port.TransformContext(cfg0, dev)
    clip0 = small_clip(24, 64, 64, seed=78)
    clip0[8:16] = (2 * np.arange(64)[None, None, :] + np.arange(64)[None, :, None])
    data = port.encode_turbo_video(clip0, cfg0, ctx0)
    types = [m[2] for m in multihost.split_members(data)]
    check({multihost.MEMBER_TEMPORAL, turbo.MEMBER_TURBO} <= set(types),
          f"quant 0 did not mix fallback and turbo members: {types}")
    want = port.decode_video(port.encode_video(clip0, cfg0, ctx0), 64, 64, 24, cfg0, ctx0)
    check(np.array_equal(port.decode_turbo_container(data, 64, 64, cfg0, ctx0), want),
          "quant-0 turbo pixels differ from the reference profile's")
    return {"quant0_member_types": types}


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
    trows = phase_turbo_kernels(clip[:8], ctx, card)

    # Reference-profile main path: encode, then decode, through the public
    # entry points.
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

    # Turbo main path: encode, decode, range decode, through the public
    # entry points, with launch counts of its own.
    cfg_t = port.CodecConfig(**TURBO_CFG)
    ctx_t = port.TransformContext(cfg_t, "cuda")
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    tdata = port.encode_turbo_video(clip, cfg_t, ctx_t)
    tenc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tout = port.decode_turbo_container(tdata, W, H, cfg_t, ctx_t)
    tdec_s = time.perf_counter() - t0
    trange = port.decode_turbo_range(tdata, W, H, 20, 45, cfg_t, ctx_t)
    tlaunches = dict(kernels.LAUNCHES)

    for r in trows:
        r["launches"] = tlaunches.get(r["name"], 0)
        check(r["launches"] > 0, f"kernel {r['name']} never ran on the turbo main path")
    for name in ("frames_to_cubes", "cubes_to_frames"):
        check(tlaunches.get(name, 0) > 0, f"kernel {name} never ran on the turbo main path")
    members = multihost.split_members(tdata)
    check([m[2] for m in members] == [turbo.MEMBER_TURBO] * (T // 8)
          and turbo.is_turbo_container(members), "not one turbo member per GOP")
    check(np.array_equal(tout, out_par), "turbo pixels differ from the reference-profile decode")
    check(np.array_equal(trange, tout[20:45]), "decode_turbo_range differs from the slice")
    tbpp = port.bits_per_pixel(len(tdata), W, H, T)
    check(container_digest(tdata) == JAX_TURBO_DIGEST,
          "the turbo container's streams differ from the JAX package's")
    check(abs(tbpp - JAX_TURBO_BPP) <= 0.0005, f"turbo bpp {tbpp} vs JAX {JAX_TURBO_BPP}")
    emit(phase="turbo", bytes=len(tdata), launches=tlaunches,
         pixels_equal_reference=True, range_equals_slice=True,
         digest_equals_jax=True, bpp=tbpp, jax_bpp=JAX_TURBO_BPP,
         **turbo_gop0(clip[:8], ctx_t, tdata))
    if turbo._zstd is None:
        emit(zstandard=False)
    else:
        zdata = port.encode_turbo_video(clip, port.CodecConfig(deflate_workers=-1), ctx_t)
        for _, payload, _ in multihost.split_members(zdata):
            o = 16
            for n in struct.unpack_from("<IIII", payload, 0):
                check(payload[o : o + 4] == turbo._ZSTD_MAGIC, "a default-wire stream is not zstd")
                o += n
        zbpp = port.bits_per_pixel(len(zdata), W, H, T)
        check(abs(zbpp - TURBO_ZSTD_BPP_REF) <= 0.0005,
              f"zstd turbo bpp {zbpp} vs {TURBO_ZSTD_BPP_REF}")
        check(np.array_equal(port.decode_turbo_container(zdata, W, H, cfg_t, ctx_t), out_par),
              "zstd-wire turbo pixels differ from the reference-profile decode")
        emit(phase="turbo", zstandard=True, zstd_bpp=zbpp)
    emit(phase="turbo", **turbo_quant0("cuda"))

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

    tenc_best = min([tenc_s] + [_timed(lambda: port.encode_turbo_video(clip, cfg_t, ctx_t))
                                for _ in range(2)])
    tdec_best = min([tdec_s] + [_timed(lambda: port.decode_turbo_container(
        tdata, W, H, cfg_t, ctx_t)) for _ in range(2)])

    def turbo_encode_device():
        for g in range(0, T, 8):
            turbo.encode_step_turbo(frames_dev[g : g + 8], ctx_t, wire=True)

    tplanes = [[torch.from_numpy(np.array(a)).to("cuda")
                for a in turbo._parse_payload(payload, 512, True, True)]
               for _, payload, _ in members]

    def turbo_decode_device():
        for wire, dc, ei, ev in tplanes:
            transform.planar4_to_frames(relayout.wire_to_plane(wire).reshape(-1),
                                        ei, ev, dc, ctx_t, H, W)

    enc_dev_ms = median_ms(encode_device, reps=5)
    dec_dev_ms = median_ms(decode_device, reps=5)
    tenc_dev_ms = median_ms(turbo_encode_device, reps=5)
    tdec_dev_ms = median_ms(turbo_decode_device, reps=5)
    emit(phase="timing", card=smi, frames=T, width=W, height=H,
         encode_fps=T / enc_best, decode_fps=T / dec_best,
         encode_device_fps=T / (enc_dev_ms / 1e3),
         decode_device_fps=T / (dec_dev_ms / 1e3),
         turbo_encode_fps=T / tenc_best, turbo_decode_fps=T / tdec_best,
         turbo_encode_device_fps=T / (tenc_dev_ms / 1e3),
         turbo_decode_device_fps=T / (tdec_dev_ms / 1e3))

    print(json.dumps({"kernels": rows + trows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
