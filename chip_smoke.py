#!/usr/bin/env python
"""Smoke run of the PyTorch port (dct3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — reference-profile and turbo-profile encode
and decode of the bench clip (1920x1080, 64 frames) at 8x8x8 cubes, and the
4x4x4 paths — through their public entry points, and checks on the card:

  1. device   the card, its power limit, torch and CUDA versions;
  2. build    nvcc builds the eleven kernels (csrc/, one nvcc per source,
              in parallel) into one library;
  3. kernels  K1-K4, group_bits and K6-K8 at one 1080p GOP's main-path
              shapes, and K5 at one padded-portrait 4x4x4 GOP's (46,368
              groups), are byte-equal to their plain PyTorch versions run on
              the CPU copy of the same input (K2 and K5 over the words of
              each row that they define and K3 reads, K3 over the stream
              words it defines, each launched into a poisoned output that
              must stay poisoned past those words), plus adversarial cases:
              bit pack with |v| <= 5770, 27-bit codewords and carries 1..7,
              and at 64,801 and 1 groups; K5 with every width 0..32 at every
              phase, and pack_bits (K5 + K3) after carries 0..7 at n
              1..70,001 and with a trailing zero-width group at an unaligned
              and an aligned phase; exception
              tables of groups holding more than 16 exceptions (overflow,
              then the 256-slot retry), and at 64,801 and 1 groups with
              slots 1/16/255/256 and dc_stride 0/512/64/96; median
              CUDA-event times of each kernel and of its plain version run
              on the card, its bytes and their bound at 3.35 TB/s, and for
              K7/K8 the library call t().contiguous();
  4. encode   encode_video with the device DEFLATE sink (deflate_workers
              -1 on the card: ops/deflate.py, one launch a GOP) and the
              serial zlib sink;
              GOP 0's quantized ints against float64 on the card;
  5. decode   decode_video of both streams with the encoder's index; GOP 0
              against the plain decode on the CPU; bpp and PSNR against the
              content figures of the JAX package's bench record (the
              serial zlib-9 stream within 0.0005, the device sink's at
              most 1.005 times it: DEVICE_DEFLATE_RATIO, also where later
              phases hold a device-sink stream to a JAX package's bpp);
  6. turbo    encode_turbo_video, decode_turbo_container and
              decode_turbo_range on the zlib-6 wire (each plane deflated on
              the card, one launch a GOP; bpp held as a device-sink
              stream's): pixels identical to the
              reference decode, the range equal to the slice, GOP 0's member
              streams against the plain CPU path, the container's content against
              the JAX package's (constants below), the zstd wire where the
              zstandard module imports, and the per-GOP reference-profile
              fallback at quant 0 on a small clip;
  7. blocks   4x4x4 cubes: the bench clip (16 GOPs, whole 256-value groups,
              so group_bits + K2 + K3) and the 1170x2532 portrait screen padded to
              1172x2532 (no GOP is whole groups, so pack_bits with K5 + K3)
              through encode, decode, range decode and crop, then turbo on
              the padded clip; streams carry the card's ints, the portrait
              stream equals pack_bits' plain route on them, content against
              the JAX package's; encode and decode fps of each, end to end
              and device-only;
  8. timing   encode and decode fps of both 8x8x8 profiles, end to end and
              device-only;
  9. delta    transport_delta under bench.py's speed profile: the plain
              encode's stream, bit ends and sync offsets, the plain pixels,
              the JAX turbo digest; encode fps with and without the delta,
              alternated; the device's rebuild scan per GOP;
 10. host_encode  StreamingEncoder(device_pack=False), serial sink: the
              device-packed serial stream, no bit pack kernel; fps;
 11. speculative  decode_video and decode_frame_range 20:45 with no index
              (the fused speculative decode, the prefix skip): the indexed
              pixels; speculative_planar4_chunks on the 1080p payload equal
              to the serial decoder's tuples; decode and host entropy fps
              without and with the index;
 12. rgb      encode_rgb_video(index=True) and encode_turbo_rgb_video of a
              1920x1080x16 RGB clip: content against the JAX package's
              (constants below), decodes equal to the per-channel decodes,
              ranges to the slices; fps;
 13. checkpoint  CheckpointingEncoder, reference (index on) and turbo: stop
              after 3 GOPs, tear the last member, resume; the file equals
              an uninterrupted run's and decodes to the plain pixels;
 14. cli      the port's command line (dct3d_tpu_torch.cli.main), file to
              file in a temporary directory, on the bench clip written raw:
              the default encode (an indexed container: its payload the
              parallel-sink stream of phase 4, its index that encode's bit
              ends and sync offsets, its content the JAX CLI's, constants
              below), decode with no frame count, --range and info;
              --parity --index (the serial-sink stream, the sidecar decode);
              --turbo --turbo-codec zlib (the JAX turbo digest); --block 4
              --pad on the portrait clip, decoded with --crop to phase 7's
              pixels; `python -m dct3d_tpu_torch devices` in a subprocess;
              --transport-delta (the default container); --rgb and --rgb
              --turbo, decoded with no flags and with --range (the JAX
              content, phase 12's pixels); --checkpoint-every 2 run twice,
              then decoded from the .meta sidecar; encode and decode fps,
              file to file.
 15. mesh     the sharded paths (dct3d_tpu_torch.parallel) on meshes that
              repeat cuda:0 (the shards take turns on the one card): 8x8x8
              ShardedEncoder on (2, 3) and (4, 1) with the serial sink equal
              to phase 4's serial stream and bit ends, with the parallel
              sink its payload; ShardedDecoder on (2, 3) with and without
              the index equal to phase 5's pixels; TurboShardedEncoder and
              TurboShardedDecoder on (2, 3) equal to phase 6's container and
              pixels; 4x4x4 on (2, 3), the bench clip (K2) and the padded
              portrait (K5, the phase pseudo-codeword), equal to their
              single-device streams and pixels; the CLI's --mesh 1x1
              --parity (phase 4's serial stream) and decode --mesh 1x1, the
              exit 2 of --mesh 2x1 on one card (its file with more) and of a
              turbo-container decode on a mesh that cannot be built; the
              two-process gloo simulation at 1920x1080x40 on cuda:0
              (python -m dct3d_tpu_torch.parallel.multihost_sim); the
              6-shard dry run (dct3d_tpu_torch.parallel.dryrun); sharded
              fps beside the single-device fps of the same phase (not a
              scaling figure: one card runs every shard).
 16. bf16     the bf16 profile (compute_dtype="bfloat16"): the bf16 forms
              of K1 and K4 byte-equal to their plain versions at one 1080p
              GOP and at 200x136 (25 block columns), timed (CUDA events,
              and torch.profiler's device time) beside their bounds (phase
              3 runs before the main path; these rows take their launches
              from this phase's reference path); the 8x8x8
              parallel-sink encode and decode of the bench clip: bpp within
              0.0005 and PSNR within 0.02 dB of the JAX package's bf16
              figures (constants below; payload equality printed), GOP 0's
              ints, and the clip's GOP by GOP, against the plain CPU bf16
              quantize (which tests/test_torch_bf16.py holds to the JAX
              package's ints) and the ints of a
              (2, 3) mesh's stream against one device's, each within 10
              per million ints (cuBLAS may sum the float32 products in
              another order than the CPU and move a bf16 rounding), GOP 0's
              pixels within 1 LSB on < 1 % of the plain CPU bf16 decode,
              the bf16 stream through the f32 decoder within 0.7 dB of the
              f32 stream; turbo zlib-6 pixels equal to the bf16 reference
              decode; 4x4x4 against the JAX bf16 figures; the CLI's --dtype
              bf16 file and pixels equal to the library's, --parity
              --dtype bf16 exits 2; the device steps and the GEMMs, f32
              beside bf16 (chained CUDA events over the clip, and at GOP 0
              torch.profiler's device time), and end-to-end fps,
              alternated.

 17. deflate  GOP 0's device bytes at zlib level 9, and GOP 0's turbo
              wire plane (8,294,400 bytes) at TURBO_CFG's level 6, through
              the DEFLATE kernels: the span byte-equal to the plain
              version's, its adler32 sums right, inflating to the input;
              CUDA-event time beside host zlib at the same level on one
              thread (the yardstick) and the plain version on the CPU,
              each kernel's device time (torch.profiler), and the span's
              size against zlib's; TurboEncoder's zlib stream of the plane
              equal to the plain span's, framed with zlib's header, and
              inflating to the plane.

Each main path runs with the launch counts set to 0 just before it and read
just after; every kernel of the path must have launched, and on the 4x4x4
paths K1 and K4 (8x8x8 cubes only) must not have.  Phases 9-13, the CLI
paths of phase 14, the mesh paths of phase 15 and the bf16 paths of phase
16 (where the float32 forms of K1 and K4 must not run) each do the same.

Each phase prints one JSON line.  Any failed check raises, and the script
exits non-zero without printing a result; with no card it fails in phase 1.
The line before the last is {"kernels": [...]}, the last
{"ok": true, "device": {...}}.  Imports torch, numpy and dct3d_tpu_torch,
never jax or the JAX package.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

import dct3d_tpu_torch as port
from dct3d_tpu_torch import cli, kernels
from dct3d_tpu_torch.codec import decoder, encoder, entropy, framing, transform, turbo
from dct3d_tpu_torch.ops import (
    deflate,
    bitpack, dct, exc_pack, exceptions, expgolomb, group_pack, relayout, splice,
)
from dct3d_tpu_torch.parallel import dryrun, multihost
from dct3d_tpu_torch.parallel.mesh import make_mesh
from dct3d_tpu_torch.parallel.sharding import ShardedDecoder, ShardedEncoder

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
# The JAX CLI's default encode of the bench clip (an indexed container):
# the sha256 of its inflated payload, its index bit ends, its
# container_digest and its bpp, printed by
#   JAX_PLATFORMS=cpu python tools/jax_cli_constants.py
JAX_CLI_CONSTANTS = {
    "payload_sha256": "9dc8f711ff0bd9081c94ca0ee2e035ff72b617e34717eeda00dee430c8faa570",
    "index_ends": [20500832, 40999136, 61498870, 81998264, 102499336, 123000658, 143502960,
                   164003764],
    "digest": "07822ab3b9392f8582c1f802f6e99601be6e384b99fc7c0f61180bc0243b3393",
    "bpp": 0.3123552637924383,
}
# The device DEFLATE sink (ops/deflate.py) writes other blocks than zlib:
# its streams may be at most this many times the size of zlib-9's.
DEVICE_DEFLATE_RATIO = 1.005
# H100 SXM device memory rate (NVIDIA's data sheet), for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
# Column order of the pair-permuted encode matrix (dct.encode_matrix_pair).
PAIR = np.concatenate([np.arange(0, 512, 2), np.arange(1, 512, 2)])

# The blocks phase: 4x4x4 cubes (`encode --block 4`), parallel DEFLATE-9,
# and the turbo profile's zlib-6 wire at the same blocks.
BLOCK4 = {"block_w": 4, "block_h": 4, "block_d": 4}
BLOCK_CFG = {"deflate_workers": -1, **BLOCK4}
TURBO_BLOCK_CFG = {**TURBO_CFG, **BLOCK4}
# The bf16 phase: the fast profile (`encode --dtype bfloat16`) at 8x8x8
# and at 4x4x4, parallel DEFLATE-9.
BF16 = {"compute_dtype": "bfloat16"}
BF16_CFG = {"deflate_workers": -1, **BF16}
BF16_BLOCK_CFG = {**BLOCK_CFG, **BF16}
# The portrait screen of an iPhone 12/13/14 (Apple's display spec,
# 2532-by-1170 pixels): `--pad` edge-replicates it to 1172x2532, 293 x 633
# = 185,469 cubes per 4-frame GOP, so each GOP's batch is 46,367.25 groups
# of 256 values and packs with pack_bits (K5).
PW, PH, PT = 1170, 2532, 16
# The JAX package's content of the three 4x4x4 runs: bits per pixel and
# the sha256 of the decompressed payload (bench, portrait) or
# container_digest (turbo), printed by
#   JAX_PLATFORMS=cpu python tools/jax_block_constants.py
JAX_BLOCK_CONSTANTS = {
    "bench": {"bpp": 1.0350431013695989,
              "digest": "39ff22d6255745661c558261e265b38602b185a61e4800e2b8c755410b18aa79"},
    "portrait": {"bpp": 1.0351000369333958,
                 "digest": "80eef2a294ca4a3847387779b42e3630b2178e4340fdc5f082f2d0d7ea8a8106"},
    "turbo": {"bpp": 0.8294907100377961,
              "digest": "04832331a2c17bbb912c86abe94ed4779baf40c9eb9e6810a1556a02ad0ce7cd"},
}


# The rgb phase's clip: RGB_T frames of interleaved 1920x1080 RGB (99.5 MB).
RGB_T = 16
# The JAX package's RGB containers of rgb_clip(): encode_rgb_video(index=True)
# under RGB_CFG and encode_turbo_rgb_video under TURBO_CFG, each container's
# container_digest and bits per (RGB) pixel, printed by
#   JAX_PLATFORMS=cpu python tools/jax_rgb_constants.py
RGB_CFG = {"deflate_workers": -1}
JAX_RGB_CONSTANTS = {
    "rgb": {"bpp": 1.7330533854166668,
            "digest": "9536235582fc020cd97e9d3cd221ab7512d3aaee41d3732f310321588c564299"},
    "turbo_rgb": {"bpp": 1.730354938271605,
                  "digest": "42a72c17717a16cedcad8b47b3b47792de48908d2e2c0df2bb77ccf98d624535"},
}
# The JAX package's bf16 profile on the bench clip, at 8x8x8 under BF16_CFG
# and at 4x4x4 under BF16_BLOCK_CFG: bits per pixel, the PSNR of its bf16
# decode and the sha256 of the decompressed payload, printed by
#   JAX_PLATFORMS=cpu python tools/jax_bf16_constants.py
JAX_BF16_CONSTANTS = {
    "8x8x8": {"bpp": 0.313789966724537, "psnr_db": 32.86090146299263,
              "digest": "fb8e0b08bc091eb674f08a697c4a3bd36b10b1371a8eafba18ad5f8160fea14e"},
    "4x4x4": {"bpp": 1.0407333863811727, "psnr_db": 34.91440141041093,
              "digest": "685bd3ae2570a65e6a023cdbc800cf1ade1e7c4c9394eb7fea27577a312808e6"},
}
# Ints the card's bf16 quantize may round otherwise than the plain CPU
# version's, or a tile shard's matmul otherwise than one device's (cuBLAS
# sums the float32 products in another order, which can move a bf16
# rounding), per million.
BF16_INTS_PER_M = 10.0


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


def rgb_clip() -> np.ndarray:
    """RGB_T frames of the bench clip's content, one channel each offset by
    85 levels and XORed with noise of its own from a second seed."""
    base = synthetic_clip(RGB_T, H, W)
    rng = np.random.default_rng(777)
    out = np.empty((RGB_T, H, W, 3), np.uint8)
    for c in range(3):
        out[..., c] = (base + np.uint8(85 * c)) ^ rng.integers(0, 8, base.shape, dtype=np.uint8)
    return out


def portrait_clip() -> np.ndarray:
    """PT frames of the bench clip's content at the portrait geometry,
    edge-padded to 4x4 blocks as `encode --pad --block 4` does."""
    return port.pad_frames(synthetic_clip(PT, PH, PW), 4, 4)


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


def check_bpp(bpp: float, want: float, what: str, device_sink: bool) -> None:
    """A zlib stream's bpp within 0.0005 of ``want`` (zlib builds differ);
    a device-sink stream's at most DEVICE_DEFLATE_RATIO times it."""
    if device_sink:
        check(bpp <= want * DEVICE_DEFLATE_RATIO,
              f"{what}: bpp {bpp} over {DEVICE_DEFLATE_RATIO} x {want}")
    else:
        check(abs(bpp - want) <= 0.0005, f"{what}: bpp {bpp} vs {want}")


REF8 = ("frames_to_cubes", "group_bits", "group_pack_values", "splice", "cubes_to_frames")
# ... and the device DEFLATE sink's launch, where the encode is on the card
REF8_DEVICE_SINK = REF8 + ("deflate",)
TURBO8 = ("frames_to_cubes", "compact_groups", "plane_to_wire", "wire_to_plane",
          "cubes_to_frames")


def path_launches(name: str, want: tuple, absent: tuple = ()) -> dict:
    """The launch counts since the last clear: every kernel of `want` must
    have launched on the path, and none of `absent`."""
    got = dict(kernels.LAUNCHES)
    for k in want:
        check(got.get(k, 0) > 0, f"kernel {k} never ran on the {name} path")
    for k in absent:
        check(not got.get(k), f"kernel {k} ran on the {name} path")
    return got


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


def profiled_us(fn, reps: int = 10) -> dict:
    """Device us per call of fn after warm-up: the time torch.profiler
    records on the card (kernels, copies, fills), summed ("us", without
    the host's launch gaps), and its five largest items by name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total:
            name = e.key.removeprefix("void ")[:70]
            by_name[name] = by_name.get(name, 0.0) + e.self_device_time_total / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"us": sum(by_name.values()), "top": dict(top)}


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.cpu().double() - b.cpu().double()).abs().max())


def tensor_bytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


POISON = 0x5A5A5A5A  # pre-fill of outputs whose undefined words must stay


def stream_bytes(total_bits: int) -> int:
    """Bytes of the stream words K3 defines, [0, ceil(total_bits / 32));
    the words past them are unspecified."""
    return 4 * -(-total_bits // 32)


def check_splice(rows: torch.Tensor, sw: torch.Tensor, ge: torch.Tensor,
                 nwords: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3 launched into a poisoned stream buffer against its plain version
    on the CPU: the words it defines equal, every later word untouched.
    Returns the defined bytes of both."""
    out = torch.full((nwords,), POISON, dtype=torch.int32, device=rows.device)
    kernels.launch("splice", rows.device, rows, sw, ge, out, rows.shape[0], rows.shape[1],
                   nwords)
    n = stream_bytes(int(ge[-1]))
    want = splice.splice_plain(rows.cpu(), sw.cpu(), ge.cpu(), nwords)[:n]
    got = out.cpu()
    check(torch.equal(got.view(torch.uint8)[:n], want) and bool((got[n // 4:] == POISON).all()),
          "K3 splice differs from its plain version over the stream words it defines, "
          "or wrote past them")
    return got.view(torch.uint8)[:n], want


def add_row(rows: list, card: str, name: str, source: str, replaces: str,
            err: float, ms: float, plain_ms: float, nbytes: int,
            library_ms: float | None = None) -> None:
    """One kernel's entry of the kernels line.  nbytes: what the function
    must move at this run's inputs (each input read once, each output
    written once); its bound is those bytes at the H100's memory rate (every
    kernel here does a few integer or float operations per byte, far below
    the card's compute peaks).  library_ms: one PyTorch call that computes
    the same function, where there is one."""
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    rows.append({"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bytes": nbytes, "bound_ms": bound_ms,
                 "bound_us": bound_ms * 1e3, "bound_by": "bytes",
                 "library_ms": library_ms})
    emit(phase="kernels", kernel=name, max_abs_err=err, ms=ms,
         plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms,
         library_ms=library_ms, card=card)


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

    def row(name, source, replaces, err, ms, plain_ms, nbytes):
        add_row(rows, card, name, source, replaces, err, ms, plain_ms, nbytes)

    frames = torch.from_numpy(gop0).to(dev)
    cubes, sums = relayout.frames_to_cubes(frames)
    p_cubes, p_sums = relayout.frames_to_cubes_plain(frames.cpu())
    check(torch.equal(cubes.cpu(), p_cubes) and torch.equal(sums.cpu(), p_sums),
          "K1 frames_to_cubes differs from its plain version")
    row("frames_to_cubes", "dct3d_tpu_torch/csrc/relayout.cu",
        "dct3d_tpu/ops/relayout.py:216", max_abs_err(cubes, p_cubes),
        median_ms(lambda: relayout.frames_to_cubes(frames)),
        median_ms(lambda: relayout.frames_to_cubes_plain(frames)),
        tensor_bytes(frames, cubes, sums))

    q = transform._quantize(cubes, sums, ctx.enc_t, ctx.cfg)
    v2 = q.reshape(-1, group_pack.GROUP)
    max_width = bitpack.max_codeword_bits(ctx.cfg.cube_size)
    w_words = bitpack.worst_case_w_words(group_pack.GROUP, max_width)
    nwords = bitpack.stream_words(v2.numel(), max_width)

    def pack_pair(v2, code, bits):
        """group_bits, K2 then K3 on the card and on the CPU from identical
        inputs.  K2 defines the words of each row that hold its group's
        bits, exactly those K3 reads, and leaves the rest unwritten: the
        comparison covers those words (`defined`)."""
        code = torch.tensor(code, dtype=torch.int64, device=dev)
        bits = torch.tensor(bits, dtype=torch.int64, device=dev)
        gb = group_pack.group_bits(v2)
        check(torch.equal(gb.cpu(), group_pack.group_bits_plain(v2.cpu())),
              "group_bits differs from its plain version")
        gstart, gend = bitpack.geometry(v2, bits)
        phase = (gstart & 31).to(torch.int32)
        k2 = group_pack.group_pack_values(v2, phase, w_words)
        p2 = group_pack.group_pack_values_plain(v2.cpu(), phase.cpu(), w_words)
        sw, ge = (gstart >> 5).to(torch.int32), gend.to(torch.int32)
        nw = (((ge - 1) >> 5) - sw + 1).cpu()  # K3's count of words read
        defined = torch.arange(w_words)[None, :] < nw[:, None]
        check(torch.equal(k2.cpu()[defined], p2[defined]),
              "K2 group_pack_values differs from its plain version")
        bitpack.or_carry_lead(k2, code, bits)
        k3, p3 = check_splice(k2, sw, ge, nwords)
        return gb, phase, k2, sw, ge, k3, p2, p3, defined, int(nw.sum())

    gb, phase, k2, sw, ge, k3, p2, p3, defined, content = pack_pair(v2, 0, 0)
    row("group_bits", "dct3d_tpu_torch/csrc/group_pack.cu",
        "dct3d_tpu/ops/bitpack.py:255", max_abs_err(gb, group_pack.group_bits_plain(v2.cpu())),
        median_ms(lambda: group_pack.group_bits(v2)),
        median_ms(lambda: group_pack.group_bits_plain(v2)), tensor_bytes(v2, gb))
    row("group_pack_values", "dct3d_tpu_torch/csrc/group_pack.cu",
        "dct3d_tpu/ops/group_pack.py:125", max_abs_err(k2.cpu()[defined], p2[defined]),
        median_ms(lambda: group_pack.group_pack_values(v2, phase, w_words)),
        median_ms(lambda: group_pack.group_pack_values_plain(v2, phase, w_words)),
        tensor_bytes(v2, phase) + 4 * content)
    row("splice", "dct3d_tpu_torch/csrc/splice.cu", "dct3d_tpu/ops/splice.py:129",
        max_abs_err(k3, p3),
        median_ms(lambda: splice.splice(k2, sw, ge, nwords)),
        median_ms(lambda: splice.splice_plain(k2, sw, ge, nwords)),
        4 * content + tensor_bytes(sw, ge) + stream_bytes(int(ge[-1])))

    # Adversarial bit pack: every codeword up to the 27-bit bound, carries
    # 1..7 with random carry codes, over one GOP's shape; then group counts
    # that leave a partial block of eight groups (64,801 and 1).
    rng = np.random.default_rng(7)
    bound = 5770
    for bits in range(1, 8):
        vals = rng.integers(-bound, bound + 1, v2.shape, dtype=np.int32)
        vals[rng.random(v2.shape) < 0.1] = bound * rng.choice([-1, 1])
        adv = torch.from_numpy(vals).to(dev)
        pack_pair(adv, int(rng.integers(0, 1 << bits)), bits)
    pack_pair(torch.cat([v2, adv[:1]]), 5, 3)
    pack_pair(adv[:1].clone(), 1, 1)
    emit(phase="kernels", adversarial="group_bits+K2+K3 byte-equal (K3 over the stream "
         "words it defines, poisoned past them), |v|<=5770, carries 1..7; 64,801 and 1 groups")

    pixels = transform._dequant_matmul(
        v2.reshape(q.shape[0], -1, 2)[..., 0], v2.reshape(q.shape[0], -1, 2)[..., 1],
        ctx.dec_me, ctx.dec_mo)
    k4 = relayout.cubes_to_frames(pixels, H, W)
    p4 = relayout.cubes_to_frames_plain(pixels.cpu(), H, W)
    check(torch.equal(k4.cpu(), p4), "K4 cubes_to_frames differs from its plain version")
    row("cubes_to_frames", "dct3d_tpu_torch/csrc/relayout.cu",
        "dct3d_tpu/ops/relayout.py:258", max_abs_err(k4, p4),
        median_ms(lambda: relayout.cubes_to_frames(pixels, H, W)),
        median_ms(lambda: relayout.cubes_to_frames_plain(pixels, H, W)),
        tensor_bytes(pixels, k4))
    return rows


def deflate_case(card: str, data: torch.Tensor, nbits: torch.Tensor, level: int,
                 **extra) -> tuple[np.ndarray, int, int]:
    """One input through ops/deflate.py at ``level``: the span byte-equal
    to the plain version's on the CPU, inflating to the input, its adler32
    sums right; CUDA-event time beside host zlib at the same level on one
    thread (the yardstick) and the plain version's time; each kernel's
    device time; the span's size against zlib's.  Returns the span and
    its sums."""
    n = int(nbits) // 8
    raw = data[:n].cpu().numpy()
    ws = deflate.Workspace(data.numel(), data.device)
    out, info = deflate.deflate(data, nbits, level, ws)
    torch.cuda.synchronize()
    info = info.cpu().tolist()
    span = out[: info[deflate.I_OUT_BYTES]].cpu().numpy()
    t0 = time.perf_counter()
    want, s1, s2 = deflate.deflate_plain(raw, level)
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(span, want), "the DEFLATE kernels' span differs from the plain version's")
    check(info[deflate.I_S1] == s1 and info[deflate.I_S2] == s2
          and deflate.adler32_of(s1, s2, n) == zlib.adler32(raw.tobytes()),
          "the DEFLATE kernels' adler32 sums are wrong")
    check(zlib.decompressobj(-zlib.MAX_WBITS).decompress(span.tobytes()) == raw.tobytes(),
          "the DEFLATE span does not inflate to the input's bytes")
    ms = median_ms(lambda: deflate.deflate(data, nbits, level, ws))
    zlib_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        co = zlib.compressobj(level, zlib.DEFLATED, -zlib.MAX_WBITS)
        zdata = co.compress(raw.tobytes()) + co.flush(zlib.Z_FULL_FLUSH)
        zlib_ms.append((time.perf_counter() - t0) * 1e3)
    zlib_ms = statistics.median(zlib_ms)
    dev = profiled_us(lambda: deflate.deflate(data, nbits, level, ws), reps=5)
    z = f"zlib{level}"
    emit(phase="deflate", card=card, level=level, **extra, input_bytes=n,
         span_bytes=len(span), **{f"{z}_bytes": len(zdata)},
         **{f"size_vs_{z}": len(span) / len(zdata)},
         symbols=info[deflate.I_SYMBOLS], blocks=info[deflate.I_BLOCKS],
         event_ms=ms, **{f"{z}_ms": zlib_ms}, plain_ms=plain_ms,
         **{f"{z}_over_kernels": zlib_ms / ms}, plain_over_kernels=plain_ms / ms,
         device_us=dev["us"], device_top=dev["top"])
    return span, s1, s2


def phase_deflate(gop0: np.ndarray, ctx, card: str) -> None:
    """deflate_case on GOP 0's device bytes (encode_step, as the encoder's
    drainer gets them) at the configuration's zlib level, and on GOP 0's
    turbo wire plane (encode_step_turbo, as TurboEncoder's drain workers
    get it) at TURBO_CFG's level; the drain's driver (``deflate.Deflater``)
    and framing (``zlib_stream``) of that plane equal to the plain span's
    zlib stream, with zlib.compress's header, and inflating to the plane."""
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    frames = torch.from_numpy(gop0).to("cuda")
    step = transform.encode_step(frames, ctx, zero, zero.clone())
    deflate_case(card, step.packed, step.total_bits, ctx.cfg.zlib_level, input="gop_bytes")

    tcfg = port.CodecConfig(**TURBO_CFG)
    plane = turbo.encode_step_turbo(frames, port.TransformContext(tcfg, "cuda"),
                                    wire=True).plane
    flat = plane.reshape(-1)
    n = flat.numel()
    level = tcfg.zlib_level
    span, s1, s2 = deflate_case(card, flat, torch.tensor(8 * n, device="cuda"), level,
                                input="turbo_wire_plane")
    driver = deflate.Deflater(level)
    got, total, d1, d2, _ = driver(flat, torch.tensor(8 * n, device="cuda"))
    stream = deflate.zlib_stream(got, level, d1, d2, total // 8)
    raw = flat.cpu().numpy().tobytes()
    check(stream == deflate.zlib_stream(span.tobytes(), level, s1, s2, n)
          and stream[:2] == zlib.compress(raw[:64], level)[:2]
          and zlib.decompress(stream) == raw,
          "the driver's plane stream is not the plain span's zlib stream")
    emit(phase="deflate", input="turbo_wire_plane", encoder_stream_equals_plain=True,
         stream_bytes=len(stream), deflate_stage_calls=driver.timer.calls.get("deflate"))


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
    # Group counts that leave a partial block of eight groups (the GOP plus
    # one group, and one group) at slots 1..256 and DC strides of none, two
    # powers of two and one that is not.
    ragged = torch.cat([v2, v2[-1:]])
    for slots in (1, 16, 255, 256):
        for dc_stride in (0, 512, 64, 96):
            err = max(err, k6(ragged, slots, dc_stride), k6(v2[:1].clone(), slots, dc_stride))
    emit(phase="kernels", ragged=f"K6 byte-equal at {ragged.shape[0]} and 1 groups, "
         "slots 1/16/255/256, dc_stride 0/512/64/96")
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
            median_ms(lambda: exc_pack.compact_groups_plain(v2, 16, 512)),
            tensor_bytes(v2, *exc_pack.compact_groups(v2, 16, 512)))

    plane = turbo._plane_and_tables(qp, 16).plane.reshape(-1, 256)
    wire = relayout.plane_to_wire(plane)
    p_wire = relayout.plane_to_wire_plain(plane.cpu())
    check(torch.equal(wire.cpu(), p_wire), "K7 plane_to_wire differs from its plain version")
    # The library call for K7 and K8 is their plain version itself, one
    # transpose made contiguous; timed again here as the yardstick.
    add_row(rows, card, "plane_to_wire", "dct3d_tpu_torch/csrc/wire.cu",
            "dct3d_tpu/ops/relayout.py:97", max_abs_err(wire, p_wire),
            median_ms(lambda: relayout.plane_to_wire(plane)),
            median_ms(lambda: relayout.plane_to_wire_plain(plane)),
            tensor_bytes(plane, wire), median_ms(lambda: plane.t().contiguous()))
    back = relayout.wire_to_plane(wire)
    p_back = relayout.wire_to_plane_plain(wire.cpu())
    check(torch.equal(back.cpu(), p_back), "K8 wire_to_plane differs from its plain version")
    check(torch.equal(back, plane), "K7 then K8 does not give the plane back")
    add_row(rows, card, "wire_to_plane", "dct3d_tpu_torch/csrc/wire.cu",
            "dct3d_tpu/ops/relayout.py:146", max_abs_err(back, p_back),
            median_ms(lambda: relayout.wire_to_plane(wire)),
            median_ms(lambda: relayout.wire_to_plane_plain(wire)),
            tensor_bytes(wire, back), median_ms(lambda: wire.t().contiguous()))
    return rows


def phase_k5_kernels(gop: np.ndarray, ctx, card: str) -> list[dict]:
    """K5, and pack_bits (K5 + K3), on the card against their plain
    versions on the CPU at one padded-portrait 4x4x4 GOP's shapes (46,368
    groups, w_words 186), plus adversarial batches."""
    dev = ctx.device
    rows = []
    q = transform.quantize_step(torch.from_numpy(gop).to(dev), ctx).reshape(-1)
    max_width = bitpack.max_codeword_bits(ctx.cfg.cube_size)
    w_words = bitpack.worst_case_w_words(group_pack.GROUP, max_width)
    rng = np.random.default_rng(9)

    def with_carry(n: int, bits: int):
        """The first n codewords of the GOP after a carry pseudo-codeword
        of `bits` bits, as encode_step builds them."""
        code, width = expgolomb.codewords(q[:n])
        lead = torch.tensor([int(rng.integers(0, 1 << bits)), bits], device=dev)
        return torch.cat([lead[:1], code]), torch.cat([lead[1:], width])

    def k5(code2, wid2, phase, w):
        """K5 into a poisoned output: words [0, nw) of each row equal the
        plain version's, the rest untouched.  Returns the error and the
        count of defined words."""
        out = torch.full((code2.shape[0], w), POISON, dtype=torch.int32, device=dev)
        kernels.launch("group_pack_codes", dev, code2, wid2, phase, out, code2.shape[0], w)
        want = group_pack.group_pack_codes_plain(code2.cpu(), wid2.cpu(), phase.cpu(), w)
        nw = ((phase.cpu().to(torch.int64) + wid2.cpu().sum(1, dtype=torch.int64) + 31)
              >> 5).clamp(max=w)
        defined = torch.arange(w)[None, :] < nw[:, None]
        got = out.cpu()
        check(torch.equal(got[defined], want[defined]) and bool((got[~defined] == POISON).all()),
              "K5 group_pack_codes differs from its plain version over words [0, nw), "
              "or wrote past them")
        return max_abs_err(got[defined], want[defined]), int(nw.sum())

    def pack_bits(code, width):
        got = bitpack.pack_bits(code, width, max_width)
        want = bitpack.pack_bits(code.cpu(), width.cpu(), max_width)
        n = stream_bytes(int(want[1]))
        check(torch.equal(got[0].cpu()[:n], want[0][:n]) and int(got[1]) == int(want[1])
              and int(got[2]) == int(want[2]),
              f"pack_bits (K5 + K3) differs from its plain route at n {code.numel()}")

    code, width = with_carry(q.numel(), 0)
    code2, wid2 = expgolomb.grouped(code, width)
    gbits = wid2.sum(1, dtype=torch.int64)
    phase = ((torch.cumsum(gbits, 0) - gbits) & 31).to(torch.int32)
    n = code.numel()
    check(n % 256 and int((wid2[-1] > 0).sum()) == n % 256,
          "the portrait GOP's batch does not end in a partial group")
    emit(phase="kernels", k5_groups=code2.shape[0], w_words=w_words,
         last_group_codewords=n % 256, card=card)
    err, content = k5(code2, wid2, phase, w_words)
    pack_bits(code, width)
    # Adversarial: random 32-bit codes with every width 0..32 at every
    # phase (kept rows and rows that drop bits past word 33); carries of
    # 0..7 bits before batches of n codewords; a whole trailing group of
    # zero-width slots at a phase that is not word-aligned (K3 ORs its zero
    # word 0 into the stream's last word) and at one that is (K3 reads
    # nothing of it).
    g = 33 * 32
    wid = rng.integers(0, 33, (g, 256)).astype(np.int32)
    wid[:, :33] = (np.arange(33)[None, :] + np.arange(g)[:, None]) % 33
    raw = rng.integers(0, 1 << 32, (g, 256), dtype=np.uint64).astype(np.uint32).view(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (raw, wid, (np.arange(g) % 32).astype(np.int32))]
    err = max(err, k5(*args, 258)[0], k5(*args, 34)[0])
    for n in (1, 255, 256, 257, 70_001):
        for bits in range(8):
            pack_bits(*with_carry(n, bits))
    pad = torch.zeros(300, dtype=torch.int64, device=dev)
    for aligned in (False, True):  # the trailing zero group's phase
        for n in range(300, 2300):
            code, width = with_carry(n, 5)
            if (int(width.sum()) % 32 == 0) == aligned:
                break
        check((int(width.sum()) % 32 == 0) == aligned, "no trailing zero group geometry")
        pack_bits(torch.cat([code, pad]), torch.cat([width, pad]))
    emit(phase="kernels", adversarial="K5 byte-equal over words [0, nw) on widths 0..32 at "
         "every phase, poisoned past them; pack_bits byte-equal over the stream words at n "
         "1/255/256/257/70001 after carries 0..7 and with a trailing zero-width group at an "
         "unaligned and an aligned phase", card=card)
    add_row(rows, card, "group_pack_codes", "dct3d_tpu_torch/csrc/group_pack.cu",
            "dct3d_tpu/ops/group_pack.py:159", err,
            median_ms(lambda: group_pack.group_pack_codes(code2, wid2, phase, w_words)),
            median_ms(lambda: group_pack.group_pack_codes_plain(code2, wid2, phase, w_words)),
            tensor_bytes(code2, wid2, phase) + 4 * content)
    return rows


def container_digest(data: bytes) -> str:
    """sha256 over each member's frame count and type and its payload's
    decompressed streams (an index member's: its v1 bit ends, as uint64 LE;
    its v2 sync offsets depend on the compressor), so it does not depend on
    the compressor's build."""
    h = hashlib.sha256()
    for t, payload, mtype in multihost.split_members(data):
        h.update(struct.pack("<II", t, mtype))
        if mtype in (turbo.MEMBER_TURBO, *turbo.MEMBER_TURBO_RGB):
            o = 16
            for n in struct.unpack_from("<IIII", payload, 0):
                h.update(turbo._decompress(payload[o : o + n]))
                o += n
        elif mtype == multihost.MEMBER_INDEX:
            ends = multihost.parse_index(payload)
            check(ends is not None, "a torn index member")
            h.update(struct.pack(f"<{len(ends)}Q", *ends))
        else:
            h.update(zlib.decompress(payload))
    return h.hexdigest()


def member_streams(member: bytes) -> tuple:
    """A container's first member: its frame count, type and (for a turbo
    member) its four streams inflated, the card's plane stream being valid
    zlib but not zlib's bytes."""
    t, payload, mtype = multihost.split_members(member)[0]
    if mtype != turbo.MEMBER_TURBO:
        return t, mtype, payload
    o, raw = 16, []
    for n in struct.unpack_from("<IIII", payload, 0):
        raw.append(zlib.decompress(payload[o : o + n]))
        o += n
    return (t, mtype, *raw)


def turbo_gop0(gop0: np.ndarray, ctx, data: bytes) -> dict:
    """GOP 0: turbo ints equal quantize_step's in pair order on the card;
    the card's member carries the streams the plain CPU versions build
    from the card's ints; against the whole plain CPU path from the same
    frames, every differing int lies within 1e-3 of a rounding tie."""
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
    card_streams = member_streams(card_member)
    check(member_streams(plain) == card_streams,
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
    same = member_streams(cpu_member) == card_streams
    check(same == (not diff.any()),
          "GOP 0's member vs the plain CPU path disagrees with their ints")
    return {"gop0_streams_equal_plain_on_card_ints": True,
            "gop0_streams_equal_cpu_path": same,
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


def quant_flips(gop0: np.ndarray, ctx, ties_allowed: bool = False) -> dict:
    """Port's quantized ints of GOP 0 against float64 on the card (the
    oracle's math: cubes @ E in float64, round half away from zero).

    ties_allowed: AC flips whose float64 value lies within 1e-3 of a
    rounding tie are counted apart and not bounded.  Small cubes make exact
    ties common (many 4x4x4 coefficients are exact multiples of 1/2), and
    there float32 and float64 round as their sums fall."""
    frames = torch.from_numpy(gop0).to(ctx.device)
    q = transform.quantize_step(frames, ctx)
    enc64 = torch.from_numpy(dct.encode_matrix(ctx.cfg, np.float64)).to(ctx.device)
    x = framing.frames_to_cubes(frames, ctx.cfg).double() @ enc64
    ref = torch.trunc(x + torch.copysign(x.new_full((), 0.5), x)).to(torch.int32)
    diff = q != ref
    at_tie = diff & (((x.abs() % 1) - 0.5).abs() < 1e-3)
    dc, ac = int(diff[:, 0].sum()), int(diff[:, 1:].sum())
    ac_ties = int(at_tie[:, 1:].sum()) if ties_allowed else 0
    per_m = 1e6 * (ac - ac_ties) / diff[:, 1:].numel()
    check(dc == 0, f"{dc} DC flips against float64")
    check(per_m <= 1.0, f"{ac - ac_ties} AC flips against float64 ({per_m:.3f} per 1M)")
    return {"coefficients": diff.numel(), "dc_flips": dc, "ac_flips": ac,
            "ac_flips_at_ties": int(at_tie[:, 1:].sum()), "ac_flips_per_1m": per_m}


def encode_clip(clip: np.ndarray, cfg, ctx):
    """encode_video's body, keeping the encoder's index."""
    enc = port.StreamingEncoder(clip.shape[2], clip.shape[1], cfg, ctx)
    data = enc.push(clip) + enc.finish()
    return data, enc.gop_bit_ends, enc.gop_sync_offsets


def stream_ints(data: bytes, n: int) -> np.ndarray:
    """The n quantized ints a reference-profile stream carries (the C
    decoder's nibble plane with its exceptions put back)."""
    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    plane, idx, val, _ = entropy.decode_values_planar4(raw, n)
    ints = np.stack([(plane & 0xF).astype(np.int32), (plane >> 4).astype(np.int32)], 1)
    ints = ((ints ^ 8) - 8).reshape(-1)
    ints[idx] = val
    return ints


def card_ints(clip: np.ndarray, ctx) -> torch.Tensor:
    """The card's quantized ints of a clip, GOP by GOP, on the CPU."""
    gop = ctx.cfg.gop_size
    return torch.cat([transform.quantize_step(torch.from_numpy(clip[g : g + gop]).to(ctx.device),
                                              ctx).cpu() for g in range(0, len(clip), gop)])


def ties_only(clip: np.ndarray, ctx, q: torch.Tensor) -> dict:
    """Ints of q that differ from float64 on the card (the oracle's math),
    and the largest distance of any of them from a rounding tie."""
    frames = torch.from_numpy(clip).to(ctx.device)
    enc64 = torch.from_numpy(dct.encode_matrix(ctx.cfg, np.float64)).to(ctx.device)
    x = framing.frames_to_cubes(frames, ctx.cfg).double() @ enc64
    ref = torch.trunc(x + torch.copysign(x.new_full((), 0.5), x)).to(torch.int32)
    diff = q.to(ctx.device) != ref
    worst = float(((x.abs() % 1) - 0.5).abs()[diff].max()) if diff.any() else 0.0
    return {"ints_differing_from_float64": int(diff.sum()), "worst_distance_from_tie": worst}


def plain_payload(q: torch.Tensor, gops: int, cfg) -> bytes:
    """The Exp-Golomb payload that pack_bits' plain route builds on the CPU
    from the card's ints q of `gops` GOPs, GOP by GOP, with the carry
    chained as encode_step chains it."""
    sink = entropy.DeflateSink(1)
    max_width = bitpack.max_codeword_bits(cfg.cube_size)
    carry = (torch.tensor(0), torch.tensor(0))
    out = []
    for qg in q.chunk(gops):
        code, width = expgolomb.codewords(qg.reshape(-1))
        buf, total, tail, _ = bitpack.pack_bits(
            torch.cat([carry[0].reshape(1), code]), torch.cat([carry[1].reshape(1), width]),
            max_width)
        rem = total % 8
        carry = (torch.where(rem > 0, tail >> (8 - rem), 0), rem)
        out.append(sink.push_packed(buf[: int(total) // 8 + 1].numpy(), int(total)))
    return zlib.decompress(b"".join(out) + sink.finish())


def content_vs_jax(run: str, digest: str, bpp: float, clip, ctx, q,
                   device_sink: bool) -> dict:
    """The run's content against the JAX package's (JAX_BLOCK_CONSTANTS):
    the digest exactly, bpp by check_bpp.  The card's
    ints also differ from float64 only at rounding ties: 4x4x4 makes exact
    ties common, and cuBLAS rounds them as XLA on the CPU does."""
    want = JAX_BLOCK_CONSTANTS[run]
    check(digest == want["digest"], f"{run}: content differs from the JAX package's")
    check_bpp(bpp, want["bpp"], f"{run} vs JAX", device_sink)
    ties = ties_only(clip, ctx, q)
    check(ties["worst_distance_from_tie"] < 1e-3,
          f"{run}: ints differ from float64 off a rounding tie: {ties}")
    return {"digest_equals_jax": True, "jax_bpp": want["bpp"], **ties}


def _timed(fn) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def best_of_3(first_s: float, fn) -> float:
    """Best of a first end-to-end run's seconds and two more runs of fn."""
    return min([first_s] + [_timed(fn) for _ in range(2)])


def turbo_device_ms(frames_dev: torch.Tensor, ctx, data: bytes, w: int,
                    h: int) -> tuple[float, float]:
    """Median CUDA-event ms of the turbo profile's device steps over a clip:
    encode_step_turbo GOP by GOP on resident frames, and K8 plus
    planar4_to_frames on members parsed and uploaded beforehand."""
    gop = ctx.cfg.gop_size

    def encode_device():
        for g in range(0, frames_dev.shape[0], gop):
            turbo.encode_step_turbo(frames_dev[g : g + gop], ctx, wire=True)

    planes = [[torch.from_numpy(np.array(a)).to(frames_dev.device)
               for a in turbo._parse_payload(payload, ctx.cfg.cube_size, True, True)]
              for _, payload, _ in multihost.split_members(data)]

    def decode_device():
        for wire, dc, ei, ev in planes:
            transform.planar4_to_frames(relayout.wire_to_plane(wire).reshape(-1),
                                        ei, ev, dc, ctx, h, w)

    return median_ms(encode_device, reps=5), median_ms(decode_device, reps=5)


def uploaded_planes(data: bytes, positions: list[int], ctx, w: int, h: int) -> list:
    """Each GOP's planar4_to_frames inputs (nibble plane, exception
    indices and values, dense DC) of a reference-profile stream, decoded on
    the host and uploaded to ctx.device."""
    raw = np.frombuffer(zlib.decompress(data), np.uint8)
    planes = []
    for p in positions:
        plane, ei, ev, _ = entropy.decode_values_planar4(raw, w * h * ctx.cfg.gop_size, p)
        dc, ei, ev = decoder._split_dc_flat(plane, ei, ev, ctx.cfg.cube_size)
        planes.append([torch.from_numpy(a).to(ctx.device)
                       for a in (plane, ei.astype(np.int64), ev, dc)])
    return planes


def device_ms(frames_dev: torch.Tensor, ctx, data: bytes, positions: list[int],
              w: int, h: int) -> tuple[float, float]:
    """Median CUDA-event ms of the reference profile's device steps over a
    clip: encode_step GOP by GOP on resident frames (carry chained), and
    planar4_to_frames on planes decoded and uploaded beforehand."""
    zero = torch.zeros((), dtype=torch.int64, device=frames_dev.device)
    gop = ctx.cfg.gop_size

    def encode_device():
        carry = (zero, zero)
        for g in range(0, frames_dev.shape[0], gop):
            step = transform.encode_step(frames_dev[g : g + gop], ctx, *carry)
            carry = (step.carry_code, step.carry_bits)

    planes = uploaded_planes(data, positions, ctx, w, h)

    def decode_device():
        for pl in planes:
            transform.planar4_to_frames(*pl, ctx, h, w)

    return median_ms(encode_device, reps=5), median_ms(decode_device, reps=5)


def phase_blocks(clip: np.ndarray, smi: str) -> tuple[dict[str, int], np.ndarray]:
    """The 4x4x4 paths through the public entry points, each with the
    launch counts set to 0 before it and read after it:

      1. the bench clip (1920x1080, 64 frames = 16 GOPs): parallel-sink
         encode and indexed decode; whole groups, so K2 + K3 and no K5;
      2. portrait_clip() (1172x2532 padded, 16 frames): encode, decode,
         range decode, crop; no batch is whole groups, so K5 + K3 and no K2;
      3. turbo (zlib-6 wire) on the same padded clip: K6 with a partial
         last group, K7/K8 at hc 32 and an odd cube count.

    K1 and K4 cover 8x8x8 cubes only and must not run.  Returns run 2's
    launch counts (K5's row) and its cropped pixels."""
    cfg = port.CodecConfig(**BLOCK_CFG)
    ctx = port.TransformContext(cfg, "cuda")

    def launched(path: str, want: tuple, absent: tuple) -> dict:
        return path_launches(f"4x4x4 {path}", want,
                             absent + ("frames_to_cubes", "cubes_to_frames"))

    # 1. The bench clip.
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    data, ends, syncs = encode_clip(clip, cfg, ctx)
    enc_s = time.perf_counter() - t0
    positions = [0] + ends[:-1]
    t0 = time.perf_counter()
    out = port.decode_video(data, W, H, T, cfg, ctx, positions=positions, sync_offsets=syncs)
    dec_s = time.perf_counter() - t0
    got = launched("bench", ("group_bits", "group_pack_values", "splice"), ("group_pack_codes",))
    q = card_ints(clip, ctx)
    check(np.array_equal(stream_ints(data, clip.size), q.reshape(-1).numpy()),
          "the 4x4x4 bench stream does not carry the card's ints")
    flips = quant_flips(clip[:4], ctx, ties_allowed=True)
    cpu_gop0 = port.decode_frame_range(data, W, H, 0, 4, cfg, device="cpu", positions=positions)
    d = np.abs(out[:4].astype(np.int16) - cpu_gop0)
    mismatch = float((d > 0).mean())
    check(int(d.max()) <= 1 and mismatch < 0.01,
          f"4x4x4 GPU decode vs plain CPU decode: max {int(d.max())}, rate {mismatch}")
    bpp = port.bits_per_pixel(len(data), W, H, T)
    emit(phase="blocks", run="bench", card=smi, bytes=len(data), launches=got, bpp=bpp,
         psnr_db=port.psnr(clip, out), gop0_max_abs_diff=int(d.max()),
         gop0_mismatch_rate=mismatch, **flips,
         **content_vs_jax("bench", hashlib.sha256(zlib.decompress(data)).hexdigest(),
                          bpp, clip, ctx, q, device_sink=True))
    enc_s = best_of_3(enc_s, lambda: encode_clip(clip, cfg, ctx))
    dec_s = best_of_3(dec_s, lambda: port.decode_video(
        data, W, H, T, cfg, ctx, positions=positions, sync_offsets=syncs))
    frames_dev = torch.from_numpy(clip).to("cuda")
    enc_ms, dec_ms = device_ms(frames_dev, ctx, data, positions, W, H)
    del frames_dev
    timing = {"bench_encode_fps": T / enc_s, "bench_decode_fps": T / dec_s,
              "bench_encode_device_fps": T / (enc_ms / 1e3),
              "bench_decode_device_fps": T / (dec_ms / 1e3)}

    # 2. The padded portrait clip.
    src = synthetic_clip(PT, PH, PW)
    padded = portrait_clip()
    ph, pw = padded.shape[1:]
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    pdata, ends, syncs = encode_clip(padded, cfg, ctx)
    enc_s = time.perf_counter() - t0
    positions = [0] + ends[:-1]
    t0 = time.perf_counter()
    pout = port.decode_video(pdata, pw, ph, PT, cfg, ctx, positions=positions,
                             sync_offsets=syncs)
    dec_s = time.perf_counter() - t0
    prange = port.decode_frame_range(pdata, pw, ph, 5, 11, cfg, ctx, positions=positions,
                                     sync_offsets=syncs)
    cropped = port.crop_frames(pout, PW, PH)
    k5_launches = launched("portrait", ("group_pack_codes", "splice"),
                           ("group_bits", "group_pack_values"))
    check(np.array_equal(prange, pout[5:11]), "4x4x4 decode_frame_range differs from the slice")
    check(cropped.shape == src.shape, f"cropped frames {cropped.shape} vs {src.shape}")
    q = card_ints(padded, ctx)
    check(zlib.decompress(pdata) == plain_payload(q, PT // cfg.gop_size, cfg),
          "the portrait stream differs from pack_bits' plain route on the card's ints")
    bpp = port.bits_per_pixel(len(pdata), pw, ph, PT)
    emit(phase="blocks", run="portrait", card=smi, bytes=len(pdata), launches=k5_launches,
         bpp=bpp, psnr_db=port.psnr(src, cropped), range_equals_slice=True,
         stream_equals_plain_route=True,
         **content_vs_jax("portrait", hashlib.sha256(zlib.decompress(pdata)).hexdigest(),
                          bpp, padded, ctx, q, device_sink=True))
    enc_s = best_of_3(enc_s, lambda: encode_clip(padded, cfg, ctx))
    dec_s = best_of_3(dec_s, lambda: port.decode_video(
        pdata, pw, ph, PT, cfg, ctx, positions=positions, sync_offsets=syncs))
    frames_dev = torch.from_numpy(padded).to("cuda")
    enc_ms, dec_ms = device_ms(frames_dev, ctx, pdata, positions, pw, ph)
    timing.update(portrait_encode_fps=PT / enc_s, portrait_decode_fps=PT / dec_s,
                  portrait_encode_device_fps=PT / (enc_ms / 1e3),
                  portrait_decode_device_fps=PT / (dec_ms / 1e3))

    # 3. Turbo on the padded clip.
    tcfg = port.CodecConfig(**TURBO_BLOCK_CFG)
    tctx = port.TransformContext(tcfg, "cuda")
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    tdata = port.encode_turbo_video(padded, tcfg, tctx)
    tenc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tout = port.decode_turbo_container(tdata, pw, ph, tcfg, tctx)
    tdec_s = time.perf_counter() - t0
    trange = port.decode_turbo_range(tdata, pw, ph, 5, 11, tcfg, tctx)
    got = launched("turbo", ("compact_groups", "plane_to_wire", "wire_to_plane"),
                   ("group_bits", "group_pack_values", "group_pack_codes", "splice"))
    members = multihost.split_members(tdata)
    check([m[2] for m in members] == [turbo.MEMBER_TURBO] * (PT // 4),
          "4x4x4 turbo: not one turbo member per GOP")
    check(np.array_equal(tout, pout), "4x4x4 turbo pixels differ from the reference decode")
    check(np.array_equal(trange, tout[5:11]), "4x4x4 decode_turbo_range differs from the slice")
    tbpp = port.bits_per_pixel(len(tdata), pw, ph, PT)
    emit(phase="blocks", run="turbo", card=smi, bytes=len(tdata), launches=got, bpp=tbpp,
         pixels_equal_reference=True, range_equals_slice=True,
         **content_vs_jax("turbo", container_digest(tdata), tbpp, padded, ctx, q,
                          device_sink=True))

    tenc_s = best_of_3(tenc_s, lambda: port.encode_turbo_video(padded, tcfg, tctx))
    tdec_s = best_of_3(tdec_s, lambda: port.decode_turbo_container(tdata, pw, ph, tcfg, tctx))
    enc_ms, dec_ms = turbo_device_ms(frames_dev, tctx, tdata, pw, ph)
    timing.update(turbo_encode_fps=PT / tenc_s, turbo_decode_fps=PT / tdec_s,
                  turbo_encode_device_fps=PT / (enc_ms / 1e3),
                  turbo_decode_device_fps=PT / (dec_ms / 1e3))
    emit(phase="blocks_timing", card=smi, **timing)
    return k5_launches, cropped


def phase_delta(clip: np.ndarray, lib: dict, smi: str) -> None:
    """transport_delta under bench.py's speed profile (bench.py:76-77):
    the stream, bit ends and sync offsets of the plain parallel-sink encode,
    the plain pixels, and the turbo container's content; encode fps with
    and without the delta, alternated in this run; the device's rebuild
    scan and delta emission per GOP, and the host's subtract."""
    cfg = port.CodecConfig(deflate_workers=-1, pack_bits_per_value=4, transport_delta=True)
    ctx = port.TransformContext(cfg, "cuda")
    tcfg = port.CodecConfig(**TURBO_CFG, transport_delta=True)
    tctx = port.TransformContext(tcfg, "cuda")
    kernels.LAUNCHES.clear()
    data, ends, syncs = encode_clip(clip, cfg, ctx)
    out = port.decode_video(data, W, H, T, cfg, ctx, positions=[0] + ends[:-1],
                            sync_offsets=syncs)
    tdata = port.encode_turbo_video(clip, tcfg, tctx)
    tout = port.decode_turbo_container(tdata, W, H, tcfg, tctx)
    launches = path_launches("delta", REF8 + TURBO8)
    check(data == lib["par"] and ends == lib["ends"] and syncs == lib["syncs"],
          "the delta encode's stream, bit ends or syncs differ from the plain encode's")
    check(np.array_equal(out, lib["out_par"]), "delta decode pixels differ from the plain decode")
    check(container_digest(tdata) == JAX_TURBO_DIGEST,
          "the delta turbo container differs from the JAX package's")
    check(np.array_equal(tout, lib["out_par"]), "delta turbo pixels differ from the plain decode")
    # Encode fps, plain and delta alternated, best of 3 each.
    plain_cfg = port.CodecConfig(deflate_workers=-1)
    plain_ctx = port.TransformContext(plain_cfg, "cuda")
    times = {"plain": [], "delta": []}
    for _ in range(3):
        times["plain"].append(_timed(lambda: encode_clip(clip, plain_cfg, plain_ctx)))
        times["delta"].append(_timed(lambda: encode_clip(clip, cfg, ctx)))
    gop = torch.from_numpy(clip[:8]).to("cuda")
    scan_ms = median_ms(lambda: transform._undelta_frames(gop, cfg))
    pixels = torch.rand((W * H * 8 // 512, 512), device="cuda") * 255
    emit_ms = (median_ms(lambda: transform._finish_frames(pixels, cfg, H, W))
               - median_ms(lambda: transform._finish_frames(pixels, plain_cfg, H, W)))
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        encoder._deltas(clip[:8])
        host.append(time.perf_counter() - t0)
    emit(phase="delta", card=smi, launches=launches, stream_equals_plain=True,
         pixels_equal_plain=True, turbo_digest_equals_jax=True, turbo_pixels_equal_plain=True,
         encode_fps=T / min(times["plain"]), delta_encode_fps=T / min(times["delta"]),
         delta_scan_us_per_gop=scan_ms * 1e3, delta_emit_us_per_gop=emit_ms * 1e3,
         host_subtract_ms_per_gop=statistics.median(host) * 1e3)


def phase_host_encode(clip: np.ndarray, lib: dict, smi: str) -> None:
    """StreamingEncoder(device_pack=False), the serial sink: the device
    quantizes (K1), the C encoder packs on the host; bytes equal the
    device-packed serial stream; no bit pack kernel runs."""
    cfg = port.CodecConfig()
    ctx = port.TransformContext(cfg, "cuda")
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    enc = port.StreamingEncoder(W, H, cfg, ctx, device_pack=False)
    data = enc.push(clip) + enc.finish()
    dt = time.perf_counter() - t0
    launches = path_launches("host encode", ("frames_to_cubes",),
                             ("group_bits", "group_pack_values", "splice", "group_pack_codes"))
    check(data == lib["ser"], "the host encode differs from the device-packed serial stream")
    check(enc.gop_bit_ends == [] and enc.gop_sync_offsets is None,
          "the host encode recorded bit ends or syncs (the JAX host path records none)")
    emit(phase="host_encode", card=smi, launches=launches, bytes_equal_serial=True,
         host_encode_fps=T / dt, runs=1)


def phase_speculative(lib: dict, ctx, smi: str) -> None:
    """The serial-sink stream decoded with no index: decode_video through
    the fused speculative decode, decode_frame_range 20:45 through the
    prefix skip; speculative_planar4_chunks on the 1080p payload equals the
    serial decoder's tuples.  Decode fps without and with the index, and
    the host entropy stage alone by route."""
    ser, cfg = lib["ser"], ctx.cfg
    cpg, n = W * H * 8, T // 8
    positions = [0] + lib["ends"][:-1]
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = port.decode_video(ser, W, H, T, cfg, ctx)
    first_s = time.perf_counter() - t0
    rng = port.decode_frame_range(ser, W, H, 20, 45, cfg, ctx)
    launches = path_launches("speculative", ("cubes_to_frames",))
    check(np.array_equal(out, lib["out_ser"]), "the speculative decode differs from the indexed")
    check(np.array_equal(rng, lib["out_ser"][20:45]),
          "the speculative range decode differs from the slice")
    payload = np.frombuffer(zlib.decompress(ser), np.uint8)
    fused = entropy.speculative_planar4_chunks(payload, cpg, n)
    check(fused is not None, "the fused speculative decode refused the 1080p payload")
    pos = 0
    for k, (plane, ei, ev, end) in enumerate(fused):
        want = entropy.decode_values_planar4(payload, cpg, pos)
        check(all(np.array_equal(a, b) for a, b in zip((plane, ei, ev), want[:3]))
              and end == want[3], f"speculative chunk {k} differs from the serial decode")
        pos = end
    check(entropy.speculative_positions(payload, cpg, n) == positions,
          "speculative_positions differ from the index")
    plain_s = best_of_3(first_s, lambda: port.decode_video(ser, W, H, T, cfg, ctx))
    index_s = min(_timed(lambda: port.decode_video(ser, W, H, T, cfg, ctx, positions=positions))
                  for _ in range(3))

    def entropy_only(pos):
        return lambda: [None for _ in entropy.parallel_chunks(
            payload, cpg, n, entropy.decode_values_planar4, positions=pos)]

    spec_host = min(_timed(entropy_only(None)) for _ in range(3))
    index_host = min(_timed(entropy_only(positions)) for _ in range(3))
    emit(phase="speculative", card=smi, launches=launches, pixels_equal_indexed=True,
         range_equals_slice=True, chunks_equal_serial=True, positions_equal_index=True,
         decode_fps=T / plain_s, indexed_decode_fps=T / index_s,
         entropy_fps=T / spec_host, indexed_entropy_fps=T / index_host)


def phase_rgb(smi: str) -> tuple[np.ndarray, np.ndarray]:
    """encode_rgb_video(index=True) and encode_turbo_rgb_video (zlib wire)
    of rgb_clip(): content equal to the JAX package's (JAX_RGB_CONSTANTS);
    the decodes equal the per-channel library decodes, the ranges the
    slices, turbo-RGB pixels the RGB ones.  Returns the clip and its
    decoded pixels."""
    rgb = rgb_clip()
    cfg = port.CodecConfig(**RGB_CFG)
    ctx = port.TransformContext(cfg, "cuda")
    tcfg = port.CodecConfig(**TURBO_CFG)
    tctx = port.TransformContext(tcfg, "cuda")
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    box = port.encode_rgb_video(rgb, cfg, ctx, index=True)
    enc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = port.decode_rgb_video(box, W, H, cfg, ctx)
    dec_s = time.perf_counter() - t0
    rng = port.decode_rgb_range(box, W, H, 5, 13, cfg, ctx)
    launches = {"rgb": path_launches("rgb", REF8_DEVICE_SINK)}
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    tbox = port.encode_turbo_rgb_video(rgb, tcfg, tctx)
    tenc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tout = port.decode_turbo_rgb_video(tbox, W, H, tcfg, tctx)
    tdec_s = time.perf_counter() - t0
    trng = port.decode_turbo_rgb_range(tbox, W, H, 5, 13, tcfg, tctx)
    launches["turbo_rgb"] = path_launches("turbo rgb", TURBO8)
    content = {}
    for name, data in (("rgb", box), ("turbo_rgb", tbox)):
        want = JAX_RGB_CONSTANTS[name]
        bpp = len(data) * 8 / (W * H * RGB_T)
        check(container_digest(data) == want["digest"],
              f"{name}: the container's content differs from the JAX package's")
        check_bpp(bpp, want["bpp"], f"{name} vs JAX", device_sink=True)
        content[f"{name}_bpp"] = bpp
    members = multihost.split_members(box)
    check([m[2] for m in members] == [1, 4, 2, 4, 3, 4], "not three indexed channel members")
    for c, k in enumerate((0, 2, 4)):
        ends = multihost.parse_index(members[k + 1][1])
        ch = port.decode_video(members[k][1], W, H, RGB_T, cfg, ctx, positions=[0] + ends[:-1],
                               sync_offsets=multihost.parse_index_syncs(members[k + 1][1]))
        check(np.array_equal(out[..., c], ch), f"channel {c} differs from its library decode")
    check(np.array_equal(rng, out[5:13]), "decode_rgb_range differs from the slice")
    check(np.array_equal(tout, out), "turbo-RGB pixels differ from the RGB decode")
    check(np.array_equal(trng, out[5:13]), "decode_turbo_rgb_range differs from the slice")
    enc_s = best_of_3(enc_s, lambda: port.encode_rgb_video(rgb, cfg, ctx, index=True))
    dec_s = best_of_3(dec_s, lambda: port.decode_rgb_video(box, W, H, cfg, ctx))
    emit(phase="rgb", card=smi, frames=RGB_T, launches=launches, **content,
         content_equals_jax=True, pixels_equal_channel_decodes=True, ranges_equal_slices=True,
         psnr_db=port.psnr(rgb, out), rgb_encode_fps=RGB_T / enc_s,
         rgb_decode_fps=RGB_T / dec_s, turbo_rgb_encode_fps=RGB_T / tenc_s,
         turbo_rgb_decode_fps=RGB_T / tdec_s)
    return rgb, out


def phase_checkpoint(clip: np.ndarray, lib: dict, smi: str) -> None:
    """CheckpointingEncoder on the bench clip, reference (2 GOPs a member,
    index on) and turbo (zlib wire): stop after 3 GOPs, tear the last
    member, resume; the file equals an uninterrupted run's and decodes to
    the plain pixels."""
    report = {}
    with tempfile.TemporaryDirectory() as d:
        for name, cfg, kw in (
                ("reference", port.CodecConfig(deflate_workers=-1), {"index": True}),
                ("turbo", port.CodecConfig(**TURBO_CFG), {"turbo": True})):
            ctx = port.TransformContext(cfg, "cuda")
            whole, torn = os.path.join(d, f"{name}.whole"), os.path.join(d, f"{name}.torn")
            kernels.LAUNCHES.clear()
            t0 = time.perf_counter()
            with port.CheckpointingEncoder(whole, W, H, cfg, ctx, checkpoint_gops=2,
                                           **kw) as enc:
                enc.push(clip)
            enc_s = time.perf_counter() - t0
            with port.CheckpointingEncoder(torn, W, H, cfg, ctx, checkpoint_gops=2,
                                           **kw) as enc:
                enc.push(clip[:24])
            size = os.path.getsize(torn)
            os.truncate(torn, size - 100)  # tear the last member
            frames_safe, _ = port.resume_info(torn)
            with port.CheckpointingEncoder(torn, W, H, cfg, ctx, checkpoint_gops=2,
                                           **kw) as enc:
                check(enc.frames_done == frames_safe, "the resume point is not resume_info's")
                enc.push(clip[enc.frames_done:])
            with open(whole, "rb") as f:
                data = f.read()
            with open(torn, "rb") as f:
                check(f.read() == data, f"{name}: the resumed file differs from the "
                      "uninterrupted one")
            if name == "turbo":
                out = port.decode_turbo_container(data, W, H, cfg, ctx)
            else:
                out = multihost.decode_multihost_container(data, W, H, cfg, ctx=ctx)
            check(np.array_equal(out, lib["out_ser"]),
                  f"{name}: the checkpointed container decodes otherwise than the stream")
            report[name] = {
                "launches": path_launches(f"{name} checkpoint",
                                          TURBO8 if name == "turbo" else REF8),
                "resumed_at_frame": frames_safe, "members": len(multihost.split_members(data)),
                "encode_fps": T / enc_s}
    emit(phase="checkpoint", card=smi, resumed_equals_uninterrupted=True,
         pixels_equal_plain=True, **report)



def run_cli(*argv: str) -> str:
    """dct3d_tpu_torch.cli.main in this process; fails unless it exits 0.
    Returns what it printed on stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    check(rc == 0, f"dct3d_tpu_torch {' '.join(argv[:1])} exited {rc}: {argv}")
    return out.getvalue()


def cli_path(name: str, want: tuple, argvs: list, absent: tuple = ()) -> dict:
    """Run one CLI path's commands with the launch counts set to 0 before
    them and read after them; every kernel of `want` must have launched and
    none of `absent`."""
    kernels.LAUNCHES.clear()
    for argv in argvs:
        run_cli(*argv)
    return path_launches(f"CLI {name}", want, absent)


def phase_cli(clip: np.ndarray, lib: dict, portrait_cropped: np.ndarray, rgb_lib: tuple,
              smi: str) -> None:
    """The port's CLI, file to file in a temporary directory, on the bench
    clip written raw; each path with launch counts of its own:

      1. default encode, then decode with no frame count, --range 20:45 and
         info: the container holds the library's parallel-sink stream and
         its index, its content is the JAX CLI's (JAX_CLI_CONSTANTS), the
         pixels are the library decode's; the container twice over decodes
         its two members on two threads to the same pixels twice;
      2. --parity --index: the serial-sink stream, and the sidecar decode;
      3. --turbo --turbo-codec zlib, decode and --range: the JAX turbo
         digest, the reference pixels;
      4. --block 4 --pad on the portrait clip, then decode --block 4 --crop:
         K5 and K3, phase 7's cropped pixels;
      5. `python -m dct3d_tpu_torch devices` in a subprocess names the card;
      6. --transport-delta: the default container, byte for byte;
      7. --rgb and --rgb --turbo --turbo-codec zlib on the rgb phase's clip,
         each decoded with no flags and with --range 5:13: the JAX
         package's content (JAX_RGB_CONSTANTS), the rgb phase's pixels;
      8. --checkpoint-every 2 twice (the second run resumes at the end),
         then a decode with no geometry, from the .meta sidecar.

    Then encode and decode fps, file to file, best of 3."""
    geo = (str(W), str(H))
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "src.raw")
        clip.tofile(src)
        box, dec = os.path.join(d, "box.d3v"), os.path.join(d, "dec.raw")

        # 1. The default container.
        launches = {"default": cli_path("default", REF8_DEVICE_SINK, [
            ("encode", src, box, *geo), ("decode", box, dec, *geo),
            ("decode", box, os.path.join(d, "rng.raw"), *geo, "--range", "20:45")])}
        with open(box, "rb") as f:
            data = f.read()
        members = multihost.split_members(data)
        check([(m[0], m[2]) for m in members] == [(T, multihost.MEMBER_TEMPORAL),
                                                  (0, multihost.MEMBER_INDEX)],
              f"the default encode is not a temporal member and its index: "
              f"{[(m[0], m[2]) for m in members]}")
        payload, index = members[0][1], members[1][1]
        check(payload == lib["par"], "the container's member is not the library's "
              "parallel-sink stream")
        check(multihost.parse_index(index) == lib["ends"],
              "the index ends differ from StreamingEncoder.gop_bit_ends")
        check(multihost.parse_index_syncs(index) == lib["syncs"],
              "the index syncs differ from StreamingEncoder.gop_sync_offsets")
        want = JAX_CLI_CONSTANTS
        bpp = len(data) * 8 / (W * H * T)
        check(hashlib.sha256(zlib.decompress(payload)).hexdigest() == want["payload_sha256"]
              and multihost.parse_index(index) == want["index_ends"]
              and container_digest(data) == want["digest"],
              "the default container's content differs from the JAX CLI's")
        check_bpp(bpp, want["bpp"], "CLI vs JAX", device_sink=True)
        out = np.fromfile(dec, np.uint8).reshape(T, H, W)
        check(np.array_equal(out, lib["out_par"]), "CLI decode differs from decode_video")
        check(np.array_equal(np.fromfile(os.path.join(d, "rng.raw"), np.uint8),
                             lib["out_par"][20:45].reshape(-1)),
              "CLI --range 20:45 differs from the slice")
        # Two members decoded at once on two threads over one card: the
        # default container twice.
        box2 = os.path.join(d, "box2.d3v")
        with open(box2, "wb") as f:
            f.write(data + data)
        run_cli("decode", box2, dec, *geo)
        out2 = np.fromfile(dec, np.uint8).reshape(2 * T, H, W)
        check(np.array_equal(out2[:T], lib["out_par"]) and np.array_equal(out2[T:], lib["out_par"]),
              "a two-member container decodes otherwise than its members one by one")
        info = json.loads(run_cli("info", box))
        check(info["kind"] == "temporal" and info["members"][1]["type"] == "index"
              and info["members"][1]["gops"] == T // 8
              and info["members"][1].get("parallel_inflate") is True,
              f"info: {info}")

        # 2. --parity --index: the raw serial-sink stream and its sidecar.
        par_file = os.path.join(d, "parity.bin")
        launches["parity_index"] = cli_path("parity_index", REF8, [
            ("encode", src, par_file, *geo, "--parity", "--index"),
            ("decode", par_file, dec, *geo)])
        with open(par_file, "rb") as f:
            check(f.read() == lib["ser"], "the --parity stream is not the serial-sink stream")
        check(os.path.exists(par_file + ".idx"), "no .idx sidecar")
        check(np.array_equal(np.fromfile(dec, np.uint8).reshape(T, H, W), lib["out_par"]),
              "the sidecar decode differs from decode_video")

        # 3. Turbo, zlib wire.
        tbox = os.path.join(d, "box.d3t")
        launches["turbo"] = cli_path(
            "turbo", TURBO8,
            [("encode", src, tbox, *geo, "--turbo", "--turbo-codec", "zlib"),
             ("decode", tbox, dec, *geo),
             ("decode", tbox, os.path.join(d, "trng.raw"), *geo, "--range", "20:45")],
            absent=("group_pack_values", "splice"))
        with open(tbox, "rb") as f:
            check(container_digest(f.read()) == JAX_TURBO_DIGEST,
                  "the CLI's turbo container differs from the JAX package's")
        check(np.array_equal(np.fromfile(dec, np.uint8).reshape(T, H, W), lib["out_par"]),
              "CLI turbo pixels differ from the reference decode")
        check(np.array_equal(np.fromfile(os.path.join(d, "trng.raw"), np.uint8),
                             lib["out_par"][20:45].reshape(-1)),
              "CLI turbo --range differs from the slice")

        # 4. 4x4x4 cubes, the portrait screen padded by the CLI.
        psrc, pbox = os.path.join(d, "portrait.raw"), os.path.join(d, "portrait.d3v")
        synthetic_clip(PT, PH, PW).tofile(psrc)
        launches["block4_pad"] = cli_path(
            "block4_pad", ("group_pack_codes", "splice"),
            [("encode", psrc, pbox, str(PW), str(PH), "--block", "4", "--pad"),
             ("decode", pbox, dec, *map(str, port.padded_geometry(PW, PH, 4, 4)),
             "--block", "4", "--crop", f"{PW}x{PH}")],
            absent=("frames_to_cubes", "cubes_to_frames", "group_pack_values"))
        check(np.array_equal(np.fromfile(dec, np.uint8).reshape(PT, PH, PW), portrait_cropped),
              "CLI --block 4 --pad/--crop pixels differ from phase 7's")

        # 5. The devices subcommand, as a user runs it.
        res = subprocess.run([sys.executable, "-m", "dct3d_tpu_torch", "devices"],
                             capture_output=True, text=True, timeout=300,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        check(res.returncode == 0 and torch.cuda.get_device_name(0) in res.stdout,
              f"`python -m dct3d_tpu_torch devices`: rc {res.returncode}, {res.stdout!r}")

        # 6. The transport-delta wire.
        dbox = os.path.join(d, "delta.d3v")
        launches["transport_delta"] = cli_path("transport_delta", REF8, [
            ("encode", src, dbox, *geo, "--transport-delta"),
            ("decode", dbox, dec, *geo, "--transport-delta")])
        with open(dbox, "rb") as f:
            check(f.read() == data, "--transport-delta changed the default container")
        check(np.array_equal(np.fromfile(dec, np.uint8).reshape(T, H, W), lib["out_par"]),
              "CLI --transport-delta pixels differ from the library decode")

        # 7. RGB, both profiles.
        rgb, rgb_out = rgb_lib
        rsrc = os.path.join(d, "src.rgb")
        rgb.tofile(rsrc)
        for name, flags, path in (("rgb", [], REF8),
                                  ("turbo_rgb", ["--turbo", "--turbo-codec", "zlib"], TURBO8)):
            rbox = os.path.join(d, f"{name}.d3v")
            launches[name] = cli_path(name, path, [
                ("encode", rsrc, rbox, *geo, "--rgb", *flags),
                ("decode", rbox, dec, *geo),
                ("decode", rbox, os.path.join(d, "rrng.raw"), *geo, "--range", "5:13")])
            with open(rbox, "rb") as f:
                check(container_digest(f.read()) == JAX_RGB_CONSTANTS[name]["digest"],
                      f"CLI {name}: the container differs from the JAX package's")
            check(np.array_equal(np.fromfile(dec, np.uint8).reshape(rgb.shape), rgb_out),
                  f"CLI {name}: pixels differ from the rgb phase's")
            check(np.array_equal(np.fromfile(os.path.join(d, "rrng.raw"), np.uint8),
                                 rgb_out[5:13].reshape(-1)),
                  f"CLI {name} --range 5:13 differs from the slice")

        # 8. Checkpointed, twice, then decoded from the .meta sidecar.
        ck = os.path.join(d, "ck.d3v")
        kernels.LAUNCHES.clear()
        run_cli("encode", src, ck, *geo, "--checkpoint-every", "2")
        second = run_cli("encode", src, ck, *geo, "--checkpoint-every", "2")
        run_cli("decode", ck, dec)
        launches["checkpoint"] = path_launches("CLI checkpoint", REF8)
        check(f"resuming at frame {T}" in second, "the second run did not resume")
        check(os.path.exists(ck + ".meta"), "no .meta sidecar")
        check(np.array_equal(np.fromfile(dec, np.uint8).reshape(T, H, W), lib["out_par"]),
              "CLI checkpoint pixels differ from the library decode")

        # End-to-end fps, file to file: the best of three runs.
        enc_s = min(_timed(lambda: run_cli("encode", src, box, *geo)) for _ in range(3))
        dec_s = min(_timed(lambda: run_cli("decode", box, dec, *geo)) for _ in range(3))
    emit(phase="cli", card=smi, launches=launches, bpp=bpp, jax_bpp=want["bpp"],
         content_equals_jax=True, pixels_equal_library=True, range_equals_slice=True,
         two_members_equal_one_by_one=True, delta_container_equals_default=True,
         rgb_content_equals_jax=True, checkpoint_resumes=True,
         parity_stream_equals_serial_sink=True, turbo_digest_equals_jax=True,
         portrait_pixels_equal_blocks_phase=True, devices=res.stdout.strip().splitlines(),
         cli_encode_fps=T / enc_s, cli_decode_fps=T / dec_s)


def cuda_mesh(gop: int, tile: int):
    """A (gop, tile) mesh whose every shard is cuda:0."""
    return make_mesh(gop=gop, tile=tile, devices=[torch.device("cuda", 0)] * (gop * tile))


def sharded(frames: np.ndarray, mesh, cfg):
    """ShardedEncoder's stream of frames, and the encoder."""
    enc = ShardedEncoder(frames.shape[2], frames.shape[1], mesh, cfg)
    return enc.push(frames) + enc.finish(), enc


def sharded_turbo(frames: np.ndarray, mesh, cfg) -> bytes:
    """TurboShardedEncoder's container of frames."""
    enc = turbo.TurboShardedEncoder(frames.shape[2], frames.shape[1], mesh, cfg)
    return enc.push(frames) + enc.finish()


def phase_mesh(clip: np.ndarray, lib: dict, smi: str) -> None:
    """The sharded paths on meshes of cuda:0 repeated, each with launch
    counts of its own (module docstring, phase 15)."""
    report, launches = {}, {}
    ref_path = ("frames_to_cubes", "group_bits", "group_pack_values", "splice")
    cfg_ser, cfg_par = port.CodecConfig(), port.CodecConfig(deflate_workers=-1)
    m23 = cuda_mesh(2, 3)
    positions = [0] + lib["ends"][:-1]

    # 8x8x8, reference profile: encode on (2, 3) and (4, 1), decode on (2, 3).
    for name, mesh in (("2x3", m23), ("4x1", cuda_mesh(4, 1))):
        kernels.LAUNCHES.clear()
        data, enc = sharded(clip, mesh, cfg_ser)
        launches[f"encode_{name}"] = path_launches(f"mesh {name} encode", ref_path,
                                                   ("group_pack_codes",))
        check(data == lib["ser"], f"the {name} sharded stream differs from the serial stream")
        check(enc.gop_bit_ends == lib["ends"], f"the {name} bit ends differ from the index")
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    pdata, enc = sharded(clip, m23, cfg_par)
    mesh_enc_s = time.perf_counter() - t0
    launches["encode_2x3_parallel_sink"] = path_launches("mesh parallel-sink encode", ref_path)
    check(zlib.decompress(pdata) == zlib.decompress(lib["par"]) and enc.gop_bit_ends == lib["ends"],
          "the parallel-sink sharded payload or bit ends differ from the single-device ones")
    check(enc.gop_sync_offsets is not None and len(enc.gop_sync_offsets) == T // 8,
          "the parallel-sink sharded encoder gave no sync offset a GOP")
    dec = ShardedDecoder(W, H, m23, cfg_ser)
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = dec.decode(lib["ser"], T, positions=positions, index_end=lib["ends"][-1])
    mesh_dec_s = time.perf_counter() - t0
    scanned = dec.decode(lib["ser"], T)
    launches["decode_2x3"] = path_launches("mesh decode", ("cubes_to_frames",))
    check(np.array_equal(out, lib["out_ser"]) and np.array_equal(scanned, lib["out_ser"]),
          "the sharded decode differs from decode_video")

    # 8x8x8 turbo on (2, 3).
    cfg_t = port.CodecConfig(**TURBO_CFG)
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    tdata = sharded_turbo(clip, m23, cfg_t)
    mesh_tenc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tout = turbo.TurboShardedDecoder(W, H, m23, cfg_t).decode(tdata)
    mesh_tdec_s = time.perf_counter() - t0
    launches["turbo_2x3"] = path_launches("mesh turbo", TURBO8, ("group_pack_values", "splice"))
    check(container_digest(tdata) == JAX_TURBO_DIGEST == container_digest(lib["tdata"]),
          "the sharded turbo container's streams differ from encode_turbo_video's")
    check(np.array_equal(tout, lib["out_par"]), "the sharded turbo decode differs")

    # 4x4x4 on (2, 3): whole groups (K2) and the padded portrait (K5).
    for run, frames in (("bench", clip), ("portrait", portrait_clip())):
        cfg4 = port.CodecConfig(**BLOCK4, zlib_level=1)
        ctx4 = port.TransformContext(cfg4, "cuda")
        t, h, w = frames.shape
        want = port.encode_video(frames, cfg4, ctx4)
        want_px = port.decode_video(want, w, h, t, cfg4, ctx4)
        kernels.LAUNCHES.clear()
        got, _ = sharded(frames, m23, cfg4)
        got_px = ShardedDecoder(w, h, m23, cfg4).decode(got, t)
        path = (("group_bits", "group_pack_values"), ("group_pack_codes",))
        if run == "portrait":
            path = path[::-1]
        launches[f"block4_{run}_2x3"] = path_launches(
            f"mesh 4x4x4 {run}", path[0] + ("splice",),
            path[1] + ("frames_to_cubes", "cubes_to_frames"))
        check(got == want, f"the 4x4x4 {run} sharded stream differs from one device's "
              "(a cuBLAS tie rounded by row count?)")
        check(np.array_equal(got_px, want_px), f"the 4x4x4 {run} sharded pixels differ")

    # The command line.
    count = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as d:
        src, box = os.path.join(d, "src.raw"), os.path.join(d, "m.bin")
        clip.tofile(src)
        dec_out = os.path.join(d, "dec.raw")
        launches["cli_1x1"] = cli_path("mesh 1x1", REF8, [
            ("encode", src, box, str(W), str(H), "--parity", "--mesh", "1x1"),
            ("decode", box, dec_out, str(W), str(H), str(T), "--mesh", "1x1")])
        with open(box, "rb") as f:
            check(f.read() == lib["ser"], "--mesh 1x1 --parity differs from --parity")
        check(np.array_equal(np.fromfile(dec_out, np.uint8).reshape(T, H, W), lib["out_ser"]),
              "decode --mesh 1x1 differs from decode_video")
        err = io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["encode", src, box, str(W), str(H), "--parity", "--mesh", "2x1"])
        if count == 1:
            check(rc == 2 and "needs 2 devices, found 1" in err.getvalue(),
                  f"--mesh 2x1 on one card: rc {rc}, {err.getvalue()!r}")
        else:
            with open(box, "rb") as f:
                check(rc == 0 and f.read() == lib["ser"], "--mesh 2x1 --parity differs")
        tbox = os.path.join(d, "t.d3t")
        with open(tbox, "wb") as f:
            f.write(tdata)
        err = io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["decode", tbox, dec_out, str(W), str(H), "--mesh", f"{count + 1}x1"])
        check(rc == 2 and f"found {count}" in err.getvalue(),
              f"a turbo decode on an unbuildable mesh: rc {rc}, {err.getvalue()!r}")

    # Two processes, one card, gloo: the gathered container.
    t0 = time.perf_counter()
    sim = subprocess.run(
        [sys.executable, "-m", "dct3d_tpu_torch.parallel.multihost_sim", "--device", "cuda",
         "--width", str(W), "--height", str(H), "--frames", "40"],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    sim_s = time.perf_counter() - t0
    check(sim.returncode == 0 and "MULTIHOST SIM PASSED" in sim.stdout,
          f"multihost sim: rc {sim.returncode}\n{sim.stdout[-3000:]}\n{sim.stderr[-3000:]}")
    kernels.LAUNCHES.clear()
    dry = dryrun.dryrun_multichip(6, "cuda")
    launches["dryrun_6"] = path_launches("dry run", REF8 + TURBO8)

    # Sharded fps beside one device's, alternated: best of 2 each.
    ctx_par = port.TransformContext(cfg_par, "cuda")
    ctx_ser = port.TransformContext(cfg_ser, "cuda")
    ctx_t = port.TransformContext(cfg_t, "cuda")
    times = {k: [] for k in ("enc", "mesh_enc", "dec", "mesh_dec", "tenc", "mesh_tenc",
                             "tdec", "mesh_tdec")}
    for _ in range(2):
        times["enc"].append(_timed(lambda: encode_clip(clip, cfg_par, ctx_par)))
        times["mesh_enc"].append(_timed(lambda: sharded(clip, m23, cfg_par)))
        times["dec"].append(_timed(lambda: port.decode_video(
            lib["ser"], W, H, T, cfg_ser, ctx_ser, positions=positions)))
        times["mesh_dec"].append(_timed(lambda: dec.decode(lib["ser"], T, positions=positions)))
        times["tenc"].append(_timed(lambda: port.encode_turbo_video(clip, cfg_t, ctx_t)))
        times["mesh_tenc"].append(_timed(lambda: sharded_turbo(clip, m23, cfg_t)))
        times["tdec"].append(_timed(lambda: port.decode_turbo_container(tdata, W, H, cfg_t, ctx_t)))
        times["mesh_tdec"].append(_timed(
            lambda: turbo.TurboShardedDecoder(W, H, m23, cfg_t).decode(tdata)))
    for k, first in (("mesh_enc", mesh_enc_s), ("mesh_dec", mesh_dec_s),
                     ("mesh_tenc", mesh_tenc_s), ("mesh_tdec", mesh_tdec_s)):
        times[k].append(first)
    fps = {f"{k}_fps": T / min(v) for k, v in times.items()}
    report.update(fps)
    emit(phase="mesh", card=smi, launches=launches, cards=count,
         streams_equal_single_device=True, pixels_equal_single_device=True,
         turbo_container_equal=True, block4_streams_equal=True, cli_exits=True,
         multihost_sim_s=sim_s, multihost_sim=sim.stdout.strip().splitlines(),
         dryrun_shards=6, dryrun_mesh=list(dry["mesh"]),
         note="one card runs every shard in turn: sharded fps are no scaling figure",
         **report)


def phase_bf16_kernels(gop0: np.ndarray, card: str) -> list[dict]:
    """The bf16 forms of K1 and K4 on the card against their plain versions
    on the CPU, byte for byte: at one 1080p GOP (timed) and at 200x136, whose
    25 block columns fill no run of 16."""
    rows = []
    ctx = port.TransformContext(port.CodecConfig(**BF16), "cuda")
    frames = torch.from_numpy(gop0).to("cuda")
    small = torch.from_numpy(small_clip(8, 136, 200, seed=16)).to("cuda")
    for f in (small, frames):
        cubes, sums = relayout.frames_to_cubes(f, torch.bfloat16)
        p_cubes, p_sums = relayout.frames_to_cubes_plain(f.cpu(), torch.bfloat16)
        check(cubes.dtype == torch.bfloat16 and torch.equal(cubes.cpu(), p_cubes)
              and torch.equal(sums.cpu(), p_sums),
              f"K1 bf16 differs from its plain version at {tuple(f.shape)}")
    add_row(rows, card, "frames_to_cubes_bf16", "dct3d_tpu_torch/csrc/relayout.cu",
            "dct3d_tpu/ops/relayout.py:216", max_abs_err(cubes, p_cubes),
            median_ms(lambda: relayout.frames_to_cubes(frames, torch.bfloat16)),
            median_ms(lambda: relayout.frames_to_cubes_plain(frames, torch.bfloat16)),
            tensor_bytes(frames, cubes, sums))
    for f in (small, frames):
        q = transform.quantize_step(f, ctx)
        pixels = transform._dequant_matmul(q[:, 0::2], q[:, 1::2], ctx.dec_me, ctx.dec_mo)
        h, w = f.shape[1:]
        k4 = relayout.cubes_to_frames(pixels, h, w)
        p4 = relayout.cubes_to_frames_plain(pixels.cpu(), h, w)
        check(pixels.dtype == torch.bfloat16 and torch.equal(k4.cpu(), p4),
              f"K4 bf16 differs from its plain version at {tuple(f.shape)}")
    add_row(rows, card, "cubes_to_frames_bf16", "dct3d_tpu_torch/csrc/relayout.cu",
            "dct3d_tpu/ops/relayout.py:258", max_abs_err(k4, p4),
            median_ms(lambda: relayout.cubes_to_frames(pixels, H, W)),
            median_ms(lambda: relayout.cubes_to_frames_plain(pixels, H, W)),
            tensor_bytes(pixels, k4))
    emit(phase="kernels", bf16="K1 and K4 bf16 byte-equal to their plain versions at "
         "1920x1080x8 and 200x136x8", card=card)
    return rows


def content_vs_jax_bf16(run: str, data: bytes, out: np.ndarray, clip: np.ndarray) -> dict:
    """A bf16 run's bpp by check_bpp (a device-sink stream) and PSNR within
    0.02 dB of the JAX
    package's (JAX_BF16_CONSTANTS); whether its payload equals the JAX
    package's is printed, not gated: cuBLAS may round a bf16 product
    otherwise than XLA on the CPU."""
    want = JAX_BF16_CONSTANTS[run]
    bpp = port.bits_per_pixel(len(data), W, H, T)
    psnr = port.psnr(clip, out)
    check_bpp(bpp, want["bpp"], f"bf16 {run} vs JAX", device_sink=True)
    check(abs(psnr - want["psnr_db"]) <= 0.02,
          f"bf16 {run}: psnr {psnr} vs JAX {want['psnr_db']}")
    return {"bpp": bpp, "psnr_db": psnr, "jax_bpp": want["bpp"], "jax_psnr_db": want["psnr_db"],
            "payload_equals_jax":
                hashlib.sha256(zlib.decompress(data)).hexdigest() == want["digest"]}


def ints_differing(a: np.ndarray, b: np.ndarray, what: str) -> dict:
    """Count of ints that differ, held to BF16_INTS_PER_M per million."""
    n = int((a != b).sum())
    per_m = 1e6 * n / a.size
    check(per_m <= BF16_INTS_PER_M, f"{what}: {n} ints differ ({per_m:.3f} per 1M)")
    return {"ints": int(a.size), "ints_differing": n, "ints_differing_per_1m": per_m}


def profile_steps() -> dict:
    """torch.profiler's device time (profiled_us) at one 1080p GOP of the
    bench clip, f32 and bf16: the encode step, the decode step on the
    GOP's uploaded plane, the encode GEMM and the decode's two GEMMs with
    their add; and the bf16 forms of K1 and K4.  Run by phase 16 in a
    process of its own (`python3 chip_smoke.py --profile-steps`): in the
    long smoke process the profiler lost some GEMM kernels' records."""
    clip = synthetic_clip(8, H, W)
    frames = torch.from_numpy(clip).to("cuda")
    zero = torch.zeros((), dtype=torch.int64, device="cuda")
    out = {}
    for name, cfg in (("f32", port.CodecConfig()), ("bf16", port.CodecConfig(**BF16))):
        c = port.TransformContext(cfg, "cuda")
        plane = uploaded_planes(port.encode_video(clip, cfg, c), [0], c, W, H)[0]
        cubes, _ = transform._cubes_and_sums(frames, cfg)
        half = torch.zeros((cubes.shape[0], 256), dtype=c.dtype, device="cuda")
        out[name] = {
            "encode_step": profiled_us(lambda: transform.encode_step(frames, c, zero, zero)),
            "decode_step": profiled_us(lambda: transform.planar4_to_frames(*plane, c, H, W)),
            "encode_gemm": profiled_us(lambda: cubes @ c.enc_t),
            "decode_gemms": profiled_us(lambda: half @ c.dec_me + half @ c.dec_mo)}
    q = transform.quantize_step(frames, c)
    pixels = transform._dequant_matmul(q[:, 0::2], q[:, 1::2], c.dec_me, c.dec_mo)
    out["frames_to_cubes_bf16"] = profiled_us(
        lambda: relayout.frames_to_cubes(frames, torch.bfloat16))
    out["cubes_to_frames_bf16"] = profiled_us(lambda: relayout.cubes_to_frames(pixels, H, W))
    return out


def phase_bf16(clip: np.ndarray, lib: dict, smi: str, rows: list[dict]) -> None:
    """The bf16 profile (compute_dtype="bfloat16") through the public entry
    points, each path with launch counts of its own (module docstring,
    phase 16); fills the launches of the bf16 kernels' rows from the
    reference path's counts and their device time from profile_steps."""
    cfg = port.CodecConfig(**BF16_CFG)
    ctx = port.TransformContext(cfg, "cuda")
    ref8 = ("frames_to_cubes_bf16", "group_bits", "group_pack_values", "splice",
            "cubes_to_frames_bf16")
    f32_forms = ("frames_to_cubes", "cubes_to_frames")
    report, launches = {}, {}

    # 8x8x8, reference profile, parallel sink.
    kernels.LAUNCHES.clear()
    t0 = time.perf_counter()
    data, ends, syncs = encode_clip(clip, cfg, ctx)
    enc_s = time.perf_counter() - t0
    positions = [0] + ends[:-1]
    t0 = time.perf_counter()
    out = port.decode_video(data, W, H, T, cfg, ctx, positions=positions, sync_offsets=syncs)
    dec_s = time.perf_counter() - t0
    launches["reference"] = path_launches("bf16", ref8, f32_forms + ("group_pack_codes",))
    for r in rows:
        r["launches"] = launches["reference"].get(r["name"], 0)
    report["reference"] = content_vs_jax_bf16("8x8x8", data, out, clip)
    q = card_ints(clip, ctx)
    check(np.array_equal(stream_ints(data, clip.size), q.reshape(-1).numpy()),
          "the bf16 stream does not carry the card's ints")
    cpu_ctx = port.TransformContext(cfg, "cpu")
    q_cpu = torch.cat([transform.quantize_step(torch.from_numpy(clip[g : g + 8]), cpu_ctx)
                       for g in range(0, T, 8)])
    rows0 = W * H * 8 // 512
    report["gop0_vs_cpu"] = ints_differing(q[:rows0].numpy(), q_cpu[:rows0].numpy(),
                                           "bf16 GOP 0 ints, card vs plain CPU")
    report["clip_vs_cpu"] = {**ints_differing(q.numpy(), q_cpu.numpy(),
                                              "bf16 ints of the clip, card vs plain CPU"),
                             "by_gop": [int((a != b).sum())
                                        for a, b in zip(q.chunk(T // 8), q_cpu.chunk(T // 8))]}
    cpu_gop0 = port.decode_frame_range(data, W, H, 0, 8, cfg, device="cpu", positions=positions)
    d = np.abs(out[:8].astype(np.int16) - cpu_gop0)
    mismatch = float((d > 0).mean())
    check(int(d.max()) <= 1 and mismatch < 0.01,
          f"bf16 GPU decode vs plain CPU decode: max {int(d.max())}, rate {mismatch}")
    report["gop0_pixels_vs_cpu"] = {"max_abs_diff": int(d.max()), "mismatch_rate": mismatch}
    f32_cfg = port.CodecConfig(deflate_workers=-1)
    f32_ctx = port.TransformContext(f32_cfg, "cuda")
    f32_of_bf16 = port.psnr(clip, port.decode_video(data, W, H, T, f32_cfg, f32_ctx,
                                                     positions=positions, sync_offsets=syncs))
    f32_psnr = port.psnr(clip, lib["out_par"])
    check(f32_psnr - f32_of_bf16 < 0.7,
          f"the f32 decoder's PSNR of the bf16 stream {f32_of_bf16} vs the f32 stream's {f32_psnr}")
    report["f32_decoder_psnr_db"] = f32_of_bf16
    report["f32_stream_psnr_db"] = f32_psnr

    # Turbo, zlib-6 wire.
    tcfg = port.CodecConfig(**TURBO_CFG, **BF16)
    tctx = port.TransformContext(tcfg, "cuda")
    kernels.LAUNCHES.clear()
    tdata = port.encode_turbo_video(clip, tcfg, tctx)
    tout = port.decode_turbo_container(tdata, W, H, tcfg, tctx)
    launches["turbo"] = path_launches("bf16 turbo", ("frames_to_cubes_bf16", "compact_groups",
                                                     "plane_to_wire", "wire_to_plane",
                                                     "cubes_to_frames_bf16"), f32_forms)
    check(np.array_equal(tout, out), "bf16 turbo pixels differ from the bf16 reference decode")
    report["turbo"] = {"bpp": port.bits_per_pixel(len(tdata), W, H, T),
                       "pixels_equal_reference": True}

    # 4x4x4 on the bench clip.
    bcfg = port.CodecConfig(**BF16_BLOCK_CFG)
    bctx = port.TransformContext(bcfg, "cuda")
    kernels.LAUNCHES.clear()
    bdata, bends, bsyncs = encode_clip(clip, bcfg, bctx)
    bout = port.decode_video(bdata, W, H, T, bcfg, bctx, positions=[0] + bends[:-1],
                             sync_offsets=bsyncs)
    launches["block4"] = path_launches(
        "bf16 4x4x4", ("group_bits", "group_pack_values", "splice"),
        f32_forms + ("frames_to_cubes_bf16", "cubes_to_frames_bf16", "group_pack_codes"))
    report["block4"] = content_vs_jax_bf16("4x4x4", bdata, bout, clip)

    # The command line: --dtype bf16 encode and decode; --parity refuses it.
    with tempfile.TemporaryDirectory() as d:
        src, box, dec = (os.path.join(d, n) for n in ("src.raw", "bf16.d3v", "dec.raw"))
        clip.tofile(src)
        geo = (str(W), str(H))
        launches["cli"] = cli_path("bf16", ref8, [
            ("encode", src, box, *geo, "--dtype", "bf16"),
            ("decode", box, dec, *geo, "--dtype", "bf16")], f32_forms)
        with open(box, "rb") as f:
            members = multihost.split_members(f.read())
        check(members[0][1] == data and multihost.parse_index(members[1][1]) == ends,
              "the CLI's bf16 container is not the library's stream and index")
        check(np.array_equal(np.fromfile(dec, np.uint8).reshape(T, H, W), out),
              "CLI bf16 pixels differ from the library's")
        err = io.StringIO()
        with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["encode", src, box, *geo, "--dtype", "bf16", "--parity"])
        check(rc == 2 and "--parity" in err.getvalue(),
              f"--parity --dtype bf16: rc {rc}, {err.getvalue()!r}")
    report["cli"] = {"container_equals_library": True, "parity_exits_2": True}

    # A (2, 3) mesh of cuda:0 against one device, serial sink.
    scfg = port.CodecConfig(**BF16)
    sctx = port.TransformContext(scfg, "cuda")
    single, _, _ = encode_clip(clip, scfg, sctx)
    kernels.LAUNCHES.clear()
    mdata, _ = sharded(clip, cuda_mesh(2, 3), scfg)
    launches["mesh_2x3"] = path_launches("bf16 mesh", ref8[:-1], f32_forms)
    report["mesh_2x3"] = {"stream_equals_single_device": mdata == single, **ints_differing(
        stream_ints(mdata, clip.size), stream_ints(single, clip.size),
        "bf16 (2, 3) mesh ints vs one device's")}

    # Timing: device steps on resident frames, f32 and bf16 in turns; the
    # encode GEMM alone at one GOP; end-to-end fps, alternated.
    frames_dev = torch.from_numpy(clip).to("cuda")
    f32_positions = [0] + lib["ends"][:-1]
    steps = {"f32": [], "bf16": []}
    for name in ("f32", "bf16", "bf16", "f32"):
        args = ((f32_ctx, lib["par"], f32_positions) if name == "f32"
                else (ctx, data, positions))
        steps[name].append(device_ms(frames_dev, *args, W, H))
    # The GEMMs alone at GOP 0, CUDA events; then torch.profiler's device
    # time of the steps, the GEMMs and K1/K4 bf16 from a fresh process
    # (profile_steps).
    gemm = {}
    for name, c in (("f32", f32_ctx), ("bf16", ctx)):
        cubes, _ = transform._cubes_and_sums(frames_dev[:8], c.cfg)
        half = torch.zeros((cubes.shape[0], 256), dtype=c.dtype, device="cuda")
        gemm[f"{name}_encode_gemm_us"] = 1e3 * median_ms(lambda: cubes @ c.enc_t)
        gemm[f"{name}_decode_gemms_us"] = 1e3 * median_ms(
            lambda: half @ c.dec_me + half @ c.dec_mo)
    del frames_dev
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile-steps"],
                         capture_output=True, text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    check(res.returncode == 0, f"--profile-steps: rc {res.returncode}\n{res.stderr[-3000:]}")
    profiled = json.loads(res.stdout.strip().splitlines()[-1])
    for r in rows:
        r["device_us"] = profiled[r["name"]]["us"]
    times = {k: [] for k in ("f32_enc", "bf16_enc", "f32_dec", "bf16_dec")}
    for _ in range(3):
        times["f32_enc"].append(_timed(lambda: encode_clip(clip, f32_cfg, f32_ctx)))
        times["bf16_enc"].append(_timed(lambda: encode_clip(clip, cfg, ctx)))
        times["f32_dec"].append(_timed(lambda: port.decode_video(
            lib["par"], W, H, T, f32_cfg, f32_ctx, positions=f32_positions,
            sync_offsets=lib["syncs"])))
        times["bf16_dec"].append(_timed(lambda: port.decode_video(
            data, W, H, T, cfg, ctx, positions=positions, sync_offsets=syncs)))
    times["bf16_enc"].append(enc_s)
    times["bf16_dec"].append(dec_s)
    gop_steps = T // 8
    emit(phase="bf16", card=smi, launches=launches, **report, **gemm,
         profiled={k: v for k, v in profiled.items() if k in ("f32", "bf16")},
         encode_step_us={k: [1e3 * e / gop_steps for e, _ in v] for k, v in steps.items()},
         decode_step_us={k: [1e3 * dd / gop_steps for _, dd in v] for k, v in steps.items()},
         **{f"{k}_fps": T / min(v) for k, v in times.items()})


def main() -> None:
    card, smi = phase_device()
    phase_build()

    clip = synthetic_clip(T, H, W)
    cfg_par = port.CodecConfig(deflate_workers=-1)
    cfg_ser = port.CodecConfig()
    ctx = port.TransformContext(cfg_ser, "cuda")
    ctx_par = port.TransformContext(cfg_par, "cuda")
    rows = phase_kernels(clip[:8], ctx, card)
    phase_deflate(clip[:8], ctx, card)
    trows = phase_turbo_kernels(clip[:8], ctx, card)
    brows = phase_k5_kernels(portrait_clip()[:4],
                             port.TransformContext(port.CodecConfig(**BLOCK_CFG), "cuda"), card)
    bf16_rows = phase_bf16_kernels(clip[:8], card)

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
          "device and serial sinks carry different payloads")
    check(launches.get("deflate", 0) == T // 8,
          f"the device sink launched {launches.get('deflate', 0)} times for {T // 8} GOPs")
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
    bpp_ser = port.bits_per_pixel(len(ser), W, H, T)
    psnr = port.psnr(clip, out_par)
    check_bpp(bpp_ser, BPP_REF, "serial sink", device_sink=False)
    check_bpp(bpp, bpp_ser, "device sink vs serial zlib-9", device_sink=True)
    check(abs(psnr - PSNR_REF) <= 0.02, f"psnr {psnr} vs {PSNR_REF}")
    emit(phase="decode", bpp=bpp, bpp_serial=bpp_ser, psnr_db=psnr,
         gop0_max_abs_diff=int(d.max()),
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
    check_bpp(tbpp, JAX_TURBO_BPP, "turbo vs JAX", device_sink=True)
    check(tlaunches.get("deflate", 0) == T // 8, "the turbo encode's planes did not each "
          "take the card's DEFLATE")
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

    # The 4x4x4 paths, each with launch counts of its own.
    launches4, portrait_cropped = phase_blocks(clip, smi)
    for r in brows:
        r["launches"] = launches4.get(r["name"], 0)
        check(r["launches"] > 0, f"kernel {r['name']} never ran on the padded-portrait path")

    # Timing: best of 3 end-to-end runs; device-only runs on resident input.
    enc_best = best_of_3(enc_s, lambda: encode_clip(clip, cfg_par, ctx_par))
    dec_best = best_of_3(dec_s, lambda: port.decode_video(
        par, W, H, T, cfg_par, ctx_par, positions=positions, sync_offsets=syncs))
    tenc_best = best_of_3(tenc_s, lambda: port.encode_turbo_video(clip, cfg_t, ctx_t))
    tdec_best = best_of_3(tdec_s, lambda: port.decode_turbo_container(tdata, W, H, cfg_t, ctx_t))
    frames_dev = torch.from_numpy(clip).to("cuda")
    enc_dev_ms, dec_dev_ms = device_ms(frames_dev, ctx, ser, positions, W, H)
    tenc_dev_ms, tdec_dev_ms = turbo_device_ms(frames_dev, ctx_t, tdata, W, H)
    emit(phase="timing", card=smi, frames=T, width=W, height=H,
         encode_fps=T / enc_best, decode_fps=T / dec_best,
         encode_device_fps=T / (enc_dev_ms / 1e3),
         decode_device_fps=T / (dec_dev_ms / 1e3),
         turbo_encode_fps=T / tenc_best, turbo_decode_fps=T / tdec_best,
         turbo_encode_device_fps=T / (tenc_dev_ms / 1e3),
         turbo_decode_device_fps=T / (tdec_dev_ms / 1e3))

    # This slice's library paths, each with launch counts of its own; then
    # the command line.  All after the library's timing, so that runs under
    # the same conditions as before.
    lib = {"par": par, "ser": ser, "ends": ends_par, "syncs": syncs, "out_par": out_par,
           "out_ser": out_ser}
    phase_delta(clip, lib, smi)
    phase_host_encode(clip, lib, smi)
    phase_speculative(lib, ctx, smi)
    rgb_lib = phase_rgb(smi)
    phase_checkpoint(clip, lib, smi)
    phase_cli(clip, lib, portrait_cropped, rgb_lib, smi)
    phase_mesh(clip, {**lib, "tdata": tdata}, smi)
    phase_bf16(clip, lib, smi, bf16_rows)

    print(json.dumps({"kernels": rows + brows + trows + bf16_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--profile-steps"]:
        print(json.dumps(profile_steps()), flush=True)
    else:
        main()
