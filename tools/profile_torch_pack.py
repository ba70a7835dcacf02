#!/usr/bin/env python
"""Device time of the port's Exp-Golomb pack stage and exception
compaction at one 1080p GOP, by kernel name, on one NVIDIA GPU.

    python3 tools/profile_torch_pack.py [--label NAME] [--out-dir DIR]

Prints one JSON line per stage, with its eight slowest kernels, and writes
them all, every kernel included, to DIR/profile_<label>.json (DIR defaults
to the working directory).  For each stage: torch.profiler over REPS calls
after 3 warm-up calls, device time per call summed by kernel name (us) and
their total; the median CUDA-event time of 15 calls (ms, warm L2); and the
median host time of one call until it returns (ms: what Python and the
launches cost before the card can start).  The stages, at one 8x8x8 GOP of
chip_smoke.py's bench clip: the pack stage of bitpack.pack_values
(geometry, phase, level 1, carry lead), level 1 alone, a fill of every word
of the (groups, w_words) rows (what writing whole rows costs), group_bits
where the port has it, the exception compaction at 16 slots, the reference
and the turbo encode steps; the 4x4x4 reference encode step of a 4-frame GOP
of the same clip; each other kernel of the port alone at its main path's
shapes (K1, K3, K4, K7, K8 at the 8x8x8 GOP, K5 at one padded-portrait
4x4x4 GOP), and t().contiguous() of the turbo plane and wire, the one
library call that computes K7's and K8's function; then, at the padded
portrait GOP, the whole pack_bits route (codes and widths in) and the
whole encode step, which put the plain-torch glue around K5 by name; and
K3 on one group, the launch-latency floor of the splice_8 stage.  Encode
device fps are chip_smoke.py's to measure, not this tool's.

It calls only functions that the port has had since its 4x4x4 slice, so a
checkout of an earlier commit can run a copy of this file (put it in that
checkout's tools/; the file imports the checkout it lies in) and the two
can be compared in one call on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as smoke  # noqa: E402
import dct3d_tpu_torch as port  # noqa: E402
from dct3d_tpu_torch.codec import transform, turbo  # noqa: E402
from dct3d_tpu_torch.ops import (  # noqa: E402
    bitpack, exc_pack, expgolomb, group_pack, relayout, splice)

REPS = 20  # profiled calls per stage


def short(name: str) -> str:
    """A kernel's name without its argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i:
            return name[:i][:100]
    return name[:100]


def by_kernel(fn) -> tuple[dict, float]:
    """Device us per call of fn by kernel name, and their sum."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.self_device_time_total:
            out[short(e.key)] = out.get(short(e.key), 0.0) + e.self_device_time_total / REPS
    out = dict(sorted(out.items(), key=lambda kv: -kv[1]))
    return out, sum(out.values())


def host_ms(fn, reps: int = 15) -> float:
    """Median host ms of one call of fn, from the call until it returns
    (the kernels it queued may still be running), after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out-dir", default=".")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    lines = []

    def emit(**fields):
        fields = {"label": args.label, "card": card, **fields}
        lines.append(fields)
        top = dict(list(fields.get("kernels", {}).items())[:8])
        print(json.dumps({**fields, **({"kernels": top} if top else {})}), flush=True)

    def stage(name, fn, **extra):
        kern, total = by_kernel(fn)
        emit(stage=name, event_ms=smoke.median_ms(fn), host_ms=host_ms(fn),
             device_us=total, kernels={k: round(v, 3) for k, v in kern.items()}, **extra)

    dev = "cuda"
    clip = smoke.synthetic_clip(smoke.T, smoke.H, smoke.W)
    ctx = port.TransformContext(port.CodecConfig(), dev)
    ctx4 = port.TransformContext(port.CodecConfig(**smoke.BLOCK_CFG), dev)
    frames = torch.from_numpy(clip[:8]).to(dev)
    cubes, sums = relayout.frames_to_cubes(frames)
    v2 = transform._quantize(cubes, sums, ctx.enc_t, ctx.cfg).reshape(-1, group_pack.GROUP)
    w_words = bitpack.worst_case_w_words(group_pack.GROUP, bitpack.max_codeword_bits(512))
    code = torch.tensor(5, dtype=torch.int64, device=dev)
    bits = torch.tensor(3, dtype=torch.int64, device=dev)
    gstart, gend = bitpack.geometry(v2, bits)
    phase = (gstart & 31).to(torch.int32)
    content = int((((gend - 1) >> 5) - (gstart >> 5) + 1).sum())

    def pack_stage():
        start, _ = bitpack.geometry(v2, bits)
        rows = group_pack.group_pack_values(v2, (start & 31).to(torch.int32), w_words)
        bitpack.or_carry_lead(rows, code, bits)

    whole = torch.empty((v2.shape[0], w_words), dtype=torch.int32, device=dev)
    stage("pack_stage_8", pack_stage, groups=v2.shape[0], w_words=w_words,
          content_words=content)
    stage("group_pack_values_8", lambda: group_pack.group_pack_values(v2, phase, w_words))
    stage("fill_whole_rows_8", whole.zero_, bytes=whole.numel() * 4)
    del whole
    if hasattr(group_pack, "group_bits"):
        stage("group_bits_8", lambda: group_pack.group_bits(v2))
    qp = transform._quantize(cubes, sums, ctx.enc_t_pair, ctx.cfg).reshape(-1, exc_pack.GROUP)
    stage("compact_groups_8", lambda: exc_pack.compact_groups(qp, 16, 512))
    stage("encode_step_8", lambda: transform.encode_step(frames, ctx, code, bits))
    stage("turbo_step_8", lambda: turbo.encode_step_turbo(frames, ctx, wire=True))
    stage("encode_step_4", lambda: transform.encode_step(frames[:4], ctx4, code, bits))

    # Each other kernel alone, at its main path's shapes, and the library
    # call of K7 and K8.
    rows = group_pack.group_pack_values(v2, phase, w_words)
    bitpack.or_carry_lead(rows, code, bits)
    sw, ge = (gstart >> 5).to(torch.int32), gend.to(torch.int32)
    nwords = bitpack.stream_words(v2.numel(), bitpack.max_codeword_bits(512))
    half = v2.reshape(cubes.shape[0], -1, 2)
    pixels = transform._dequant_matmul(half[..., 0], half[..., 1], ctx.dec_me, ctx.dec_mo)
    plane = turbo._plane_and_tables(qp, 16).plane.reshape(-1, 256)
    wire = relayout.plane_to_wire(plane)
    for name, fn in (
            ("frames_to_cubes_8", lambda: relayout.frames_to_cubes(frames)),
            ("splice_8", lambda: splice.splice(rows, sw, ge, nwords)),
            ("cubes_to_frames_8", lambda: relayout.cubes_to_frames(pixels, smoke.H, smoke.W)),
            ("plane_to_wire_8", lambda: relayout.plane_to_wire(plane)),
            ("wire_to_plane_8", lambda: relayout.wire_to_plane(wire)),
            ("plane_t_contiguous_8", lambda: plane.t().contiguous()),
            ("wire_t_contiguous_8", lambda: wire.t().contiguous())):
        stage(name, fn)
    # K5 at one padded-portrait GOP, after a 0-bit carry pseudo-codeword as
    # encode_step builds its batch (46,368 groups, the last partial).
    q4 = transform.quantize_step(torch.from_numpy(smoke.portrait_clip()[:4]).to(dev), ctx4)
    c4, w4 = expgolomb.codewords(q4.reshape(-1))
    lead = torch.zeros(1, dtype=c4.dtype, device=dev)
    code2, wid2 = expgolomb.grouped(torch.cat([lead, c4]), torch.cat([lead, w4]))
    gb4 = wid2.sum(1, dtype=torch.int64)
    phase4 = ((torch.cumsum(gb4, 0) - gb4) & 31).to(torch.int32)
    ww4 = bitpack.worst_case_w_words(group_pack.GROUP,
                                     bitpack.max_codeword_bits(ctx4.cfg.cube_size))
    stage("group_pack_codes_4", lambda: group_pack.group_pack_codes(code2, wid2, phase4, ww4),
          groups=code2.shape[0], w_words=ww4)
    # The rest of the portrait route around K5: the whole pack_bits (codes
    # and widths in: grouping, geometry, K5, K3, tail byte) and the whole
    # encode step (quantize, int64 codewords, the carry's two cats,
    # pack_bits).
    mw4 = bitpack.max_codeword_bits(ctx4.cfg.cube_size)
    code4, width4 = torch.cat([lead, c4]), torch.cat([lead, w4])
    stage("pack_bits_4", lambda: bitpack.pack_bits(code4, width4, mw4))
    pframes = torch.from_numpy(smoke.portrait_clip()[:4]).to(dev)
    stage("encode_step_portrait_4", lambda: transform.encode_step(pframes, ctx4, code, bits))
    # K3 on one group of the 8x8x8 rows: the launch and tail latency that
    # bound a grid this small, the practical floor of splice_8.
    stage("splice_one_group", lambda: splice.splice(
        rows[:1], sw[:1], ge[:1], bitpack.stream_words(group_pack.GROUP, 27)))

    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, f"profile_{args.label}.json"), "w") as f:
        json.dump(lines, f, indent=1)


if __name__ == "__main__":
    main()
