"""Command-line interface of the port: ``python -m dct3d_tpu_torch``.

Follows ``dct3d_tpu/cli.py`` subcommand by subcommand and flag by flag,
and writes the same files (tests/test_torch_cli.py holds the two to equal
bytes):

  encode/decode  <in> <out> <width> <height> [frames]  on --device (default
                 cuda; --device cpu runs the kernels' plain versions)
  info           inspect a stream or container
  devices        the CUDA devices, with their power limit
  capture, split, mix, render, sweep, psnr   as in the JAX package

A default encode writes an indexed D3MH container: one temporal member,
then an index member with the per-GOP bit ends and the parallel-inflate
sync offsets, so decode needs no frame count.  ``--rgb`` carries a colour
clip as three channel members, ``--checkpoint-every N`` writes a resumable
container (a rerun resumes; decode then reads the geometry from its
``.meta`` sidecar), and ``--transport-delta`` ships temporal deltas to the
device without changing a byte.  ``--mesh GxT`` runs encode and decode on
a (gop, tile) mesh of G*T CUDA devices (with ``--device cpu``, of G*T
CPU shards) and writes the single-device bytes (parallel/sharding.py).
``--dtype bfloat16`` runs the lossy fast profile (bfloat16 matmuls on the
tensor cores; ``--parity`` refuses it).  ``--pack-bits`` and
``--gops-per-batch`` size the TPU's buffers and batches, never the bytes,
and are accepted and ignored.  Without a card,
encode, decode and sweep exit 2 unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import struct
import sys
import time

import numpy as np

from . import metrics
from .config import CodecConfig

#: GOPs read from the input per batch; the encoders still run one GOP per
#: device step (a batched quantize could round a 4x4x4 tie otherwise).
_BATCH_GOPS = 4


def _norm_dtype(d: str) -> str:
    return {"bf16": "bfloat16", "f32": "float32"}.get(d, d)


def _device(args):
    """The torch device of --device, or None after printing why (the
    caller returns 2): a CUDA device needs a card, and the CPU is used only
    when asked for."""
    import torch

    try:
        dev = torch.device(args.device)
    except RuntimeError as e:
        print(f"--device {args.device!r}: {e}", file=sys.stderr)
        return None
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"--device {args.device}: no CUDA device "
              "(torch.cuda.is_available() is false); --device cpu runs the "
              "plain PyTorch versions of the kernels on the CPU",
              file=sys.stderr)
        return None
    return dev


def _cfg_from_args(args) -> CodecConfig:
    level = args.zlib_level
    if level is None:
        # Reference parity wants Z_BEST_COMPRESSION (encoder.c:139); the
        # turbo profile deflates the raw nibble plane, where level 9 costs
        # far more time for ~5% rate, so it defaults to 6.  Turbo's default
        # codec is zstd, which ignores this knob.
        level = 6 if getattr(args, "turbo", False) else 9
    return CodecConfig(
        turbo_codec=getattr(args, "turbo_codec", "zstd"),
        turbo_zstd_level=getattr(args, "turbo_zstd_level", None) or 3,
        block_w=args.block,
        block_h=args.block,
        block_d=args.block,
        quant_strength=args.quant,
        quant_bias=getattr(args, "quant_bias", 0.5),
        transport_delta=getattr(args, "transport_delta", False),
        zlib_level=level,
        deflate_workers=0 if getattr(args, "parity", False) else args.deflate_workers,
        compute_dtype=_norm_dtype(getattr(args, "dtype", "float32")),
        pack_bits_per_value=getattr(args, "pack_bits", None) or 4,
    )


def _add_codec_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument(
        "width", type=int, nargs="?", default=None,
        help="frame width (required for raw input; PNG sequences and .y4m "
        "streams carry their own geometry)",
    )
    p.add_argument("height", type=int, nargs="?", default=None)
    p.add_argument(
        "frames", type=int, nargs="?", default=None,
        help="frame count (default: derived from file size, the fallback the "
        "reference intended at Encoder.java:34-36)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="torch device: cuda (default; exits 2 without a card) or cpu "
        "(the kernels' plain PyTorch versions)",
    )
    p.add_argument("--block", type=int, default=8, help="DCT cube edge (8 or 4)")
    p.add_argument("--quant", type=int, default=5, help="quantization strength")
    p.add_argument(
        "--quant-bias", type=float, default=0.5,
        help="quantizer rounding bias; 0.5 = reference parity, ~0.4 = "
        "deadzone (the stream stays reference-decodable)",
    )
    p.add_argument(
        "--zlib-level", type=int, default=None,
        help="DEFLATE level (default 9 = reference C encoder; the turbo "
        "profile defaults to 6)",
    )
    p.add_argument(
        "--gops-per-batch", type=int, default=4,
        help="accepted for the JAX CLI's scripts and ignored: it batches TPU "
        "dispatches, never the bytes",
    )
    p.add_argument(
        "--deflate-workers", type=int, default=-1,
        help="DEFLATE threads (-1 = all cores but one; 0 = serial "
        "reference-parity stream layout)",
    )
    p.add_argument(
        "--parity", action="store_true",
        help="byte-exact stream layout vs the serial reference encoder "
        "(same as --deflate-workers 0)",
    )
    p.add_argument(
        "--pack-bits", type=int, default=None, metavar="N",
        help="accepted for the JAX CLI's scripts and ignored: it sizes TPU "
        "pack buffers, never the bytes",
    )
    p.add_argument(
        "--dtype", default="float32",
        choices=("float32", "bfloat16", "f32", "bf16"),
        help="transform matmul dtype: float32 (default) is byte-exact "
        "reference parity; bfloat16 is the fast profile — the stream stays "
        "reference-decodable within 0.7 dB (tests/test_pipeline.py pins "
        "the floor; RD/speed table in PERFORMANCE.md)",
    )
    p.add_argument(
        "--stats", action="store_true",
        help="encode: print per-stage timing/bandwidth JSON to stderr",
    )
    p.add_argument(
        "--transport-delta", action="store_true",
        help="encode: ship frames to the device as temporal deltas (output "
        "unchanged)",
    )
    p.add_argument(
        "--rgb", action="store_true",
        help="treat input/output as interleaved RGB (3 B/px): channels are "
        "coded separately and carried as 3 members of one container",
    )
    p.add_argument(
        "--turbo", action="store_true",
        help="encode: turbo (planar) profile — the wire carries the "
        "nibble-plane device transport per GOP (D3MH type-5 members); "
        "identical pixels, smaller files; only this codec reads it (decode "
        "auto-detects; see docs/FORMAT.md)",
    )
    p.add_argument(
        "--turbo-codec", choices=("zstd", "zlib"), default="zstd",
        help="turbo payload codec (zstd when the zstandard module imports, "
        "else zlib). Decode sniffs per stream — no flag needed",
    )
    p.add_argument(
        "--turbo-zstd-level", type=int, default=None,
        help="zstd level for turbo payloads (default 3)",
    )
    p.add_argument(
        "--index", action="store_true", default=None,
        help="encode: wrap the stream in a D3MH container with a seekable "
        "per-GOP bit index member (DEFAULT for file outputs); with --parity "
        "the reference-byte-exact stream stays raw and the index goes to a "
        "<output>.idx sidecar (decode auto-loads it)",
    )
    p.add_argument(
        "--no-index", dest="index", action="store_false",
        help="encode: emit the raw headerless stream (decode then needs an "
        "explicit frame count)",
    )
    p.add_argument(
        "--checkpoint-every", type=int, default=0, metavar="GOPS",
        help="encode: write a resumable member container (D3MH) with durable "
        "progress every N GOPs; re-running the same command resumes",
    )
    p.add_argument(
        "--profile-dir", default=None,
        help="write a torch.profiler trace of the run to DIR/trace.json",
    )
    p.add_argument(
        "--mesh", default=None, metavar="GxT",
        help="run on a (gop, tile) device mesh, e.g. 4x1 or 2x2: G*T CUDA "
        "devices (with --device cpu, G*T CPU shards); the bitstream stays "
        "byte-identical to single-device",
    )
    p.add_argument(
        "--pad", action="store_true",
        help="encode: edge-replicate frames up to block multiples; decode "
        "then takes the padded geometry and --crop WxH",
    )
    p.add_argument(
        "--crop", default=None, metavar="WxH",
        help="decode: crop the decoded frames back to WxH (pairs with "
        "encode --pad)",
    )
    p.add_argument(
        "--range", default=None, metavar="A:B", dest="frame_range",
        help="decode: random-access decode of frames [A, B) only",
    )


def _make_cli_mesh(spec: str, device):
    """The (gop, tile) mesh of --mesh, or None after printing why (the
    caller returns 2).  On CUDA it takes the first G*T cards and needs that
    many; with --device cpu every shard runs on the CPU."""
    import torch

    from .parallel.mesh import make_mesh

    g, _, t = spec.lower().partition("x")
    try:
        gop, tile = int(g), int(t or 1)
        if gop < 1 or tile < 1:
            raise ValueError
    except ValueError:
        print(f"--mesh expects GxT (e.g. 4x1, 2x2), got {spec!r}", file=sys.stderr)
        return None
    if device.type != "cuda":
        return make_mesh(gop=gop, tile=tile, devices=[device] * (gop * tile))
    found = torch.cuda.device_count()
    if gop * tile > found:
        print(f"--mesh {spec} needs {gop * tile} devices, found {found} "
              "(see `devices`)", file=sys.stderr)
        return None
    return make_mesh(gop=gop, tile=tile,
                     devices=[torch.device("cuda", i) for i in range(gop * tile)])


def _setup_mesh(args, cfg, frames, device):
    """One scaffold for the encode paths: (mesh, align, frames), or None
    after printing the error (the caller returns 2).  Without --mesh, mesh
    is None and align the GOP size; with it, align is gop_size * mesh gop
    and frames (None = until EOF: the batches align downstream) truncate to
    whole mesh steps."""
    if not args.mesh:
        return None, cfg.gop_size, frames
    mesh = _make_cli_mesh(args.mesh, device)
    if mesh is None:
        return None
    align = cfg.gop_size * mesh.shape["gop"]
    if frames is not None:
        old, frames = frames, frames - frames % align
        if frames == 0:
            print(f"input shorter than one {align}-frame mesh step", file=sys.stderr)
            return None
        if frames != old:
            print(f"note: truncating to {frames} frames (mesh step {align})",
                  file=sys.stderr)
    return mesh, align, frames


def _load_footage(args):
    """Detect and load non-raw input (stdin pipe / PNG sequence / y4m).

    Returns (video_or_None, width, height): video None means "raw file,
    stream it from disk"; a StreamFrames streams a pipe; otherwise the
    footage is in memory and geometry came from the content.
    """
    inp = args.input
    if inp == "-":
        if args.width is None or args.height is None:
            print("stdin input needs explicit width and height",
                  file=sys.stderr)
            raise SystemExit(2)
        from .io import rawvideo

        stream = rawvideo.StreamFrames(sys.stdin.buffer, args.width,
                                       args.height, 3 if args.rgb else 1)
        return stream, args.width, args.height
    is_png = (
        os.path.isdir(inp)
        or any(c in inp for c in "*?[")
        or inp.lower().endswith(".png")
    )
    is_y4m = False
    if not is_png and os.path.isfile(inp):
        with open(inp, "rb") as f:
            is_y4m = f.read(9) == b"YUV4MPEG2"
    if is_png:
        from .io.png import read_png_sequence

        video = read_png_sequence(inp, frames=args.frames, gray=not args.rgb)
    elif is_y4m:
        from .io.y4m import read_y4m, read_y4m_rgb

        # --rgb: BT.601 YCbCr -> RGB; the planes take the RGB member path.
        read = read_y4m_rgb if args.rgb else read_y4m
        video, _info = read(inp, frames=args.frames)
    else:
        return None, args.width, args.height
    h, w = video.shape[1], video.shape[2]
    if (args.width, args.height) not in ((None, None), (w, h)):
        print(f"note: input carries its own geometry {w}x{h}; "
              "ignoring the command-line values", file=sys.stderr)
    return video, w, h


def cmd_encode(args) -> int:
    from .codec.encoder import StreamingEncoder
    from .codec.transform import TransformContext
    from .io import rawvideo
    from .profiling import profile_to

    cfg = _cfg_from_args(args)
    if args.parity and cfg.compute_dtype != "float32":
        print("--parity (byte-exact reference layout) cannot combine with "
              "the lossy --dtype bfloat16 fast profile", file=sys.stderr)
        return 2
    if args.output == "-" and (args.index or args.checkpoint_every):
        print("stdout output cannot combine with --index (needs a seekable "
              "file) or --checkpoint-every (needs fsync/resume)",
              file=sys.stderr)
        return 2
    say = (lambda *a: print(*a, file=sys.stderr)) \
        if args.output == "-" else print
    if args.turbo:
        for flag, why in (
            ("index", "turbo members are already per-GOP seekable"),
            ("parity", "turbo is an extension profile, never byte-parity"),
        ):
            if getattr(args, flag, None):
                print(f"--turbo cannot combine with --{flag} ({why})",
                      file=sys.stderr)
                return 2
    elif args.output == "-" and args.index is None and not args.parity:
        print("note: stdout cannot seek to patch a container header, so the "
              "index is dropped and the output is the raw headerless stream "
              "(decode needs the frame count; write to a file for the "
              "indexed container)", file=sys.stderr)
    dev = _device(args)
    if dev is None:
        return 2
    if args.mesh and args.transport_delta:
        print("warning: --transport-delta is a single-device upload "
              "optimization; the sharded path ships raw frames (output "
              "is identical)", file=sys.stderr)
    video, width, height = _load_footage(args)
    if width is None or height is None:
        print("raw input needs explicit width and height", file=sys.stderr)
        return 2
    stream = video if isinstance(video, rawvideo.StreamFrames) else None
    if stream is not None and args.rgb:
        # The three channel passes re-read the footage and a pipe cannot be
        # re-read, so this path buffers the whole pipe.
        print("warning: --rgb with piped input buffers the WHOLE pipe in "
              "RAM (channel passes re-read the footage) — use a file input "
              "for bounded memory", file=sys.stderr)
        video, stream = stream.read_all(), None
    if args.pad:
        from .io.pad import pad_frames, padded_geometry, padded_stream

        pw, ph = padded_geometry(width, height, cfg.block_w, cfg.block_h)
        if (pw, ph) != (width, height):
            if stream is not None:
                video = stream = padded_stream(stream, cfg.block_w,
                                               cfg.block_h)
            else:
                if video is None:
                    video = rawvideo.read_video(args.input, width, height, args.frames,
                                                channels=3 if args.rgb else 1)
                video = pad_frames(video, cfg.block_w, cfg.block_h)
            print(
                f"note: padded {width}x{height} -> {pw}x{ph}; decode with "
                f"geometry {pw} {ph} and --crop {width}x{height}",
                file=sys.stderr,
            )
            width, height = pw, ph
    if args.rgb:
        return _encode_rgb(args, cfg, dev, video, width, height, say)
    if stream is not None:
        total = None  # a pipe's length is unknowable up front
    elif video is not None:
        total = video.shape[0]
    else:
        total = rawvideo.frame_count(args.input, width, height)
    if total is None:
        frames = args.frames  # None = until EOF; tail trims per batch
    else:
        frames = total if args.frames is None else min(args.frames, total)
    if frames is not None:
        frames -= frames % cfg.gop_size
        if frames == 0:
            print(
                f"nothing to encode: input holds fewer than one GOP "
                f"({cfg.gop_size} frames; reference truncates the same way, "
                "Encoder.java:39-40)", file=sys.stderr,
            )
            return 2
    if args.checkpoint_every:
        return _encode_checkpointed(args, cfg, dev, video, width, height, frames)
    ms = _setup_mesh(args, cfg, frames, dev)
    if ms is None:
        return 2
    mesh, align, frames = ms
    if args.turbo:
        from .codec.turbo import TurboEncoder, TurboShardedEncoder

        if mesh is not None:
            enc = TurboShardedEncoder(width, height, mesh, cfg)
        else:
            enc = TurboEncoder(width, height, cfg, TransformContext(cfg, dev))
        t0 = time.perf_counter()
        written = 0
        with profile_to(args.profile_dir), _open_out(args.output) as out:
            for batch in _frame_batches(args, video, width, height, align,
                                        frames):
                written += out.write(enc.push(batch))
            written += out.write(enc.finish())
        dt = time.perf_counter() - t0
        frames = enc.frames_encoded
        if frames == 0:
            print(f"nothing to encode: input shorter than one "
                  f"{align}-frame step", file=sys.stderr)
            return 2
        say(
            f"encoded {frames} frames {width}x{height} -> {written} bytes "
            f"(turbo, "
            f"{metrics.bits_per_pixel(written, width, height, frames):.3f} "
            f"bpp) in {dt:.2f}s ({frames / dt:.1f} fps)"
        )
        if args.stats and hasattr(enc, "timer"):
            print(enc.timer.report(), file=sys.stderr)
        return 0
    if mesh is not None:
        from .parallel.sharding import ShardedEncoder

        enc = ShardedEncoder(width, height, mesh, cfg)
    else:
        enc = StreamingEncoder(width, height, cfg, TransformContext(cfg, dev))
    # Seekability is the default for file outputs: the stream is wrapped in
    # an indexed container, so decode needs no frame count and the host
    # entropy stage jumps straight to every GOP.  --parity keeps the raw
    # reference-byte-exact layout (with --index the index goes to a
    # <output>.idx sidecar); --no-index keeps the raw headerless stream;
    # stdout cannot seek to patch the header, so it stays raw.
    write_container = (not args.parity and args.index is not False
                       and args.output != "-")
    write_sidecar = bool(args.index) and args.parity
    t0 = time.perf_counter()
    written = 0
    with profile_to(args.profile_dir), _open_out(args.output) as out:
        if write_container:
            from .parallel.multihost import (
                _MAX_MEMBER_FRAMES, MEMBER_MAGIC, MEMBER_TEMPORAL,
                make_index_member,
            )

            if frames is not None and frames > _MAX_MEMBER_FRAMES:
                if args.index:
                    print(f"--index: {frames} frames exceed one member's "
                          f"2^24-1 limit", file=sys.stderr)
                    return 2
                print(f"note: {frames} frames exceed one indexed member's "
                      "2^24-1 limit; writing a raw headerless stream",
                      file=sys.stderr)
                write_container = False
        if write_container:
            # Placeholder member header now; the frame count and payload
            # length are patched after streaming (a pipe's length is
            # unknowable up front), the index member appended last.
            if frames is None:  # pipe: bound by the member header field
                frames = _MAX_MEMBER_FRAMES - _MAX_MEMBER_FRAMES % align
            out.write(MEMBER_MAGIC + struct.pack("<IQ", 0, 0))
        for batch in _frame_batches(args, video, width, height, align, frames):
            written += out.write(enc.push(batch))
        written += out.write(enc.finish())
        if write_container:
            out.write(make_index_member(enc.gop_bit_ends,
                                        sync_offsets=enc.gop_sync_offsets))
            out.seek(4)
            out.write(struct.pack(
                "<IQ", (MEMBER_TEMPORAL << 24) | enc.frames_encoded, written
            ))
            written = out.seek(0, os.SEEK_END)
    if write_sidecar:
        from .parallel.multihost import make_index_member

        with open(args.output + ".idx", "wb") as sf:
            sf.write(make_index_member(enc.gop_bit_ends))
        say(f"index sidecar -> {args.output}.idx (stream file stays "
            "reference-byte-exact)")
    dt = time.perf_counter() - t0
    frames = enc.frames_encoded
    if frames == 0:
        print(f"nothing to encode: input shorter than one "
              f"{align}-frame step", file=sys.stderr)
        return 2
    say(
        f"encoded {frames} frames {width}x{height} -> {written} bytes "
        f"({metrics.bits_per_pixel(written, width, height, frames):.3f} bpp) "
        f"in {dt:.2f}s ({frames / dt:.1f} fps)"
    )
    if args.stats:
        print(enc.timer.report(), file=sys.stderr)
    return 0


def _encode_rgb(args, cfg, dev, video, width, height, say) -> int:
    """encode --rgb [--turbo] [--mesh]: the whole clip in memory, three
    channel members (index members too unless --no-index); on a mesh the
    channels are sharded and the members stay the single-device ones."""
    from .codec.transform import TransformContext
    from .io import rawvideo

    for flag in ("checkpoint_every", "profile_dir", "stats"):
        if getattr(args, flag, None):
            print(f"warning: --{flag.replace('_', '-')} is not yet "
                  "supported with --rgb and is ignored", file=sys.stderr)
    ms = _setup_mesh(args, cfg, None, dev)
    if ms is None:
        return 2
    mesh, align, _ = ms
    if video is None:
        video = rawvideo.read_video(args.input, width, height, args.frames,
                                    channels=3)
    t = video.shape[0] - video.shape[0] % align
    if t == 0:
        print(f"input shorter than one {align}-frame step", file=sys.stderr)
        return 2
    ctx = TransformContext(cfg, dev) if mesh is None else None
    t0 = time.perf_counter()
    if args.turbo:
        from .codec.turbo import encode_turbo_rgb_video

        data = encode_turbo_rgb_video(video, cfg, ctx, mesh=mesh)
    else:
        from .codec.rgb_codec import encode_rgb_video

        data = encode_rgb_video(video, cfg, ctx, index=args.index is not False,
                                mesh=mesh)
    dt = time.perf_counter() - t0
    with _open_out(args.output) as f:
        f.write(data)
    say(f"encoded {t} RGB frames {width}x{height} -> "
        f"{len(data)} bytes in {dt:.2f}s ({t / dt:.1f} fps)")
    return 0


def _encode_checkpointed(args, cfg, dev, video, width, height, frames) -> int:
    """encode --checkpoint-every N [--turbo] [--index] [--mesh]: a
    resumable member container; a rerun of the same command resumes after
    the last complete member.  Turbo on a mesh keeps every GOP (whole mesh
    steps go to the sharded encoder, a GOP tail to a single-device one);
    the reference profile truncates to whole mesh steps."""
    from .codec.checkpoint import CheckpointingEncoder
    from .codec.transform import TransformContext
    from .profiling import profile_to

    if args.turbo:
        mesh, align = None, cfg.gop_size
        if args.mesh:
            mesh = _make_cli_mesh(args.mesh, dev)
            if mesh is None:
                return 2
    else:
        ms = _setup_mesh(args, cfg, frames, dev)
        if ms is None:
            return 2
        mesh, align, frames = ms
    ctx = TransformContext(cfg, dev) if mesh is None else None
    t0 = time.perf_counter()
    with profile_to(args.profile_dir), CheckpointingEncoder(
        args.output, width, height, cfg, ctx,
        checkpoint_gops=args.checkpoint_every, turbo=args.turbo,
        # Explicit --index only: a resume must find the member layout of
        # the first run.
        index=bool(args.index), mesh=mesh,
    ) as cenc:
        skip = cenc.frames_done
        if skip:
            print(f"resuming at frame {skip}")
        for batch in _frame_batches(args, video, width, height,
                                    align, frames, start=skip):
            cenc.push(batch)
    dt = time.perf_counter() - t0
    written = os.path.getsize(args.output)
    kind = "turbo container" if args.turbo else "container"
    print(f"encoded {cenc.frames_done} frames -> {written} bytes ({kind}) "
          f"in {dt:.2f}s")
    return 0


def _frame_batches(args, video, width, height, align, frames, start=0):
    """Aligned frame batches from in-memory footage, a raw file, or a
    stdin pipe (constant-RSS streaming; frames None = until EOF), from
    frame ``start`` on (a checkpoint resume)."""
    from .io import rawvideo

    step = align * _BATCH_GOPS
    if isinstance(video, rawvideo.StreamFrames):
        yield from video.iter_batches(step, frames, align=align, start=start)
    elif video is not None:
        for i in range(start, frames, step):
            yield video[i : min(i + step, frames)]
    else:
        yield from rawvideo.iter_frame_batches(
            args.input, width, height, step, frames, align=align, start=start
        )


@contextlib.contextmanager
def _open_out(path):
    """Output sink; '-' streams to stdout (status then prints to stderr)."""
    if path == "-":
        yield sys.stdout.buffer
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            yield f


def _read_sidecar(path: str, cfg: CodecConfig):
    """(frames, positions, sync offsets, last bit end) from an .idx
    sidecar next to a raw stream, or all None when there is none or it is
    torn."""
    from .parallel.multihost import (
        MEMBER_INDEX, gop_positions, parse_index, parse_index_syncs,
        split_members,
    )

    if not os.path.exists(path):
        return None, None, None, None
    try:
        with open(path, "rb") as f:
            members = split_members(f.read())
    except ValueError:
        members = []
    ipay = next((p for _, p, t in members if t == MEMBER_INDEX), None)
    ends = parse_index(ipay) if ipay is not None else None
    if not ends:
        return None, None, None, None
    frames = len(ends) * cfg.gop_size
    return (frames, gop_positions(ends, len(ends), cfg.gop_size, frames),
            parse_index_syncs(ipay), ends[-1])


def _refuse_container(members) -> bool:
    """Print why and return True for a container of unknown member
    types."""
    from .codec.turbo import is_turbo_container, is_turbo_rgb_container
    from .parallel.multihost import container_kind

    if (is_turbo_container(members) or is_turbo_rgb_container(members)
            or container_kind(members) != "unknown"):
        return False
    print(f"unrecognized member type tags {[m[2] for m in members]}",
          file=sys.stderr)
    return True


def _rgb_streams(args, members) -> bool | None:
    """Whether a non-turbo container decodes as RGB: tagged channel members
    do, and --rgb picks a legacy all-zero-tag container of exactly three
    stream members.  None after printing why --rgb cannot apply."""
    from .parallel.multihost import MEMBER_INDEX, container_kind

    kind = container_kind(members)
    n_streams = sum(1 for m in members if m[2] != MEMBER_INDEX)
    if args.rgb and kind == "temporal" and n_streams != 3:
        print("--rgb requested but this container holds "
              f"{n_streams} temporal member(s)", file=sys.stderr)
        return None
    return kind == "rgb" or (args.rgb and n_streams == 3)


def _read_meta(args, cfg, width, height):
    """(cfg, width, height), from the input's .meta sidecar (written by a
    checkpointing encode) where there is one: it pins the codec parameters
    and the geometry, so stale command-line flags cannot decode to
    garbage."""
    meta_path = args.input + ".meta"
    if not os.path.exists(meta_path):
        return cfg, width, height
    with open(meta_path) as f:
        meta = json.load(f)
    mcfg = CodecConfig(**meta["cfg"])
    if ((width, height) != (meta["width"], meta["height"])
            or (cfg.block_w, cfg.block_h, cfg.block_d, cfg.quant_strength)
            != (mcfg.block_w, mcfg.block_h, mcfg.block_d, mcfg.quant_strength)):
        print(f"note: decoding with the parameters pinned in {meta_path} "
              "(the command-line flags differ)", file=sys.stderr)
    return mcfg, meta["width"], meta["height"]


def cmd_decode(args) -> int:
    from .profiling import profile_to

    cfg, width, height = _read_meta(args, _cfg_from_args(args), args.width,
                                    args.height)
    if width is None or height is None:
        print("decode requires explicit width and height (or a .meta "
              "sidecar next to the input)", file=sys.stderr)
        return 2
    dev = _device(args)
    if dev is None:
        return 2
    if args.input == "-":
        data = sys.stdin.buffer.read()
    elif os.path.exists(args.input):
        with open(args.input, "rb") as f:
            data = f.read()
    else:
        print(f"no such input: {args.input}", file=sys.stderr)
        return 2
    head = data[:4]
    if head != b"D3MH" and args.rgb:
        print("--rgb decode needs a D3MH container (produced by encode "
              "--rgb); this input is a raw grayscale stream", file=sys.stderr)
        return 2
    frame_range = None
    if args.frame_range is not None:
        a, _, b = args.frame_range.partition(":")
        try:
            frame_range = (int(a), int(b))
            if not (0 <= frame_range[0] < frame_range[1]):
                raise ValueError
        except ValueError:
            print(f"--range expects A:B with 0 <= A < B, got "
                  f"{args.frame_range!r}", file=sys.stderr)
            return 2
        if args.frames is not None:
            print("--range and an explicit frame count are mutually "
                  "exclusive", file=sys.stderr)
            return 2
        if args.mesh:
            print("note: --range decodes single-device; ignoring --mesh",
                  file=sys.stderr)
            args.mesh = None
    # Raw stream with an .idx sidecar (encode --parity --index): the
    # stream file is reference-byte-exact, the sidecar supplies the frame
    # count and the per-GOP positions for the indexed entropy path.
    side_frames = side_positions = side_syncs = side_end = None
    if head != b"D3MH" and args.input != "-":
        side_frames, side_positions, side_syncs, side_end = _read_sidecar(
            args.input + ".idx", cfg)
    if (head != b"D3MH" and args.frames is None
            and frame_range is None and side_frames is None):
        print("decode requires an explicit frame count or --range "
              "(headerless stream, as in the reference: Decoder.java:18; "
              "default encodes write an indexed container or an .idx "
              "sidecar that makes the count optional)",
              file=sys.stderr)
        return 2
    members = None
    as_rgb = False
    if head == b"D3MH":
        from .codec.turbo import is_turbo_container, is_turbo_rgb_container
        from .parallel.multihost import split_members

        members = split_members(data)
        if _refuse_container(members):
            return 2
        turbo = is_turbo_container(members) or is_turbo_rgb_container(members)
        if not turbo:
            as_rgb = _rgb_streams(args, members)
            if as_rgb is None:
                return 2
    t0 = time.perf_counter()
    with profile_to(args.profile_dir):
        video = None
        if args.mesh and not as_rgb:
            video = _decode_on_mesh(args, data, members, width, height, cfg, dev,
                                    side_frames, side_positions, side_end)
            if isinstance(video, int):
                return video
        if video is None:
            video = _decode_one_device(args, data, members, as_rgb, frame_range,
                                       width, height, cfg, dev, side_frames,
                                       side_positions, side_syncs, side_end)
        elif args.frames is not None:
            video = video[: args.frames]
    return _write_decoded(args, video, width, height, t0)


def _decode_one_device(args, data, members, as_rgb, frame_range, width, height,
                       cfg, dev, side_frames, side_positions, side_syncs, side_end):
    """cmd_decode on one device: the frames of a range, a container or a
    raw stream."""
    from .codec.auto import decode_auto, decode_auto_range
    from .codec.decoder import decode_video
    from .codec.rgb_codec import decode_rgb_range, decode_rgb_video
    from .codec.transform import TransformContext

    ctx = TransformContext(cfg, dev)
    if frame_range is not None and as_rgb:
        return decode_rgb_range(data, width, height, *frame_range, cfg, ctx)
    if frame_range is not None:
        return decode_auto_range(data, width, height, *frame_range, cfg, ctx=ctx,
                                 positions=side_positions, index_end=side_end)
    if members is not None:
        if as_rgb:
            video = decode_rgb_video(data, width, height, cfg, ctx)
        else:
            video = decode_auto(data, width, height, cfg=cfg, ctx=ctx)
        return video if args.frames is None else video[: args.frames]
    frames = args.frames if args.frames is not None else side_frames
    positions = side_positions
    if positions is not None and frames // cfg.gop_size > len(positions):
        positions = None  # a short sidecar: scan instead
    return decode_video(data, width, height, frames, cfg, ctx, positions=positions,
                        sync_offsets=side_syncs, index_end=side_end)


def _decode_on_mesh(args, data, members, width, height, cfg, dev,
                    side_frames, side_positions, side_end):
    """cmd_decode on --mesh: the frames, None where the container takes the
    single-device path (a note says why), or 2 after printing why the mesh
    cannot be built.

    A turbo container decodes on TurboShardedDecoder.  A single-stream
    temporal container feeds its member, with its index positions, to
    ShardedDecoder, unless its frames do not fill whole mesh steps (the
    sharded decoder would drop the tail).  Several stream members decode
    host-parallel instead, and turbo-RGB and RGB containers ignore the
    mesh.  A raw stream decodes on ShardedDecoder with the .idx sidecar's
    positions.  Either index is held against the payload first (R1)."""
    from .codec.turbo import TurboShardedDecoder, is_turbo_container
    from .parallel.multihost import (
        MEMBER_INDEX, MEMBER_TEMPORAL, gop_positions, parse_index,
    )
    from .parallel.sharding import ShardedDecoder

    if members is not None:
        if not is_turbo_container(members):
            if any(m[2] not in (MEMBER_TEMPORAL, MEMBER_INDEX) for m in members):
                return None  # turbo RGB: no mesh route
            n_streams = sum(1 for m in members if m[2] == MEMBER_TEMPORAL)
            if n_streams > 1:
                print("note: --mesh applies only to single-stream "
                      "containers; decoding members host-parallel instead",
                      file=sys.stderr)
            if n_streams != 1:
                return None
    mesh = _make_cli_mesh(args.mesh, dev)
    if mesh is None:
        return 2
    if members is not None and is_turbo_container(members):
        return TurboShardedDecoder(width, height, mesh, cfg).decode(data)
    step = cfg.gop_size * mesh.shape["gop"]
    if members is not None:
        frames, payload, _ = next(m for m in members if m[2] == MEMBER_TEMPORAL)
        if frames % step:
            print(f"note: {frames} frames don't fill whole {step}-frame mesh "
                  "steps; decoding single-device instead", file=sys.stderr)
            return None
        positions = index_end = None
        for _, p, mtype in members:
            if mtype == MEMBER_INDEX and (ends := parse_index(p)) is not None:
                positions = gop_positions(ends, frames // cfg.gop_size,
                                          cfg.gop_size, frames)
                index_end = ends[-1] if ends else None
        return ShardedDecoder(width, height, mesh, cfg).decode(
            payload, frames, positions=positions, index_end=index_end)
    frames = args.frames if args.frames is not None else side_frames
    positions = side_positions
    if positions is not None and frames // cfg.gop_size > len(positions):
        positions = None  # a short sidecar: scan instead
    return ShardedDecoder(width, height, mesh, cfg).decode(
        data, frames, positions=positions, index_end=side_end)


def _write_decoded(args, video, width, height, t0) -> int:
    """Shared tail of cmd_decode: crop, write (.y4m or raw), report."""
    from .io import rawvideo

    dt = time.perf_counter() - t0
    if args.crop:
        from .io.pad import crop_frames

        cw, _, ch = args.crop.lower().partition("x")
        video = crop_frames(video, int(cw), int(ch))
        width, height = int(cw), int(ch)
    if args.output == "-":
        sys.stdout.buffer.write(np.ascontiguousarray(video).tobytes())
        sys.stdout.buffer.flush()
    elif args.output.lower().endswith(".y4m"):
        from .io.y4m import write_y4m, write_y4m_rgb

        # Colour output: C444 BT.601 (read_y4m_rgb reads it back).
        (write_y4m_rgb if video.ndim == 4 else write_y4m)(args.output, video)
    else:
        rawvideo.write_video(args.output, video)
    print(
        f"decoded {video.shape[0]} frames {width}x{height} "
        f"in {dt:.2f}s ({video.shape[0] / dt:.1f} fps)",
        file=sys.stderr if args.output == "-" else sys.stdout,
    )
    return 0


def cmd_info(args) -> int:
    """Inspect a bitstream / container."""
    import zlib

    with open(args.input, "rb") as f:
        data = f.read()
    out: dict = {"bytes": len(data)}
    if data[:4] == b"D3MH":
        from .codec.turbo import (
            _ZSTD_MAGIC, MEMBER_TURBO, MEMBER_TURBO_RGB, is_turbo_container,
            is_turbo_rgb_container,
        )
        from .parallel.multihost import (
            MEMBER_INDEX, container_kind, parse_index, parse_index_syncs,
            split_members,
        )

        members = split_members(data)
        type_names = {0: "temporal", 1: "red", 2: "green", 3: "blue",
                      4: "index", 5: "turbo", 6: "turbo-red",
                      7: "turbo-green", 8: "turbo-blue"}

        def _index_info(payload):
            ends = parse_index(payload)
            if ends is None:
                return {"torn": True}
            info = {"gops": len(ends)}
            if parse_index_syncs(payload) is not None:
                info["parallel_inflate"] = True  # v2 sync offsets present
            return info

        out["format"] = "d3mh-container"
        out["kind"] = (
            "turbo" if is_turbo_container(members)
            else "turbo-rgb" if is_turbo_rgb_container(members)
            else container_kind(members)
        )
        out["members"] = [
            {"frames": frames, "bytes": len(payload),
             "type": type_names.get(mtype, mtype),
             **(_index_info(payload) if mtype == MEMBER_INDEX else {})}
            for frames, payload, mtype in members
        ]
        if out["kind"] == "rgb":
            out["frames"] = members[0][0]
        elif out["kind"] == "turbo-rgb":
            out["frames"] = sum(m[0] for m in members
                                if m[2] == MEMBER_TURBO_RGB[0])
        else:
            out["frames"] = sum(m[0] for m in members)
        if out["kind"] in ("turbo", "turbo-rgb"):
            payload = next((m[1] for m in members
                            if m[2] in (MEMBER_TURBO, *MEMBER_TURBO_RGB)), None)
            if payload is not None:
                out["codec"] = (
                    "zstd" if payload[16:20] == _ZSTD_MAGIC else "zlib"
                )
        meta_path = args.input + ".meta"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                out["meta"] = json.load(f)
    else:
        out["format"] = "raw-zlib-stream (reference-compatible, headerless)"
        try:
            payload = zlib.decompressobj().decompress(data, 1 << 20)
            out["payload_bytes_sampled"] = len(payload)
            out["note"] = ("geometry travels out of band; supply width/"
                           "height/frames to decode (Decoder.java:17-28)")
        except zlib.error:
            out["format"] = "unknown (not zlib, not D3MH)"
    print(json.dumps(out, indent=2))
    return 0


def _power_limits() -> dict[int, str]:
    """nvidia-smi's power limit by device index; empty where nvidia-smi
    is missing or fails."""
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return {}
    out = {}
    for line in res.stdout.splitlines():
        idx, _, limit = line.partition(",")
        if idx.strip().isdigit():
            out[int(idx)] = limit.strip()
    return out


def cmd_devices(_args) -> int:
    import torch

    if not torch.cuda.is_available():
        print("platform: cuda  devices: 0 (no CUDA device: "
              "torch.cuda.is_available() is false; encode and decode need "
              "--device cpu here)")
        return 0
    n = torch.cuda.device_count()
    limits = _power_limits()
    print(f"platform: cuda  devices: {n}")
    for i in range(n):
        limit = f"  power limit: {limits[i]}" if i in limits else ""
        print(f"  [{i}] {torch.cuda.get_device_name(i)}{limit}")
    return 0


def cmd_capture(args) -> int:
    from .io import synthetic

    cfg = CodecConfig()
    t, h, w = synthetic.capture(
        args.output, args.frames, args.height, args.width,
        cfg, kind=args.kind, rgb=args.rgb, seed=args.seed,
    )
    ch = 3 if args.rgb else 1
    print(f"captured {t} frames {w}x{h} x{ch}B/px -> {args.output}")
    return 0


def cmd_split(args) -> int:
    from .io import rgb

    outs = rgb.split_file(args.input, args.prefix)
    print("wrote: " + " ".join(outs))
    return 0


def cmd_mix(args) -> int:
    from .io import rgb

    out = rgb.mix_files(args.prefix, args.output)
    print(f"wrote: {out}")
    return 0


def cmd_render(args) -> int:
    from .io import render

    if args.play:
        try:
            return render.play_video(
                args.input, args.width, args.height, fps=args.fps,
                channels=3 if args.rgb else 1, player=args.player,
            )
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            return 2
    stats = render.video_stats(
        args.input, args.width, args.height, channels=3 if args.rgb else 1
    )
    print(json.dumps(stats))
    if args.png_prefix:
        sel = None  # default: first / middle / last
        if args.frames == "all":
            sel = list(range(stats["frames"]))
        elif args.frames and ":" in args.frames:
            a, _, b = args.frames.partition(":")
            sel = list(range(int(a or 0), min(int(b or stats["frames"]),
                                              stats["frames"])))
        elif args.frames:
            sel = [int(x) for x in args.frames.split(",")]
        outs = render.render_frames(
            args.input, args.width, args.height, args.png_prefix,
            frames=sel, channels=3 if args.rgb else 1,
        )
        print("wrote: " + " ".join(outs))
    return 0


def cmd_sweep(args) -> int:
    """Rate-distortion sweep: quant strength x block size -> bpp/PSNR/fps."""
    from .codec.decoder import decode_video
    from .codec.encoder import encode_video
    from .codec.transform import TransformContext
    from .io import rawvideo

    dev = _device(args)
    if dev is None:
        return 2
    if args.input == "synthetic":
        from .io import synthetic

        video = synthetic.moving_gradient(
            args.frames or 32, args.height, args.width
        )
    else:
        total = rawvideo.frame_count(args.input, args.width, args.height)
        n = total if args.frames is None else min(args.frames, total)
        video = rawvideo.read_video(args.input, args.width, args.height, n)
    t, h, w = video.shape

    strengths = [int(s) for s in args.quants.split(",")]
    blocks = [int(b) for b in args.blocks.split(",")]
    rows = []
    for block in blocks:
        for q in strengths:
            cfg = CodecConfig(
                block_w=block, block_h=block, block_d=block,
                quant_strength=q, quant_bias=args.quant_bias,
                zlib_level=args.zlib_level,
                deflate_workers=args.deflate_workers,
                compute_dtype=_norm_dtype(args.dtype),
            )
            tt = t - t % cfg.gop_size
            if tt == 0:
                print(f"skipping block={block}: fewer than one "
                      f"{cfg.gop_size}-frame GOP", file=sys.stderr)
                continue
            ctx = TransformContext(cfg, dev)
            t0 = time.perf_counter()
            data = encode_video(video[:tt], cfg, ctx)
            enc_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            out = decode_video(data, w, h, tt, cfg, ctx)
            dec_s = time.perf_counter() - t0
            row = {
                "block": block,
                "quant": q,
                **({"dtype": cfg.compute_dtype}
                   if cfg.compute_dtype != "float32" else {}),
                "bpp": round(metrics.bits_per_pixel(len(data), w, h, tt), 4),
                "psnr_db": round(metrics.psnr(video[:tt], out), 3),
                "encode_fps": round(tt / enc_s, 2),
                "decode_fps": round(tt / dec_s, 2),
            }
            if args.turbo:
                from .codec.turbo import encode_turbo_video

                tdata = encode_turbo_video(video[:tt], cfg, ctx)
                row["turbo_bpp"] = round(
                    metrics.bits_per_pixel(len(tdata), w, h, tt), 4
                )
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(rows, f, indent=2)
    return 0


def cmd_psnr(args) -> int:
    from .io import rawvideo

    ch = 3 if args.rgb else 1
    a = rawvideo.read_video(args.a, args.width, args.height, channels=ch)
    b = rawvideo.read_video(args.b, args.width, args.height, channels=ch)
    t = min(a.shape[0], b.shape[0])
    print(f"PSNR: {metrics.psnr(a[:t], b[:t]):.3f} dB over {t} frames")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dct3d_tpu_torch",
        description="3D-DCT video codec, PyTorch/CUDA port",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="raw grayscale video -> bitstream")
    _add_codec_args(pe)
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode", help="bitstream -> raw grayscale video")
    _add_codec_args(pd)
    pd.set_defaults(fn=cmd_decode)

    pv = sub.add_parser("devices", help="list CUDA devices")
    pv.set_defaults(fn=cmd_devices)

    pi = sub.add_parser("info", help="inspect a bitstream or container")
    pi.add_argument("input")
    pi.set_defaults(fn=cmd_info)

    pc = sub.add_parser("capture", help="generate a synthetic raw clip")
    pc.add_argument("output")
    pc.add_argument("width", type=int)
    pc.add_argument("height", type=int)
    pc.add_argument("frames", type=int)
    pc.add_argument("--kind", choices=["gradient", "blocks"], default="gradient")
    pc.add_argument("--rgb", action="store_true")
    pc.add_argument("--seed", type=int, default=0)
    pc.set_defaults(fn=cmd_capture)

    ps = sub.add_parser("split", help="interleaved RGB -> planar .red/.green/.blue")
    ps.add_argument("input")
    ps.add_argument("--prefix", default=None)
    ps.set_defaults(fn=cmd_split)

    pm = sub.add_parser("mix", help="planar .red/.green/.blue -> interleaved RGB")
    pm.add_argument("prefix")
    pm.add_argument("output")
    pm.set_defaults(fn=cmd_mix)

    pr = sub.add_parser("render", help="raw video stats + PNG export")
    pr.add_argument("input")
    pr.add_argument("width", type=int)
    pr.add_argument("height", type=int)
    pr.add_argument("--rgb", action="store_true")
    pr.add_argument("--png-prefix", default=None)
    pr.add_argument(
        "--frames", default=None,
        help='frames to export: "all", "a:b", or a comma list '
        "(default: first/middle/last)",
    )
    pr.add_argument(
        "--play", action="store_true",
        help="fps-paced playback: pipe the video as y4m into a player "
        "(ffplay/mpv, or any y4m-reading command via --player)",
    )
    pr.add_argument("--fps", type=float, default=30.0,
                    help="playback rate for --play")
    pr.add_argument(
        "--player", default=None,
        help="player command reading YUV4MPEG2 on stdin "
        "(default: ffplay, then mpv)",
    )
    pr.set_defaults(fn=cmd_render)

    pw = sub.add_parser(
        "sweep", help="rate-distortion sweep (quant x block -> bpp/PSNR/fps)"
    )
    pw.add_argument("input", help='raw grayscale video path, or "synthetic"')
    pw.add_argument("width", type=int)
    pw.add_argument("height", type=int)
    pw.add_argument("frames", type=int, nargs="?", default=None)
    pw.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    pw.add_argument("--quants", default="0,1,2,5,10,20",
                    help="comma-separated quant strengths")
    pw.add_argument("--blocks", default="8,4",
                    help="comma-separated cube edges")
    pw.add_argument("--quant-bias", type=float, default=0.5)
    pw.add_argument("--zlib-level", type=int, default=9)
    pw.add_argument("--deflate-workers", type=int, default=-1)
    pw.add_argument(
        "--dtype", default="float32",
        choices=("float32", "bfloat16", "f32", "bf16"),
        help="transform dtype for the RD rows (bfloat16 = fast profile)",
    )
    pw.add_argument("--output", default=None, help="write JSON table here")
    pw.add_argument(
        "--turbo", action="store_true",
        help="also report the turbo profile's bpp at each point "
        "(pixels are identical, so PSNR is shared)",
    )
    pw.set_defaults(fn=cmd_sweep)

    pq = sub.add_parser("psnr", help="PSNR between two raw videos")
    pq.add_argument("a")
    pq.add_argument("b")
    pq.add_argument("width", type=int)
    pq.add_argument("height", type=int)
    pq.add_argument("--rgb", action="store_true",
                    help="inputs are interleaved RGB (3 B/px); PSNR over "
                    "all three channels")
    pq.set_defaults(fn=cmd_psnr)

    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
