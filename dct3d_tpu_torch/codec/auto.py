"""Format-sniffing one-call decode: the library twin of ``cli.py decode``.

The port's counterpart of ``dct3d_tpu.codec.auto``.  The codec writes
several on-disk forms (docs/FORMAT.md): the raw reference-compatible zlib
stream and D3MH containers of temporal, RGB, turbo and turbo-RGB members,
optionally with index members; ``decode_auto`` routes by content exactly
like the CLI.
"""

from __future__ import annotations

import numpy as np

from ..config import CodecConfig
from ..parallel.multihost import MEMBER_MAGIC, container_kind, split_members
from .transform import TransformContext
from .turbo import is_turbo_container, is_turbo_rgb_container


def decode_auto(
    data: bytes,
    width: int,
    height: int,
    frames: int | None = None,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
) -> np.ndarray:
    """Decode any output of the ported encoders -> (T, H, W) or
    (T, H, W, 3) uint8, on ``device`` (or ``ctx.device``).

    ``frames`` is required only for the headerless raw stream (exactly the
    CLI's rule); containers are self-describing and ``frames`` then just
    truncates the result.
    """
    from ..parallel.multihost import decode_multihost_container
    from .decoder import decode_video
    from .rgb_codec import decode_rgb_video
    from .turbo import decode_turbo_container, decode_turbo_rgb_video

    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg, device)
    if data[:4] != MEMBER_MAGIC:
        if frames is None:
            raise ValueError(
                "raw streams are headerless (Decoder.java:18): pass the "
                "frame count, or encode with --index for a self-describing "
                "container"
            )
        return decode_video(data, width, height, frames, cfg, ctx)
    members = split_members(data)
    if is_turbo_container(members):
        out = decode_turbo_container(data, width, height, cfg, ctx)
    elif is_turbo_rgb_container(members):
        out = decode_turbo_rgb_video(data, width, height, cfg, ctx)
    else:
        kind = container_kind(members)
        if kind == "rgb":
            out = decode_rgb_video(data, width, height, cfg, ctx)
        elif kind == "temporal":
            out = decode_multihost_container(data, width, height, cfg,
                                             ctx=ctx)
        else:
            raise ValueError(
                f"unrecognized member type tags {[m[2] for m in members]}"
            )
    return out if frames is None else out[:frames]


def decode_auto_range(
    data: bytes,
    width: int,
    height: int,
    start: int,
    stop: int,
    cfg: CodecConfig | None = None,
    positions: list[int] | None = None,
    ctx: TransformContext | None = None,
    device=None,
    index_end: int | None = None,
) -> np.ndarray:
    """Random-access twin of decode_auto: frames [start, stop) from any
    output of the ported encoders, routed by content exactly like ``cli.py
    decode --range`` — only the covering GOPs/members run (see
    decoder.decode_frame_range).  Raw headerless streams need no frame
    count here: the range bounds the work, EOFError past the end.

    ``positions`` and ``index_end`` (e.g. from an .idx sidecar next to a
    raw parity stream) make a raw stream's prefix skip scan-free;
    containers carry their own.
    """
    from ..parallel.multihost import decode_container_range
    from .decoder import decode_frame_range
    from .rgb_codec import decode_rgb_range
    from .turbo import decode_turbo_range, decode_turbo_rgb_range

    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg, device)
    if data[:4] != MEMBER_MAGIC:
        return decode_frame_range(data, width, height, start, stop, cfg, ctx,
                                  positions=positions, index_end=index_end)
    members = split_members(data)
    if is_turbo_container(members):
        return decode_turbo_range(data, width, height, start, stop, cfg, ctx)
    if is_turbo_rgb_container(members):
        return decode_turbo_rgb_range(data, width, height, start, stop, cfg, ctx)
    kind = container_kind(members)
    if kind == "rgb":
        return decode_rgb_range(data, width, height, start, stop, cfg, ctx)
    if kind == "temporal":
        return decode_container_range(data, width, height, start, stop, cfg,
                                      ctx)
    raise ValueError(
        f"unrecognized member type tags {[m[2] for m in members]}"
    )
