"""Colour (interleaved RGB) codec: three channel members in one container.

The port's counterpart of ``dct3d_tpu.codec.rgb_codec``.  The reference
handles colour by hand: RGBUtils splits interleaved RGB into three planar
files, each runs through the grayscale codec, and RGBUtils.mix joins them
again (README.md:22-27).  Here the three channel planes are encoded as three
members of one D3MH container (R, G, B order, tagged 1/2/3), each followed
by its index member when asked for, so one file carries a colour clip.  The
per-channel payload is the unmodified grayscale bitstream, also when a
device mesh encodes it (``mesh=``, parallel/sharding.py).
"""

from __future__ import annotations

import numpy as np

from ..config import CodecConfig
from ..parallel.multihost import (
    MEMBER_BLUE, MEMBER_GREEN, MEMBER_INDEX, MEMBER_RED, IndexInfo, _index_kwargs,
    _member, container_kind, make_index_member, parse_index, parse_index_syncs,
    split_members,
)
from ..parallel.sharding import ShardedEncoder
from .decoder import decode_frame_range, decode_video
from .encoder import StreamingEncoder, encode_video
from .transform import TransformContext


def encode_rgb_video(
    frames: np.ndarray,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    index: bool = False,
    mesh=None,
    device=None,
) -> bytes:
    """(T, H, W, 3) uint8 interleaved RGB -> D3MH container on ``device``
    (or ``ctx.device``): three members tagged MEMBER_RED/GREEN/BLUE, so
    decode routes without a flag.

    index=True follows each channel member with its per-GOP index member
    (bit ends and parallel-inflate sync offsets, docs/FORMAT.md).

    mesh: an optional (gop, tile) device mesh (parallel/mesh.py); each
    channel stream then comes from ShardedEncoder, byte-identical to the
    single-device member, so the container needs no mesh to decode.
    Frames truncate to whole mesh steps (gop_size * mesh gop)."""
    cfg = cfg or CodecConfig()
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError("expected (T, H, W, 3) interleaved RGB")
    if mesh is None:
        ctx = ctx or TransformContext(cfg, device)
    align = cfg.gop_size if mesh is None else cfg.gop_size * mesh.shape["gop"]
    t = frames.shape[0] - frames.shape[0] % align
    if t == 0:
        raise ValueError(f"input shorter than one {align}-frame step")
    out = []
    for c, mtype in enumerate((MEMBER_RED, MEMBER_GREEN, MEMBER_BLUE)):
        plane = np.ascontiguousarray(frames[:t, :, :, c])
        if mesh is not None:
            enc = ShardedEncoder(plane.shape[2], plane.shape[1], mesh, cfg, ctx)
        elif index:
            enc = StreamingEncoder(plane.shape[2], plane.shape[1], cfg, ctx)
        else:
            out.append(_member(encode_video(plane, cfg, ctx), t, mtype))
            continue
        data = enc.push(plane) + enc.finish()
        out.append(_member(data, t, mtype))
        if index:
            out.append(make_index_member(enc.gop_bit_ends,
                                         sync_offsets=enc.gop_sync_offsets))
    return b"".join(out)


def _collect_channels(members):
    """Channel members with their index members attached (type 4 describes
    the member preceding it); validates the 3-channel shape and tags."""
    channels: list[tuple[int, bytes, IndexInfo]] = []
    for frames, payload, mtype in members:
        if mtype == MEMBER_INDEX and channels:
            f, p, _ = channels[-1]
            channels[-1] = (f, p, IndexInfo(
                parse_index(payload), parse_index_syncs(payload)
            ))
        elif mtype != MEMBER_INDEX:
            channels.append((frames, payload, IndexInfo(None, None)))
    if len(channels) != 3:
        raise ValueError(f"expected 3 channel members, found {len(channels)}")
    # kind == 'temporal' (all-zero tags): an RGB container that predates
    # type tags; the caller asked for RGB and it has exactly 3 members.
    if container_kind(members) == "unknown":
        raise ValueError(
            f"unexpected member type tags {[m[2] for m in members]}; "
            "not an RGB container"
        )
    return channels


def decode_rgb_video(
    data: bytes,
    width: int,
    height: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
) -> np.ndarray:
    """D3MH container (3 channel members) -> (T, H, W, 3) uint8 interleaved
    RGB, on ``device`` (or ``ctx.device``)."""
    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg, device)
    channels = _collect_channels(split_members(data))
    planes = [
        decode_video(payload, width, height, frames, cfg, ctx,
                     **_index_kwargs(frames, idx, cfg))
        for frames, payload, idx in channels
    ]
    return np.stack(planes, axis=-1)


def decode_rgb_range(
    data: bytes,
    width: int,
    height: int,
    start: int,
    stop: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
) -> np.ndarray:
    """Random-access decode of frames [start, stop) from an RGB container
    -> (stop-start, H, W, 3): each channel member decodes only its covering
    GOPs (decoder.decode_frame_range; scan-free when the channel carries an
    index member)."""
    cfg = cfg or CodecConfig()
    if not (0 <= start < stop):
        raise ValueError(f"bad frame range [{start}, {stop})")
    channels = _collect_channels(split_members(data))
    total = min(f for f, _, _ in channels)
    if stop > total:
        raise EOFError(
            f"container holds {total} frames, range [{start}, {stop}) "
            "reaches past the end"
        )
    ctx = ctx or TransformContext(cfg, device)
    planes = [
        decode_frame_range(payload, width, height, start, stop, cfg, ctx,
                           **_index_kwargs(frames, idx, cfg))
        for frames, payload, idx in channels
    ]
    return np.stack(planes, axis=-1)
