"""Multi-host scale-out and D3MH containers: member framing, the per-GOP
index member, the container decoders, and the multi-host encode with its
ordered gather.

Host copies of ``dct3d_tpu.parallel.multihost`` (tests/test_torch_host.py
pins each to the original): the framing, ``host_frame_span``, the index
member (``make_index_member``, ``parse_index``, ``parse_index_syncs``,
``IndexInfo``, ``gop_positions``), ``container_kind`` and
``_temporal_streams``.  ``decode_container_range`` and
``decode_multihost_container`` run the port's decoder with a
``TransformContext`` on the caller's device.

Multi-host encode, as in the JAX package: each process reads only its
temporal span of the video (``host_frame_span``, GOP-major), encodes it on
its own device mesh (parallel/sharding.py) into complete members, and the
members are gathered to process 0 in process order
(``gather_ordered_bytes``: one all-gather of the lengths, one of the
padded bytes).  Only compressed bytes cross between processes, once.  The
processes talk through ``torch.distributed`` with the gloo backend
(``initialize``): the gather moves host bytes, and NCCL refuses two ranks
on one device, which is how one card runs the two-process simulation
(multihost_sim.py).  With one process ``gather_ordered_bytes`` returns its
input.

A container is a sequence of members, each a 16-byte header (magic, then
uint32 LE ``(member type << 24) | frame count``, then uint64 LE payload
length) and its payload.  The member type lets decode route each member;
decoders skip types they do not know.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

from ..config import CodecConfig

MEMBER_MAGIC = b"D3MH"

MEMBER_TEMPORAL = 0
MEMBER_RED, MEMBER_GREEN, MEMBER_BLUE = 1, 2, 3
#: Seekable index for the PRECEDING stream member: per-GOP absolute bit end
#: positions within that member's inflated Exp-Golomb payload (v1), then
#: optionally per-GOP compressed sync offsets for parallel inflate (v2).
MEMBER_INDEX = 4
_MAX_MEMBER_FRAMES = (1 << 24) - 1


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group of a multi-host run: ``coordinator_address``
    is "host:port" of process 0, which every process names.  A no-op for
    one process (num_processes None or 1)."""
    if num_processes in (None, 1):
        return
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def _world() -> tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def host_frame_span(total_frames: int, cfg: CodecConfig,
                    process_index: int, process_count: int) -> tuple[int, int]:
    """[start, stop) frame range this host ingests: a contiguous GOP-major
    slice, balanced to within one GOP.  Frame count is truncated to a GOP
    multiple first (Encoder.java:39-40)."""
    t = total_frames - total_frames % cfg.gop_size
    gops = t // cfg.gop_size
    base, extra = divmod(gops, process_count)
    start_gop = process_index * base + min(process_index, extra)
    n_gop = base + (1 if process_index < extra else 0)
    return start_gop * cfg.gop_size, (start_gop + n_gop) * cfg.gop_size


def _member(payload: bytes, frames: int, mtype: int = MEMBER_TEMPORAL) -> bytes:
    if frames > _MAX_MEMBER_FRAMES:
        raise ValueError(f"member frame count {frames} exceeds 2^24-1")
    return (
        MEMBER_MAGIC
        + struct.pack("<IQ", (mtype << 24) | frames, len(payload))
        + payload
    )


def split_members(data: bytes) -> list[tuple[int, bytes, int]]:
    """Parse a container into [(frame_count, payload, member_type), ...]."""
    out = []
    pos = 0
    while pos < len(data):
        if data[pos : pos + 4] != MEMBER_MAGIC:
            raise ValueError("not a multi-host container (missing D3MH magic)")
        tagged, length = struct.unpack_from("<IQ", data, pos + 4)
        pos += 16
        out.append((tagged & _MAX_MEMBER_FRAMES, data[pos : pos + length],
                    tagged >> 24))
        pos += length
    return out


def make_index_member(gop_bit_ends: list[int],
                      sync_offsets: list[int] | None = None) -> bytes:
    """Frame an index member (see MEMBER_INDEX): uint32 LE GOP count, then
    one uint64 LE absolute bit end position per GOP; with ``sync_offsets``
    (v2, len == GOP count) a second uint64 array of per-GOP compressed byte
    sync points, which old readers ignore."""
    n = len(gop_bit_ends)
    payload = struct.pack("<I", n) + struct.pack(f"<{n}Q", *gop_bit_ends)
    if sync_offsets is not None and len(sync_offsets) == n:
        payload += struct.pack(f"<{n}Q", *sync_offsets)
    return _member(payload, 0, MEMBER_INDEX)


def parse_index(payload: bytes) -> list[int] | None:
    """Inverse of make_index_member; None for a torn/short payload (e.g. a
    crash mid-checkpoint) so callers fall back to the serial scan instead
    of refusing to decode a file whose stream members are valid."""
    if len(payload) < 4:
        return None
    (n,) = struct.unpack_from("<I", payload, 0)
    if len(payload) < 4 + 8 * n:
        return None
    return list(struct.unpack_from(f"<{n}Q", payload, 4))


def parse_index_syncs(payload: bytes) -> list[int] | None:
    """The v2 sync-offset array of an index member, or None when the
    member predates v2 (or is torn) — callers then inflate serially."""
    if len(payload) < 4:
        return None
    (n,) = struct.unpack_from("<I", payload, 0)
    if n == 0 or len(payload) < 4 + 16 * n:
        return None
    return list(struct.unpack_from(f"<{n}Q", payload, 4 + 8 * n))


class IndexInfo(NamedTuple):
    """Parsed index member: per-GOP bit ends (v1) + per-GOP compressed
    sync offsets for parallel inflate (v2, may be None)."""

    ends: list[int] | None
    syncs: list[int] | None


def gop_positions(index_ends: list[int], n_gops: int,
                  gop_size: int, member_frames: int) -> list[int] | None:
    """GOP START bit offsets from an index member's end positions, or None
    if the index doesn't cover the member's GOP count (decoders then fall
    back to the serial scan rather than trusting a stale index)."""
    if member_frames and len(index_ends) != member_frames // gop_size:
        return None
    if len(index_ends) < n_gops:
        return None
    return [0] + index_ends[: n_gops - 1]


def container_kind(members: list[tuple[int, bytes, int]]) -> str:
    """'rgb' | 'temporal' | 'unknown' from the member type tags (index
    members describe their predecessor and don't affect the kind)."""
    types = [m[2] for m in members if m[2] != MEMBER_INDEX]
    if types == [MEMBER_RED, MEMBER_GREEN, MEMBER_BLUE]:
        return "rgb"
    if all(t == MEMBER_TEMPORAL for t in types):
        return "temporal"
    return "unknown"


def _temporal_streams(
    members: list[tuple[int, bytes, int]],
) -> list[tuple[int, bytes, "IndexInfo"]]:
    """Temporal stream members with their index members attached
    (IndexInfo: bit ends + v2 parallel-inflate sync offsets, either None).

    Rejects containers that ALSO carry other frame-bearing member types
    (turbo, RGB channels): silently decoding just the temporal subset
    would return a wrong, shorter video — mixed turbo containers (per-GOP
    fallback, codec/turbo.FALLBACK_EXC_FRAC) must go through the turbo
    route, which reads both types."""
    foreign = {m[2] for m in members} - {MEMBER_TEMPORAL, MEMBER_INDEX}
    if foreign:
        raise ValueError(
            f"container carries non-temporal member types {sorted(foreign)};"
            " decode it through its own route (decode_turbo_container / "
            "decode_rgb_video / decode_auto)"
        )
    streams: list[tuple[int, bytes, IndexInfo]] = []
    for frames, payload, mtype in members:
        if mtype == MEMBER_INDEX and streams:
            f, p, _ = streams[-1]
            streams[-1] = (f, p, IndexInfo(
                parse_index(payload), parse_index_syncs(payload)
            ))
        elif mtype == MEMBER_TEMPORAL:
            streams.append((frames, payload, IndexInfo(None, None)))
    if not streams:
        raise ValueError(
            f"container has no decodable stream members "
            f"(member type tags: {[m[2] for m in members]})"
        )
    return streams


def gather_ordered_bytes(local_container: bytes) -> bytes | None:
    """Gather each process's container fragment (already member-framed) to
    process 0 in process (= stream) order.

    Returns the concatenation on process 0 and None on the others; with no
    process group, or a group of one, returns ``local_container``.  Two
    all-gathers of CPU tensors: the lengths (int64), then the payloads
    padded to the longest."""
    import torch
    import torch.distributed as dist

    rank, world = _world()
    if world == 1:
        return local_container
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(lengths, torch.tensor([len(local_container)], dtype=torch.int64))
    sizes = [int(n) for n in lengths]
    padded = torch.zeros(max(1, max(sizes)), dtype=torch.uint8)
    padded[: len(local_container)] = torch.from_numpy(
        np.frombuffer(local_container, np.uint8).copy())
    gathered = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(gathered, padded)
    if rank != 0:
        return None
    return b"".join(g[:n].numpy().tobytes() for g, n in zip(gathered, sizes))


def encode_multihost(
    local_frames: np.ndarray,
    width: int,
    height: int,
    total_frames: int,
    mesh,
    cfg: CodecConfig | None = None,
    index: bool = False,
    turbo: bool = False,
) -> bytes | None:
    """Encode a video whose frames are spread over processes.

    ``local_frames`` is this process's span (host_frame_span).  Each
    process encodes its GOPs on its own ``mesh`` (encode_local_members);
    the fragments are gathered in order to process 0, which returns the
    container (None elsewhere).  Each process's span is complete members:
    one stream across processes would serialize them on the DEFLATE and
    Exp-Golomb carry state."""
    return gather_ordered_bytes(
        encode_local_members(local_frames, width, height, mesh, cfg,
                             index=index, turbo=turbo))


def encode_local_members(
    local_frames: np.ndarray,
    width: int,
    height: int,
    mesh,
    cfg: CodecConfig | None = None,
    index: bool = False,
    turbo: bool = False,
) -> bytes:
    """This process's member-framed fragment of its frame span, the local
    half of encode_multihost (no communication).

    Reference profile: one member from ShardedEncoder over the whole mesh
    steps (and its index member with ``index``), then the tail GOPs that do
    not fill a mesh step as a member of their own from a single-device
    encoder on shard 0's device (and its index member).  Turbo: the
    sharded encoder's per-GOP members, then the tail's."""
    from ..codec.encoder import StreamingEncoder
    from ..codec.transform import TransformContext
    from .sharding import ShardedEncoder

    cfg = cfg or CodecConfig()
    step = cfg.gop_size * mesh.shape["gop"]
    t_all = local_frames.shape[0] - local_frames.shape[0] % cfg.gop_size
    t_main = t_all - t_all % step
    tail_ctx = (TransformContext(cfg, mesh.devices[0]) if t_all > t_main
                else None)
    if turbo:
        # Turbo encoders emit complete per-GOP members already; the global
        # container is the in-order concatenation across processes.
        from ..codec.turbo import TurboEncoder, TurboShardedEncoder

        members = b""
        if t_main:
            tse = TurboShardedEncoder(width, height, mesh, cfg)
            members += b"".join(tse.push(local_frames[i : i + step])
                                for i in range(0, t_main, step)) + tse.finish()
        if t_all > t_main:
            te = TurboEncoder(width, height, cfg, tail_ctx)
            members += te.push(local_frames[t_main:t_all]) + te.finish()
        return members
    members = b""
    if t_main:
        enc = ShardedEncoder(width, height, mesh, cfg)
        chunks = [enc.push(local_frames[i : i + step]) for i in range(0, t_main, step)]
        chunks.append(enc.finish())
        members += _member(b"".join(chunks), t_main)
        if index:
            members += make_index_member(enc.gop_bit_ends)
    if t_all > t_main:
        # Tail GOPs that do not fill the gop mesh axis: their own member (a
        # span is balanced to one GOP, so the tail is at most mesh gop - 1
        # GOPs).
        tenc = StreamingEncoder(width, height, cfg, tail_ctx)
        members += _member(tenc.push(local_frames[t_main:t_all]) + tenc.finish(),
                           t_all - t_main)
        if index:
            members += make_index_member(tenc.gop_bit_ends)
    return members


def _index_kwargs(frames: int, idx: IndexInfo, cfg: CodecConfig) -> dict:
    """The decoder keywords of one stream member's index: GOP start
    positions (None when the index is torn or does not cover the member),
    the v2 sync offsets, and the last bit end, which the decoder holds
    against the inflated payload before it trusts the positions."""
    if idx.ends is None:
        return {"sync_offsets": idx.syncs}
    return {
        "positions": gop_positions(idx.ends, frames // cfg.gop_size,
                                   cfg.gop_size, frames),
        "sync_offsets": idx.syncs,
        "index_end": idx.ends[-1] if idx.ends else None,
    }


def decode_container_range(
    data: bytes,
    width: int,
    height: int,
    start: int,
    stop: int,
    cfg: CodecConfig | None = None,
    ctx=None,
    device=None,
) -> np.ndarray:
    """Random-access decode of frames [start, stop) from a temporal
    container (single- or multi-stream, with or without index members), on
    ``device`` (or ``ctx.device``).

    Each covering stream member decodes only its local sub-range
    (codec.decoder.decode_frame_range — scan-free when the member carries
    an index); members wholly before/after the range are never touched.
    Pixels are identical to the same slice of decode_multihost_container.
    """
    from ..codec.decoder import decode_frame_range
    from ..codec.transform import TransformContext

    cfg = cfg or CodecConfig()
    if not (0 <= start < stop):
        raise ValueError(f"bad frame range [{start}, {stop})")
    streams = _temporal_streams(split_members(data))
    total = sum(f for f, _, _ in streams)
    if stop > total:
        raise EOFError(
            f"container holds {total} frames, range [{start}, {stop}) "
            "reaches past the end"
        )
    ctx = ctx or TransformContext(cfg, device)
    parts: list[np.ndarray] = []
    a0 = 0
    for frames, payload, idx in streams:
        lo, hi = max(start, a0), min(stop, a0 + frames)
        if lo < hi:
            parts.append(decode_frame_range(
                payload, width, height, lo - a0, hi - a0, cfg, ctx,
                **_index_kwargs(frames, idx, cfg),
            ))
        a0 += frames
        if a0 >= stop:
            break
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def decode_multihost_container(
    data: bytes,
    width: int,
    height: int,
    cfg: CodecConfig | None = None,
    workers: int | None = None,
    ctx=None,
    device=None,
) -> np.ndarray:
    """Decode a temporal container back to (T, H, W) frames on ``device``
    (or ``ctx.device``).

    Members are self-contained, so several decode at once on a thread pool
    that shares one context (the C entropy decoder and zlib release the
    GIL).  The threads' device work shares the device's current stream, in
    launch order; each thread waits only on the events it recorded."""
    from ..codec.decoder import decode_video
    from ..codec.transform import TransformContext

    cfg = cfg or CodecConfig()
    members = split_members(data)
    if container_kind(members) == "rgb":
        raise ValueError(
            "this container carries RGB channel members; decode it with "
            "codec.rgb_codec.decode_rgb_video (CLI: decode --rgb)"
        )
    # Attach each index member to the stream member it describes (the one
    # preceding it); streams without one decode via the serial-scan path.
    streams = _temporal_streams(members)
    ctx = ctx or TransformContext(cfg, device)

    def _one(m: tuple[int, bytes, IndexInfo]) -> np.ndarray:
        frames, payload, idx = m
        return decode_video(payload, width, height, frames, cfg, ctx,
                            **_index_kwargs(frames, idx, cfg))

    if len(streams) == 1:
        return _one(streams[0])
    with ThreadPoolExecutor(
        workers or min(len(streams), os.cpu_count() or 2)
    ) as pool:
        parts = list(pool.map(_one, streams))
    return np.concatenate(parts)
