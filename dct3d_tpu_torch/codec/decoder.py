"""GOP-parallel decode of whole streams and frame ranges.

The port's counterpart of ``dct3d_tpu.codec.decoder`` for reference-profile
streams: the host inflates the zlib stream (GOP-parallel when the encoder's
sync offsets are given) and entropy-decodes GOPs on a thread pool into
nibble planes + exceptions (C, codec/entropy.py); each GOP goes to the
device with non-blocking copies from pinned memory, is inverse-transformed
there (codec/transform.planar4_to_frames), and comes back with a
non-blocking copy while the host decodes the next GOPs: in a whole-output
decode straight into its slice of the output (staging.Landing).
``StreamingDecoder`` / ``decode_stream`` run the same device step on
compressed bytes fed in pieces (entropy.InflateSource).  Without an index
the GOP boundaries come from the fused speculative decode
(entropy.parallel_chunks).  With ``cfg.transport_delta`` the device emits
wrapping temporal deltas and the host undoes them GOP by GOP (_undelta).

Geometry (width/height/frame count) is supplied out of band exactly like
the reference (no container header, Decoder.java:17-28, main.c:27-44).
"""

from __future__ import annotations

import os
import zlib
from typing import Iterable, Iterator

import numpy as np
import torch

from ..config import CodecConfig
from ..ops import relayout
from ..profiling import trace, traced_iter
from ..staging import Landing, landed, to_device, to_host_async
from . import entropy
from .transform import TransformContext, planar4_to_frames


def _undelta(frames: np.ndarray, cfg: CodecConfig,
             out: np.ndarray | None = None) -> np.ndarray:
    """Reconstruct frames shipped as wrapping temporal deltas (exact), GOP
    by GOP: the deltas restart at every GOP.  The drains pass the
    context's cfg, the one the device step emitted the deltas under.
    ``out=frames`` rebuilds a landed output's slice in place."""
    if not cfg.transport_delta:
        return frames
    t, h, w = frames.shape
    gops = frames.reshape(t // cfg.gop_size, cfg.gop_size, h, w)
    return np.cumsum(gops, axis=1, dtype=np.uint8,
                     out=None if out is None else out.reshape(gops.shape)
                     ).reshape(frames.shape)


def _split_dc_flat(plane: np.ndarray, idx: np.ndarray, val: np.ndarray,
                   cube: int):
    """Derive the dense per-cube DC vector of a flat nibble plane and drop
    the DC entries from the exception list.

    dc[c] is the true value at flat index c*cube: the sign-extended low
    nibble of the cube's first plane byte, overwritten by its exception
    when one exists.  The device splices dc as column 0 and the exception
    scatter shrinks to the true outliers.  Returns (dc int32, idx', val').
    """
    dc = (((plane[:: cube // 2].astype(np.int32)) & 0xF) ^ 8) - 8
    is_dc = (idx % cube) == 0
    if is_dc.any():
        dc[idx[is_dc] // cube] = val[is_dc]
        idx = idx[~is_dc]
        val = val[~is_dc]
    return dc, idx, val


def _dispatch_planar4(planar, ctx: TransformContext, height: int,
                      width: int) -> torch.Tensor:
    """Upload one GOP and run the device step.

    A flat 3-tuple (plane, exc_idx, exc_val) gets its dense DC split off on
    the host (_split_dc_flat).  A 4-tuple (wire, dc, exc_idx, exc_val) is a
    turbo member (codec/turbo._parse_payload(split_dc=True)): the (cube/2,
    cubes) wire plane goes up as it is and K8 turns it into the flat plane
    on the device.  Both then run the same planar4_to_frames.  Spans:
    ``dispatch`` over the whole call, ``stage_in`` over the uploads."""
    dev = ctx.device
    with trace("dispatch"):
        if len(planar) == 4:
            plane, dc, idx, val = planar
        else:
            plane, idx, val = planar
            dc, idx, val = _split_dc_flat(plane, idx, val, ctx.cfg.cube_size)
        with trace("stage_in"):
            plane, idx, val, dc = (
                to_device(plane, dev),
                to_device(idx.astype(np.int64, copy=False), dev),
                to_device(val.astype(np.int32, copy=False), dev),
                to_device(dc, dev))
        if len(planar) == 4:
            plane = relayout.wire_to_plane(plane).reshape(-1)
        return planar4_to_frames(plane, idx, val, dc, ctx, height, width)


class StreamingDecoder:
    """Feed compressed bytes, pull decoded frame batches.

    The host inflates incrementally (entropy.InflateSource) and decodes
    each buffered GOP into a nibble plane; the device step is decode_video's
    (_dispatch_planar4), so the pixels are decode_video's.
    """

    def __init__(
        self,
        width: int,
        height: int,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
        gops_per_batch: int = 1,
        device=None,
    ) -> None:
        self.cfg = cfg or CodecConfig()
        self.cfg.validate_geometry(width, height)
        self.width = width
        self.height = height
        self.ctx = ctx or TransformContext(self.cfg, device)
        self.source = entropy.InflateSource()
        self.gops_per_batch = gops_per_batch
        self._coeffs_per_gop = width * height * self.cfg.gop_size

    def feed(self, data: bytes) -> None:
        self.source.feed(data)

    def feed_eof(self) -> None:
        self.source.feed_eof()

    def try_decode(self) -> np.ndarray | None:
        """Decode up to gops_per_batch buffered GOPs -> (T, H, W) uint8, or
        None when not one whole GOP is buffered yet."""
        pending = []
        for _ in range(self.gops_per_batch):
            planar = self.source.try_read_planar4(self._coeffs_per_gop)
            if planar is None:
                break
            pending.append(to_host_async(_dispatch_planar4(
                planar, self.ctx, self.height, self.width)))
        if not pending:
            return None
        return np.concatenate([_undelta(landed(p), self.ctx.cfg) for p in pending])


def decode_video(
    data: bytes,
    width: int,
    height: int,
    frames: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
    positions: list[int] | None = None,
    sync_offsets: list[int] | None = None,
    index_end: int | None = None,
    entropy_workers: int | None = None,
) -> np.ndarray:
    """One-call decode of a complete bitstream -> (T, H, W) uint8, on
    ``device`` (or ``ctx.device``).

    `frames` is truncated to a GOP multiple (Decoder.java:34-36).
    ``positions`` (per-GOP start bit offsets) and ``sync_offsets`` (per-GOP
    compressed byte offsets), both from the encoder's index, let every host
    core work; without positions the fused speculative decode finds the
    GOPs.  ``index_end`` is the index's last bit end: see
    decode_frame_range.  ``entropy_workers`` sizes the host entropy pool
    (default: every core).
    """
    cfg = cfg or CodecConfig()
    t = frames - frames % cfg.gop_size
    if t == 0:
        return np.empty((0, height, width), np.uint8)
    return decode_frame_range(
        data, width, height, 0, t, cfg, ctx, device, positions=positions,
        sync_offsets=sync_offsets, index_end=index_end,
        entropy_workers=entropy_workers,
    )


def decode_frame_range(
    data: bytes,
    width: int,
    height: int,
    start: int,
    stop: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
    positions: list[int] | None = None,
    sync_offsets: list[int] | None = None,
    index_end: int | None = None,
    entropy_workers: int | None = None,
) -> np.ndarray:
    """Random-access decode of the half-open frame range [start, stop).

    Only the covering GOPs run the host entropy stage and the device
    inverse transform.  The skipped prefix costs one inflate pass plus,
    without ``positions``, a boundary scan: the speculative parallel scan
    of the whole payload or the serial walk of the prefix, whichever the
    estimated work favours.  With ``sync_offsets`` the inflate itself runs
    GOP-parallel.

    ``index_end``, the last GOP bit end of the index that gave
    ``positions``, is held against the inflated payload: an index that
    ends past the payload's last bit belongs to another stream, so its
    positions are dropped and the GOP boundaries are scanned instead (the
    JAX package trusts any index of the right GOP count).

    Returns (stop - start, H, W) pixels identical to the same slice of
    decode_video's output; raises EOFError when the stream ends before
    ``stop`` and ValueError on corrupt input.
    """
    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg, device)
    cfg.validate_geometry(width, height)
    if not (0 <= start < stop):
        raise ValueError(f"bad frame range [{start}, {stop})")
    fpg = cfg.gop_size
    g0, g1 = start // fpg, -(-stop // fpg)
    cpg = width * height * fpg
    try:
        with trace("inflate"):
            if sync_offsets is not None:
                raw = entropy.parallel_inflate(data, sync_offsets)
            else:
                z = zlib.decompressobj()
                raw = z.decompress(data) + z.flush()
    except zlib.error as e:
        raise ValueError(f"corrupt bitstream: {e}") from e
    payload = np.frombuffer(raw, np.uint8)
    if index_end is not None and index_end > 8 * payload.size:
        positions = None  # a stale index: scan instead
    if positions is not None:
        if len(positions) < g1:
            raise ValueError(f"index has {len(positions)} positions, need {g1}")
        span = list(positions[g0:g1])
    elif g0 == 0:
        span = None  # parallel_chunks finds the boundaries itself
    else:
        # Prefix skip.  The speculative scan covers the whole payload on
        # every core; the serial walk touches only the g1-GOP prefix on
        # one.  Pick by estimated work (a payload carries ~1.2 bits/value
        # on typical streams, so ~payload_bytes*6.7 values in all).
        workers = entropy_workers or (os.cpu_count() or 2)
        spec = None
        if g1 * cpg * workers > payload.size * 6.7:
            spec = entropy.speculative_positions(payload, cpg, g1,
                                                 entropy_workers)
        if spec is not None:
            span = spec[g0:g1]
        else:
            pos, span = 0, []
            try:
                for g in range(g1):
                    if g >= g0:
                        span.append(pos)
                    if g + 1 < g1:
                        pos = entropy.scan_values(payload, cpg, pos)
            except EOFError:
                raise EOFError("bitstream too short for requested frame range")
    landing = Landing(((g1 - g0) * fpg, height, width), ctx.device)
    try:
        for k, (plane, ei, ev, _pos) in enumerate(traced_iter(
            "entropy_wait", entropy.parallel_chunks(
                payload, cpg, g1 - g0, entropy.decode_values_planar4,
                entropy_workers, positions=span,
            ))):
            frames_dev = _dispatch_planar4((plane, ei, ev), ctx, height, width)
            with trace("readback"):
                landing.put(k * fpg, frames_dev)
    except EOFError:
        raise EOFError("bitstream too short for requested frames")
    with trace("readback"):
        out = landing.result(lambda f: _undelta(f, ctx.cfg, out=f))
    lo, hi = start - g0 * fpg, stop - g0 * fpg
    if lo == 0 and hi == out.shape[0]:
        return out
    # Copy the trimmed slice: a view would pin up to gop_size-1 hidden
    # frames per end alive and alias them under caller writes.
    return np.ascontiguousarray(out[lo:hi])


def decode_stream(
    chunks: Iterable[bytes],
    width: int,
    height: int,
    frames: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
) -> Iterator[np.ndarray]:
    """Generator: inflate+decode an iterable of compressed chunks into frame
    batches on ``device`` (or ``ctx.device``), stopping after `frames`
    frames (GOP-truncated)."""
    cfg = cfg or CodecConfig()
    t = frames - frames % cfg.gop_size
    dec = StreamingDecoder(width, height, cfg, ctx, device=device)
    emitted = 0
    it = iter(chunks)
    exhausted = False
    while emitted < t:
        batch = dec.try_decode()
        if batch is None:
            if exhausted:
                raise EOFError("bitstream too short for requested frame count")
            try:
                dec.feed(next(it))
            except StopIteration:
                dec.feed_eof()
                exhausted = True
            continue
        emitted += batch.shape[0]
        yield batch
