"""Turbo (planar) profile: block-compressed planes, no Exp-Golomb anywhere.

The port's counterpart of ``dct3d_tpu.codec.turbo`` for one device and
grayscale video.  The wire carries the codec's device transport format —
a packed-nibble plane of quantized zigzag coefficients, a dense DC stream
and a sparse exception list — compressed per GOP:

  encode step:  K1 (8x8x8 cubes; framing otherwise) -> matmul in the
                compute dtype with the pair-permuted encode matrix ->
                exact-DC quantize -> nibble pack -> K7 (plane -> wire) ->
                K6 (exception tables), all on the device;
  host drain:   tables -> sorted exception list -> four compressed streams
                -> one D3MH member (type 5) per GOP;
  decode:       host decompression (GOP-parallel) -> K8 (wire -> plane)
                -> the reference profile's planar4_to_frames (K4 for
                8x8x8 cubes).

Pixels are identical to the reference profile's decode: the quantized
integers are the same and so is the inverse transform.  Only the container
differs.  A GOP whose exceptions exceed FALLBACK_EXC_FRAC of its values is
also encoded as a reference-profile member, and the smaller one ships.

Wire format (docs/FORMAT.md): payload = four length-prefixed compressed
streams (coefficient-pair-major nibble plane, dense DC deltas int16,
exception-index deltas int32, exception values int16).  Streams are zstd
when cfg.turbo_codec == "zstd" and the zstandard module imports, else zlib
at cfg.zlib_level; decode sniffs each stream's magic.

Turbo RGB (``encode_turbo_rgb_video`` and its decoders) carries each
channel as its own members, types 6/7/8, channel-major.  With
``cfg.transport_delta`` the host sends wrapping temporal deltas and the
decode undoes them, as in the reference profile.  ``TurboShardedEncoder``
and ``TurboShardedDecoder`` run the same steps over a (gop, tile) device
mesh (parallel/mesh.py), members and pixels identical to one device's.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import struct
import sys
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, NamedTuple

import numpy as np
import torch

from .. import staging
from ..config import CodecConfig
from ..ops import deflate as dev_deflate, exceptions, relayout
from ..parallel.multihost import (
    MEMBER_BLUE, MEMBER_GREEN, MEMBER_INDEX, MEMBER_RED, MEMBER_TEMPORAL,
    _member, split_members,
)
from ..parallel.mesh import GOP_AXIS, TILE_AXIS
from ..parallel.sharding import _check_tiles, mesh_contexts
from ..profiling import StageTimer, trace, traced
from . import entropy
from .decoder import _dispatch_planar4, _undelta, decode_video
from .encoder import _deltas, encode_video
from .transform import TransformContext, _frames_to_q

try:  # optional: smaller and faster than DEFLATE on the nibble plane
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

#: every zstd frame starts with this magic; zlib streams start 0x78
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

MEMBER_TURBO = 5
#: turbo RGB channel members (red, green, blue)
MEMBER_TURBO_RGB = (6, 7, 8)

#: Per-GOP escape hatch for content the nibble wire degenerates on
#: (near-lossless quants flood the exception streams).  When a GOP's
#: exception count crosses this fraction of its coefficients, the encoder
#: also builds the GOP as a reference-profile member and ships whichever
#: is smaller, tagged with the reference member type.
FALLBACK_EXC_FRAC = 0.02
#: turbo member type -> its reference-profile fallback member type
_FALLBACK_TYPE = {
    MEMBER_TURBO: MEMBER_TEMPORAL,
    MEMBER_TURBO_RGB[0]: MEMBER_RED,
    MEMBER_TURBO_RGB[1]: MEMBER_GREEN,
    MEMBER_TURBO_RGB[2]: MEMBER_BLUE,
}
_REF_TYPES = frozenset(_FALLBACK_TYPE.values())

_RETRY_SLOTS = 256  # exception slots per group that cannot overflow
_WINDOW = 3  # decode: GOPs in flight on the device before the oldest drains


def _warn_fallback_once(already: bool) -> bool:
    """One note per encoder when the wire degenerates; returns the new
    warned flag."""
    if not already:
        print(
            "note: turbo wire degenerate on this content (exceptions "
            f"above {FALLBACK_EXC_FRAC:.0%} of coefficients); affected "
            "GOPs ship as reference-profile members (decode "
            "auto-routes per member)", file=sys.stderr,
        )
    return True


def _pick_member(raw_gop: np.ndarray, payload: bytes, n_exc: int, t: int,
                 member_type: int, cfg: CodecConfig, ctx, warn) -> bytes:
    """Emit the GOP as a turbo member, or as a reference-profile member
    when the turbo wire degenerates (see FALLBACK_EXC_FRAC).  The probe
    compares actual encoded sizes."""
    if n_exc <= FALLBACK_EXC_FRAC * raw_gop.size:
        return _member(payload, t, member_type)
    # Serial sink: deterministic reference-layout bytes regardless of the
    # caller's deflate worker pool.
    ref = encode_video(raw_gop, dataclasses.replace(cfg, deflate_workers=0),
                       ctx)
    if len(ref) < len(payload):
        warn()
        return _member(ref, t, _FALLBACK_TYPE[member_type])
    return _member(payload, t, member_type)


class TurboGOP(NamedTuple):
    """Device-side result of the turbo encode step for one GOP."""

    plane: torch.Tensor  # (cube/2, cubes) uint8 wire, or (n/2,) flat plane
    dc: torch.Tensor  # (cubes,) int16 dense DC
    lidx: torch.Tensor  # (g, slots) uint8 exception lanes
    vals: torch.Tensor  # (g, slots) int16 exception values
    counts: torch.Tensor  # (g,) int32 exceptions per group
    overflow: torch.Tensor  # () bool, some group exceeded its slots


def _plane_and_tables(qp: torch.Tensor, slots: int,
                      wire: bool = False) -> TurboGOP:
    """Coefficients -> (nibble plane, dense DC, exception tables).

    qp: (num_cubes, cube) quantized coefficients in PAIR-PERMUTED column
    order (even zigzag indices first, then odd; ops/dct.
    encode_matrix_pair), so the two nibble halves are contiguous slices and
    the pack is elementwise.  DC (column 0) ships densely and is excluded
    from the exception tables, which index the permuted flat order (the
    host converts back with _expand_pair).

    wire=True emits the plane in the wire's (cube/2, cubes)
    coefficient-pair-major layout (K7); wire=False keeps the flat
    transport layout."""
    cube = qp.shape[-1]
    half = cube // 2
    qe, qo = qp[:, :half], qp[:, half:]
    plane = ((qe & 0xF) | ((qo & 0xF) << 4)).to(torch.uint8)
    plane = relayout.plane_to_wire(plane) if wire else plane.reshape(-1)
    dc = qe[:, 0].to(torch.int16)
    lidx, vals, counts, overflow = exceptions.compact_exceptions(
        qp.reshape(-1), slots=slots, dc_stride=cube
    )
    return TurboGOP(plane, dc, lidx, vals, counts, overflow)


def encode_step_turbo(frames: torch.Tensor, ctx: TransformContext,
                      slots: int = exceptions.DEFAULT_SLOTS,
                      wire: bool = False) -> TurboGOP:
    """(T, H, W) uint8 frames on ctx.device (transport deltas when
    cfg.transport_delta) -> TurboGOP.

    The quantized integers are those of the reference profile
    (transform.quantize_step) with the columns in pair order: the
    pair-permuted matrix has the same column values, and DC takes the same
    exact quantizer."""
    qp = _frames_to_q(frames, ctx.enc_t_pair, ctx.cfg)
    return _plane_and_tables(qp, slots, wire=wire)


def _expand_pair(lidx, vals, counts, cube: int):
    """Host half: tables over the PAIR-PERMUTED flat order -> sorted
    original-zigzag-order flat (idx, val) lists.

    Permuted flat p = c*cube + pk maps to zigzag j = 2*pk for
    pk < cube/2, else 2*(pk - cube/2) + 1."""
    p_idx, val = exceptions.expand_exceptions_np(
        np.asarray(lidx), np.asarray(vals), np.asarray(counts)
    )
    half = cube // 2
    c, pk = np.divmod(p_idx, cube)
    j = np.where(pk < half, 2 * pk, 2 * (pk - half) + 1)
    idx = c * cube + j
    order = np.argsort(idx)
    return idx[order], val[order]


def _zstd_wire(cfg: CodecConfig) -> bool:
    """The wire is zstd: configured so and the zstandard module imports."""
    return cfg.turbo_codec == "zstd" and _zstd is not None


def _compress(data, cfg: CodecConfig) -> bytes:
    """One wire stream: zstd when configured and installed, else zlib."""
    if _zstd_wire(cfg):
        # The checksum gives the zstd wire the bit-flip detection that
        # zlib's adler32 gives the zlib wire.
        return _zstd.ZstdCompressor(
            level=cfg.turbo_zstd_level, write_checksum=True
        ).compress(data)
    return zlib.compress(data, cfg.zlib_level)


def _decompress(buf: bytes) -> bytes:
    """Per-stream codec sniff: either wire reads here.  Raises ValueError
    on corrupt data (both codecs)."""
    if buf[:4] == _ZSTD_MAGIC:
        if _zstd is None:  # pragma: no cover
            raise RuntimeError(
                "zstd-coded turbo member, but the zstandard module is not "
                "installed (re-encode with CodecConfig(turbo_codec='zlib'))"
            )
        try:
            return _zstd.ZstdDecompressor().decompress(buf)
        except _zstd.ZstdError as e:
            raise ValueError(f"corrupt turbo stream: {e}") from e
    try:
        return zlib.decompress(buf)
    except zlib.error as e:
        raise ValueError(f"corrupt turbo stream: {e}") from e


def _member_streams(plane: np.ndarray, dc: np.ndarray, idx: np.ndarray,
                    val: np.ndarray, cube: int,
                    wire: bool = False) -> list[np.ndarray]:
    """The four raw streams of a member payload, before compression.

    The nibble plane is stored COEFFICIENT-pair-major: byte [jj, c] packs
    coefficients (2jj, 2jj+1) of cube c.  Exception indices are stored in
    the same coefficient-major order as sorted deltas; DC as deltas.

    wire=True: ``plane`` already is the (cube/2, cubes) wire layout;
    wire=False: it is the flat transport plane and is transposed here."""
    if wire:
        wire_plane = np.ascontiguousarray(plane)
    else:
        wire_plane = np.ascontiguousarray(
            plane.reshape(plane.size * 2 // cube, cube // 2).T)
    return [wire_plane.reshape(-1), *_side_streams(dc, idx, val, cube)]


def _side_streams(dc: np.ndarray, idx: np.ndarray, val: np.ndarray,
                  cube: int) -> list[np.ndarray]:
    """_member_streams' last three: DC deltas, exception index deltas and
    exception values, before compression."""
    cubes = np.size(dc)
    idx = np.asarray(idx, np.int64)
    j = idx % cube
    c = idx // cube
    # Coefficient-pair-major order = stable sort by the pair key alone:
    # the incoming idx is cube-major ascending, so within one pair the
    # (cube, parity) order is already right.
    pair = j >> 1
    key_dtype = np.uint8 if cube <= 512 else np.uint16
    order = np.argsort(pair.astype(key_dtype), kind="stable")
    i2 = ((pair * cubes + c) * 2 + (j & 1))[order]
    didx = np.diff(i2, prepend=np.int64(0)).astype(np.int32)
    dc = np.asarray(dc, np.int16)
    ddc = np.diff(dc, prepend=np.int16(0)).astype(np.int16)  # |dc| <= 5771
    return [ddc, didx, np.ascontiguousarray(np.asarray(val)[order], np.int16)]


def _member_payload(plane: np.ndarray | None, dc: np.ndarray,
                    idx: np.ndarray, val: np.ndarray, cfg: CodecConfig,
                    wire: bool = False,
                    plane_stream: bytes | None = None) -> bytes:
    """Member payload: the four streams of _member_streams, each compressed
    and length-prefixed.  Given ``plane_stream``, the plane's finished
    stream (the card's DEFLATE, TurboEncoder), that ships as it is in the
    plane's place and ``plane`` is not read."""
    if plane_stream is None:
        parts = [_compress(s, cfg) for s in _member_streams(
            plane, dc, idx, val, cfg.cube_size, wire)]
    else:
        parts = [plane_stream] + [_compress(s, cfg) for s in _side_streams(
            dc, idx, val, cfg.cube_size)]
    head = struct.pack("<IIII", *(len(p) for p in parts))
    return head + b"".join(parts)


def _parse_payload(payload: bytes, cube: int, wire: bool = False,
                   split_dc: bool = False):
    """Wire payload -> (plane, exception idx, exception val) with the dense
    DC stream merged back into the exception list.

    wire=False returns the flat transport plane (host transpose); wire=True
    returns the raw (cube/2, cubes) wire layout, for K8 on the device.
    split_dc=True (wire only) skips the merge and returns (plane, dc int32,
    idx, val), the 4-tuple decoder._dispatch_planar4 takes."""
    if len(payload) < 16:
        raise EOFError("torn turbo member (truncated header)")
    a, b, c, d = struct.unpack_from("<IIII", payload, 0)
    if 16 + a + b + c + d > len(payload):
        raise EOFError(
            "torn turbo member (payload shorter than its stream lengths)"
        )
    o = 16
    wire_plane = np.frombuffer(_decompress(payload[o : o + a]), np.uint8)
    o += a
    ddc = np.frombuffer(_decompress(payload[o : o + b]), np.int16)
    dc = np.cumsum(ddc.astype(np.int32)).astype(np.int16)
    o += b
    didx = np.frombuffer(_decompress(payload[o : o + c]), np.int32)
    o += c
    val = np.frombuffer(_decompress(payload[o : o + d]), np.int16)
    cubes = dc.size
    if wire:
        plane = wire_plane.reshape(cube // 2, cubes)
    else:
        plane = np.ascontiguousarray(
            wire_plane.reshape(cube // 2, cubes).T).reshape(-1)
    i2 = np.cumsum(didx.astype(np.int64))
    cpos = (i2 >> 1) % cubes
    jj = (i2 >> 1) // cubes
    idx = cpos * cube + jj * 2 + (i2 & 1)
    if split_dc:
        if not wire:
            raise ValueError("split_dc needs the wire layout")
        return plane, dc.astype(np.int32), idx, val.astype(np.int32)
    idx_all = np.concatenate(
        [idx, np.arange(cubes, dtype=np.int64) * cube]
    )
    val_all = np.concatenate([val.astype(np.int32), dc.astype(np.int32)])
    return plane, idx_all, val_all


class TurboEncoder:
    """Push frames, get turbo container bytes (one type-5 member per GOP).

    Each GOP's device step runs on the pushing thread, which records one
    event per GOP.  A pool of drain workers (cfg.deflate_workers, resolved
    as entropy.resolve_workers) waits on the event, reads the GOP back on
    its own CUDA stream into pinned memory, and compresses the member;
    output order is kept by the futures deque.  A GOP whose exception
    tables overflowed is re-encoded with 256 slots by its worker, on the
    worker's stream.  ``timer`` holds the stages (``encode --turbo
    --stats``): ``dispatch`` and ``stage_in`` on the pushing thread,
    ``device_wait``, ``d2h`` and ``member`` (expand and compress) summed
    over the drain workers.

    On a card, with ``deflate_workers != 0`` and a zlib wire, the worker
    deflates the GOP's wire plane with the card's DEFLATE on its stream
    (its own ``ops.deflate.Deflater``, kept until ``finish()``) and reads
    back only the compressed span, which it frames as the plane's zlib
    stream: valid zlib, but not zlib's bytes.  The driver's stages
    ``deflate`` (the plane's bytes in) and ``deflate_out`` (the span's
    bytes) count that route.  CPU tensors, ``deflate_workers=0`` and the
    zstd wire compress the plane with ``_compress`` on the host, as the
    JAX package does.

    Usage:
        enc = TurboEncoder(width, height, cfg, device="cuda")
        for batch in frame_batches:        # (T, H, W) uint8, T % gop == 0
            out.write(enc.push(batch))
        out.write(enc.finish())
    """

    def __init__(
        self,
        width: int,
        height: int,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
        device=None,
        slots: int = exceptions.DEFAULT_SLOTS,
        max_inflight: int = 6,
        member_type: int = MEMBER_TURBO,
    ) -> None:
        self.member_type = member_type
        self.cfg = cfg or CodecConfig()
        self.cfg.validate_geometry(width, height)
        self.width = width
        self.height = height
        self.ctx = ctx or TransformContext(self.cfg, device)
        self.device = self.ctx.device
        self.slots = slots
        self.frames_encoded = 0
        self.max_inflight = max_inflight
        #: per-stage wall time and bytes (``encode --turbo --stats``)
        self.timer = StageTimer()
        self._drainer = ThreadPoolExecutor(
            max_workers=entropy.resolve_workers(self.cfg.deflate_workers)
        )
        self._out: collections.deque = collections.deque()
        self._warned_fallback = False
        self._local = threading.local()  # each worker's stream and Deflater
        self._card_deflate = (self.device.type == "cuda"
                              and self.cfg.deflate_workers != 0
                              and not _zstd_wire(self.cfg))
        if self._card_deflate:  # the wire plane's bits: 4 a pixel
            self._plane_bits = torch.tensor(4 * self.cfg.gop_size * height * width,
                                            dtype=torch.int64, device=self.device)

    def _warn_fallback(self) -> None:
        self._warned_fallback = _warn_fallback_once(self._warned_fallback)

    def _readback(self, gop: TurboGOP, frames_dev: torch.Tensor,
                  done) -> tuple[bytes | None, list]:
        """Worker: the plane's zlib stream on the card's DEFLATE route (else
        None), and (plane, dc, lidx, vals, counts) on the host, after the
        overflow retry if one is needed; the plane is None on that route.
        Holds the GOP's device tensors until their copies are done."""
        loc = self._local
        if done is not None and getattr(loc, "stream", None) is None:
            loc.stream = torch.cuda.Stream(self.device)
            if self._card_deflate:
                loc.deflater = dev_deflate.Deflater(self.cfg.zlib_level, self.timer)
        with staging.after(done, getattr(loc, "stream", None)):
            with staging.on_card(self.timer, "device_wait", done is not None):
                overflow = bool(gop.overflow)  # synchronizes this stream
            if overflow:
                gop = encode_step_turbo(frames_dev, self.ctx, _RETRY_SLOTS,
                                        wire=True)
            plane_stream = None
            if self._card_deflate:
                span, bits, s1, s2, _ = loc.deflater(gop.plane.reshape(-1), self._plane_bits)
                plane_stream = dev_deflate.zlib_stream(span, self.cfg.zlib_level, s1, s2,
                                                       bits // 8)
            host = staging.fetch(gop[1:5] if plane_stream else gop[:5], self.timer)
        return plane_stream, [None, *host] if plane_stream else host

    def _drain_gop(self, gop: TurboGOP, frames_dev: torch.Tensor, done,
                   t: int, raw: np.ndarray) -> bytes:
        plane_stream, host = self._readback(gop, frames_dev, done)
        plane, dc, lidx, vals, counts = host
        with self.timer.stage("member", len(plane_stream or b"") + sum(
                h.nbytes for h in host if h is not None)):
            idx, val = _expand_pair(lidx, vals, counts, self.cfg.cube_size)
            payload = _member_payload(plane, dc, idx, val, self.cfg, wire=True,
                                      plane_stream=plane_stream)
            return _pick_member(raw, payload, idx.size, t, self.member_type,
                                self.cfg, self.ctx, self._warn_fallback)

    def push(self, frames: np.ndarray) -> bytes:
        """Encode a (T, H, W) uint8 batch; T must be a GOP multiple.
        Returns the members that are complete (may be empty)."""
        t = frames.shape[0]
        gop = self.cfg.gop_size
        if t % gop:
            raise ValueError(
                f"batch of {t} frames is not a multiple of GOP {gop}"
            )
        if frames.shape[1:] != (self.height, self.width):
            raise ValueError("frame geometry mismatch")
        for i in range(0, t, gop):
            raw = frames[i : i + gop]
            with self.timer.stage("dispatch", raw.nbytes):
                up = _deltas(raw) if self.cfg.transport_delta else raw
                with self.timer.stage("stage_in", up.nbytes):
                    frames_dev = staging.to_device(up, self.device)
                step = encode_step_turbo(frames_dev, self.ctx, self.slots,
                                         wire=True)
            done = staging.mark(self.device)
            self._out.append(self._drainer.submit(
                self._drain_gop, step, frames_dev, done, gop, raw))
            if len(self._out) > self.max_inflight:
                with trace("wait_drainer"):
                    self._out[0].result()
        self.frames_encoded += t
        out = []
        while self._out and self._out[0].done():
            out.append(self._out.popleft().result())
        return b"".join(out)

    def drain(self) -> bytes:
        """Block for every in-flight member and return its bytes."""
        out = []
        with trace("wait_drainer"):
            while self._out:
                out.append(self._out.popleft().result())
        return b"".join(out)

    def finish(self) -> bytes:
        out = self.drain()
        self._drainer.shutdown(wait=True)
        self._local = threading.local()  # frees the workers' Deflaters
        return out


class TurboShardedEncoder:
    """Turbo encode over a (gop, tile) device mesh (parallel/mesh.py);
    members byte-identical to TurboEncoder's.

    Turbo has no bit phases, so shard rank order is global value order
    (GOP-major, then block-row tiles): each shard runs the single-device
    step (K1, K7 to its (cube/2, local cubes) wire slab, K6) on its device,
    and a GOP's wire plane is its tiles' slabs side by side.  The shards'
    exception tables are expanded one shard at a time and offset by the
    tile's first value, so a shard whose values end in a partial 256-value
    group (4x4x4 cubes) cannot shift the next one's indices.  If any shard
    overflows its slots, the whole step reruns at 256 slots.  The shards get
    raw frames whatever cfg.transport_delta says.  The host builds the
    members on a pool of deflate workers (cfg.deflate_workers), up to
    ``max_inflight`` GOPs at a time across the steps of a push, as
    TurboEncoder does; push() returns every member of its frames.
    """

    max_inflight = 6  # TurboEncoder's default

    def __init__(self, width, height, mesh, cfg: CodecConfig | None = None,
                 ctx: TransformContext | None = None,
                 slots: int = exceptions.DEFAULT_SLOTS,
                 member_type: int = MEMBER_TURBO) -> None:
        self.member_type = member_type
        self.cfg = cfg or CodecConfig()
        self.width = width
        self.height = height
        self.mesh = mesh
        n_gop, n_tile = mesh.shape[GOP_AXIS], mesh.shape[TILE_AXIS]
        _check_tiles(self.cfg, height, n_tile)
        self.cfg.validate_geometry(width, height)
        self._mesh_shape = (n_gop, n_tile)
        self._shard_cfg = dataclasses.replace(self.cfg, transport_delta=False)
        self._ctx = mesh_contexts(mesh, self._shard_cfg, ctx)
        self.slots = slots
        self._pool = ThreadPoolExecutor(
            max_workers=entropy.resolve_workers(self.cfg.deflate_workers))
        self._warned_fallback = False
        self.frames_encoded = 0

    def _warn_fallback(self) -> None:
        self._warned_fallback = _warn_fallback_once(self._warned_fallback)

    def _step(self, frames: np.ndarray, slots: int) -> list[TurboGOP]:
        n_tile = self._mesh_shape[1]
        gop, lh = self.cfg.gop_size, self.height // n_tile
        out = []
        for k, dev in enumerate(self.mesh.devices):
            g, t = divmod(k, n_tile)
            fd = staging.to_device(frames[g * gop : (g + 1) * gop, t * lh : (t + 1) * lh], dev)
            out.append(_plane_and_tables(
                _frames_to_q(fd, self._ctx[dev].enc_t_pair, self._shard_cfg), slots,
                wire=True))
        return out

    def push(self, frames: np.ndarray) -> bytes:
        """Encode a (T, H, W) uint8 batch, T a multiple of gop_size * mesh
        gop; returns its members."""
        n_gop, n_tile = self._mesh_shape
        gop = self.cfg.gop_size
        step_t = gop * n_gop
        t, h, w = frames.shape
        if t % step_t or (h, w) != (self.height, self.width):
            raise ValueError(
                f"push expects T % {step_t} == 0 and geometry "
                f"{self.height}x{self.width}"
            )
        out: list[bytes] = []
        futs: collections.deque = collections.deque()
        dev0 = self.mesh.devices[0]
        for i in range(0, t, step_t):
            step = frames[i : i + step_t]
            shards = self._step(step, self.slots)
            if bool(torch.stack([s.overflow.to(dev0) for s in shards]).any()):
                shards = self._step(step, _RETRY_SLOTS)
            host = staging.fetch([a for s in shards for a in s[:5]])
            for g in range(n_gop):
                futs.append(self._pool.submit(
                    self._member, host[5 * g * n_tile : 5 * (g + 1) * n_tile],
                    step[g * gop : (g + 1) * gop]))
                if len(futs) > self.max_inflight:
                    out.append(futs.popleft().result())
            self.frames_encoded += step_t
        out.extend(f.result() for f in futs)
        return b"".join(out)

    def _member(self, host: list[np.ndarray], raw: np.ndarray) -> bytes:
        """Worker: one GOP's member from its tiles' (plane, dc, lidx, vals,
        counts), five arrays a tile in tile order."""
        n_tile = self._mesh_shape[1]
        local_n = self.cfg.gop_size * (self.height // n_tile) * self.width
        tiles = [host[5 * k : 5 * k + 5] for k in range(n_tile)]
        plane = np.concatenate([tl[0] for tl in tiles], axis=1)
        dc = np.concatenate([tl[1] for tl in tiles])
        exc = [_expand_pair(*tl[2:], self.cfg.cube_size) for tl in tiles]
        idx = np.concatenate([e[0] + k * local_n for k, e in enumerate(exc)])
        val = np.concatenate([e[1] for e in exc])
        payload = _member_payload(plane, dc, idx, val, self.cfg, True)
        # The same content-measured fallback as TurboEncoder: the exception
        # lists and payloads equal the single-device ones, so the choice
        # does too.
        return _pick_member(raw, payload, idx.size, self.cfg.gop_size,
                            self.member_type, self._shard_cfg,
                            self._ctx[self.mesh.devices[0]], self._warn_fallback)

    def drain(self) -> bytes:
        """push() returns every member of its frames, so nothing is in
        flight here (the checkpointing encoder drains before each fsync)."""
        return b""

    def finish(self) -> bytes:
        self._pool.shutdown(wait=True)
        return b""


class TurboShardedDecoder:
    """Turbo decode over a (gop, tile) device mesh; pixels identical to the
    single-device turbo decode's, through the same composition: the
    split-DC parse (``_parse_payload(split_dc=True)``), K8, then
    planar4_to_frames (K4 at 8x8x8) on each shard's device.

    Host work per mesh step is n_gop payload parses on a pool (pure
    decompression) and per tile a column slice of the (cube/2, cubes) wire
    plane, the tile's DC slice and its exact exception list.  Members that
    do not fill a whole mesh step, and reference-profile fallback members,
    take the single-device path."""

    def __init__(self, width, height, mesh, cfg: CodecConfig | None = None,
                 ctx: TransformContext | None = None,
                 inflate_workers: int | None = None) -> None:
        self.cfg = cfg or CodecConfig()
        self.width = width
        self.height = height
        self.mesh = mesh
        n_gop, n_tile = mesh.shape[GOP_AXIS], mesh.shape[TILE_AXIS]
        _check_tiles(self.cfg, height, n_tile)
        self.cfg.validate_geometry(width, height)
        self._mesh_shape = (n_gop, n_tile)
        self._ctx = mesh_contexts(
            mesh, dataclasses.replace(self.cfg, transport_delta=False), ctx)
        self._workers = inflate_workers or max(1, os.cpu_count() or 2)

    def _dispatch(self, parsed: list) -> list:
        """n_gop parsed split-DC wire payloads -> each shard's frames on its
        device, started back to the host (staging.to_host_async), rank order."""
        n_tile = self._mesh_shape[1]
        local_h = self.height // n_tile
        local_n = self.cfg.gop_size * local_h * self.width
        lc = local_n // self.cfg.cube_size
        out = []
        for k, dev in enumerate(self.mesh.devices):
            g, t = divmod(k, n_tile)
            wire, dc, idx, val = parsed[g]
            sel = (idx >= t * local_n) & (idx < (t + 1) * local_n)
            planar = (wire[:, t * lc : (t + 1) * lc], dc[t * lc : (t + 1) * lc],
                      idx[sel] - t * local_n, val[sel])
            out.append(staging.to_host_async(
                _dispatch_planar4(planar, self._ctx[dev], local_h, self.width)))
        return out

    def decode(self, data: bytes, member_type: int = MEMBER_TURBO) -> np.ndarray:
        members = [m for m in split_members(data) if m[2] in _typed(member_type)]
        if not members:
            raise ValueError(f"not a turbo container (no type-{member_type} members)")
        n_gop, n_tile = self._mesh_shape
        gop = self.cfg.gop_size
        lh = self.height // n_tile
        n_steps = len(members) // n_gop
        # Step offsets assume one GOP per turbo member (what every turbo
        # encoder writes); fallback members or odd sizes in the steps send
        # the whole container down the single-device path.
        if any(m[0] != gop or m[2] != member_type for m in members[: n_steps * n_gop]):
            n_steps = 0
        step_t = gop * n_gop
        out = np.empty((sum(m[0] for m in members), self.height, self.width), np.uint8)
        pending: collections.deque = collections.deque()
        cube = self.cfg.cube_size

        def drain_one() -> None:
            a0, parts = pending.popleft()
            for k, started in enumerate(parts):
                g, t = divmod(k, n_tile)
                out[a0 + g * gop : a0 + (g + 1) * gop,
                    t * lh : (t + 1) * lh] = staging.landed(started)

        with ThreadPoolExecutor(self._workers) as pool:
            n_main = n_steps * n_gop
            lookahead = max(n_gop, 2 * self._workers)
            inflight = collections.deque(
                pool.submit(_parse_payload, m[1], cube, True, True)
                for m in members[: min(n_main, lookahead)])
            nxt = len(inflight)
            for s in range(n_steps):
                parsed = []
                for _ in range(n_gop):
                    parsed.append(inflight.popleft().result())
                    if nxt < n_main:
                        inflight.append(pool.submit(
                            _parse_payload, members[nxt][1], cube, True, True))
                        nxt += 1
                pending.append((s * step_t, self._dispatch(parsed)))
                if len(pending) >= _WINDOW:
                    drain_one()
            while pending:
                drain_one()
            if n_main < len(members):  # the tail: the single-device path
                out[n_steps * step_t :] = _decode_members(
                    members[n_main:], pool, self.width, self.height, self.cfg,
                    self._ctx[self.mesh.devices[0]])
        return out


def encode_turbo_video(
    frames: np.ndarray,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
) -> bytes:
    """One-call turbo encode of an in-memory (T, H, W) uint8 video on
    ``device`` (or ``ctx.device``); frames past the last whole GOP are
    dropped."""
    cfg = cfg or CodecConfig()
    t = frames.shape[0] - frames.shape[0] % cfg.gop_size
    enc = TurboEncoder(frames.shape[2], frames.shape[1], cfg, ctx, device)
    return enc.push(frames[:t]) + enc.finish()


def encode_turbo_rgb_video(
    frames: np.ndarray,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    mesh=None,
    device=None,
) -> bytes:
    """(T, H, W, 3) interleaved RGB -> turbo container on ``device`` (or
    ``ctx.device``): per channel, one type-6/7/8 member per GOP
    (channel-major member order, like the reference-profile RGB
    container).

    mesh: an optional (gop, tile) device mesh (parallel/mesh.py); each
    channel then encodes through TurboShardedEncoder, members identical to
    the single-device ones, and frames truncate to whole mesh steps."""
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
    for c, mtype in enumerate(MEMBER_TURBO_RGB):
        if mesh is not None:
            enc = TurboShardedEncoder(frames.shape[2], frames.shape[1], mesh,
                                      cfg, ctx, member_type=mtype)
        else:
            enc = TurboEncoder(frames.shape[2], frames.shape[1], cfg, ctx,
                               member_type=mtype)
        plane = np.ascontiguousarray(frames[:t, :, :, c])
        out.append(enc.push(plane) + enc.finish())
    return b"".join(out)


def is_turbo_container(members: Iterable[tuple[int, bytes, int]]) -> bool:
    """Turbo containers may interleave reference-profile fallback members
    (MEMBER_TEMPORAL).  A container where every GOP fell back carries no
    type-5 member at all and is a plain temporal container."""
    types = {m[2] for m in members}
    return MEMBER_TURBO in types and types <= {
        MEMBER_TURBO, MEMBER_TEMPORAL, MEMBER_INDEX
    }


def is_turbo_rgb_container(members: Iterable[tuple[int, bytes, int]]) -> bool:
    """Like is_turbo_container, channel members may interleave per-GOP
    RGB-channel fallback types (1/2/3).  A container where EVERY GOP of
    every channel fell back carries only channel types — it is a plain RGB
    container ONLY in the one-member-per-channel shape decode_rgb_video
    reads; with several members per channel it must route here (the
    per-channel member walk reads both types)."""
    members = list(members)
    types = {m[2] for m in members}
    channel = {MEMBER_RED, MEMBER_GREEN, MEMBER_BLUE}
    if not types or not types <= set(MEMBER_TURBO_RGB) | channel:
        return False
    if types & set(MEMBER_TURBO_RGB):
        return True
    return sum(1 for m in members if m[2] in channel) > 3


def _pool_size(n_members: int, inflate_workers: int | None) -> int:
    return inflate_workers or max(1, min(n_members, os.cpu_count() or 2))


def _typed(member_type: int) -> tuple[int, int]:
    """The member types a channel of ``member_type`` reads: its own and
    its reference-profile fallback."""
    return member_type, _FALLBACK_TYPE[member_type]


def decode_turbo_container(
    data: bytes,
    width: int,
    height: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
    inflate_workers: int | None = None,
    member_type: int = MEMBER_TURBO,
) -> np.ndarray:
    """Turbo container -> (T, H, W) uint8 on ``device`` (or ctx.device);
    pixels identical to the reference profile's decode of the same source.
    ``member_type`` selects a turbo-RGB channel.

    The host stage is pure decompression, GOP-parallel on a pool; device
    steps overlap with it through a window of in-flight GOPs."""
    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg, device)
    members = [m for m in split_members(data) if m[2] in _typed(member_type)]
    if not members:
        raise ValueError(f"not a turbo container (no type-{member_type} members)")
    with ThreadPoolExecutor(_pool_size(len(members), inflate_workers)) as pool:
        return _decode_members(members, pool, width, height, cfg, ctx)


def decode_turbo_range(
    data: bytes,
    width: int,
    height: int,
    start: int,
    stop: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
    inflate_workers: int | None = None,
    member_type: int = MEMBER_TURBO,
) -> np.ndarray:
    """Random-access decode of frames [start, stop) from a turbo container
    (``member_type`` selects a turbo-RGB channel).

    Members are self-delimiting and independent (one GOP each), so only
    the covering members are decompressed and decoded.  Pixels are
    identical to the same slice of decode_turbo_container's output."""
    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg, device)
    if not (0 <= start < stop):
        raise ValueError(f"bad frame range [{start}, {stop})")
    covering = []
    a0 = first_a0 = 0
    saw_member = False
    for m in split_members(data):
        if m[2] not in _typed(member_type):
            continue
        saw_member = True
        if a0 + m[0] > start and a0 < stop:
            if not covering:
                first_a0 = a0
            covering.append(m)
        a0 += m[0]
        if a0 >= stop:
            break
    if not saw_member:
        # Wrong container type, not truncation.
        raise ValueError(f"not a turbo container (no type-{member_type} members)")
    if a0 < stop:
        raise EOFError(
            f"container holds {a0} frames, range [{start}, {stop}) "
            "reaches past the end"
        )
    with ThreadPoolExecutor(_pool_size(len(covering), inflate_workers)) as pool:
        span = _decode_members(covering, pool, width, height, cfg, ctx)
    return span[start - first_a0 : stop - first_a0]


def decode_turbo_rgb_video(
    data: bytes,
    width: int,
    height: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
) -> np.ndarray:
    """Turbo-RGB container -> (T, H, W, 3) uint8 on ``device`` (or
    ctx.device): one split, one inflate pool shared by the three
    channels."""
    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg, device)
    members = split_members(data)
    by_type = {t: [m for m in members if m[2] in _typed(t)]
               for t in MEMBER_TURBO_RGB}
    if not all(by_type.values()):
        raise ValueError("not a turbo-rgb container (missing channels)")
    with ThreadPoolExecutor(max(1, os.cpu_count() or 2)) as pool:
        planes = [_decode_members(by_type[t], pool, width, height, cfg, ctx)
                  for t in MEMBER_TURBO_RGB]
    return np.stack(planes, axis=-1)


def decode_turbo_rgb_range(
    data: bytes,
    width: int,
    height: int,
    start: int,
    stop: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
) -> np.ndarray:
    """Random-access decode of frames [start, stop) from a turbo-RGB
    container -> (stop-start, H, W, 3): each channel skips its
    non-covering members (decode_turbo_range per channel type)."""
    cfg = cfg or CodecConfig()
    ctx = ctx or TransformContext(cfg, device)
    planes = [decode_turbo_range(data, width, height, start, stop, cfg, ctx,
                                 member_type=t)
              for t in MEMBER_TURBO_RGB]
    return np.stack(planes, axis=-1)


def _decode_members(members, pool, width, height, cfg, ctx) -> np.ndarray:
    """Decompress members on ``pool`` with a bounded lookahead, dispatch
    the device steps in order, assemble the frames.  Reference-typed
    fallback members decode through decoder.decode_video on the pool."""
    landing = staging.Landing((sum(m[0] for m in members), height, width),
                              ctx.device)
    cube = cfg.cube_size
    lookahead = max(4, 2 * pool._max_workers)

    def submit(m):
        t_m, payload, mtype = m
        if mtype in _REF_TYPES:
            return pool.submit(decode_video, payload, width, height, t_m,
                               cfg, ctx)
        return pool.submit(traced, "parse", _parse_payload, payload, cube,
                           True, True)

    inflight = collections.deque(submit(m) for m in members[:lookahead])
    nxt = len(inflight)
    a0 = 0
    for t, _, mtype in members:
        with trace("entropy_wait"):
            planar = inflight.popleft().result()
        if nxt < len(members):
            inflight.append(submit(members[nxt]))
            nxt += 1
        if mtype in _REF_TYPES:
            landing.out[a0 : a0 + t] = planar  # already decoded frames
        else:
            frames_dev = _dispatch_planar4(planar, ctx, height, width)
            with trace("readback"):
                landing.put(a0, frames_dev)
        a0 += t
    with trace("readback"):
        return landing.result(lambda f: _undelta(f, ctx.cfg, out=f))
