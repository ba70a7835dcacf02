"""Sharded encode/decode over a (gop, tile) device mesh.

The port's counterpart of ``dct3d_tpu.parallel.sharding``.  Frames are
sharded over devices — the temporal axis across the "gop" mesh axis, frame
block rows across the "tile" axis (mesh.py).  Every shard runs the same
transform and bit pack as the single-device encoder.  The bitstream is
order-sensitive (cube order: GOP-major, then block row; codec/framing.py),
and the shards own contiguous runs of cubes in exactly mesh-rank order, so
concatenation is the only coupling.

The serial concatenation is solved on the devices: each shard's bit count
(group_bits for whole 256-value groups, the codeword widths otherwise) is
gathered on shard 0's device, an exclusive scan plus the sink's carry gives
each shard its global start bit, and each shard packs its codewords already
phase-aligned to it (K2 + K3, or K5 + K3).  The host then only
byte-splices the shards' buffers and ORs the one boundary byte each shares
with its predecessor — no host bit shifting of bulk data.  The carry for
the next step stays on the device, so steps dispatch back to back; the host
syncs once a step, before assembly.

The JAX package sizes the shards' buffers with a bit budget and retries on
overflow; the port's pack buffers have the worst-case size (ops/bitpack.py),
so neither the budget ladder nor the retry comes along.  The bytes are the
same.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from .. import native
from ..codec import entropy
from ..codec.transform import (
    TransformContext, _dequant_matmul, _finish_frames, _frames_to_q,
    host_matrices,
)
from ..config import CodecConfig
from ..ops import bitpack, expgolomb, group_pack
from ..profiling import StageTimer
from ..staging import fetch, landed, to_device, to_host_async
from .mesh import GOP_AXIS, TILE_AXIS, Mesh, normalize_device

_WINDOW = 3  # decode: mesh steps in flight on the devices


def mesh_contexts(mesh: Mesh, cfg: CodecConfig,
                  ctx: TransformContext | None = None) -> dict:
    """One TransformContext per distinct device of ``mesh``, all built from
    one set of host matrices in cfg's compute dtype (host_matrices).
    ``ctx`` serves its own device when it holds the same cfg."""
    out: dict = {}
    arrays = None
    for dev in mesh.distinct_devices:
        if (ctx is not None and ctx.cfg == cfg
                and normalize_device(ctx.device) == dev):
            out[dev] = ctx
            continue
        if arrays is None:
            arrays = host_matrices(cfg)
        out[dev] = TransformContext(cfg, dev, arrays)
    return out


def _check_tiles(cfg: CodecConfig, height: int, n_tile: int) -> None:
    if height % (cfg.block_h * n_tile):
        raise ValueError(
            f"height {height} must split into {n_tile} tiles of whole "
            f"{cfg.block_h}-pixel block rows"
        )


class ShardedEncoder:
    """Multi-device streaming encoder.

    Frames per push: (T, H, W) with T a multiple of gop_size * mesh gop and
    H a multiple of block_h * mesh tile.  Emits one continuous zlib stream
    byte-identical to the single-device encoder's (with the parallel
    DEFLATE sink, the same inflated payload: that sink marks one sync point
    a mesh step).  The shards get raw frames whatever cfg.transport_delta
    says (deltas are a single-device upload optimization; the stream is
    the same).  ``timer`` holds the stages (``encode --mesh GxT --stats``):
    ``dispatch`` and ``stage_in`` a mesh step, ``sink_push`` and the
    sink's ``deflate``.
    """

    def __init__(
        self,
        width: int,
        height: int,
        mesh: Mesh,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
    ) -> None:
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
        self._max_width = bitpack.max_codeword_bits(self.cfg.cube_size)
        #: per-stage wall time and bytes (``encode --stats``)
        self.timer = StageTimer()
        self.sink = entropy.make_sink(self.cfg, self.timer)
        self.frames_encoded = 0
        #: absolute bit position after each GOP (the seekable index, same
        #: contract as StreamingEncoder.gop_bit_ends); complete after push.
        self.gop_bit_ends: list[int] = []
        self._abs_end = 0

    def push(self, frames: np.ndarray) -> bytes:
        """Encode frames; T must be a multiple of gop_size * mesh gop.

        Each step takes exactly ONE GOP per gop shard: that makes shard
        rank order global cube order (GOP-major, then block row), which is
        what keeps the stream byte-identical to the single-device encoder's.
        Longer inputs loop over steps; step k+1 is dispatched before step k
        is assembled (the carry chains on the device).
        """
        n_gop, _ = self._mesh_shape
        t, h, w = frames.shape
        step_t = self.cfg.gop_size * n_gop
        if t % step_t or (h, w) != (self.height, self.width):
            raise ValueError(
                f"push expects T % {step_t} == 0 and geometry "
                f"{self.height}x{self.width}"
            )
        carry = torch.tensor(self.sink.carry_bits, dtype=torch.int64,
                             device=self.mesh.devices[0])
        pending = None
        out = []
        for i in range(0, t, step_t):
            with self.timer.stage("dispatch", frames[i : i + step_t].nbytes):
                *step, carry = self._dispatch(frames[i : i + step_t], carry)
            if pending is not None:
                out.append(self._assemble(*pending))
            pending = step
        if pending is not None:
            out.append(self._assemble(*pending))
        self.frames_encoded += t
        return b"".join(out)

    def _dispatch(self, frames: np.ndarray, carry: torch.Tensor):
        """One mesh step on the devices: quantize each shard, gather the
        bit counts, pack each shard at its global bit phase.  Returns
        (packed buffers, bit counts, start bits, next carry); the last
        three are tensors on shard 0's device."""
        n_gop, n_tile = self._mesh_shape
        gop, lh = self.cfg.gop_size, self.height // n_tile
        shards, bits = [], []
        slabs = []
        with self.timer.stage("stage_in", frames.nbytes):
            for k, dev in enumerate(self.mesh.devices):
                g, t = divmod(k, n_tile)
                slabs.append(to_device(
                    frames[g * gop : (g + 1) * gop, t * lh : (t + 1) * lh], dev))
        for slab, dev in zip(slabs, self.mesh.devices):
            q = _frames_to_q(slab, self._ctx[dev].enc_t, self._shard_cfg).reshape(-1)
            if q.numel() % group_pack.GROUP:
                code, width = expgolomb.codewords(q)
                shards.append((None, None, code, width))
                bits.append(width.sum())
            else:
                # One group_bits launch serves the count and the geometry.
                gbits = group_pack.group_bits(q.reshape(-1, group_pack.GROUP))
                shards.append((q, gbits, None, None))
                bits.append(gbits.sum(dtype=torch.int64))
        # The gather: one count a shard, on shard 0's device.
        dev0 = self.mesh.devices[0]
        counts = torch.stack([b.to(dev0) for b in bits])
        starts = carry + torch.cumsum(counts, 0) - counts
        packed = []
        for k, (dev, (q, gbits, code, width)) in enumerate(zip(self.mesh.devices, shards)):
            # The first `phase` bits are zeros, so the buffer's bytes land
            # on global byte boundaries: the carry of pack_values, a zero
            # pseudo-codeword ahead of pack_bits' codewords.
            phase = (starts[k] % 8).to(dev)
            if q is None:
                buf = bitpack.pack_bits(
                    torch.cat([torch.zeros(1, dtype=code.dtype, device=dev), code]),
                    torch.cat([phase.reshape(1), width]), self._max_width)[0]
            else:
                zero = torch.zeros((), dtype=torch.int64, device=dev)
                buf = bitpack.pack_values(q, zero, phase, self._max_width, gbits)[0]
            packed.append(buf)
        return packed, counts, starts, (carry + counts.sum()) % 8

    def _assemble(self, packed: list[torch.Tensor], counts: torch.Tensor,
                  starts: torch.Tensor) -> bytes:
        """Byte-splice the phase-aligned shard buffers into the global
        stream: bring back each shard's bit count and start (one sync),
        then only the bytes of each buffer that hold its bits."""
        bits, starts = fetch([torch.stack([counts, starts])])[0].astype(np.int64)
        carry_bits = self.sink.carry_bits
        total_bits = int(carry_bits + bits.sum())
        # Seekable index: shard k = (gop g, tile t) in rank order, so GOP g
        # starts at shard g * n_tile's offset.  starts[] include the sink's
        # carry phase, like total_bits; add the whole bytes emitted so far
        # to get absolute stream positions.
        base = (self._abs_end >> 3) << 3
        n_gop, n_tile = self._mesh_shape
        self.gop_bit_ends.extend(base + int(starts[g * n_tile]) for g in range(1, n_gop))
        self.gop_bit_ends.append(base + total_bits)
        self._abs_end = base + total_bits
        if total_bits >= 1 << 31:
            # The JAX package's device offsets are int32; the port keeps
            # its limit, so both read the same streams.
            raise OverflowError(
                f"one sharded step produced {total_bits} bits >= 2^31; "
                "push fewer GOPs per step (smaller gop mesh axis)"
            )
        spans = [(int(s) % 8 + int(b) + 7) // 8 if b else 0 for s, b in zip(starts, bits)]
        chunks = fetch([buf[:n] for buf, n in zip(packed, spans)])
        nbytes = total_bits // 8 + 1
        stream = np.zeros(nbytes, dtype=np.uint8)
        for s, n, chunk in zip(starts, spans, chunks):
            if n == 0:
                continue  # a shard with no bits shares no byte
            byte0 = int(s) // 8
            end = min(byte0 + n, nbytes)
            # OR the (at most one) boundary byte shared with the previous
            # shard; the rest is a plain copy.
            stream[byte0] |= chunk[0]
            if end - byte0 > 1:
                stream[byte0 + 1 : end] = chunk[1 : end - byte0]
        # push_packed expects the carry phase's zeros at the front (bit 0).
        # Step-granularity parallel-inflate sync: the parallel sink resets
        # its priming window here (the serial sink does nothing).
        with self.timer.stage("sink_push", total_bits // 8):
            self.sink.gop_boundary()
            return self.sink.push_packed(stream, total_bits)

    def finish(self) -> bytes:
        out = self.sink.finish()
        self.sink.close()
        return out

    @property
    def gop_sync_offsets(self) -> list[int] | None:
        """Per-GOP compressed sync offsets at STEP granularity: every GOP of
        a mesh step shares the step's sync (entropy.parallel_inflate treats
        equal adjacent syncs as empty spans), so mesh encodes are
        parallel-inflatable too.  None for the serial sink."""
        syncs = self.sink.sync_offsets()
        if syncs is None:
            return None
        return [s for s in syncs for _ in range(self._mesh_shape[0])]


def sharded_decode_step(mesh: Mesh, contexts: dict, cfg: CodecConfig,
                        height: int, width: int):
    """The sharded inverse transform: a function from one mesh step's
    coefficients, laid out (n_gop, n_tile, cubes_local, cube) int32 on the
    host, to each shard's (gop_size, height / tile, width) uint8 frames on
    its device, in rank order.

    Each shard uploads its cubes and runs the single-device decode's
    even/odd split matmul (transform._dequant_matmul), then
    transform._finish_frames (K4 at 8x8x8) under ``cfg``, whose
    transport_delta must be off: the frames come back whole."""
    n_tile = mesh.shape[TILE_AXIS]
    local_h = height // n_tile

    def step(coeffs: np.ndarray) -> list[torch.Tensor]:
        out = []
        for k, dev in enumerate(mesh.devices):
            ctx = contexts[dev]
            c = to_device(coeffs[k // n_tile, k % n_tile], dev)
            pixels = _dequant_matmul(c[:, 0::2], c[:, 1::2], ctx.dec_me, ctx.dec_mo)
            out.append(_finish_frames(pixels, cfg, local_h, width))
        return out

    return step


class ShardedDecoder:
    """Multi-device streaming decode: entropy on the host, the inverse
    transform sharded over the mesh.

    Streams one mesh step (gop_size * mesh gop frames) at a time: the host
    entropy stage runs step-parallel on a worker pool over a bounded
    InflateWindow (index positions when given, else a scan ahead of the
    workers), and at most three steps are in flight on the devices.  The
    int32 coefficients, the inflated payload and — through decode_stream —
    the output frames are all O(step).  decode() assembles the generator
    into one array.  Pixels equal the single-device decode's.
    """

    def __init__(
        self,
        width: int,
        height: int,
        mesh: Mesh,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
        entropy_workers: int | None = None,
    ) -> None:
        self.cfg = cfg or CodecConfig()
        self.width = width
        self.height = height
        self.mesh = mesh
        _check_tiles(self.cfg, height, mesh.shape[TILE_AXIS])
        self.cfg.validate_geometry(width, height)
        self.entropy_workers = entropy_workers
        shard_cfg = dataclasses.replace(self.cfg, transport_delta=False)
        self._step = sharded_decode_step(
            mesh, mesh_contexts(mesh, shard_cfg, ctx), shard_cfg, height, width)

    def _relayout(self, vals: np.ndarray, n_gop: int, n_tile: int) -> np.ndarray:
        """Stream-ordered coefficients of ONE mesh step -> shard layout.

        Global cube order is (gop, block row, block column); axis 0 becomes
        the gop shard, axis 1 the tile (block-row) shard."""
        cube = self.cfg.cube_size
        rows_per_tile = self.height // self.cfg.block_h // n_tile
        cols = self.width // self.cfg.block_w
        return vals.reshape(
            n_gop, 1, n_tile, rows_per_tile * cols, cube
        ).transpose(0, 2, 1, 3, 4).reshape(n_gop, n_tile, -1, cube)

    def decode_stream(self, data: bytes, frames: int,
                      positions: list[int] | None = None,
                      index_end: int | None = None,
                      _window: entropy.InflateWindow | None = None):
        """Generator: yield (step_t, H, W) uint8 batches, one per mesh step,
        at O(step) host memory.  Frames past the last whole mesh step are
        not decoded.

        positions: per-GOP start bit offsets from an index member
        (docs/FORMAT.md); every mesh step then starts at a known offset and
        the host entropy stage needs no serial scan.  index_end, the index's
        last bit end, is held against the payload first, as
        decoder.decode_frame_range does: an index that ends past it belongs
        to another stream, so its positions are dropped and the boundaries
        scanned (the check inflates the payload up to index_end at once)."""
        n_gop, n_tile = self.mesh.shape[GOP_AXIS], self.mesh.shape[TILE_AXIS]
        gop = self.cfg.gop_size
        step_t = gop * n_gop
        lh = self.height // n_tile
        n_steps = (frames - frames % step_t) // step_t
        step_positions = None
        if positions is not None and len(positions) >= n_steps * n_gop:
            step_positions = positions[::n_gop][:n_steps]
        cps = self.width * self.height * step_t  # coefficients per step
        pending: collections.deque = collections.deque()
        win = _window or entropy.InflateWindow(data)
        if (step_positions is not None and index_end is not None
                and not win.ensure_bit(index_end)):
            step_positions = None  # a stale index: scan instead

        def dispatch(vals: np.ndarray) -> None:
            shards = self._step(self._relayout(vals, n_gop, n_tile))
            pending.append([to_host_async(f) for f in shards])

        def drain_one() -> np.ndarray:
            out = np.empty((step_t, self.height, self.width), np.uint8)
            for k, started in enumerate(pending.popleft()):
                g, t = divmod(k, n_tile)
                out[g * gop : (g + 1) * gop, t * lh : (t + 1) * lh] = landed(started)
            return out

        hint = cps * self.cfg.stream_budget_bits_per_value
        try:
            if n_steps > 1 and native.load() is not None:
                for vals, _pos in entropy.parallel_chunks_bounded(
                    win, cps, n_steps, entropy.decode_values,
                    self.entropy_workers, positions=step_positions,
                    hint_bits_per_value=self.cfg.stream_budget_bits_per_value,
                ):
                    dispatch(vals)
                    if len(pending) >= _WINDOW:
                        yield drain_one()
            else:
                pos = 0
                for _ in range(n_steps):
                    win.ensure_bit(pos + hint)
                    while True:
                        arr, base = win.array(pos)
                        try:
                            vals, rel = entropy.decode_values(arr, cps, pos - base)
                            break
                        except EOFError:
                            if not win.pump():
                                raise
                    pos = rel + base
                    win.drop_before(pos)
                    dispatch(vals)
                    if len(pending) >= _WINDOW:
                        yield drain_one()
        except EOFError:
            raise EOFError("bitstream too short")
        while pending:
            yield drain_one()

    def decode(self, data: bytes, frames: int,
               positions: list[int] | None = None,
               index_end: int | None = None) -> np.ndarray:
        """Whole-video assembly of decode_stream: (T, H, W) with T the
        frames of whole mesh steps."""
        step_t = self.cfg.gop_size * self.mesh.shape[GOP_AXIS]
        t = frames - frames % step_t
        out = np.empty((t, self.height, self.width), np.uint8)
        a0 = 0
        for batch in self.decode_stream(data, frames, positions, index_end):
            out[a0 : a0 + batch.shape[0]] = batch
            a0 += batch.shape[0]
        return out
