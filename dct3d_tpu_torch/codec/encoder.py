"""Streaming GOP encoder.

The port's counterpart of ``dct3d_tpu.codec.encoder`` (encode(),
encoder.c:88-293): frames stream through one GOP at a time; each GOP is
transformed and bit-packed on the device (codec/transform.encode_step), the
cross-GOP bit carry is chained on the device, and a single drainer thread
copies each GOP's packed bytes to the host and deflates them into one zlib
stream while the device works on the next GOP.  On a CUDA device with
``cfg.deflate_workers != 0`` the drainer deflates each GOP on the card
instead (``entropy.DeviceDeflateSink``) and copies back the compressed span.

With ``cfg.transport_delta`` the host sends each GOP as wrapping uint8
temporal deltas and the device rebuilds the frames before the transform;
the stream does not change.  ``device_pack=False`` is the host encode path:
the device quantizes raw frames, the drainer copies the ints back and the C
encoder packs them into the sink (``sink.push_values``).  Like the JAX
package's host path it marks no GOP boundaries and records no bit ends, so
``gop_bit_ends`` stays empty and the parallel sink's ``gop_sync_offsets``
is None.

The JAX encoder's budget ladder and overflow retry are gone: the port's
pack buffers have the worst-case size and cannot overflow.
"""

from __future__ import annotations

import collections
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch

from .. import staging
from ..config import CodecConfig
from ..profiling import StageTimer, trace
from . import entropy
from .transform import EncodedGOP, TransformContext, encode_step, quantize_step

_MAX_INFLIGHT = 3  # GOPs in flight before push() waits for the oldest


class StreamingEncoder:
    """Push frames in, get compressed bytes out.

    Usage:
        enc = StreamingEncoder(width, height, cfg, device="cuda")
        for batch in frame_batches:        # (T, H, W) uint8, T % gop == 0
            out.write(enc.push(batch))
        out.write(enc.finish())

    push() may return b"" while work is in flight; finish() flushes
    everything.  Output bytes are always emitted in stream order.

    ``carry`` = (code, bits) starts the Exp-Golomb payload with a partial
    byte of ``bits`` (0..7) bits, e.g. another encoder's carry, so a stream
    can continue where that encoder stopped.  ``device_pack=False`` packs on
    the host (see the module docstring).
    """

    def __init__(
        self,
        width: int,
        height: int,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
        device=None,
        device_pack: bool = True,
        carry: tuple[int, int] = (0, 0),
    ) -> None:
        self.cfg = cfg or CodecConfig()
        self.cfg.validate_geometry(width, height)
        self.width = width
        self.height = height
        self.ctx = ctx or TransformContext(self.cfg, device)
        self.device = self.ctx.device
        #: per-stage wall time and bytes (``encode --stats``); the sink's
        #: ``deflate`` stages land here too
        self.timer = StageTimer()
        self.device_pack = device_pack
        # On a CUDA device the GOPs' bytes deflate on the card (unless the
        # config asks for the serial reference layout).
        self.sink = entropy.make_sink(self.cfg, self.timer,
                                      self.device if device_pack else None)
        self.sink.carry_code, self.sink.carry_bits = carry
        #: frames pushed so far (GOP multiples); complete once finish()
        #: returns, and what a container's member header records.
        self.frames_encoded = 0
        # Single-thread drainer: serializes sink access and keeps output order
        # while overlapping readback/DEFLATE with device compute.
        self._drainer = ThreadPoolExecutor(max_workers=1)
        self._out: collections.deque[Future] = collections.deque()
        self._carry = tuple(
            torch.tensor(c, dtype=torch.int64, device=self.device) for c in carry
        )
        # The drainer's device->host copies and the card's DEFLATE run on
        # their own stream, after an event recorded on the producing stream.
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        #: absolute bit position after each GOP — the seekable stream index
        #: (docs/FORMAT.md "index member"); complete once finish() returns.
        self.gop_bit_ends: list[int] = []
        self._abs_end = 0

    # -- internal ------------------------------------------------------------

    def _drain_values(self, q: torch.Tensor, done) -> bytes:
        """Drainer thread, host path: fetch one GOP's quantized ints and
        entropy-code them into the sink (no GOP boundary, no bit end: the
        JAX package's host path records neither)."""
        with staging.after(done, self._copy_stream):
            host = staging.fetch([q], self.timer)[0]
        with self.timer.stage("sink_push", host.nbytes):
            return self.sink.push_values(host.reshape(-1))

    def _drain_gop(self, gop: EncodedGOP, done) -> bytes:
        """Drainer thread: hand one GOP to the sink's ``push_gop`` on the
        copy stream.  Holds the GOP's device tensors until that is done."""
        with staging.after(done, self._copy_stream):
            out, total_bits = self.sink.push_gop(gop.packed, gop.total_bits)
        self._note_end(total_bits)
        return out

    def _note_end(self, total_bits: int) -> None:
        """Record a GOP's absolute end bit.  Per-batch total_bits includes
        the carried partial byte's bits, so the absolute end chains as
        whole-bytes-so-far + batch bits.  The drainer runs one GOP at a time
        in stream order, so appending here yields the in-order index."""
        self._abs_end = ((self._abs_end >> 3) << 3) + total_bits
        self.gop_bit_ends.append(self._abs_end)

    def _collect(self, block: bool = False) -> bytes:
        out = []
        while self._out and (block or self._out[0].done()):
            out.append(self._out.popleft().result())
        return b"".join(out)

    # -- public --------------------------------------------------------------

    def push(self, frames: np.ndarray) -> bytes:
        """Encode a (T, H, W) uint8 batch; T must be a GOP multiple.

        Returns compressed bytes ready to append to the output stream (may
        be empty — work is pipelined and DEFLATE buffers internally).
        """
        t = frames.shape[0]
        gop_size = self.cfg.gop_size
        if t % gop_size:
            raise ValueError(
                f"batch of {t} frames is not a multiple of GOP {gop_size}; "
                "truncate (reference behavior, Encoder.java:39-40) or pad "
                "upstream"
            )
        if frames.shape[1:] != (self.height, self.width):
            raise ValueError("frame geometry mismatch")
        for i in range(0, t, gop_size):
            raw = frames[i : i + gop_size]
            with self.timer.stage("dispatch", raw.nbytes):
                if self.device_pack and self.cfg.transport_delta:
                    raw = _deltas(raw)
                with self.timer.stage("stage_in", raw.nbytes):
                    frames_dev = staging.to_device(raw, self.device)
                if not self.device_pack:
                    step = quantize_step(frames_dev, self.ctx)
                else:
                    step = encode_step(frames_dev, self.ctx, *self._carry)
                    self._carry = (step.carry_code, step.carry_bits)
            done = staging.mark(self.device)
            drain = self._drain_gop if self.device_pack else self._drain_values
            self._out.append(self._drainer.submit(drain, step, done))
            # Backpressure: bound in-flight device buffers / host memory.
            if len(self._out) > _MAX_INFLIGHT:
                with trace("wait_drainer"):
                    self._out[0].result()
        self.frames_encoded += t
        return self._collect()

    def finish(self) -> bytes:
        """Flush pipeline + carry + DEFLATE tail.  Stream complete after;
        releases the drainer and sink threads."""
        tail = self._drainer.submit(self.sink.finish)
        with trace("wait_drainer"):
            out = self._collect(block=True)
        with trace("wait_deflate"):
            out += tail.result()
        self._drainer.shutdown(wait=True)
        self.sink.close()
        return out

    @property
    def gop_sync_offsets(self) -> list[int] | None:
        """Per-GOP compressed byte sync offsets for parallel inflate
        (entropy.parallel_inflate) — available after finish() with the
        parallel sink; None for the serial reference-parity layout."""
        return self.sink.sync_offsets()


def _deltas(gop: np.ndarray) -> np.ndarray:
    """One GOP's frames as wrapping uint8 temporal deltas (the first frame
    as it is), which the device's mod-256 prefix sum undoes."""
    delta = np.empty_like(gop)
    delta[0] = gop[0]
    np.subtract(gop[1:], gop[:-1], out=delta[1:])  # wraps
    return delta


def encode_video(
    frames: np.ndarray,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
) -> bytes:
    """One-call encode of an in-memory (T, H, W) uint8 video on ``device``
    (or ``ctx.device``).

    Frame count is truncated to a GOP multiple (Encoder.java:39-40)."""
    cfg = cfg or CodecConfig()
    t = frames.shape[0] - frames.shape[0] % cfg.gop_size
    enc = StreamingEncoder(frames.shape[2], frames.shape[1], cfg, ctx, device)
    return enc.push(frames[:t]) + enc.finish()


def encode_stream(
    batches: Iterable[np.ndarray],
    width: int,
    height: int,
    cfg: CodecConfig | None = None,
    ctx: TransformContext | None = None,
    device=None,
) -> Iterator[bytes]:
    """Generator: encode an iterable of frame batches (each a GOP multiple)
    into stream chunks on ``device`` (or ``ctx.device``); the chunks
    concatenate to encode_video's stream of the same frames."""
    enc = StreamingEncoder(width, height, cfg, ctx, device)
    for batch in batches:
        yield enc.push(batch)
    yield enc.finish()
