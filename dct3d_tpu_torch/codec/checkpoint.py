"""Checkpointable, resumable encoding into a D3MH member container.

The port's counterpart of ``dct3d_tpu.codec.checkpoint``.  GOPs are
independent, so every N-GOP boundary is a restart point once the entropy
and DEFLATE state is reset there: the checkpointed file is a sequence of
self-contained members (``D3MH | frames | length | zlib payload``), each
decodable alone, and decodes with ``parallel.multihost.
decode_multihost_container`` (turbo: ``codec.turbo.decode_turbo_container``).

CheckpointingEncoder appends complete members to the output file and
fsyncs; ``resume_info`` reports how many frames a (possibly torn) file holds
safely, and the encoder truncates a torn tail member on resume.  A
``<path>.meta`` sidecar pins the codec parameters (the JAX package's JSON,
byte for byte).  Members are built from the encoders' output bytes only.
On a device mesh (``mesh=``) the sharded encoders make the members, byte
for byte the single-device ones, so a resume may change or drop the mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct

import numpy as np

from ..config import CodecConfig
from ..parallel.multihost import MEMBER_MAGIC, _member, make_index_member
from .encoder import StreamingEncoder
from .transform import TransformContext
from ..parallel.sharding import ShardedEncoder
from .turbo import TurboEncoder, TurboShardedEncoder


def resume_info(path: str) -> tuple[int, int]:
    """(frames_safe, bytes_safe) of the longest complete-member prefix.

    Returns (0, 0) for a missing or empty file.  A torn trailing member (a
    crash mid-write) is excluded.
    """
    if not os.path.exists(path):
        return 0, 0
    with open(path, "rb") as f:
        data = f.read()
    frames = 0
    pos = 0
    while pos + 16 <= len(data) and data[pos : pos + 4] == MEMBER_MAGIC:
        tagged, length = struct.unpack_from("<IQ", data, pos + 4)
        if pos + 16 + length > len(data):
            break  # torn member
        frames += tagged & 0xFFFFFF  # top byte is the member type tag
        pos += 16 + length
    return frames, pos


class CheckpointingEncoder:
    """Encode into a member container with durable progress every
    ``checkpoint_gops`` GOPs, on ``device`` (or ``ctx.device``).
    Construction resumes from the longest complete prefix of ``path``.

    Reference profile: one member (and, with ``index``, its index member)
    per ``checkpoint_gops`` GOPs.  Turbo profile: the turbo encoder's one
    member per GOP, fsynced every ``checkpoint_gops`` GOPs.

    ``mesh``: an optional (gop, tile) device mesh (parallel/mesh.py).  The
    sharded encoders then make the members, byte-identical to the
    single-device ones, so the .meta sidecar does not pin the mesh.
    Reference profile: ``checkpoint_gops`` must be whole mesh steps and the
    resume point a whole number of steps (both raise ValueError otherwise).
    Turbo profile: members are independent per GOP, so whole steps take the
    sharded encoder and a GOP tail a single-device one, and neither rule
    applies."""

    def __init__(
        self,
        path: str,
        width: int,
        height: int,
        cfg: CodecConfig | None = None,
        ctx: TransformContext | None = None,
        checkpoint_gops: int = 8,
        index: bool = False,
        turbo: bool = False,
        mesh=None,
        device=None,
    ) -> None:
        self.mesh = mesh
        self.cfg = cfg or CodecConfig()
        if mesh is not None and not turbo and checkpoint_gops % mesh.shape["gop"]:
            raise ValueError(
                f"checkpoint_gops={checkpoint_gops} is not a multiple of "
                f"the mesh gop axis ({mesh.shape['gop']}): members would "
                "flush at different boundaries than a single-device encode "
                "(breaking container byte-identity); pick a multiple or a "
                "smaller gop axis"
            )
        self.path = path
        self.width = width
        self.height = height
        if mesh is None:
            self.ctx = ctx or TransformContext(self.cfg, device)
        else:  # the sharded encoders build a context a device
            self.ctx = ctx
        self.checkpoint_gops = checkpoint_gops
        #: follow each member with its per-GOP index member; a torn index
        #: member truncates away on resume, leaving its stream member valid
        self.index = index
        self.turbo = turbo
        self.frames_done, safe_bytes = resume_info(path)
        if mesh is not None and not turbo:
            step = self.cfg.gop_size * mesh.shape["gop"]
            if self.frames_done % step:
                raise ValueError(
                    f"cannot resume at frame {self.frames_done} on a "
                    f"{mesh.shape['gop']}-gop mesh (not a whole "
                    f"{step}-frame mesh step); resume without --mesh or "
                    "with a gop axis that divides the resume point"
                )
        # The headerless member format cannot describe its codec
        # parameters; the sidecar pins them so a resume with other flags
        # fails loudly instead of appending members that decode to garbage.
        meta = {
            "cfg": dataclasses.asdict(self.cfg),
            "width": width,
            "height": height,
        }
        if turbo:
            meta["profile"] = "turbo"
        meta_path = path + ".meta"
        if self.frames_done and os.path.exists(meta_path):
            with open(meta_path) as f:
                have = json.load(f)
            if self._semantic(have) != self._semantic(meta):
                raise ValueError(
                    f"resume parameters differ from {meta_path}; re-encode "
                    "from scratch or restore the original flags "
                    f"(was {have}, now {meta})"
                )
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        mode = "r+b" if os.path.exists(path) else "w+b"
        self._f = open(path, mode)
        self._f.truncate(safe_bytes)  # drop any torn tail member
        self._f.seek(safe_bytes)
        self._enc: StreamingEncoder | None = None
        self._member_frames = 0
        self._member_chunks: list[bytes] = []
        self._turbo_enc: TurboEncoder | TurboShardedEncoder | None = None
        self._turbo_tail: TurboEncoder | None = None
        self._since_sync = 0

    @staticmethod
    def _semantic(meta: dict) -> dict:
        """The part of the meta a resume must match.  Compression-effort
        knobs are left out: members are self-contained streams, so a level
        or worker change between runs decodes fine."""
        out = dict(meta)
        out["cfg"] = {
            k: v for k, v in meta.get("cfg", {}).items()
            if k not in ("zlib_level", "deflate_workers", "turbo_zstd_level")
        }
        return out

    def _flush_member(self) -> None:
        if self._enc is None:
            return
        self._member_chunks.append(self._enc.finish())
        payload = b"".join(self._member_chunks)
        self._f.write(_member(payload, self._member_frames))
        if self.index:
            self._f.write(make_index_member(self._enc.gop_bit_ends))
        self._sync()
        self.frames_done += self._member_frames
        self._enc = None
        self._member_frames = 0
        self._member_chunks = []

    def _sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._since_sync = 0

    def _tail_ctx(self) -> TransformContext:
        """A context for single-device work on a mesh: shard 0's device."""
        if self.ctx is None:
            self.ctx = TransformContext(self.cfg, self.mesh.devices[0])
        return self.ctx

    def _push_turbo(self, frames: np.ndarray) -> None:
        if self.mesh is None:
            if self._turbo_enc is None:
                self._turbo_enc = TurboEncoder(self.width, self.height, self.cfg,
                                               self.ctx)
            self._f.write(self._turbo_enc.push(frames))
        else:
            # Turbo members are one independent stream a GOP, so a batch
            # that does not fill whole mesh steps (a resume point from a
            # single-device run, or the stream's tail) splits: whole steps
            # take the sharded encoder, the GOP tail a single-device one;
            # members land in frame order and the file stays byte-identical.
            step = self.cfg.gop_size * self.mesh.shape["gop"]
            whole = frames.shape[0] - frames.shape[0] % step
            if whole:
                if self._turbo_enc is None:  # lazy: tail-only pushes
                    self._turbo_enc = TurboShardedEncoder(
                        self.width, self.height, self.mesh, self.cfg, self.ctx)
                self._f.write(self._turbo_enc.push(frames[:whole]))
            if whole < frames.shape[0]:
                if self._turbo_tail is None:
                    self._turbo_tail = TurboEncoder(
                        self.width, self.height, self.cfg, self._tail_ctx())
                self._f.write(self._turbo_tail.push(frames[whole:])
                              + self._turbo_tail.drain())
        self.frames_done += frames.shape[0]
        self._since_sync += frames.shape[0] // self.cfg.gop_size
        if self._since_sync >= self.checkpoint_gops:
            # Force in-flight members out before the fsync, else the
            # durability bound grows by the encoder's pipeline depth.
            if self._turbo_enc is not None:
                self._f.write(self._turbo_enc.drain())
            self._sync()

    def push(self, frames: np.ndarray) -> None:
        """Encode a (T, H, W) uint8 batch, T a multiple of the GOP (on a
        mesh, of gop_size * mesh gop).  After a resume the caller feeds
        frames from ``frames_done`` on."""
        if self.turbo:
            return self._push_turbo(frames)
        gop = self.cfg.gop_size
        step = gop if self.mesh is None else gop * self.mesh.shape["gop"]
        if frames.shape[0] % step:
            raise ValueError(
                f"push expects a multiple of {step} frames "
                f"(gop_size x mesh gop axis), got {frames.shape[0]}"
            )
        for i in range(0, frames.shape[0], step):
            if self._enc is None:
                if self.mesh is not None:
                    self._enc = ShardedEncoder(self.width, self.height,
                                               self.mesh, self.cfg, self.ctx)
                else:
                    self._enc = StreamingEncoder(self.width, self.height,
                                                 self.cfg, self.ctx)
            self._member_chunks.append(self._enc.push(frames[i : i + step]))
            self._member_frames += step
            if self._member_frames >= self.checkpoint_gops * gop:
                self._flush_member()

    def close(self) -> None:
        if self.turbo:
            for enc in (self._turbo_enc, self._turbo_tail):
                if enc is not None:
                    self._f.write(enc.finish())
            self._sync()
        else:
            self._flush_member()
        self._f.close()

    def __enter__(self) -> "CheckpointingEncoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
