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

``mesh`` is not ported (ROADMAP Queue 1, item 12) and raises.
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
from .turbo import TurboEncoder, _no_mesh


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
    member per GOP, fsynced every ``checkpoint_gops`` GOPs."""

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
        _no_mesh(mesh)
        self.cfg = cfg or CodecConfig()
        self.path = path
        self.width = width
        self.height = height
        self.ctx = ctx or TransformContext(self.cfg, device)
        self.checkpoint_gops = checkpoint_gops
        #: follow each member with its per-GOP index member; a torn index
        #: member truncates away on resume, leaving its stream member valid
        self.index = index
        self.turbo = turbo
        self.frames_done, safe_bytes = resume_info(path)
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
        self._turbo_enc: TurboEncoder | None = None
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

    def _push_turbo(self, frames: np.ndarray) -> None:
        if self._turbo_enc is None:
            self._turbo_enc = TurboEncoder(self.width, self.height, self.cfg,
                                           self.ctx)
        self._f.write(self._turbo_enc.push(frames))
        self.frames_done += frames.shape[0]
        self._since_sync += frames.shape[0] // self.cfg.gop_size
        if self._since_sync >= self.checkpoint_gops:
            # Force in-flight members out before the fsync, else the
            # durability bound grows by the encoder's pipeline depth.
            self._f.write(self._turbo_enc.drain())
            self._sync()

    def push(self, frames: np.ndarray) -> None:
        """Encode a (T, H, W) uint8 batch, T a multiple of the GOP.  After a
        resume the caller feeds frames from ``frames_done`` on."""
        if self.turbo:
            return self._push_turbo(frames)
        gop = self.cfg.gop_size
        if frames.shape[0] % gop:
            raise ValueError(
                f"push expects a multiple of {gop} frames, got {frames.shape[0]}"
            )
        for i in range(0, frames.shape[0], gop):
            if self._enc is None:
                self._enc = StreamingEncoder(self.width, self.height, self.cfg,
                                             self.ctx)
            self._member_chunks.append(self._enc.push(frames[i : i + gop]))
            self._member_frames += gop
            if self._member_frames >= self.checkpoint_gops * gop:
                self._flush_member()

    def close(self) -> None:
        if self.turbo:
            if self._turbo_enc is not None:
                self._f.write(self._turbo_enc.finish())
            self._sync()
        else:
            self._flush_member()
        self._f.close()

    def __enter__(self) -> "CheckpointingEncoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
