"""The system under test: the one module of the benchmark that imports the
program, ``dct3d_tpu_torch``.

An encode is what ``python -m dct3d_tpu_torch encode`` does with default
flags, in memory: frames pushed in batches of four GOPs, then for the
reference profile the stream member wrapped with its index member as
``cli.cmd_encode`` writes it, and for the turbo profile the members as the
encoder returns them.  A decode is ``decode_auto``, a seek
``decode_auto_range``.  A reference-profile configuration with ``"mesh":
[G, T]`` runs ``encode --mesh GxT`` and ``decode --mesh GxT`` instead: the
sharded encoder and decoder over the first G*T devices (G*T times the CPU
in the tests), with seeks single-device as the CLI's ``--range`` runs them.
"""

from __future__ import annotations

import struct
import time

import numpy as np
import torch

from dct3d_tpu_torch import (
    CodecConfig, StreamingEncoder, TransformContext, TurboEncoder,
    decode_auto, decode_auto_range,
)
from dct3d_tpu_torch.parallel.mesh import make_mesh
from dct3d_tpu_torch.parallel.multihost import (
    MEMBER_INDEX, MEMBER_MAGIC, MEMBER_TEMPORAL, gop_positions, make_index_member,
    parse_index, split_members,
)
from dct3d_tpu_torch.parallel.sharding import ShardedDecoder, ShardedEncoder

#: frames per push: the CLI's batch (cli._BATCH_GOPS GOPs)
BATCH_GOPS = 4


class Encoded:
    """One file's container, with what its encode left to read."""

    def __init__(self, data: bytes, timer: dict | None, finish_s: float) -> None:
        self.data = data
        self.timer = timer  # StageTimer seconds by stage (reference encoder)
        self.finish_s = finish_s  # seconds in the encoder's finish()


class Codec:
    """One configuration of the program on one device."""

    def __init__(self, config: dict, device: torch.device,
                 compute_dtype: str | None = None) -> None:
        codec = dict(config["codec"])
        if compute_dtype:
            codec["compute_dtype"] = compute_dtype
        self.cfg = CodecConfig(**codec)
        self.profile = config["profile"]
        self.width, self.height = config["width"], config["height"]
        self.ctx = TransformContext(self.cfg, device)
        self.mesh = None
        if "mesh" in config:
            if self.profile != "reference":
                raise ValueError("a mesh runs only with the reference profile here")
            g, t = config["mesh"]
            devices = ([torch.device("cuda", i) for i in range(g * t)]
                       if device.type == "cuda" else [device] * (g * t))
            self.mesh = make_mesh(g, t, devices)

    def _encoder(self):
        w, h, cfg = self.width, self.height, self.cfg
        if self.mesh is not None:
            return ShardedEncoder(w, h, self.mesh, cfg)
        cls = TurboEncoder if self.profile == "turbo" else StreamingEncoder
        return cls(w, h, cfg, self.ctx)

    def encode(self, frames: np.ndarray, span) -> Encoded:
        step = self.cfg.gop_size * BATCH_GOPS
        if self.mesh is not None:
            step *= self.mesh.shape["gop"]
        enc = self._encoder()
        parts = [enc.push(frames[i : i + step]) for i in range(0, len(frames), step)]
        with span("bench.encode.finish"):
            t0 = time.perf_counter()
            parts.append(enc.finish())
            finish_s = time.perf_counter() - t0
        if self.profile == "turbo":
            return Encoded(b"".join(parts), None, finish_s)
        stream = b"".join(parts)
        head = MEMBER_MAGIC + struct.pack(
            "<IQ", (MEMBER_TEMPORAL << 24) | enc.frames_encoded, len(stream))
        index = make_index_member(enc.gop_bit_ends, sync_offsets=enc.gop_sync_offsets)
        timer = dict(enc.timer.seconds) if hasattr(enc, "timer") else None
        return Encoded(head + stream + index, timer, finish_s)

    def decode(self, data: bytes) -> np.ndarray:
        if self.mesh is None:
            return decode_auto(data, self.width, self.height, cfg=self.cfg, ctx=self.ctx)
        members = split_members(data)
        frames, payload, _ = next(m for m in members if m[2] == MEMBER_TEMPORAL)
        ends = next(parse_index(p) for _, p, kind in members if kind == MEMBER_INDEX)
        positions = gop_positions(ends, frames // self.cfg.gop_size, self.cfg.gop_size, frames)
        return ShardedDecoder(self.width, self.height, self.mesh, self.cfg).decode(
            payload, frames, positions=positions, index_end=ends[-1])

    def decode_range(self, data: bytes, start: int, stop: int) -> np.ndarray:
        return decode_auto_range(data, self.width, self.height, start, stop,
                                 cfg=self.cfg, ctx=self.ctx)
