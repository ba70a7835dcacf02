"""The n-shard dry run: every sharded path once, against one device.

    python -m dct3d_tpu_torch.parallel.dryrun [N] [--device cpu|cuda]

The port's counterpart of ``dryrun_multichip`` in ``__graft_entry__.py``:
build an N-shard (gop, tile) mesh (two tiles when N is even), encode one
mesh step of noise with ShardedEncoder and TurboShardedEncoder, decode it
with ShardedDecoder and TurboShardedDecoder, and hold each result to the
single-device port on the mesh's first device: the same stream and turbo
container, byte for byte, and the same pixels.  At N >= 4 the clip is
640x368 (3,680 cubes a GOP), so shard boundaries fall at real cube counts;
below, one block row a tile.  On CUDA the shards take the cards in turn
(N shards on one card run one after the other); on the CPU every shard runs
there.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..codec.decoder import decode_video
from ..codec.encoder import encode_video
from ..codec.turbo import (
    TurboShardedDecoder, TurboShardedEncoder, decode_turbo_container,
    encode_turbo_video,
)
from ..config import CodecConfig
from .mesh import make_mesh
from .sharding import ShardedDecoder, ShardedEncoder


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the dry run; raises AssertionError on any difference.  Returns
    {"mesh": (gop, tile), "frames", "stream", "pixels"}: the noise clip,
    its sharded stream and the sharded decode's pixels."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if not count:
            raise RuntimeError("dry run on cuda: no CUDA device")
        devices = [torch.device("cuda", k % count) for k in range(n_devices)]
    else:
        devices = [dev] * n_devices
    n_tile = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    n_gop = n_devices // n_tile
    mesh = make_mesh(gop=n_gop, tile=n_tile, devices=devices)
    cfg = CodecConfig()
    t = cfg.gop_size * n_gop
    if n_devices >= 4:
        w, h = 640, 368
    else:
        w, h = cfg.block_w * 2, cfg.block_h * n_tile
    frames = np.random.default_rng(0).integers(0, 256, size=(t, h, w), dtype=np.uint8)
    one = mesh.devices[0]

    enc = ShardedEncoder(w, h, mesh, cfg)
    data = enc.push(frames) + enc.finish()
    ref = encode_video(frames, cfg, device=one)
    assert data == ref, (
        f"sharded stream differs from one device's ({len(data)} vs {len(ref)} bytes)")
    out = ShardedDecoder(w, h, mesh, cfg).decode(data, t)
    assert out.shape == (t, h, w), out.shape
    assert np.array_equal(out, decode_video(ref, w, h, t, cfg, device=one)), (
        "sharded decode differs from one device's")

    tenc = TurboShardedEncoder(w, h, mesh, cfg)
    tdata = tenc.push(frames) + tenc.finish()
    assert tdata == encode_turbo_video(frames, cfg, device=one), (
        "sharded turbo container differs from one device's")
    tout = decode_turbo_container(tdata, w, h, cfg, device=one)
    assert np.array_equal(tout, out), "turbo decode differs from the reference decode"
    assert np.array_equal(TurboShardedDecoder(w, h, mesh, cfg).decode(tdata), tout), (
        "sharded turbo decode differs from one device's")
    return {"mesh": (n_gop, n_tile), "frames": frames, "stream": data, "pixels": out}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m dct3d_tpu_torch.parallel.dryrun")
    p.add_argument("n", type=int, nargs="?", default=4, help="shards (default 4)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = p.parse_args(argv)
    r = dryrun_multichip(args.n, args.device)
    t, h, w = r["frames"].shape
    print(f"dry run passed: {args.n} shards as {r['mesh'][0]}x{r['mesh'][1]}, "
          f"{w}x{h}x{t}, {len(r['stream'])} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
