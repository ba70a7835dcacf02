"""Two-process multi-host simulation: a real torch.distributed run.

    python -m dct3d_tpu_torch.parallel.multihost_sim [--device cpu|cuda]
        [--width W] [--height H] [--frames T] [--out PATH]

Spawns two worker processes that join one gloo process group over
localhost (multihost.initialize).  Each takes its host_frame_span of a
deterministic clip, encodes it on a (2, 1) mesh of its device (on CUDA both
processes use cuda:0) and gathers the members to process 0
(multihost.encode_multihost).  Checked:

  * rank 0's container equals the container one process makes from the
    same spans (encode_local_members of each span, joined), and the other
    rank gets None;
  * the turbo container equals a single-device encode_turbo_video of the
    whole clip, and decodes to the reference container's pixels;
  * each process decodes its own members of the shared container to the
    same frames as the whole container's decode;
  * each process checkpoints its span, is interrupted, resumes, and the
    gathered checkpoint files decode to the same pixels.

Exits 0 and prints "MULTIHOST SIM PASSED" when every check holds; the
container is kept at --out when given.  The default clip is 64x64, 40
frames (five GOPs: spans of 24 and 16 frames).
"""

from __future__ import annotations

import argparse
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

NPROC = 2


def _args(argv=None):
    p = argparse.ArgumentParser(prog="python -m dct3d_tpu_torch.parallel.multihost_sim")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--height", type=int, default=64)
    p.add_argument("--frames", type=int, default=40)
    p.add_argument("--out", default=None, help="keep rank 0's container here")
    p.add_argument("--worker", nargs=3, metavar=("RANK", "PORT", "DIR"),
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def worker(rank: int, port: int, workdir: str, args) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..codec.checkpoint import CheckpointingEncoder
    from ..codec.decoder import decode_video
    from ..codec.turbo import decode_turbo_container, encode_turbo_video
    from ..config import CodecConfig
    from ..io import synthetic
    from ..metrics import psnr
    from . import multihost
    from .mesh import make_mesh

    if args.device == "cpu":
        torch.set_num_threads(2)
    multihost.initialize(f"localhost:{port}", NPROC, rank)
    dev = torch.device("cpu") if args.device == "cpu" else torch.device("cuda", 0)
    w, h, total = args.width, args.height, args.frames
    cfg = CodecConfig()
    clip = synthetic.moving_gradient(total, h, w, seed=3)
    spans = [multihost.host_frame_span(total, cfg, p, NPROC) for p in range(NPROC)]
    lo, hi = spans[rank]
    mesh = make_mesh(gop=2, tile=1, devices=[dev, dev])

    t0 = time.perf_counter()
    data = multihost.encode_multihost(clip[lo:hi], w, h, total, mesh, cfg)
    wall = time.perf_counter() - t0
    # The only cross-process work is the ordered gather of compressed
    # bytes (two all-gathers); time it alone.
    t0 = time.perf_counter()
    multihost.gather_ordered_bytes(b"x" * (len(data) if data else 4096))
    gather = time.perf_counter() - t0
    print(f"process {rank}: frames [{lo}, {hi}), encode+gather {wall:.3f} s, "
          f"standalone gather {gather * 1e3:.1f} ms", flush=True)
    tdata = multihost.encode_multihost(clip[lo:hi], w, h, total, mesh, cfg, turbo=True)

    # Distributed decode: each process decodes ITS members of the shared
    # container, which must equal the same span of the whole decode.
    full_path = os.path.join(workdir, "full.d3v")
    if rank == 0:
        with open(full_path, "wb") as f:
            f.write(data)
    dist.barrier()
    with open(full_path, "rb") as f:
        shared = f.read()
    full = multihost.decode_multihost_container(shared, w, h, cfg, device=dev)
    at = 0
    for frames_i, payload_i, mtype in multihost.split_members(shared):
        if mtype != multihost.MEMBER_TEMPORAL:
            continue
        if lo <= at and at + frames_i <= hi:
            mine = decode_video(payload_i, w, h, frames_i, cfg, device=dev)
            assert np.array_equal(mine, full[at : at + frames_i]), (
                f"process {rank}: its member decodes otherwise than the container")
        at += frames_i
    assert at == total - total % cfg.gop_size, (at, total)

    # Checkpoint and resume in each process; the gathered files decode to
    # the plain container's pixels.
    ck = os.path.join(workdir, f"ck{rank}.d3v")
    span = clip[lo:hi]
    half = (span.shape[0] // (2 * cfg.gop_size)) * cfg.gop_size
    with CheckpointingEncoder(ck, w, h, cfg, checkpoint_gops=1, device=dev) as enc:
        enc.push(span[:half])
    with CheckpointingEncoder(ck, w, h, cfg, checkpoint_gops=1, device=dev) as enc:
        assert enc.frames_done == half, (enc.frames_done, half)
        enc.push(span[half:])
    with open(ck, "rb") as f:
        assembled = multihost.gather_ordered_bytes(f.read())

    if rank == 0:
        assert np.array_equal(
            multihost.decode_multihost_container(assembled, w, h, cfg, device=dev), full
        ), "the gathered checkpoint files decode otherwise than the container"
        want = b"".join(multihost.encode_local_members(clip[a:b], w, h, mesh, cfg)
                        for a, b in spans)
        assert data == want, "the gathered container differs from one process's"
        assert tdata == encode_turbo_video(clip, cfg, device=dev), (
            "the gathered turbo container differs from a single-device encode")
        assert np.array_equal(decode_turbo_container(tdata, w, h, cfg, device=dev), full), (
            "turbo pixels differ from the reference container's")
        p = psnr(clip[: full.shape[0]], full)
        assert p > 30.0, p
        members = multihost.split_members(data)
        print(f"process 0: {len(members)} members {[m[0] for m in members]}, "
              f"PSNR {p:.2f} dB; equal to one process's container, turbo equal "
              "to the single-device encode", flush=True)
        with open(os.path.join(workdir, "out.d3v"), "wb") as f:
            f.write(data)
    else:
        assert data is None and tdata is None and assembled is None
    dist.barrier()
    dist.destroy_process_group()


def main(argv=None) -> int:
    args = _args(argv)
    if args.worker:
        rank, port, workdir = args.worker
        worker(int(rank), int(port), workdir, args)
        return 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    fwd = ["--device", args.device, "--width", str(args.width),
           "--height", str(args.height), "--frames", str(args.frames)]
    with tempfile.TemporaryDirectory() as workdir:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "dct3d_tpu_torch.parallel.multihost_sim", *fwd,
             "--worker", str(rank), str(port), workdir], env=env)
            for rank in range(NPROC)]
        try:
            rcs = [p.wait(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if rcs != [0] * NPROC:
            print(f"multihost sim: worker exit codes {rcs}", file=sys.stderr)
            return 1
        if args.out:
            shutil.copyfile(os.path.join(workdir, "out.d3v"), args.out)
    print("MULTIHOST SIM PASSED", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
