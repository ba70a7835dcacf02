"""Headless rendering / inspection of raw video (a copy of
``dct3d_tpu.io.render``; tests/test_torch_host.py pins it to the original).

The reference plays raw RGB in a Swing window (RenderVideo.java:14-122);
a TPU host has no display, so this renders frames to PNG (via matplotlib if
present, else a minimal built-in PNG writer) and prints stream statistics —
the observability the reference lacks (SURVEY.md §5 metrics).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import rawvideo


def _write_png(path: str, img: np.ndarray) -> None:
    """Minimal PNG writer for grayscale or RGB uint8 images (no deps)."""
    if img.ndim == 2:
        color_type, nch = 0, 1
        raw = img[:, :, None]
    else:
        color_type, nch = 2, 3
        raw = img
    h, w = raw.shape[:2]
    scanlines = b"".join(
        b"\x00" + raw[y].astype(np.uint8).tobytes() for y in range(h)
    )

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(scanlines, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def render_frames(
    path: str,
    width: int,
    height: int,
    out_prefix: str,
    frames: list[int] | None = None,
    channels: int = 1,
) -> list[str]:
    """Export selected frames of a raw video to PNG files."""
    video = rawvideo.read_video(path, width, height, channels=channels)
    sel = frames or [0, video.shape[0] // 2, video.shape[0] - 1]
    outs = []
    for idx in sel:
        idx = max(0, min(video.shape[0] - 1, idx))
        out = f"{out_prefix}_f{idx:05d}.png"
        _write_png(out, video[idx])
        outs.append(out)
    return outs


def video_stats(path: str, width: int, height: int, channels: int = 1) -> dict:
    video = rawvideo.read_video(path, width, height, channels=channels)
    return {
        "frames": int(video.shape[0]),
        "width": width,
        "height": height,
        "channels": channels,
        "mean": float(video.mean()),
        "std": float(video.std()),
        "min": int(video.min()),
        "max": int(video.max()),
    }


def _rgb_to_ycbcr444(frame: np.ndarray) -> tuple[np.ndarray, ...]:
    """See y4m.rgb_to_ycbcr444 (one conversion shared with y4m output)."""
    from .y4m import rgb_to_ycbcr444

    return rgb_to_ycbcr444(frame)


_PLAYERS = (
    "ffplay -autoexit -loglevel error -f yuv4mpeg2pipe -",
    "mpv --really-quiet -",
)


def play_video(
    path: str,
    width: int,
    height: int,
    fps: float = 30.0,
    channels: int = 1,
    player: str | None = None,
    frames: int | None = None,
) -> int:
    """fps-paced playback: stream the raw video as YUV4MPEG2 into a player
    process, pacing frames against a deadline clock — the analogue of the
    reference's Swing playback loop (RenderVideo.java:54-87: render, then
    sleep the remainder of the frame period).  A TPU host has no display,
    so the window belongs to whatever player the user points at (ffplay /
    mpv by default, any y4m-reading command via `player`).

    Grayscale streams as Cmono; RGB converts to C444 BT.601 limited range.
    Returns the player's exit code; a player closed mid-stream (broken
    pipe) counts as a normal stop.
    """
    import shlex
    import shutil
    import subprocess
    import time

    video = rawvideo.read_video(path, width, height, frames,
                                channels=channels)
    cmd = shlex.split(player) if player else None
    if cmd is None:
        for cand in _PLAYERS:
            if shutil.which(cand.split()[0]):
                cmd = shlex.split(cand)
                break
        else:
            raise RuntimeError(
                "no video player found (install ffplay or mpv, or pass "
                "--player 'command reading y4m on stdin')"
            )
    chroma = "mono" if channels == 1 else "444"
    num = int(round(fps * 1000))
    header = (f"YUV4MPEG2 W{width} H{height} F{num}:1000 Ip A1:1 "
              f"C{chroma}\n").encode()
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE)
    t0 = time.perf_counter()
    try:
        try:
            proc.stdin.write(header)
            for k in range(video.shape[0]):
                wait = t0 + k / fps - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                proc.stdin.write(b"FRAME\n")
                if channels == 1:
                    proc.stdin.write(video[k].tobytes())
                else:
                    for plane in _rgb_to_ycbcr444(video[k]):
                        proc.stdin.write(plane.tobytes())
        except BrokenPipeError:  # window closed mid-stream: a normal stop
            pass
        try:
            proc.stdin.close()
        except BrokenPipeError:  # pragma: no cover
            pass
        return proc.wait()
    except BaseException:
        # Any other failure (I/O error, Ctrl-C): don't orphan the player
        # blocked on a half-written stream.
        proc.kill()
        proc.wait()
        raise
