"""Raw video file I/O (a copy of ``dct3d_tpu.io.rawvideo``;
tests/test_torch_host.py pins it to the original).

Format (reference, SURVEY.md §1 data formats): headerless sequences of
row-major frames — 1 byte/pixel grayscale for the codec (Encoder.java:47-56,
encoder.c:10-45), 3 bytes/pixel interleaved RGB for the capture/playback
tools (CaptureScreen.java:119-147, RenderVideo.java:57-76).  All geometry is
supplied out of band.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np


def frame_count(path: str, width: int, height: int, channels: int = 1) -> int:
    return os.path.getsize(path) // (width * height * channels)


def read_video(
    path: str,
    width: int,
    height: int,
    frames: int | None = None,
    channels: int = 1,
) -> np.ndarray:
    """Whole file -> (T, H, W) or (T, H, W, C) uint8."""
    fsize = width * height * channels
    total = frame_count(path, width, height, channels)
    t = total if frames is None else min(frames, total)
    with open(path, "rb") as f:
        buf = np.fromfile(f, dtype=np.uint8, count=t * fsize)
    if channels == 1:
        return buf.reshape(t, height, width)
    return buf.reshape(t, height, width, channels)


def write_video(path: str, frames: np.ndarray) -> None:
    np.ascontiguousarray(frames, dtype=np.uint8).tofile(path)


class StreamFrames:
    """GOP-aligned batch iteration over a NON-SEEKABLE byte stream (a
    stdin pipe) holding raw frames — the C encoder's bounded-memory
    streaming loop (encoder.c:203-278) for ``encode -``.

    Exactly one batch buffer is resident at a time, so encoding an
    arbitrarily long pipe runs at constant RSS (the previous behavior
    buffered the whole pipe: an hour of 1080p is ~7.5 GB).  The frame
    count is unknowable up front; a partial tail is trimmed to whole
    ``align`` frames, matching the reference's truncate-to-GOP behavior
    (Encoder.java:39-40).
    """

    def __init__(self, stream, width: int, height: int, channels: int = 1):
        self.stream = stream
        self.width = width
        self.height = height
        self.channels = channels
        self._fsize = width * height * channels

    def _read_exact(self, nbytes: int) -> bytes:
        """Read up to nbytes; shorter only at EOF (pipes return short
        reads mid-stream, so one read() call is not enough)."""
        chunks = []
        got = 0
        while got < nbytes:
            b = self.stream.read(nbytes - got)
            if not b:
                break
            chunks.append(b)
            got += len(b)
        return b"".join(chunks)

    def read_all(self) -> np.ndarray:
        """Whole-pipe buffer — the fallback for modes that need the full
        footage in memory (--rgb channel passes, --pad)."""
        raw = self.stream.read()
        n = len(raw) // self._fsize
        shape = ((n, self.height, self.width) if self.channels == 1
                 else (n, self.height, self.width, self.channels))
        return np.frombuffer(raw[: n * self._fsize], np.uint8).reshape(shape)

    def iter_batches(self, batch_frames: int, max_frames: int | None = None,
                     align: int | None = None, start: int = 0):
        """Yield (n, H, W[, C]) uint8 batches of whole-`align` frames.

        `start` frames are read and DISCARDED first (checkpoint resume on
        a restarted pipe re-feeds from frame 0; pipes cannot seek).
        `max_frames` is an ABSOLUTE end bound counted from stream frame 0
        — the same contract as iter_frame_batches and the in-memory
        branch of cli._frame_batches — so a resumed encode yields frames
        [start, max_frames), not max_frames more."""
        align = align or batch_frames
        fsize = self._fsize
        skip = start * fsize
        while skip:
            b = self.stream.read(min(skip, 8 << 20))
            if not b:
                return
            skip -= len(b)
        done = start
        while max_frames is None or done < max_frames:
            n = batch_frames
            if max_frames is not None:
                n = min(n, max_frames - done)
                n -= n % align
                if n == 0:
                    return
            buf = self._read_exact(n * fsize)
            got = len(buf) // fsize
            shape = ((got, self.height, self.width) if self.channels == 1
                     else (got, self.height, self.width, self.channels))
            if got < n:  # EOF: trim the tail to whole align-frame groups
                got -= got % align
                if got:
                    yield np.frombuffer(
                        buf[: got * fsize], np.uint8
                    ).reshape((got,) + shape[1:])
                return
            yield np.frombuffer(buf, np.uint8).reshape(shape)
            done += got


def iter_frame_batches(
    path: str,
    width: int,
    height: int,
    batch_frames: int,
    max_frames: int | None = None,
    channels: int = 1,
    align: int | None = None,
    start: int = 0,
) -> Iterator[np.ndarray]:
    """Stream a raw file in frame batches (the C codec's chunked read,
    encoder.c:203-278).

    The total is trimmed to a multiple of `align` (default: batch_frames) —
    pass the GOP size to keep a GOP-aligned partial tail batch instead of
    dropping it, matching the reference's truncate-to-GOP behavior
    (Encoder.java:39-40).  `start` skips that many leading frames
    (checkpoint resume).
    """
    fsize = width * height * channels
    total = frame_count(path, width, height, channels)
    if max_frames is not None:
        total = min(total, max_frames)
    total -= total % (align or batch_frames)
    with open(path, "rb") as f:
        f.seek(start * fsize)
        done = start
        while done < total:
            n = min(batch_frames, total - done)
            buf = np.fromfile(f, dtype=np.uint8, count=n * fsize)
            done += n
            shape = (n, height, width) if channels == 1 else (n, height, width, channels)
            yield buf.reshape(shape)
