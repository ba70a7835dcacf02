"""YUV4MPEG2 (.y4m) ingestion — the standard uncompressed-video interchange
format (ffmpeg: `-f yuv4mpeg`).  A copy of ``dct3d_tpu.io.y4m``
(tests/test_torch_host.py pins it to the original).  The codec is single-plane (the reference
encodes one channel at a time, RGBUtils.java:39-90), so this reads the luma
plane; geometry comes from the stream header, unlike the reference's
out-of-band CLI geometry (Decoder.java:17-28).
"""

from __future__ import annotations

import numpy as np

_CHROMA_DIV = {
    # chroma tag -> (x_div, y_div) of each chroma plane, or None for mono
    "420": (2, 2), "420jpeg": (2, 2), "420mpeg2": (2, 2), "420paldv": (2, 2),
    "422": (2, 1), "444": (1, 1), "mono": None,
}


def probe_y4m(path: str) -> dict:
    """Parse the stream header: {'width', 'height', 'fps', 'chroma'}."""
    with open(path, "rb") as f:
        header = f.readline()
    if not header.startswith(b"YUV4MPEG2"):
        raise ValueError(f"{path}: not a YUV4MPEG2 stream")
    out = {"fps": 30.0, "chroma": "420jpeg"}
    for tok in header.split()[1:]:
        tag, val = chr(tok[0]), tok[1:].decode()
        if tag == "W":
            out["width"] = int(val)
        elif tag == "H":
            out["height"] = int(val)
        elif tag == "F":
            num, den = val.split(":")
            out["fps"] = int(num) / int(den)
        elif tag == "C":
            out["chroma"] = val
    if "width" not in out or "height" not in out:
        raise ValueError(f"{path}: header missing W/H")
    if out["chroma"] not in _CHROMA_DIV:
        raise ValueError(f"{path}: unsupported chroma mode C{out['chroma']}")
    return out


def write_y4m(path: str, frames: np.ndarray, fps: float = 30.0) -> None:
    """(T, H, W) uint8 luma -> a Cmono YUV4MPEG2 stream (ffmpeg-readable).

    Gives decoded output a standard container so `ffmpeg -i out.y4m ...`
    works directly; the reference's raw format needs -video_size/-pix_fmt
    flags typed by hand."""
    t, h, w = frames.shape
    num = int(round(fps * 1000))
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{num}:1000 Ip A1:1 Cmono\n".encode())
        for k in range(t):
            f.write(b"FRAME\n")
            f.write(np.ascontiguousarray(frames[k], dtype=np.uint8).tobytes())


def rgb_to_ycbcr444(frame: np.ndarray) -> tuple[np.ndarray, ...]:
    """Interleaved RGB uint8 -> BT.601 limited-range Y, Cb, Cr planes
    (the inverse of _ycbcr_to_rgb at 4:4:4; shared by write_y4m_rgb and
    the render --play pipe)."""
    r = frame[..., 0].astype(np.float32)
    g = frame[..., 1].astype(np.float32)
    b = frame[..., 2].astype(np.float32)
    y = 16.0 + (65.481 * r + 128.553 * g + 24.966 * b) / 255.0
    cb = 128.0 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255.0
    cr = 128.0 + (112.0 * r - 93.786 * g - 18.214 * b) / 255.0
    return tuple(
        np.clip(np.rint(p), 0, 255).astype(np.uint8) for p in (y, cb, cr)
    )


def write_y4m_rgb(path: str, frames: np.ndarray, fps: float = 30.0) -> None:
    """(T, H, W, 3) uint8 interleaved RGB -> a C444 YUV4MPEG2 stream
    (BT.601 limited range; ffmpeg/ffplay-readable).  Lossy only by the
    limited-range quantization (~2 LSBs); read_y4m_rgb round-trips it."""
    t, h, w = frames.shape[:3]
    num = int(round(fps * 1000))
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{num}:1000 Ip A1:1 C444\n".encode())
        for k in range(t):
            f.write(b"FRAME\n")
            for plane in rgb_to_ycbcr444(frames[k]):
                f.write(plane.tobytes())


def read_y4m(path: str, frames: int | None = None) -> tuple[np.ndarray, dict]:
    """(T, H, W) uint8 luma plane + the header info."""
    info = probe_y4m(path)
    w, h = info["width"], info["height"]
    div = _CHROMA_DIV[info["chroma"]]
    luma = w * h
    chroma = 0 if div is None else 2 * ((w // div[0]) * (h // div[1]))
    out = []
    with open(path, "rb") as f:
        f.readline()  # stream header
        while frames is None or len(out) < frames:
            frame_hdr = f.readline()
            if not frame_hdr:
                break
            if not frame_hdr.startswith(b"FRAME"):
                raise ValueError(f"{path}: bad FRAME marker")
            y = f.read(luma)
            if len(y) < luma:
                break  # truncated tail frame
            f.seek(chroma, 1)
            out.append(np.frombuffer(y, np.uint8).reshape(h, w))
    if not out:
        raise ValueError(f"{path}: no complete frames")
    return np.stack(out), info


def read_y4m_rgb(path: str,
                 frames: int | None = None) -> tuple[np.ndarray, dict]:
    """(T, H, W, 3) uint8 interleaved RGB + the header info.

    YCbCr -> RGB via BT.601 limited range (the y4m default; ffmpeg's
    yuv4mpegpipe emits it unless XCOLORRANGE=FULL, which is rare enough to
    ignore); subsampled chroma upsamples by sample repetition — the codec
    re-quantizes everything anyway, so a fancier filter buys nothing.
    Cmono streams reject: encode them without --rgb instead."""
    info = probe_y4m(path)
    w, h = info["width"], info["height"]
    div = _CHROMA_DIV[info["chroma"]]
    if div is None:
        raise ValueError(
            f"{path}: Cmono stream has no chroma; encode without --rgb"
        )
    cw, ch = w // div[0], h // div[1]
    luma, cplane = w * h, cw * ch
    out = []
    with open(path, "rb") as f:
        f.readline()
        while frames is None or len(out) < frames:
            frame_hdr = f.readline()
            if not frame_hdr:
                break
            if not frame_hdr.startswith(b"FRAME"):
                raise ValueError(f"{path}: bad FRAME marker")
            buf = f.read(luma + 2 * cplane)
            if len(buf) < luma + 2 * cplane:
                break
            y = np.frombuffer(buf, np.uint8, luma).reshape(h, w)
            cb = np.frombuffer(buf, np.uint8, cplane, luma).reshape(ch, cw)
            cr = np.frombuffer(
                buf, np.uint8, cplane, luma + cplane
            ).reshape(ch, cw)
            out.append(_ycbcr_to_rgb(y, cb, cr, div))
    if not out:
        raise ValueError(f"{path}: no complete frames")
    return np.stack(out), info


def _ycbcr_to_rgb(y, cb, cr, div) -> np.ndarray:
    """BT.601 limited-range (16-235/16-240) -> full-range RGB uint8."""
    if div != (1, 1):
        cb = np.repeat(np.repeat(cb, div[1], 0), div[0], 1)
        cr = np.repeat(np.repeat(cr, div[1], 0), div[0], 1)
    h, w = y.shape
    yf = 1.164383 * (y.astype(np.float32) - 16.0)
    pb = cb[:h, :w].astype(np.float32) - 128.0
    pr = cr[:h, :w].astype(np.float32) - 128.0
    rgb = np.stack(
        [yf + 1.596027 * pr,
         yf - 0.391762 * pb - 0.812968 * pr,
         yf + 2.017232 * pb],
        axis=-1,
    )
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)
