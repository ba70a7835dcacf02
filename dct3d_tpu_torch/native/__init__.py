"""The C entropy codec, shared with the JAX package as one source file.

``dct3d_tpu/native/expgolomb.c`` imports nothing, so the port compiles that
file by its path (importing the ``dct3d_tpu`` package would load jax) with
the system C compiler into ``native/_build/`` and binds the functions the
port calls (the encoder, the decoders to ints and to nibble planes, the
boundary scans, the speculative
segment walks and their catch-ups, the nibble copy and the PNG unfilter)
through ctypes, with the argtypes of ``dct3d_tpu.native.load``.  There is
no NumPy fallback: the host entropy paths need the library, and a missing
compiler raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "dct3d_tpu", "native", "expgolomb.c",
)
_BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
_LIB = os.path.join(_BUILD_DIR, "libexpgolomb.so")

_lib = None
_lock = threading.Lock()


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return _LIB
    # Build into a temp file then rename, so concurrent builds race safely.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["cc", "-O3", "-fPIC", "-shared", "-o", tmp, _SRC],
                       check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        os.unlink(tmp)
        raise RuntimeError(f"building {_SRC} failed:\n{e.stderr}") from e
    os.replace(tmp, _LIB)
    return _LIB


def load() -> ctypes.CDLL:
    """Return the ctypes handle, building the library on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_build())
            lib.eg_encode.restype = ctypes.c_int
            lib.eg_encode.argtypes = [
                ctypes.c_void_p,  # values (int32[n])
                ctypes.c_size_t,  # n
                ctypes.c_void_p,  # out bytes
                ctypes.c_size_t,  # out capacity
                ctypes.POINTER(ctypes.c_uint64),  # bitpos (in/out)
            ]
            lib.eg_decode.restype = ctypes.c_int
            lib.eg_decode.argtypes = [
                ctypes.c_void_p,  # data
                ctypes.c_uint64,  # nbits_avail
                ctypes.POINTER(ctypes.c_uint64),  # bitpos (in/out)
                ctypes.c_void_p,  # out (int32[n])
                ctypes.c_size_t,  # n
            ]
            lib.eg_decode_planar4.restype = ctypes.c_int
            lib.eg_decode_planar4.argtypes = [
                ctypes.c_void_p,  # data
                ctypes.c_uint64,  # nbits_avail
                ctypes.POINTER(ctypes.c_uint64),  # bitpos (in/out)
                ctypes.c_void_p,  # plane (n/2 bytes)
                ctypes.c_size_t,  # n
                ctypes.c_void_p,  # exc_idx
                ctypes.c_void_p,  # exc_val
                ctypes.c_size_t,  # exc_cap
                ctypes.POINTER(ctypes.c_uint64),  # exc count
            ]
            lib.eg_decode_planar4_multi.restype = ctypes.c_int
            lib.eg_decode_planar4_multi.argtypes = [
                ctypes.c_void_p,  # data
                ctypes.c_uint64,  # nbits_avail
                ctypes.c_void_p,  # positions (uint64[nstreams], in/out)
                ctypes.c_int,     # nstreams
                ctypes.c_size_t,  # n per stream
                ctypes.c_void_p,  # planes (nstreams * n/2 bytes)
                ctypes.c_void_p,  # exc_idx (nstreams * exc_cap)
                ctypes.c_void_p,  # exc_val
                ctypes.c_size_t,  # exc_cap
                ctypes.c_void_p,  # exc_counts (uint64[nstreams])
            ]
            lib.eg_decode_planar4_seg_multi.restype = ctypes.c_int
            lib.eg_decode_planar4_seg_multi.argtypes = [
                ctypes.c_void_p,  # data
                ctypes.c_uint64,  # nbits_avail
                ctypes.c_int,     # nstreams
                ctypes.c_void_p,  # bitpos (uint64[nstreams], in/out)
                ctypes.c_void_p,  # end_bits (uint64[nstreams])
                ctypes.c_void_p,  # recs (uint64[nstreams * rec_cap])
                ctypes.c_size_t,  # rec_cap
                ctypes.c_void_p,  # ckpt_cnts (uint64[nstreams * ckpt_cap])
                ctypes.c_void_p,  # ckpt_poss
                ctypes.c_size_t,  # ckpt_cap
                ctypes.c_int,     # ckpt_shift
                ctypes.c_void_p,  # planes (nstreams * plane_stride bytes)
                ctypes.c_size_t,  # plane_stride
                ctypes.c_size_t,  # val_cap
                ctypes.c_void_p,  # exc_idx (nstreams * exc_cap)
                ctypes.c_void_p,  # exc_val
                ctypes.c_size_t,  # exc_cap
                ctypes.c_void_p,  # exc_counts (uint64[nstreams])
                ctypes.c_void_p,  # counts (uint64[nstreams])
            ]
            lib.eg_decode_catchup.restype = ctypes.c_int
            lib.eg_decode_catchup.argtypes = [
                ctypes.c_void_p,  # data
                ctypes.c_uint64,  # nbits_avail
                ctypes.c_uint64,  # bitpos
                ctypes.c_uint64,  # limit_bit
                ctypes.c_void_p,  # rec (sorted uint64[rec_len])
                ctypes.c_size_t,  # rec_len
                ctypes.c_void_p,  # vals (int32[val_cap])
                ctypes.c_size_t,  # val_cap
                ctypes.POINTER(ctypes.c_int64),   # match index or -1
                ctypes.POINTER(ctypes.c_uint64),  # pos_out
                ctypes.POINTER(ctypes.c_uint64),  # steps_out
            ]
            lib.nibble_copy.restype = None
            lib.nibble_copy.argtypes = [
                ctypes.c_void_p,  # dst
                ctypes.c_size_t,  # d0 (nibble index)
                ctypes.c_void_p,  # src
                ctypes.c_size_t,  # s0 (nibble index)
                ctypes.c_size_t,  # count (nibbles)
            ]
            lib.eg_scan.restype = ctypes.c_uint64
            lib.eg_scan.argtypes = [
                ctypes.c_void_p,  # data
                ctypes.c_uint64,  # nbits_avail
                ctypes.c_uint64,  # bitpos
                ctypes.c_size_t,  # n
            ]
            lib.eg_scan_segment.restype = ctypes.c_uint64
            lib.eg_scan_segment.argtypes = [
                ctypes.c_void_p,  # data
                ctypes.c_uint64,  # nbits_avail
                ctypes.c_uint64,  # bitpos (speculative segment start)
                ctypes.c_uint64,  # end_bit
                ctypes.c_void_p,  # rec (uint64[rec_cap])
                ctypes.c_size_t,  # rec_cap
                ctypes.c_void_p,  # ckpt_cnt (uint64[ckpt_cap])
                ctypes.c_void_p,  # ckpt_pos
                ctypes.c_size_t,  # ckpt_cap
                ctypes.c_int,     # ckpt_shift
                ctypes.POINTER(ctypes.c_uint64),  # count_out
            ]
            lib.eg_scan_catchup.restype = ctypes.c_int
            lib.eg_scan_catchup.argtypes = [
                ctypes.c_void_p,  # data
                ctypes.c_uint64,  # nbits_avail
                ctypes.c_uint64,  # bitpos
                ctypes.c_uint64,  # limit_bit
                ctypes.c_void_p,  # rec (sorted uint64[rec_len])
                ctypes.c_size_t,  # rec_len
                ctypes.POINTER(ctypes.c_int64),   # match index or -1
                ctypes.POINTER(ctypes.c_uint64),  # pos_out
                ctypes.POINTER(ctypes.c_uint64),  # steps_out
            ]
            lib.png_unfilter.restype = ctypes.c_int
            lib.png_unfilter.argtypes = [
                ctypes.c_void_p,  # filtered scanlines, h * (stride + 1)
                ctypes.c_size_t,  # h
                ctypes.c_size_t,  # stride
                ctypes.c_int,  # bytes per pixel
                ctypes.c_void_p,  # out, h * stride
            ]
            _lib = lib
    return _lib
