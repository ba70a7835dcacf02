"""The C entropy codec, shared with the JAX package as one source file.

``dct3d_tpu/native/expgolomb.c`` imports nothing, so the port compiles that
file by its path (importing the ``dct3d_tpu`` package would load jax) with
the system C compiler into ``native/_build/`` and binds the three functions
the port calls (the two entropy decoders and the PNG unfilter) through
ctypes, with the argtypes of
``dct3d_tpu.native.load``.  There is no NumPy fallback: the host decode
path needs the library, and a missing compiler raises.
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
            lib.eg_scan.restype = ctypes.c_uint64
            lib.eg_scan.argtypes = [
                ctypes.c_void_p,  # data
                ctypes.c_uint64,  # nbits_avail
                ctypes.c_uint64,  # bitpos
                ctypes.c_size_t,  # n
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
