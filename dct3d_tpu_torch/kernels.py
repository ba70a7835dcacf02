"""Build, load and launch the port's hand-written CUDA kernels.

The sources are ``csrc/*.cu``; ``build()`` compiles them with nvcc for
Hopper (``sm_90a``), one nvcc process per source, all started together,
and links the objects into one shared library with a plain C interface,
``_build/libkernels.so``, the first time a kernel is launched and again
whenever a source is newer than the library.  ``load()`` binds it with
ctypes: every pointer and the stream travel as ``c_void_p``.

Nothing here runs at import: the CPU tests import every module of the
package on a machine without nvcc or a card.  Each op wrapper
(ops/relayout.py, ops/group_pack.py, ops/splice.py, ops/exc_pack.py,
ops/deflate.py) takes its plain version only for CPU tensors; for a CUDA
tensor it launches through here or raises, and never falls back.

``LAUNCHES`` counts kernel launches by name, process-wide: a wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_DIR, "csrc")
_BUILD_DIR = os.path.join(_DIR, "_build")
_LIB = os.path.join(_BUILD_DIR, "libkernels.so")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

#: kernel name -> launches in this process (see module docstring)
LAUNCHES: collections.Counter = collections.Counter()

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: argtypes; every entry point returns cudaGetLastError() as int
    "dct3d_frames_to_cubes": [_P, _P, _P, _I, _I, _I, _P],
    "dct3d_frames_to_cubes_bf16": [_P, _P, _P, _I, _I, _I, _P],
    "dct3d_cubes_to_frames": [_P, _P, _I, _I, _I, _P],
    "dct3d_cubes_to_frames_bf16": [_P, _P, _I, _I, _I, _P],
    "dct3d_group_bits": [_P, _P, _I, _P],
    "dct3d_group_pack_values": [_P, _P, _P, _I, _I, _P],
    "dct3d_group_pack_codes": [_P, _P, _P, _P, _I, _I, _P],
    "dct3d_splice": [_P, _P, _P, _P, _I, _I, _I, _P],
    "dct3d_compact_groups": [_P, _P, _P, _P, _I, _I, _I, _P],
    "dct3d_plane_to_wire": [_P, _P, _I, _I, _P],
    "dct3d_wire_to_plane": [_P, _P, _I, _I, _P],
    "dct3d_deflate": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME / nvcc on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> str:
    """Compile csrc/*.cu into _build/libkernels.so unless it is up to date;
    returns the library's path.  Raises with nvcc's output on failure."""
    sources = sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))
    inputs = sources + glob.glob(os.path.join(_SRC_DIR, "*.cuh"))
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= max(
        os.path.getmtime(p) for p in inputs
    ):
        return _LIB
    # Compile every source at once, link, then rename into place, so
    # concurrent builds race safely.
    tmpdir = tempfile.mkdtemp(dir=_BUILD_DIR)
    tmp = os.path.join(tmpdir, "libkernels.so")
    try:
        objs = [os.path.join(tmpdir, os.path.basename(s) + ".o") for s in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(sources, objs)]
        logs = [(p.communicate()[0], p.returncode) for p in procs]
        bad = [log for log, rc in logs if rc]
        if bad:
            raise RuntimeError("nvcc failed:\n" + "\n".join(bad))
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, _LIB)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return _LIB


def load() -> ctypes.CDLL:
    """The kernel library, built and bound on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.dct3d_error_string.argtypes = [ctypes.c_int]
            lib.dct3d_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry point ``dct3d_<name>`` on ``device``'s current stream
    (appended as the last argument), count the launch, and raise if CUDA
    refused it.  Tensor arguments are passed as their data pointers."""
    lib = load()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, "dct3d_" + name)(*ptrs, stream)
    if rc != 0:
        msg = lib.dct3d_error_string(rc).decode()
        raise RuntimeError(f"kernel {name} launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Common wrapper checks: CUDA tensors on one device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def check_aligned16(name: str, t: torch.Tensor) -> None:
    """For kernels that read their input with 16-byte vector loads."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: input must start on a 16-byte boundary")
