"""Host-side entropy layer: the C Exp-Golomb codec + streaming zlib.

A copy of the host part of ``dct3d_tpu.codec.entropy``; the code is NumPy,
ctypes and zlib, and the copy exists only because importing the JAX package
loads jax.

  * ``encode_values`` and the sinks' ``push_values``: the host Exp-Golomb
    encode (``StreamingEncoder(device_pack=False)``);
  * the DEFLATE sinks (serial reference-parity layout, and the parallel
    pigz-style layout with per-GOP sync points) and parallel inflate;
    the port adds ``DeviceDeflateSink``, the parallel layout written by
    the card's DEFLATE kernels (ops/deflate.py), which a CUDA encode takes;
  * the C decoders: ``eg_scan`` for GOP boundaries, the fused
    decode-to-nibble-plane ``eg_decode_planar4`` and its two-stream pair
    form;
  * the speculative parallel scan (``speculative_positions``) and the fused
    speculative decode (``speculative_planar4_chunks``) of streams without
    an index;
  * ``parallel_chunks``, which decodes GOPs on a thread pool, from known
    start positions (a stream index) or through the speculative routes,
    with the serial boundary scan as the last resort;
  * ``InflateSource``, the streaming inflate with a bit cursor behind
    ``StreamingDecoder`` (its planar4 reader only: the port decodes
    through the nibble plane);
  * the sharded decoder's stream (parallel/sharding.py): ``decode_values``
    (to int32 values), the bounded ``InflateWindow`` and
    ``parallel_chunks_bounded`` over it.

The C library is required (there is no NumPy fallback), so the JAX code's
``native.load() is None`` branches are not copied.
"""

from __future__ import annotations

import bisect
import collections
import ctypes
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native, staging
from ..ops import deflate as dev_deflate
from ..profiling import StageTimer, trace, traced


def _as_u8(data) -> np.ndarray:
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else data
    return np.ascontiguousarray(buf, dtype=np.uint8)


def encode_values(values: np.ndarray, bitpos: int = 0) -> tuple[bytes, int]:
    """Pack int32 values; returns (bytes incl. partial, new bit length).

    The returned buffer starts at stream bit 0; `bitpos` bits of leading
    padding are zeros to be OR-merged by the caller (the sinks do this with
    their carry byte).
    """
    values = np.ascontiguousarray(values, dtype=np.int32)
    # Worst case ~61 bits/value, typical <4; allocate generously.
    cap = (bitpos + 7) // 8 + values.size * 8 + 16
    out = np.zeros(cap, dtype=np.uint8)
    pos = ctypes.c_uint64(bitpos)
    rc = native.load().eg_encode(
        values.ctypes.data, values.size, out.ctypes.data, cap, ctypes.byref(pos),
    )
    if rc != 0:  # pragma: no cover - cap is worst-case sized
        raise OverflowError("exp-golomb encode buffer overflow")
    nbits = int(pos.value)
    return out[: (nbits + 7) // 8].tobytes(), nbits


def scan_values(data: bytes | np.ndarray, n: int, bitpos: int = 0) -> int:
    """Bit position after skipping n codewords, without materializing them
    (native/expgolomb.c eg_scan).

    Raises EOFError if the stream ends within the n codewords.
    """
    buf = _as_u8(data)
    pos = native.load().eg_scan(buf.ctypes.data, buf.size * 8, bitpos, n)
    if pos == (1 << 64) - 1:
        raise EOFError("exp-golomb stream exhausted")
    return int(pos)


def decode_values(
    data: bytes | np.ndarray, n: int, bitpos: int = 0
) -> tuple[np.ndarray, int]:
    """Decode n values starting at bit `bitpos` (native/expgolomb.c
    eg_decode); returns (int32 values, new bitpos).

    Raises EOFError if the buffer ends mid-stream.
    """
    buf = _as_u8(data)
    out = np.empty(n, dtype=np.int32)
    pos = ctypes.c_uint64(bitpos)
    rc = native.load().eg_decode(
        buf.ctypes.data, buf.size * 8, ctypes.byref(pos), out.ctypes.data, n,
    )
    if rc != 0:
        raise EOFError("exp-golomb stream exhausted")
    return out, int(pos.value)


def decode_values_planar4(
    data: bytes | np.ndarray, n: int, bitpos: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Decode n (even) values into a packed 4-bit plane + exceptions.

    Two values per byte (low nibble = even index); values outside [-8, 7]
    go to the exception list.  Returns (plane, exc_idx, exc_val, bitpos).
    """
    assert n % 2 == 0, "planar4 needs an even value count"
    buf = _as_u8(data)
    lib = native.load()
    plane = np.empty(n // 2, np.uint8)
    cap = max(1024, n // 16)
    while True:
        exc_idx = np.empty(cap, np.int32)
        exc_val = np.empty(cap, np.int32)
        pos = ctypes.c_uint64(bitpos)
        cnt = ctypes.c_uint64(0)
        rc = lib.eg_decode_planar4(
            buf.ctypes.data, buf.size * 8, ctypes.byref(pos),
            plane.ctypes.data, n,
            exc_idx.ctypes.data, exc_val.ctypes.data, cap,
            ctypes.byref(cnt),
        )
        if rc == -2:  # exception capacity; pathological content
            cap *= 4
            continue
        if rc != 0:
            raise EOFError("exp-golomb stream exhausted")
        k = int(cnt.value)
        return plane, exc_idx[:k], exc_val[:k], int(pos.value)


#: Speculative-scan tuning: handshake window (starts recorded per segment),
#: checkpoint stride (2**shift codewords), minimum bytes per segment.
_SPEC_REC_CAP = 1024
_SPEC_CKPT_SHIFT = 12
_SPEC_MIN_SEG = 1 << 17


def speculative_positions(payload, values_per_chunk: int, n_chunks: int,
                          workers: int | None = None) -> list[int] | None:
    """All chunk start bit positions of a headerless stream, in parallel.

    The payload is cut into byte-aligned segments and every segment is
    scanned concurrently from its (speculative) byte boundary; Exp-Golomb
    walks from different alignments converge onto the true codeword grid
    after a few codewords, and the stitch validates each segment by an exact
    position handshake: the true entry position must appear among the
    segment's first recorded starts (then the true walk from there is the
    speculative walk).  A failed handshake falls back to a serial catch-up
    scan of that segment, so adversarial content costs the serial
    behaviour, never correctness.

    Returns n_chunks absolute bit positions, or None when the payload is
    too small to be worth it or the stream ends prematurely (callers then
    use the serial scan, which owns the reference EOF semantics).
    """
    lib = native.load()
    buf = _as_u8(payload)
    workers = workers or (os.cpu_count() or 2)
    n_seg = max(1, min(workers * 4, buf.size // _SPEC_MIN_SEG))
    if n_seg < 2 or n_chunks < 2:
        return None  # too small to beat the serial scan
    nbits = buf.size * 8
    bounds = [buf.size * s // n_seg for s in range(n_seg)] + [buf.size]

    def scan_segment(s: int):
        start_bit = bounds[s] * 8
        end_bit = bounds[s + 1] * 8
        seg_bits = end_bit - start_bit
        ckpt_cap = (seg_bits >> _SPEC_CKPT_SHIFT) + 2
        rec = np.empty(_SPEC_REC_CAP, np.uint64)
        ckpt_cnt = np.zeros(ckpt_cap, np.uint64)
        ckpt_pos = np.full(ckpt_cap, start_bit, np.uint64)
        cnt = ctypes.c_uint64(0)
        exit_pos = lib.eg_scan_segment(
            buf.ctypes.data, nbits, start_bit, end_bit,
            rec.ctypes.data, _SPEC_REC_CAP,
            ckpt_cnt.ctypes.data, ckpt_pos.ctypes.data, ckpt_cap,
            _SPEC_CKPT_SHIFT, ctypes.byref(cnt),
        )
        return rec, ckpt_cnt, ckpt_pos, int(exit_pos), int(cnt.value)

    with ThreadPoolExecutor(workers) as pool:
        segs = list(pool.map(scan_segment, range(n_seg)))

    # Stitch: walk the true entry position through the segments.  Per
    # segment: A = cumulative true count at entry, entry position p,
    # (steps, j) = serial catch-up length and the speculative index at
    # convergence (segment 0 is exact: steps=0, j=0).
    A = [0]
    meta = []  # (p_s, steps_s, j_s)
    entry = 0
    for s in range(n_seg):
        rec, ckpt_cnt, ckpt_pos, exit_pos, cnt = segs[s]
        end_bit = bounds[s + 1] * 8
        if s + 1 < n_seg and exit_pos < end_bit:
            return None  # stream ended inside an interior segment
        if s == 0:
            steps, j = 0, 0
        else:
            rlen = min(cnt, _SPEC_REC_CAP)
            j = int(np.searchsorted(rec[:rlen], np.uint64(entry)))
            if j < rlen and int(rec[j]) == entry:
                steps = 0
            else:
                # handshake miss: serial catch-up inside this segment
                match = ctypes.c_int64(-1)
                pos_out = ctypes.c_uint64(0)
                steps_out = ctypes.c_uint64(0)
                rc = lib.eg_scan_catchup(
                    buf.ctypes.data, nbits, entry, end_bit,
                    rec.ctypes.data, rlen,
                    ctypes.byref(match), ctypes.byref(pos_out),
                    ctypes.byref(steps_out),
                )
                if rc != 0:
                    return None  # data ran out: serial path owns EOF
                steps = int(steps_out.value)
                if match.value >= 0:
                    j = int(match.value)
                else:
                    # walked the whole segment serially: exact by itself
                    A.append(A[-1] + steps)
                    meta.append((entry, steps, None))
                    entry = int(pos_out.value)
                    continue
        A.append(A[-1] + steps + (cnt - j))
        meta.append((entry, steps, j))
        entry = exit_pos

    # Boundary positions: chunk k starts after k*values_per_chunk true
    # codewords.  Inside a segment, counts >= steps map onto the
    # speculative walk (checkpoint + short rescan); earlier ones rescan
    # from the entry.
    positions = []
    for k in range(n_chunks):
        g = k * values_per_chunk
        if g > A[-1]:
            return None  # stream too short: serial path owns EOF semantics
        s = bisect.bisect_right(A, g) - 1
        s = min(s, n_seg - 1)
        m = g - A[s]
        p_s, steps, j = meta[s]
        if m < steps or j is None:
            pos = scan_values(buf, m, p_s)
        else:
            rec, ckpt_cnt, ckpt_pos, _, _ = segs[s]
            msp = j + (m - steps)
            t = msp >> _SPEC_CKPT_SHIFT
            if t == 0:
                c0, q0 = 0, bounds[s] * 8
            else:
                c0, q0 = int(ckpt_cnt[t]), int(ckpt_pos[t])
            pos = scan_values(buf, msp - c0, q0)
        positions.append(pos)
    return positions


#: Interleaved streams per speculative-decode task (the table walk is
#: load-chain-bound; independent chains overlap in the out-of-order core,
#: as in the indexed pair decoder).  Deeper interleave loses when stalls
#: are frequent (more live state per stall), so 2 is the robust default.
_SPEC_INTERLEAVE = 2
#: Segments per worker: _SPEC_SEG_FACTOR / _SPEC_INTERLEAVE task waves
#: (two with the defaults; stragglers idle at most half a wave).
_SPEC_SEG_FACTOR = 4


def speculative_planar4_chunks(payload, values_per_chunk: int, n_chunks: int,
                               workers: int | None = None):
    """Fused speculative scan and decode of a headerless planar4 stream.

    speculative_positions finds the chunk boundaries with a parallel scan
    and the chunks are then decoded in a second pass: two table walks per
    codeword.  Here the segment walk is the decode: every worker
    speculatively decodes its byte-aligned segment (local nibble plane +
    exceptions), the stitch validates each segment by the exact position
    handshake (a failed handshake falls back to a serial catch-up decode of
    that segment), and chunk planes are assembled from the validated
    segment spans with nibble-granular copies (native nibble_copy).  One
    table walk in all.

    Returns a generator of (plane, exc_idx, exc_val, end_bit) per chunk,
    exactly decode_values_planar4's result tuples, in stream order, or None
    when the payload is too small to be worth it, a segment is too large
    for the local 32-bit indices, or the stream ends prematurely (callers
    then use the serial path, which owns the reference EOF semantics).

    A chunk that lies inside one byte-aligned span is a view of its
    segment's plane, shared with no other chunk; callers must not write
    into the planes.  Memory: the segment planes hold about 4 bytes per
    payload byte while they live (a nibble per possible 1-bit codeword);
    streams too large for that should carry an index instead.
    """
    if values_per_chunk % 2:
        return None  # planar4 needs even chunks
    lib = native.load()
    buf = _as_u8(payload)
    workers = workers or (os.cpu_count() or 2)
    n_seg = max(1, min(workers * _SPEC_SEG_FACTOR,
                       buf.size // _SPEC_MIN_SEG))
    if n_seg < 2 or n_chunks < 1:
        return None  # too small to beat the serial scan
    if buf.size // n_seg >= (1 << 27):
        return None  # local int32 indices would overflow
    nbits = buf.size * 8
    bounds = [buf.size * s // n_seg for s in range(n_seg)] + [buf.size]
    groups = [list(range(g, min(g + _SPEC_INTERLEAVE, n_seg)))
              for g in range(0, n_seg, _SPEC_INTERLEAVE)]

    def run_group(group):
        ns = len(group)
        seg_bits = max(
            (bounds[s + 1] - bounds[s]) * 8 for s in group
        )
        val_cap = seg_bits + 128
        stride = val_cap // 2 + 24
        pos = np.array([bounds[s] * 8 for s in group], np.uint64)
        ends = np.array([bounds[s + 1] * 8 for s in group], np.uint64)
        planes = np.empty(ns * stride, np.uint8)
        recs = np.empty(ns * _SPEC_REC_CAP, np.uint64)
        ckpt_cap = (val_cap >> _SPEC_CKPT_SHIFT) + 2
        ckpt_cnt = np.zeros(ns * ckpt_cap, np.uint64)
        ckpt_pos = np.zeros(ns * ckpt_cap, np.uint64)
        cap = max(4096, val_cap // 64)
        while True:
            p = pos.copy()
            exc_idx = np.empty(ns * cap, np.int32)
            exc_val = np.empty(ns * cap, np.int32)
            nexc = np.zeros(ns, np.uint64)
            cnts = np.zeros(ns, np.uint64)
            rc = lib.eg_decode_planar4_seg_multi(
                buf.ctypes.data, nbits, ns,
                p.ctypes.data, ends.ctypes.data,
                recs.ctypes.data, _SPEC_REC_CAP,
                ckpt_cnt.ctypes.data, ckpt_pos.ctypes.data, ckpt_cap,
                _SPEC_CKPT_SHIFT,
                planes.ctypes.data, stride, val_cap,
                exc_idx.ctypes.data, exc_val.ctypes.data, cap,
                nexc.ctypes.data, cnts.ctypes.data,
            )
            if rc == -2:  # exception capacity; pathological content
                cap *= 4
                continue
            if rc != 0:
                return None
            out = []
            for t, s in enumerate(group):
                k = int(nexc[t])
                out.append({
                    "plane": planes[t * stride : (t + 1) * stride],
                    "rec": recs[t * _SPEC_REC_CAP : (t + 1) * _SPEC_REC_CAP],
                    "ckpt_cnt": ckpt_cnt[t * ckpt_cap : (t + 1) * ckpt_cap],
                    "ckpt_pos": ckpt_pos[t * ckpt_cap : (t + 1) * ckpt_cap],
                    "exc_idx": exc_idx[t * cap : t * cap + k].copy(),
                    "exc_val": exc_val[t * cap : t * cap + k].copy(),
                    "cnt": int(cnts[t]),
                    "exit_pos": int(p[t]),
                    "start_bit": bounds[s] * 8,
                })
            return out

    with ThreadPoolExecutor(min(workers, len(groups))) as pool:
        results = list(pool.map(run_group, groups))
    if any(r is None for r in results):
        return None
    segs = [seg for group in results for seg in group]

    # Stitch: walk the true entry position through the segments.  Per
    # segment: A[s] = cumulative true count at entry, and (steps, j,
    # cvals) = the serial catch-up decode (length `steps`, values cvals)
    # plus the speculative index at convergence (segment 0 is exact:
    # steps=0, j=0).  j=None means the whole segment was walked serially.
    A = [0]
    A_pos = []  # true entry position of each segment
    meta = []  # (steps, j, cvals)
    entry = 0
    for s in range(n_seg):
        A_pos.append(entry)
        seg = segs[s]
        end_bit = bounds[s + 1] * 8
        if s + 1 < n_seg and seg["exit_pos"] < end_bit:
            return None  # stream ended inside an interior segment
        if s == 0:
            steps, j, cvals = 0, 0, None
        else:
            rlen = min(seg["cnt"], _SPEC_REC_CAP)
            j = int(np.searchsorted(seg["rec"][:rlen], np.uint64(entry)))
            if j < rlen and int(seg["rec"][j]) == entry:
                steps, cvals = 0, None
            else:
                # handshake miss: serial catch-up decode of this segment
                vcap = 1 << 16
                while True:
                    vals = np.empty(vcap, np.int32)
                    match = ctypes.c_int64(-1)
                    pos_out = ctypes.c_uint64(0)
                    steps_out = ctypes.c_uint64(0)
                    rc = lib.eg_decode_catchup(
                        buf.ctypes.data, nbits, entry, end_bit,
                        seg["rec"].ctypes.data, rlen,
                        vals.ctypes.data, vcap,
                        ctypes.byref(match), ctypes.byref(pos_out),
                        ctypes.byref(steps_out),
                    )
                    if rc == -2:
                        vcap *= 4
                        continue
                    if rc != 0:
                        return None
                    break
                steps = int(steps_out.value)
                cvals = vals[:steps].copy()
                if match.value >= 0:
                    j = int(match.value)
                else:
                    if s + 1 < n_seg and int(pos_out.value) < end_bit:
                        return None  # data ran out mid-stream: serial EOF
                    # walked the whole segment serially: exact by itself
                    A.append(A[-1] + steps)
                    meta.append((steps, None, cvals))
                    entry = int(pos_out.value)
                    continue
        A.append(A[-1] + steps + (seg["cnt"] - j))
        meta.append((steps, j, cvals))
        entry = seg["exit_pos"]
    total = A[-1]
    if n_chunks * values_per_chunk > total:
        return None  # stream too short: serial path owns EOF semantics

    def position_of(g: int) -> int:
        """Exact bit position of true codeword `g` (checkpoint + a short
        rescan of < 2**_SPEC_CKPT_SHIFT codewords)."""
        s = bisect.bisect_right(A, g) - 1
        s = min(s, n_seg - 1)
        m = g - A[s]
        steps, j, _cvals = meta[s]
        seg = segs[s]
        if m < steps or j is None:
            return scan_values(buf, m, A_pos[s])
        msp = j + (m - steps)
        t = msp >> _SPEC_CKPT_SHIFT
        if t == 0:
            c0, q0 = 0, seg["start_bit"]
        else:
            c0, q0 = int(seg["ckpt_cnt"][t]), int(seg["ckpt_pos"][t])
        return scan_values(buf, msp - c0, q0)

    try:
        ends = [position_of((k + 1) * values_per_chunk)
                for k in range(n_chunks)]
    except EOFError:
        return None

    V = values_per_chunk

    def build_chunk(k: int):
        """Chunk k's (plane, exc_idx, exc_val, end_bit) from the validated
        spans.  Exceptions rebase per chunk in the pool.  A chunk fully
        inside one byte-aligned span is a view of the segment plane."""
        g0 = k * V
        s = bisect.bisect_right(A, g0) - 1
        plane = None
        parts_i: list[np.ndarray] = []
        parts_v: list[np.ndarray] = []
        g = g0
        while g < g0 + V:
            a, b = max(g, A[s]), min(g0 + V, A[s + 1])
            if b <= a:
                s += 1
                continue
            steps, j, cvals = meta[s]
            if a < A[s] + steps:  # catch-up splice
                c1 = min(b, A[s] + steps)
                cv = cvals[a - A[s] : c1 - A[s]]
                if plane is None:
                    plane = np.empty(V // 2, np.uint8)
                _pack_vals_into(plane, a - g0, cv)
                li = np.flatnonzero((cv < -8) | (cv > 7))
                parts_i.append(((a - g0) + li).astype(np.int32))
                parts_v.append(cv[li])
                a = c1
            if a < b:  # validated speculative span
                local = j + (a - A[s] - steps)
                if plane is None and a == g0 and b == g0 + V \
                        and local % 2 == 0:
                    plane = segs[s]["plane"][local // 2
                                             : local // 2 + V // 2]
                else:
                    if plane is None:
                        plane = np.empty(V // 2, np.uint8)
                    lib.nibble_copy(plane.ctypes.data, a - g0,
                                    segs[s]["plane"].ctypes.data, local,
                                    b - a)
                ei, ev = segs[s]["exc_idx"], segs[s]["exc_val"]
                lo = int(np.searchsorted(ei, local))
                hi = int(np.searchsorted(ei, local + (b - a)))
                parts_i.append(ei[lo:hi] - np.int32(local - (a - g0)))
                parts_v.append(ev[lo:hi])
            g = b
            s += 1
        ci = (np.concatenate(parts_i) if parts_i
              else np.empty(0, np.int32))
        cv_ = (np.concatenate(parts_v) if parts_v
               else np.empty(0, np.int32))
        return plane, ci, cv_, ends[k]

    def gen():
        with ThreadPoolExecutor(workers) as pool:
            futs: dict = {}
            ahead = workers + 2
            for c in range(n_chunks):
                for k in range(c, min(c + ahead, n_chunks)):
                    if k not in futs:
                        futs[k] = pool.submit(traced, "entropy", build_chunk, k)
                yield futs.pop(c).result()

    return gen()


def _pack_vals_into(plane: np.ndarray, d0: int, vals: np.ndarray) -> None:
    """Write int32 values as nibbles at nibble offset d0 (read-modify-write
    at the boundary bytes).  Catch-up splice path only: usually tiny, but a
    never-converging stream (all-wide codewords) routes whole segments
    through here, so the body is vectorized."""
    vals = np.asarray(vals, np.int32)
    n = vals.size
    if n == 0:
        return
    nib = (vals & 0xF).astype(np.uint8)
    o = 0
    if d0 & 1:
        b = d0 >> 1
        plane[b] = (plane[b] & 0x0F) | (int(nib[0]) << 4)
        o = 1
    m = (n - o) & ~1
    if m:
        b0 = (d0 + o) >> 1
        plane[b0 : b0 + m // 2] = nib[o : o + m : 2] | (
            nib[o + 1 : o + m : 2] << 4
        )
    if o + m < n:
        i = d0 + o + m
        plane[i >> 1] = (plane[i >> 1] & 0xF0) | int(nib[-1])


def decode_values_planar4_pair(data, n: int, bitpos0: int, bitpos1: int):
    """Decode two independent n-value chunks in one interleaved native call
    (eg_decode_planar4_multi round-robins the two chunks' windows so their
    serial advance chains overlap in the out-of-order core).  Returns a
    pair of (plane, exc_idx, exc_val, end_bitpos) tuples, exactly two
    decode_values_planar4 results."""
    assert n % 2 == 0, "planar4 needs an even value count"
    buf = _as_u8(data)
    lib = native.load()
    cap = max(1024, n // 16)
    while True:
        planes = np.empty(n, np.uint8)
        ei = np.empty(2 * cap, np.int32)
        ev = np.empty(2 * cap, np.int32)
        p = np.array([bitpos0, bitpos1], np.uint64)
        cnts = np.zeros(2, np.uint64)
        rc = lib.eg_decode_planar4_multi(
            buf.ctypes.data, buf.size * 8, p.ctypes.data, 2, n,
            planes.ctypes.data, ei.ctypes.data, ev.ctypes.data, cap,
            cnts.ctypes.data,
        )
        if rc == -2:  # exception capacity; pathological content
            cap *= 4
            continue
        if rc != 0:
            raise EOFError("exp-golomb stream exhausted")
        k0, k1 = int(cnts[0]), int(cnts[1])
        half = n // 2
        return (
            (planes[:half], ei[:k0], ev[:k0], int(p[0])),
            (planes[half:], ei[cap : cap + k1], ev[cap : cap + k1],
             int(p[1])),
        )


def parallel_chunks(payload, values_per_chunk: int, n_chunks: int,
                    decode_fn, workers: int | None = None,
                    positions: list[int] | None = None):
    """Entropy-decode consecutive fixed-size chunks GOP-parallel, in order.

    A worker pool applies ``decode_fn(payload, n, bitpos)`` to several
    chunks concurrently (the C decoders release the GIL) and this generator
    yields each chunk's result tuple in stream order; raises EOFError if
    the stream ends early.

    Without ``positions``, a planar4 stream takes the fused speculative
    decode; failing that (a small payload, truncation), the speculative
    parallel scan gives the positions; failing that, the caller thread runs
    eg_scan ahead of the workers and one core is left to it.

    ``positions`` (len >= n_chunks): known chunk start bit offsets, from a
    stream index or the speculative scan.  Every core then decodes; planar4
    chunks are decoded two per task through the pair decoder when there
    are at least two chunks for every worker.  With fewer, pairs would
    leave workers idle (8 GOPs on 8 cores would run on 4), so each chunk
    is a task of its own, as the JAX package does not do: the tuples are
    the same either way.
    """
    if positions is None:
        if decode_fn is decode_values_planar4:
            fused = speculative_planar4_chunks(
                payload, values_per_chunk, n_chunks, workers
            )
            if fused is not None:
                yield from fused
                return
        positions = speculative_positions(
            payload, values_per_chunk, n_chunks, workers
        )
    have_index = positions is not None
    if workers is None:
        cores = os.cpu_count() or 2
        workers = max(1, min(n_chunks, cores if have_index else cores - 1))
    if have_index:
        if len(positions) < n_chunks:
            raise ValueError(
                f"index has {len(positions)} positions, need {n_chunks}"
            )
        positions = list(positions[:n_chunks])
    else:
        positions = [0]
    pair = (have_index and decode_fn is decode_values_planar4
            and values_per_chunk % 2 == 0 and n_chunks >= 2 * workers)
    futs: dict = {}
    with ThreadPoolExecutor(workers) as pool:
        def ensure(k: int) -> None:
            if k in futs or k >= n_chunks:
                return
            while len(positions) <= k:
                positions.append(
                    scan_values(payload, values_per_chunk, positions[-1])
                )
            if pair and not (k & 1) and k + 1 < n_chunks:
                while len(positions) <= k + 1:
                    positions.append(
                        scan_values(payload, values_per_chunk, positions[-1])
                    )
                f = pool.submit(
                    traced, "entropy", decode_values_planar4_pair, payload,
                    values_per_chunk, positions[k], positions[k + 1],
                )
                futs[k] = (f, 0)
                futs[k + 1] = (f, 1)
            else:
                futs[k] = (pool.submit(
                    traced, "entropy", decode_fn, payload, values_per_chunk,
                    positions[k],
                ), None)

        lookahead = (2 * workers + 2) if pair else (workers + 1)
        for c in range(n_chunks):
            for k in range(c, min(c + lookahead, n_chunks)):
                ensure(k)
            f, part = futs.pop(c)
            r = f.result()
            yield r if part is None else r[part]


class InflateWindow:
    """Bounded sliding window over an inflating zlib stream, addressed in
    ABSOLUTE payload bits.

    parallel_chunks needs random access to the inflated payload, so its
    callers inflate the whole stream up front — an hour of 1080p holds GBs
    of entropy payload.  This window pumps the inflater on demand
    (`ensure_bit`), hands workers bounded COPIES of their chunk's byte span
    (`array`), and drops consumed bytes (`drop_before`), so the resident
    payload is O(in-flight chunks), not O(stream).

    `max_held` records the high-water window size (tests pin the bound).
    """

    def __init__(self, data: bytes, chunk_bytes: int = 1 << 20) -> None:
        self._z = zlib.decompressobj()
        self._src = memoryview(data)
        self._off = 0
        self._chunk = chunk_bytes
        self._buf = bytearray()
        self._base = 0  # absolute byte offset of _buf[0]
        self._eof = False
        self.max_held = 0

    @property
    def end_bit(self) -> int:
        return (self._base + len(self._buf)) * 8

    def pump(self) -> bool:
        """Inflate more source; False once the stream is exhausted."""
        try:
            while not self._eof:
                piece = self._src[self._off : self._off + self._chunk]
                self._off += len(piece)
                out = self._z.decompress(bytes(piece)) if piece else b""
                if self._off >= len(self._src):
                    out += self._z.flush()
                    self._eof = True
                if out:
                    self._buf += out
                    self.max_held = max(self.max_held, len(self._buf))
                    return True
            return False
        except zlib.error as e:
            raise ValueError(f"corrupt bitstream: {e}") from e

    def ensure_bit(self, bit: int) -> bool:
        """Grow the window to cover absolute `bit`; False at stream end."""
        while self.end_bit < bit:
            if not self.pump():
                return False
        return True

    def drop_before(self, bit: int) -> None:
        n = bit // 8 - self._base
        if n > 0:
            del self._buf[:n]
            self._base += n

    def array(self, from_bit: int, to_bit: int | None = None):
        """Contiguous uint8 COPY of [from_bit's byte, to_bit's byte] (or the
        window end) -> (arr, base_bit).  A copy, so the window can keep
        growing and dropping while workers read their snapshots."""
        a = max(0, from_bit // 8 - self._base)
        if to_bit is None:
            b = len(self._buf)
        else:
            b = min(len(self._buf), -(-to_bit // 8) - self._base)
        arr = np.frombuffer(self._buf, np.uint8, len(self._buf))[a:b].copy()
        return arr, (self._base + a) * 8

    def scan(self, n: int, bitpos: int, hint_bits: int) -> int:
        """scan_values over the window, pumping on shortfall.

        `hint_bits` pre-grows the window to the chunk's expected span so
        the scan rarely restarts.  Raises EOFError only at true stream
        end."""
        self.ensure_bit(bitpos + hint_bits)
        while True:
            arr, base = self.array(bitpos)
            try:
                return scan_values(arr, n, bitpos - base) + base
            except EOFError:
                if not self.pump():
                    raise


def parallel_chunks_bounded(win: InflateWindow, values_per_chunk: int,
                            n_chunks: int, decode_fn,
                            workers: int | None = None,
                            positions: list[int] | None = None,
                            hint_bits_per_value: int = 3):
    """parallel_chunks over an InflateWindow: the same ordered results, the
    same scan-ahead and worker-pool overlap, but O(in-flight) payload
    residency.

    Chunk k is submitted once its end boundary is known (scan, or the
    index's positions[k+1]); each worker decodes a bounded snapshot of its
    own byte span.  The final chunk's end is unknown without a scan, so it
    decodes with a pump-and-retry loop (main thread only — the window is
    not thread-safe).
    """
    workers = workers or max(1, min(n_chunks, (os.cpu_count() or 2) - 1))
    hint = values_per_chunk * hint_bits_per_value
    have_index = positions is not None
    if have_index:
        if len(positions) < n_chunks:
            raise ValueError(
                f"index has {len(positions)} positions, need {n_chunks}"
            )
        pos = list(positions[:n_chunks])
    else:
        pos = [0]
    slack = 64  # native decoders may peek a word past the last codeword

    futs: dict = {}
    with ThreadPoolExecutor(workers) as pool:
        def submit(k: int) -> None:
            if k in futs:
                return
            if not have_index:
                while len(pos) <= k + 1:
                    # Walking the scan also grows the window to the span
                    # (and scanning the last chunk pins its exact end, so
                    # the EOF-retry path below only fires on truncation).
                    pos.append(win.scan(values_per_chunk, pos[-1], hint))
            end = pos[k + 1] + slack if k + 1 < len(pos) else None
            if end is not None:
                win.ensure_bit(end)
            else:  # indexed last chunk, end unknown: take the hint span
                win.ensure_bit(pos[k] + hint + slack)
            arr, base = win.array(pos[k], end)
            futs[k] = (pool.submit(decode_fn, arr, values_per_chunk,
                                   pos[k] - base), base)

        for c in range(n_chunks):
            for k in range(c, min(c + workers + 1, n_chunks)):
                submit(k)
            fut, base = futs.pop(c)
            while True:
                try:
                    result = fut.result()
                    break
                except EOFError:
                    # Snapshot too short (hint miss on the last chunk, or a
                    # truncated stream): grow and retry in the main thread.
                    if not win.pump():
                        raise
                    arr, base = win.array(pos[c])
                    fut = pool.submit(decode_fn, arr, values_per_chunk,
                                      pos[c] - base)
            *vals, rel_end = result
            end = rel_end + base
            if not have_index:
                while len(pos) <= c + 1:
                    pos.append(end)
            yield tuple(vals) + (end,)
            win.drop_before(pos[c + 1] if c + 1 < len(pos) else end)


class InflateSource:
    """Streaming inflate + Exp-Golomb decode with explicit bit cursor.

    Replaces the reference decoder's triple buffer-compaction loop
    (decoder.c:210-243) with a single growing byte buffer and a bit cursor;
    consumed whole bytes are dropped lazily.
    """

    def __init__(self) -> None:
        self._z = zlib.decompressobj()
        self._buf = bytearray()
        self._start = 0  # consumed-bytes offset (lazy compaction)
        self._bitpos = 0  # bit cursor within the byte at _start
        self._eof = False

    def feed(self, data: bytes) -> None:
        if data:
            try:
                self._buf += self._z.decompress(data)
            except zlib.error as e:
                raise ValueError(f"corrupt bitstream: {e}") from e

    def feed_eof(self) -> None:
        if not self._eof:
            try:
                self._buf += self._z.flush()
            except zlib.error as e:
                raise ValueError(f"corrupt bitstream: {e}") from e
            self._eof = True

    def _window(self) -> np.ndarray:
        # Zero-copy view of the unconsumed bytes (the view is dropped before
        # feed() can resize the bytearray again).
        return np.frombuffer(self._buf, dtype=np.uint8)[self._start :]

    def _read(self, decoder, n: int):
        try:
            *result, pos = decoder(self._window(), n, self._bitpos)
        except EOFError:
            return None
        self._consume(pos)
        return result[0] if len(result) == 1 else tuple(result)

    def try_read_planar4(self, n: int):
        """Decode n values into the packed-nibble planar format, or None."""
        return self._read(decode_values_planar4, n)

    def _consume(self, pos: int) -> None:
        self._start += pos // 8
        self._bitpos = pos % 8
        # Amortized compaction: one memmove when over half is consumed,
        # keeping long-stream decode linear (not O(n^2) in memcpy).
        if self._start > 65536 and self._start * 2 > len(self._buf):
            del self._buf[: self._start]
            self._start = 0


# ----------------------------------------------------------------------------
# Streaming DEFLATE with reference chunk semantics
# ----------------------------------------------------------------------------


def _split_carry(packed: np.ndarray, total_bits: int,
                 carry_code: int, carry_bits: int):
    """Shared bit-carry bookkeeping of the DEFLATE sinks: merge the incoming
    carry into the whole-byte chunk, extract the new trailing carry.
    Returns (chunk bytes, new_carry_code, new_carry_bits)."""
    full = total_bits // 8
    rem = total_bits % 8
    chunk = packed[:full].copy()
    if carry_bits and full:
        chunk[0] |= carry_code << (8 - carry_bits)
    if rem:
        nxt = int(packed[full])
        if full == 0 and carry_bits:
            # Stream still inside the original partial byte.
            nxt |= carry_code << (8 - carry_bits)
        new_code = nxt >> (8 - rem)
    else:
        new_code = 0
    return chunk.tobytes(), new_code, rem


def _final_byte(carry_code: int, carry_bits: int) -> int:
    """The reference's final extra byte: the zero-padded partial byte, or a
    zero byte (encoder.c:270, Encoder.java:117)."""
    return (carry_code << (8 - carry_bits)) & 0xFF if carry_bits else 0


class _ZlibSink:
    """The host zlib sinks' GOP entry point and host path."""

    def push_gop(self, packed: torch.Tensor, total_bits: torch.Tensor
                 ) -> tuple[bytes, int]:
        """One GOP where the device step left it (as DeviceDeflateSink's):
        the bit count (``device_wait`` on a card), the bytes through the
        partial last byte (``d2h``), then the GOP's sync boundary and
        ``push_packed`` (``sink_push``).  Returns (stream bytes, bits)."""
        with staging.on_card(self.timer, "device_wait", packed.is_cuda):
            bits = int(total_bits)  # synchronizes the current stream
        host = staging.fetch([packed[: bits // 8 + 1]], self.timer)[0]
        with self.timer.stage("sink_push", bits // 8):
            self.gop_boundary()
            return self.push_packed(host, bits), bits

    def push_values(self, values: np.ndarray) -> bytes:
        """Host path: entropy-code values directly into the sink."""
        payload, nbits = encode_values(values, bitpos=self.carry_bits)
        return self.push_packed(np.frombuffer(payload, dtype=np.uint8), nbits)


class DeflateSink(_ZlibSink):
    """One zlib stream across all GOP chunks, whole bytes only, final extra
    byte on close — byte-compatible with both reference encoders.

    ``timer`` (a StageTimer, e.g. the encoder's) gets a ``deflate`` stage
    for each compress call, with its input bytes."""

    def __init__(self, level: int = zlib.Z_BEST_COMPRESSION,
                 timer: StageTimer | None = None) -> None:
        self._z = zlib.compressobj(level)
        self.timer = timer or StageTimer()
        self.carry_code = 0  # partial byte's bits, right-aligned
        self.carry_bits = 0  # 0..7

    def push_packed(self, packed: np.ndarray, total_bits: int) -> bytes:
        """Consume a device-packed buffer whose stream includes carry_bits
        bits of this sink's carry at the front (bit 0)."""
        chunk, self.carry_code, self.carry_bits = _split_carry(
            packed, total_bits, self.carry_code, self.carry_bits
        )
        if not chunk:
            return b""
        with self.timer.stage("deflate", len(chunk)):
            return self._z.compress(chunk)

    def finish(self) -> bytes:
        """Final partial byte (zero-padded) or a zero byte, then Z_FINISH —
        mirroring `expGolombCodedDataSize + 1` (encoder.c:270) and
        `getBufferPosition() + 1` (Encoder.java:117)."""
        with self.timer.stage("deflate", 1):
            out = self._z.compress(
                bytes([_final_byte(self.carry_code, self.carry_bits)]))
            out += self._z.flush(zlib.Z_FINISH)
        self.carry_code = 0
        self.carry_bits = 0
        return out

    def gop_boundary(self) -> None:
        """No-op: one z_stream spans the whole file (reference layout), so
        back-references inherently cross GOPs and no sync point exists."""

    def sync_offsets(self) -> list[int] | None:
        """No parallel-inflate sync points in the serial reference layout."""
        return None

    def close(self) -> None:
        """No worker threads to release; symmetry with ParallelDeflateSink."""


class ParallelDeflateSink(_ZlibSink):
    """Multi-threaded DEFLATE producing ONE valid zlib stream (pigz-style).

    Splits the Exp-Golomb byte stream into blocks, deflates them on a
    thread pool as *raw* streams ending in Z_FULL_FLUSH (a byte-aligned
    sync point), primes each block's 32 KiB window with the tail of the
    previous block, and stitches header + blocks + final empty block +
    adler32 into a stream any zlib inflater reads as-is.  CPython's zlib
    releases the GIL, so the workers run in parallel.

    Byte layout differs from the serial sink (block boundaries), payload is
    identical.  Select via CodecConfig.deflate_workers.  ``timer`` gets a
    ``deflate`` stage for each block, on the worker that compresses it.
    """

    _HEADER = b"\x78\xda"  # CMF/FLG, 32K window, FCHECK valid

    def __init__(self, level: int = zlib.Z_BEST_COMPRESSION,
                 workers: int | None = None, block_size: int = 1 << 20,
                 timer: StageTimer | None = None) -> None:
        self._level = level
        self.timer = timer or StageTimer()
        self._block_size = block_size
        self._pool = ThreadPoolExecutor(
            max_workers=workers or max(1, (os.cpu_count() or 2) - 1)
        )
        self._futs: collections.deque = collections.deque()
        self._adler = zlib.adler32(b"")
        self._header_sent = False
        self._tail = b""  # up to 32 KiB of raw history for window priming
        self.carry_code = 0
        self.carry_bits = 0
        # Parallel-inflate sync bookkeeping (gop_boundary/sync_offsets):
        # block count at each boundary + resolved compressed block lengths.
        self._n_blocks = 0
        self._marks: list[int] = []
        self._block_lens: list[int] = []

    def _compress_block(self, data: bytes, zdict: bytes) -> bytes:
        with self.timer.stage("deflate", len(data)):
            if zdict:
                co = zlib.compressobj(
                    self._level, zlib.DEFLATED, -zlib.MAX_WBITS,
                    zlib.DEF_MEM_LEVEL, zlib.Z_DEFAULT_STRATEGY, zdict,
                )
            else:
                co = zlib.compressobj(self._level, zlib.DEFLATED,
                                      -zlib.MAX_WBITS)
            return co.compress(data) + co.flush(zlib.Z_FULL_FLUSH)

    def _submit(self, data: bytes) -> None:
        self._adler = zlib.adler32(data, self._adler)
        for i in range(0, len(data), self._block_size):
            blk = data[i : i + self._block_size]
            self._futs.append(self._pool.submit(self._compress_block, blk, self._tail))
            self._n_blocks += 1
            self._tail = blk[-32768:] if len(blk) >= 32768 else (self._tail + blk)[-32768:]

    def _ready(self, block: bool = False) -> bytes:
        out = []
        if not self._header_sent:
            out.append(self._HEADER)
            self._header_sent = True
        while self._futs and (block or self._futs[0].done()):
            blk = self._futs.popleft().result()
            self._block_lens.append(len(blk))
            out.append(blk)
        return b"".join(out)

    def gop_boundary(self) -> None:
        """Mark a GOP boundary: the next block compresses with NO window
        priming from earlier data, so a raw inflater can start at it
        independently (docs/FORMAT.md index member v2)."""
        self._tail = b""
        self._marks.append(self._n_blocks)

    def sync_offsets(self) -> list[int] | None:
        """Absolute compressed byte offset of each marked boundary — valid
        once finish() has drained every block.  None when no boundaries
        were marked."""
        if not self._marks:
            return None
        prefix = [len(self._HEADER)]
        for ln in self._block_lens:
            prefix.append(prefix[-1] + ln)
        return [prefix[m] for m in self._marks]

    def push_packed(self, packed: np.ndarray, total_bits: int) -> bytes:
        chunk, self.carry_code, self.carry_bits = _split_carry(
            packed, total_bits, self.carry_code, self.carry_bits
        )
        if chunk:
            self._submit(chunk)
        return self._ready()

    def finish(self) -> bytes:
        self._submit(bytes([_final_byte(self.carry_code, self.carry_bits)]))
        self.carry_code = 0
        self.carry_bits = 0
        body = self._ready(block=True)
        # Final empty fixed-Huffman block with BFINAL=1, then the adler32 of
        # the whole uncompressed payload — completing the zlib framing.
        return body + b"\x03\x00" + struct.pack(">I", self._adler & 0xFFFFFFFF)

    def close(self) -> None:
        """Release the worker threads (sinks are one-shot after finish)."""
        self._pool.shutdown(wait=True)


class DeviceDeflateSink:
    """DEFLATE on the card (ops/deflate.py), in ParallelDeflateSink's
    layout: ``78 DA``; each GOP's whole bytes as raw DEFLATE blocks that
    refer to nothing before the GOP, then an empty stored block after byte
    alignment, the GOP's sync offset at its first block; on finish the
    final byte as a stored block, ``03 00`` and the adler32 of the whole
    payload.  ``parallel_inflate`` and the index v2 sync offsets read it as
    they read the parallel sink's stream.

    ``push_gop`` deflates a GOP with ``ops.deflate.Deflater`` on the
    current stream; ``append_span`` places the span (a span of the plain
    engine places the same way).  ``timer`` gets the driver's stages inside
    a ``sink_push`` stage a GOP."""

    _HEADER = ParallelDeflateSink._HEADER

    def __init__(self, level: int = zlib.Z_BEST_COMPRESSION,
                 timer: StageTimer | None = None) -> None:
        self.timer = timer or StageTimer()
        self._deflater = dev_deflate.Deflater(level, self.timer)
        self.carry_code = 0
        self.carry_bits = 0
        self._adler = zlib.adler32(b"")
        self._pos = 0  # compressed bytes written so far
        self._syncs: list[int] = []

    def _head(self) -> bytes:
        if self._pos:
            return b""
        self._pos = len(self._HEADER)
        return self._HEADER

    def gop_boundary(self) -> None:
        """Mark the next GOP's first block as a sync point."""
        self._syncs.append(self._pos or len(self._HEADER))

    def sync_offsets(self) -> list[int] | None:
        """Absolute compressed offset of each marked GOP (None if none)."""
        return self._syncs or None

    def push_gop(self, packed: torch.Tensor, total_bits: torch.Tensor
                 ) -> tuple[bytes, int]:
        """Deflate one GOP on the card: ``packed`` its (cap,) uint8 CUDA
        bytes, the carry's bits first, ``total_bits`` its 0-d int64 bit
        count, both where the device step left them; marks the GOP's sync
        boundary.  Returns (stream bytes, total_bits)."""
        if not packed.is_cuda:
            raise ValueError("DeviceDeflateSink deflates CUDA tensors only")
        with self.timer.stage("sink_push"):
            self.gop_boundary()
            span, total, s1, s2, tail = self._deflater(packed, total_bits)
            self.timer.add_bytes("sink_push", total // 8)
            return self.append_span(span, total, s1, s2, tail), total

    def append_span(self, span: bytes, total_bits: int, s1: int, s2: int,
                    tail: int) -> bytes:
        """Place one GOP's span (``ops.deflate``'s output and record: its
        bit count, adler32 sums and partial byte) in the stream; returns
        the stream bytes it adds."""
        n, rem = total_bits // 8, total_bits % 8
        self.carry_code = tail >> (8 - rem) if rem else 0
        self.carry_bits = rem
        self._adler = _adler32_combine(self._adler, dev_deflate.adler32_of(s1, s2, n), n)
        head = self._head()
        self._pos += len(span)
        return head + span

    def finish(self) -> bytes:
        """The final byte (encoder.c:270) as a stored block, the final
        empty block and the adler32."""
        last = _final_byte(self.carry_code, self.carry_bits)
        self.carry_code = 0
        self.carry_bits = 0
        self._adler = _adler32_combine(self._adler, zlib.adler32(bytes([last])), 1)
        return (self._head() + bytes([0, 1, 0, 0xFE, 0xFF, last]) + b"\x03\x00"
                + struct.pack(">I", self._adler & 0xFFFFFFFF))

    def close(self) -> None:
        """Drop the driver: the card's workspace and the pinned buffer."""
        self._deflater = None


def resolve_workers(deflate_workers: int) -> int:
    """cfg.deflate_workers -> a concrete thread count: 0 means serial
    (1 worker), negative means all cores but one, N>0 means exactly N.
    Used by the turbo encoder; make_sink keeps its 0-means-DeflateSink
    special case for reference-parity stream layout."""
    if deflate_workers < 0:
        return max(1, (os.cpu_count() or 2) - 1)
    return max(1, deflate_workers)


def make_sink(cfg, timer: StageTimer | None = None, device=None
              ) -> DeflateSink | ParallelDeflateSink | DeviceDeflateSink:
    """Sink per config: 0 workers = serial reference-parity stream; else
    the device sink when the GOPs' bytes are on a CUDA ``device``, the
    parallel zlib sink otherwise.  ``timer`` receives the sink's
    ``deflate`` stages."""
    if cfg.deflate_workers == 0:
        return DeflateSink(cfg.zlib_level, timer)
    if device is not None and torch.device(device).type == "cuda":
        return DeviceDeflateSink(cfg.zlib_level, timer)
    workers = None if cfg.deflate_workers < 0 else cfg.deflate_workers
    return ParallelDeflateSink(cfg.zlib_level, workers, timer=timer)


def parallel_inflate(data: bytes, syncs: list[int]) -> bytes:
    """Inflate a parallel-sink zlib stream GOP-parallel via its sync points.

    ``syncs`` are absolute compressed byte offsets of per-GOP boundaries
    written by ParallelDeflateSink.gop_boundary.  Returns bytes identical
    to zlib.decompress(data); any inconsistency (stale syncs, foreign
    stream, adler32 mismatch) falls back to the serial inflate, so
    correctness never rests on the index.
    """
    # Equal ADJACENT syncs are legal (the duplicate spans are empty).
    if not syncs or syncs[0] != 2 or data[:2] != b"\x78\xda" or any(
        a > b for a, b in zip(syncs, syncs[1:])
    ) or syncs[-1] >= len(data):
        return zlib.decompress(data)
    bounds = list(syncs) + [len(data)]

    def one(k: int):
        with trace("inflate"):
            z = zlib.decompressobj(-zlib.MAX_WBITS)
            out = z.decompress(data[bounds[k] : bounds[k + 1]]) + z.flush()
            return out, zlib.adler32(out), len(out)

    try:
        with ThreadPoolExecutor(os.cpu_count() or 2) as pool:
            parts = list(pool.map(one, range(len(syncs))))
        joined = b"".join(p[0] for p in parts)
    except zlib.error:
        return zlib.decompress(data)
    # Integrity gate: the stream's own adler32 (its last 4 bytes) must
    # match the payload, combined from the per-span checksums.
    got = 1
    for _, ad, ln in parts:
        got = _adler32_combine(got, ad, ln)
    (want,) = struct.unpack(">I", data[-4:])
    if got != want:
        return zlib.decompress(data)
    return joined


def _adler32_combine(ad1: int, ad2: int, len2: int) -> int:
    """zlib's adler32_combine: checksum of a concatenation from the two
    parts' checksums (O(1); the C symbol isn't exposed in Python)."""
    MOD = 65521
    rem = len2 % MOD
    sum1 = ad1 & 0xFFFF
    sum2 = (rem * sum1) % MOD
    sum1 += (ad2 & 0xFFFF) + MOD - 1
    sum2 += ((ad1 >> 16) & 0xFFFF) + ((ad2 >> 16) & 0xFFFF) + MOD - rem
    if sum1 >= MOD:
        sum1 -= MOD
    if sum1 >= MOD:
        sum1 -= MOD
    if sum2 >= 2 * MOD:
        sum2 -= 2 * MOD
    if sum2 >= MOD:
        sum2 -= MOD
    return sum1 | (sum2 << 16)
