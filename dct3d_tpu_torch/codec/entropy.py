"""Host-side entropy layer: the C Exp-Golomb decoder + streaming zlib.

A copy of the part of ``dct3d_tpu.codec.entropy`` that the reference-profile
encode/decode slice calls; the code is NumPy, ctypes and zlib, and the copy
exists only because importing the JAX package loads jax.

  * the DEFLATE sinks (serial reference-parity layout, and the parallel
    pigz-style layout with per-GOP sync points) and parallel inflate;
  * the C decoders: ``eg_scan`` for GOP boundaries and the fused
    decode-to-nibble-plane ``eg_decode_planar4``;
  * ``parallel_chunks``, which decodes GOPs on a thread pool, from known
    start positions (a stream index) or behind a serial boundary scan;
  * ``InflateSource``, the streaming inflate with a bit cursor behind
    ``StreamingDecoder`` (its planar4 reader only: the port decodes
    through the nibble plane).

Not copied yet: the speculative parallel scan and the fused speculative
decode (``dct3d_tpu.codec.entropy.speculative_*``).  Without positions the
port therefore takes the serial scan-ahead.
"""

from __future__ import annotations

import collections
import ctypes
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import native


def _as_u8(data) -> np.ndarray:
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else data
    return np.ascontiguousarray(buf, dtype=np.uint8)


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


def parallel_chunks(payload, values_per_chunk: int, n_chunks: int,
                    positions: list[int] | None = None):
    """Entropy-decode consecutive fixed-size chunks GOP-parallel, in order.

    A worker pool applies ``decode_values_planar4(payload, n, bitpos)`` to
    several chunks concurrently (the C decoder releases the GIL) and this
    generator yields each result tuple in stream order; raises EOFError if
    the stream ends early.

    ``positions`` (optional, len >= n_chunks): known chunk START bit
    offsets from a stream index, so every core decodes.  Without them the
    caller thread runs eg_scan ahead of the workers (boundaries are ~3x
    cheaper than decoding) and one core is left to it.
    """
    have_index = positions is not None
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
    futs: dict = {}
    with ThreadPoolExecutor(workers) as pool:
        def ensure(k: int) -> None:
            if k in futs or k >= n_chunks:
                return
            while len(positions) <= k:
                positions.append(
                    scan_values(payload, values_per_chunk, positions[-1])
                )
            futs[k] = pool.submit(
                decode_values_planar4, payload, values_per_chunk, positions[k]
            )

        for c in range(n_chunks):
            for k in range(c, min(c + workers + 1, n_chunks)):
                ensure(k)
            yield futs.pop(c).result()


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


class DeflateSink:
    """One zlib stream across all GOP chunks, whole bytes only, final extra
    byte on close — byte-compatible with both reference encoders."""

    def __init__(self, level: int = zlib.Z_BEST_COMPRESSION) -> None:
        self._z = zlib.compressobj(level)
        self.carry_code = 0  # partial byte's bits, right-aligned
        self.carry_bits = 0  # 0..7

    def push_packed(self, packed: np.ndarray, total_bits: int) -> bytes:
        """Consume a device-packed buffer whose stream includes carry_bits
        bits of this sink's carry at the front (bit 0)."""
        chunk, self.carry_code, self.carry_bits = _split_carry(
            packed, total_bits, self.carry_code, self.carry_bits
        )
        return self._z.compress(chunk) if chunk else b""

    def finish(self) -> bytes:
        """Final partial byte (zero-padded) or a zero byte, then Z_FINISH —
        mirroring `expGolombCodedDataSize + 1` (encoder.c:270) and
        `getBufferPosition() + 1` (Encoder.java:117)."""
        out = self._z.compress(bytes([_final_byte(self.carry_code, self.carry_bits)]))
        self.carry_code = 0
        self.carry_bits = 0
        return out + self._z.flush(zlib.Z_FINISH)

    def gop_boundary(self) -> None:
        """No-op: one z_stream spans the whole file (reference layout), so
        back-references inherently cross GOPs and no sync point exists."""

    def sync_offsets(self) -> list[int] | None:
        """No parallel-inflate sync points in the serial reference layout."""
        return None

    def close(self) -> None:
        """No worker threads to release; symmetry with ParallelDeflateSink."""


class ParallelDeflateSink:
    """Multi-threaded DEFLATE producing ONE valid zlib stream (pigz-style).

    Splits the Exp-Golomb byte stream into blocks, deflates them on a
    thread pool as *raw* streams ending in Z_FULL_FLUSH (a byte-aligned
    sync point), primes each block's 32 KiB window with the tail of the
    previous block, and stitches header + blocks + final empty block +
    adler32 into a stream any zlib inflater reads as-is.  CPython's zlib
    releases the GIL, so the workers run in parallel.

    Byte layout differs from the serial sink (block boundaries), payload is
    identical.  Select via CodecConfig.deflate_workers.
    """

    _HEADER = b"\x78\xda"  # CMF/FLG, 32K window, FCHECK valid

    def __init__(self, level: int = zlib.Z_BEST_COMPRESSION,
                 workers: int | None = None, block_size: int = 1 << 20) -> None:
        self._level = level
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
        if zdict:
            co = zlib.compressobj(
                self._level, zlib.DEFLATED, -zlib.MAX_WBITS,
                zlib.DEF_MEM_LEVEL, zlib.Z_DEFAULT_STRATEGY, zdict,
            )
        else:
            co = zlib.compressobj(self._level, zlib.DEFLATED, -zlib.MAX_WBITS)
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


def resolve_workers(deflate_workers: int) -> int:
    """cfg.deflate_workers -> a concrete thread count: 0 means serial
    (1 worker), negative means all cores but one, N>0 means exactly N.
    Used by the turbo encoder; make_sink keeps its 0-means-DeflateSink
    special case for reference-parity stream layout."""
    if deflate_workers < 0:
        return max(1, (os.cpu_count() or 2) - 1)
    return max(1, deflate_workers)


def make_sink(cfg) -> DeflateSink | ParallelDeflateSink:
    """Sink per config: 0 workers = serial reference-parity stream."""
    if cfg.deflate_workers == 0:
        return DeflateSink(cfg.zlib_level)
    workers = None if cfg.deflate_workers < 0 else cfg.deflate_workers
    return ParallelDeflateSink(cfg.zlib_level, workers)


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
