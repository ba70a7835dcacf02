"""The plain reference that decides ``correct``: the codec written again in
float64 PyTorch from its published description (docs/FORMAT.md), with no
code, weights or tables of the program.

  * ``Transform``: the orthonormal 3D DCT-II of each cube (a Kronecker
    product of three 1D bases, 1/sqrt(2) on each zero-frequency axis), the
    analytic quantizer max(1, q*(x+y+z)), the 3D zigzag order (constant
    x+y+z planes; y outer, z middle, x inner), the rounding
    sign(c)*floor(|c| + bias), and the inverse: ints times divisors through
    the transposed basis, clamped to [0, 255] and truncated to uint8;
  * ``split_members``, ``parse_index``: the D3MH container and its index;
  * ``eg_decode``: signed Exp-Golomb, MSB-first, decoded for all values at
    once by pointer doubling over the bit positions;
  * ``turbo_ints``: a turbo member's four zlib streams back to the ints.

Everything runs on the tensors' device: the CPU in the tests, the card
after a run's window has closed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

MAGIC = b"D3MH"
TEMPORAL, INDEX, TURBO = 0, 4, 5
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis: rows are frequencies."""
    k = np.arange(n, dtype=np.float64)[:, None]
    m = np.arange(n, dtype=np.float64)[None, :]
    d = np.sqrt(2.0 / n) * np.cos(np.pi * (2.0 * m + 1.0) * k / (2.0 * n))
    d[0] /= np.sqrt(2.0)
    return d


def _zigzag(bw: int, bh: int, bd: int) -> np.ndarray:
    """Flat [z][y][x] cube indices in stream order."""
    order = [(x, y, z)
             for s in range(bw + bh + bd - 2)
             for y in range(bh) for z in range(bd) for x in range(bw)
             if x + y + z == s]
    return np.array([x + y * bw + z * bw * bh for x, y, z in order])


class Transform:
    """Forward and inverse transform of one block shape in float64."""

    def __init__(self, block: tuple[int, int, int], quant: int, bias: float,
                 device: torch.device) -> None:
        bw, bh, bd = block
        self.block = block
        self.bias = bias
        self.device = device
        basis = np.kron(_dct_basis(bd), np.kron(_dct_basis(bh), _dct_basis(bw)))
        x = np.arange(bw)[None, None, :]
        y = np.arange(bh)[None, :, None]
        z = np.arange(bd)[:, None, None]
        div = np.broadcast_to(np.maximum(1, quant * (x + y + z)), (bd, bh, bw))
        zz = _zigzag(bw, bh, bd)
        rows = basis[zz]
        dz = div.reshape(-1)[zz].astype(np.float64)[:, None]
        self.enc = torch.from_numpy(np.ascontiguousarray((rows / dz).T)).to(device)
        self.dec = torch.from_numpy(np.ascontiguousarray(rows * dz)).to(device)

    def cubes(self, frames: torch.Tensor) -> torch.Tensor:
        """(T, H, W) frames, T a GOP multiple -> (cubes, cube): GOPs in time
        order, block rows outer, block columns inner, [z][y][x] inside."""
        bw, bh, bd = self.block
        t, h, w = frames.shape
        c = frames.reshape(t // bd, bd, h // bh, bh, w // bw, bw)
        return c.permute(0, 2, 4, 1, 3, 5).reshape(-1, bw * bh * bd)

    def frames(self, cubes: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
        """Inverse of ``cubes``: (cubes, cube) -> (t, h, w)."""
        bw, bh, bd = self.block
        c = cubes.reshape(t // bd, h // bh, w // bw, bd, bh, bw)
        return c.permute(0, 3, 1, 4, 2, 5).reshape(t, h, w)

    def scaled(self, frames: np.ndarray) -> torch.Tensor:
        """Quantizer inputs in float64: DCT coefficients over divisors."""
        f = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        return self.cubes(f).to(torch.float64) @ self.enc

    def quantize(self, scaled: torch.Tensor) -> torch.Tensor:
        return (torch.sign(scaled) * torch.floor(scaled.abs() + self.bias)).to(torch.int64)

    def unscaled(self, ints: torch.Tensor) -> torch.Tensor:
        """Inverse transform in float64, before the clamp and the cast."""
        return ints.to(torch.float64) @ self.dec

    @staticmethod
    def pixels(x: torch.Tensor) -> torch.Tensor:
        return x.clamp(0.0, 255.0).to(torch.uint8)


def split_members(data: bytes) -> list[tuple[int, int, bytes]]:
    """D3MH container -> [(member type, frame count, payload)]; ValueError
    on a bad magic or a payload that runs past the end."""
    out, pos = [], 0
    while pos < len(data):
        if data[pos : pos + 4] != MAGIC or pos + 16 > len(data):
            raise ValueError(f"no D3MH member header at byte {pos}")
        tagged, length = struct.unpack_from("<IQ", data, pos + 4)
        pos += 16
        if pos + length > len(data):
            raise ValueError("member payload runs past the container's end")
        out.append((tagged >> 24, tagged & 0xFFFFFF, data[pos : pos + length]))
        pos += length
    return out


def parse_index(payload: bytes) -> tuple[list[int], list[int] | None]:
    """Index member -> (bit end of each GOP, compressed sync offsets or None)."""
    (n,) = struct.unpack_from("<I", payload, 0)
    if len(payload) < 4 + 8 * n:
        raise ValueError("index member shorter than its GOP count")
    ends = list(struct.unpack_from(f"<{n}Q", payload, 4))
    syncs = None
    if len(payload) >= 4 + 16 * n:
        syncs = list(struct.unpack_from(f"<{n}Q", payload, 4 + 8 * n))
    return ends, syncs


def inflate(payload: bytes) -> bytes:
    """One zlib stream; ValueError for anything else (a zstd frame too)."""
    if payload[:4] == _ZSTD_MAGIC:
        raise ValueError("zstd stream where the configuration states zlib")
    try:
        return zlib.decompress(payload)
    except zlib.error as e:
        raise ValueError(f"zlib stream does not inflate: {e}") from e


def eg_decode(raw: bytes, start_bit: int, n: int, stop_bit: int,
              device: torch.device) -> tuple[torch.Tensor, int]:
    """``n`` signed Exp-Golomb values from bit ``start_bit`` of ``raw``,
    reading no bit at or past ``stop_bit`` -> (int64 values, end bit).

    A codeword is z zeros, a one, and z bits: the code number m + 1,
    MSB-first; m = 2v - 1 for v > 0 and -2v for v <= 0.  From every bit
    position p the next codeword would start at 2 * o(p) - p + 1, where
    o(p) is the first one at or after p; doubling that map log2(n) times
    gives the n starts from ``start_bit`` without a serial walk.  Raises
    ValueError when the values do not fit below ``stop_bit``."""
    b0 = start_bit >> 3
    b1 = min(len(raw), (stop_bit + 7) >> 3)
    if b1 <= b0 or n <= 0:
        raise ValueError("no bits to decode")
    buf = torch.frombuffer(bytearray(raw[b0:b1]), dtype=torch.uint8).to(device)
    nbits = 8 * (b1 - b0)
    shifts = torch.arange(7, -1, -1, device=device, dtype=torch.uint8)
    bits = ((buf[:, None] >> shifts) & 1).reshape(-1)
    p = torch.arange(nbits, device=device)
    ones = torch.where(bits == 1, p, nbits)
    o = torch.flip(torch.cummin(torch.flip(ones, [0]), 0).values, [0])
    del ones, bits
    after = 2 * o - p + 1
    del p
    jump = torch.cat([after.clamp(max=nbits), after.new_tensor([nbits])])
    tables = [jump]
    for _ in range(max(1, (n - 1).bit_length()) - 1):
        tables.append(tables[-1][tables[-1]])
    starts = torch.tensor([start_bit - 8 * b0], device=device)
    for table in reversed(tables):
        starts = torch.stack([starts, table[starts]], 1).reshape(-1)
    del tables, jump
    starts = starts[:n]
    if starts.numel() < n or int(starts.max()) >= nbits:
        raise ValueError("the stream ends before its values do")
    last = int(after[starts[-1]])
    if last > nbits:
        raise ValueError("the last codeword runs past the stream's end")
    first_one = o[starts]
    z = first_one - starts
    if int(z.max()) > 24:
        raise ValueError("codeword longer than the decoder reads")
    pad = torch.cat([buf, buf.new_zeros(4)]).to(torch.int64)
    i = first_one >> 3
    word = (pad[i] << 24) | (pad[i + 1] << 16) | (pad[i + 2] << 8) | pad[i + 3]
    code = ((word << (first_one & 7)) & 0xFFFFFFFF) >> (31 - z)
    m = code - 1
    values = torch.where((m & 1) == 1, (m + 1) >> 1, -(m >> 1))
    return values, 8 * b0 + last


def turbo_ints(payload: bytes, cubes: int, cube: int) -> torch.Tensor:
    """A turbo member's payload -> (cubes, cube) int64 ints in zigzag order.

    Four length-prefixed zlib streams: the nibble plane, coefficient-pair
    major (byte [jj, c] holds coefficients 2jj, low nibble, and 2jj + 1 of
    cube c, each a signed 4-bit value); the DC of every cube as int16
    deltas; the flat indices of the other values outside [-8, 7] as int32
    deltas over (pair * cubes + cube) * 2 + parity; and their int16
    values."""
    if len(payload) < 16:
        raise ValueError("turbo member shorter than its header")
    lens = struct.unpack_from("<IIII", payload, 0)
    if 16 + sum(lens) != len(payload):
        raise ValueError("turbo member's stream lengths do not add up")
    parts, o = [], 16
    for n in lens:
        parts.append(inflate(payload[o : o + n]))
        o += n
    wire = np.frombuffer(parts[0], np.uint8)
    ddc = np.frombuffer(parts[1], np.int16)
    didx = np.frombuffer(parts[2], np.int32)
    val = np.frombuffer(parts[3], np.int16)
    if wire.size * 2 != cubes * cube or ddc.size != cubes or didx.size != val.size:
        raise ValueError("turbo member's streams have the wrong sizes")
    w = wire.reshape(cube // 2, cubes).T.astype(np.int64)
    ints = np.empty((cubes, cube), np.int64)
    ints[:, 0::2] = ((w & 0xF) ^ 8) - 8
    ints[:, 1::2] = ((w >> 4) ^ 8) - 8
    ints[:, 0] = np.cumsum(ddc.astype(np.int64))
    i2 = np.cumsum(didx.astype(np.int64))
    if i2.size and (i2.min() < 0 or i2.max() >= cubes * cube):
        raise ValueError("turbo exception index out of range")
    pair, cpos = np.divmod(i2 >> 1, cubes)
    ints[cpos, 2 * pair + (i2 & 1)] = val
    return torch.from_numpy(ints)
