"""DEFLATE of one GOP's Exp-Golomb bytes on the card (csrc/deflate.cu),
and its plain version.

The kernels replace no TPU kernel: the JAX package deflates on the host
(``dct3d_tpu.codec.entropy``'s zlib sinks).  They take the host zlib pool
off the reference encode and the turbo drain through one driver,
``Deflater``, which launches them on a GOP's device bytes and copies back
only the compressed span: ``codec/entropy.DeviceDeflateSink`` places each
GOP's span in its stream, and ``codec/turbo.TurboEncoder`` frames the span
of each GOP's nibble wire plane as a zlib stream (``zlib_stream``).

What one call writes, for a GOP of ``n = total_bits // 8`` whole bytes:
raw DEFLATE blocks that refer to nothing before the GOP's first byte, then
an empty non-final stored block (``Z_FULL_FLUSH``'s ``00 00 FF FF`` after
byte alignment), so that the span starts and ends on a byte boundary and
inflates on its own.  The engine, stage by stage:

1. **Chains.**  For every position, the distance back to the nearest
   earlier position with the same hash of its next 3 bytes (15 bits), of
   its next 4 bytes (15 bits) and of its next 8 bytes (14 bits); 0 where
   there is none within 32 KiB.
2. **Matches.**  For every position ``i``, the longest match of 3 to
   ``min(258, segment end - i)`` bytes: first the nearest 3-byte-hash
   candidate, then up to ``depth // 4`` candidates down the 4-byte chain
   and up to ``depth`` down the 8-byte chain, nearest first; a candidate
   replaces the best only if strictly longer, and the search stops at
   ``nice``.  A 3-byte match farther than 4096 bytes counts as none in the
   lazy levels (zlib's ``TOO_FAR``).
3. **Parse.**  Each segment of ``SEGMENT`` bytes is parsed on its own over
   the precomputed matches: zlib's lazy evaluation (``deflate_slow``, with
   ``lazy`` as ``max_lazy``) for levels 4-9, greedy (``deflate_fast``) for
   1-3, only literals for 0.  Matches refer back across segments but end
   at their segment's end.
4. **Blocks.**  The GOP's symbols are cut into ``ceil(N / BLOCK_SYMBOLS)``
   blocks of equal count.  Each gets length-limited canonical Huffman
   codes (15 bits, 7 for the code-length code; Moffat-Katajainen lengths,
   limited as miniz does), a header run-length coded as zlib's
   ``scan_tree`` does, and the smallest of dynamic, fixed and stored
   (stored priced for the worst alignment).  Runs of stored blocks merge
   into stored blocks of up to 65535 bytes: 5 bytes over the data's size
   each.
5. **Emit.**  Each field's bit offset is an exclusive scan of the widths;
   fields are OR-ed into 32-bit little-endian words.
6. **adler32.**  ``S1 = sum(x)`` and ``S2 = sum((n - k) * x[k])`` over the
   GOP's bytes, from which the GOP's adler32 is ``(1 + S1) % 65521 |
   ((n + S2) % 65521) << 16``; the sink combines GOPs on the host.

The parameters per ``zlib_level`` (``LEVELS``) are zlib's own table
(``max_lazy``, ``nice_length``, ``max_chain``; greedy for 1-3) with the
chain cut to 256, since every position is searched and not only those the
parse visits; zlib's ``good_length`` cut has no counterpart, since no
search knows the parse's previous match.  The chains run on 4- and 8-byte
hashes, which skip the short repeats that make zlib's 3-byte chains long:
the 8-byte chain reaches the long matches far back, the 4-byte chain the
short ones nearby, the nearest 3-byte candidate the shortest.  What bounds
the match search is the walk down the chains: up to ``depth * 5 / 4``
dependent reads of shared memory per position.

CPU tensors take the plain version (``deflate_plain``), NumPy and Python
written from the description above; CUDA tensors launch the kernels
(``deflate``), whose output equals the plain version's byte for byte.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from .. import kernels, staging
from ..profiling import StageTimer

#: bytes a segment parses on its own (step 3)
SEGMENT = 32768
#: symbols a block aims at: zlib's lit_bufsize at memLevel 8
BLOCK_SYMBOLS = 16384
#: bytes of the card's per-call record (``info``): int64 fields below
INFO_WORDS = 8
I_TOTAL_BITS, I_OUT_BYTES, I_S1, I_S2, I_TAIL, I_SYMBOLS, I_BLOCKS = range(7)

HASH_BITS = 15
HASH8_BITS = 14
WINDOW = 32768
MAX_MATCH = 258
TOO_FAR = 4096
STORED_MAX = 65535

# level -> (greedy, lazy, nice, depth); zlib's deflate.c configuration_table
# (max_lazy, nice_length, max_chain) with the chain cut to 256.  The 8-byte
# chain is walked ``depth`` steps, the 4-byte chain a quarter of that.
LEVELS = {
    0: (True, 0, 0, 0),
    1: (True, 4, 8, 4),
    2: (True, 5, 16, 8),
    3: (True, 6, 32, 32),
    4: (False, 4, 16, 16),
    5: (False, 16, 32, 32),
    6: (False, 16, 128, 128),
    7: (False, 32, 128, 256),
    8: (False, 128, 258, 256),
    9: (False, 258, 258, 256),
}

_LBASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
          59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
_LEXT = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
_DBASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
          513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385,
          24577]
_DEXT = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
         10, 11, 11, 12, 12, 13, 13]
#: order of the code-length code lengths in a dynamic header (RFC 1951 3.2.7)
_CL_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
_CL_EXT = {16: 2, 17: 3, 18: 7}


def _code_tables():
    lcode = np.zeros(MAX_MATCH + 1, np.int64)
    for c, base in enumerate(_LBASE):
        lcode[base:] = c
    dcode = np.zeros(WINDOW + 1, np.int64)
    for c, base in enumerate(_DBASE):
        dcode[base:] = c
    return lcode, dcode


_LCODE, _DCODE = _code_tables()
_LEXT_A = np.array(_LEXT, np.int64)
_DEXT_A = np.array(_DEXT, np.int64)
_LBASE_A = np.array(_LBASE, np.int64)
_DBASE_A = np.array(_DBASE, np.int64)
_FIXED_LIT = np.array([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8, np.int64)


# ----------------------------------------------------------------------------
# The plain version
# ----------------------------------------------------------------------------


def _prev_dist(h: np.ndarray) -> np.ndarray:
    """Distance from each position back to the nearest earlier one with the
    same hash, 0 if none within WINDOW (stage 1)."""
    order = np.argsort(h, kind="stable")
    d = np.zeros(len(h), np.int64)
    if len(h) > 1:
        same = h[order[1:]] == h[order[:-1]]
        gap = order[1:] - order[:-1]
        d[order[1:]] = np.where(same & (gap <= WINDOW), gap, 0)
    return d


def chains_plain(b: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(n,) uint8 -> (prev3, prev4, prev8) distances (stage 1)."""
    n = len(b)
    x = b.astype(np.int64)
    p3, p4, p8 = (np.zeros(n, np.int64) for _ in range(3))
    if n >= 3:
        h3 = ((x[:-2] << 10) ^ (x[1:-1] << 5) ^ x[2:]) & ((1 << HASH_BITS) - 1)
        p3[: n - 2] = _prev_dist(h3)
    if n >= 4:
        v = (x[:-3] << 24) | (x[1:-2] << 16) | (x[2:-1] << 8) | x[3:]
        h4 = ((v * 2654435761) & 0xFFFFFFFF) >> (32 - HASH_BITS)
        p4[: n - 3] = _prev_dist(h4)
    if n >= 8:
        lo = x[:-7] | (x[1:-6] << 8) | (x[2:-5] << 16) | (x[3:-4] << 24)
        hi = x[4:-3] | (x[5:-2] << 8) | (x[6:-1] << 16) | (x[7:] << 24)
        h8 = (((lo * 2654435761) ^ (hi * 2246822519)) & 0xFFFFFFFF) >> (32 - HASH8_BITS)
        p8[: n - 7] = _prev_dist(h8)
    return p3, p4, p8


def _common(b: np.ndarray, i: np.ndarray, j: np.ndarray, cap: np.ndarray) -> np.ndarray:
    """Length of the common prefix of b[i:] and b[j:], at most cap (each
    position's cap keeps i + cap within b)."""
    length = np.zeros(len(i), np.int64)
    live = np.arange(len(i))
    while len(live):
        k = length[live]
        eq = b[i[live] + k] == b[j[live] + k]
        length[live[eq]] += 1
        live = live[eq]
        live = live[length[live] < cap[live]]
    return length


def matches_plain(b: np.ndarray, level: int) -> tuple[np.ndarray, np.ndarray]:
    """(n,) uint8 -> (length, distance) of each position's match (stage 2);
    length 0 where there is none."""
    greedy, _, nice, depth = LEVELS[level]
    n = len(b)
    mlen = np.zeros(n, np.int64)
    mdist = np.zeros(n, np.int64)
    if depth == 0 or n < 3:
        return mlen, mdist
    p3, p4, p8 = chains_plain(b)
    pos = np.arange(n)
    cap = np.minimum(MAX_MATCH, np.minimum((pos // SEGMENT + 1) * SEGMENT, n) - pos)
    stop = np.minimum(nice, cap)
    best = np.full(n, 2, np.int64)
    # the nearest 3-byte-hash candidate
    act = np.nonzero((cap >= 3) & (p3 > 0))[0]
    ln = _common(b, act, act - p3[act], cap[act])
    win = ln > best[act]
    best[act[win]] = ln[win]
    mdist[act[win]] = p3[act[win]]
    # then the 4-byte and the 8-byte chains, nearest first; a candidate
    # wins only if strictly longer
    for chain, steps, need in ((p4, depth // 4, 4), (p8, depth, 8)):
        act = np.nonzero((cap >= need) & (chain > 0) & (best < stop))[0]
        cand = act - chain[act]
        for _ in range(steps):
            if not len(act):
                break
            bl = best[act]
            quick = b[cand + bl] == b[act + bl]  # bl < stop <= cap: in range
            ln = np.zeros(len(act), np.int64)
            ln[quick] = _common(b, act[quick], cand[quick], cap[act[quick]])
            win = ln > bl
            best[act[win]] = ln[win]
            mdist[act[win]] = (act - cand)[win]
            d = chain[cand]
            nxt = cand - d
            keep = (best[act] < stop[act]) & (d > 0) & (act - nxt <= WINDOW)
            act, cand = act[keep], nxt[keep]
    found = best >= 3
    if not greedy:
        found &= ~((best == 3) & (mdist > TOO_FAR))
    mlen[found] = best[found]
    mdist[~found] = 0
    return mlen, mdist


def parse_plain(b: np.ndarray, mlen: np.ndarray, mdist: np.ndarray,
                level: int) -> np.ndarray:
    """Stage 3: the GOP's symbols as uint32 tokens, segment after segment:
    a literal is its byte, a match ``length << 16 | distance``."""
    greedy, lazy, _, _ = LEVELS[level]
    n = len(b)
    out: list[int] = []
    ml = mlen.tolist()
    md = mdist.tolist()
    bl = b.tolist()
    for s in range(0, n, SEGMENT):
        e = min(s + SEGMENT, n)
        i = s
        if greedy:  # level 0 too: it has no matches
            while i < e:
                if ml[i]:
                    out.append(ml[i] << 16 | md[i])
                    i += ml[i]
                else:
                    out.append(bl[i])
                    i += 1
        else:
            avail = False
            plen, pdist = 2, 0
            while i < e:
                cur = ml[i] if plen < lazy else 0
                if cur < 3:
                    cur = 2
                if plen >= 3 and cur <= plen:
                    out.append(plen << 16 | pdist)
                    i += plen - 1
                    avail = False
                    plen = 2
                    continue
                if avail:
                    out.append(bl[i - 1])
                avail = True
                plen, pdist = cur, md[i]
                i += 1
            if avail:
                out.append(bl[i - 1])
    return np.array(out, np.int64)


def huffman_lengths(freq: list[int], limit: int) -> list[int]:
    """Code lengths of a Huffman code for ``freq``, at most ``limit`` bits.

    Symbols sorted by (frequency, symbol); lengths by Moffat and
    Katajainen's in-place method; over-long codes cut to ``limit`` and the
    Kraft sum restored as miniz does (``tdefl_huffman_enforce_max_code_
    size``); the longest codes go to the rarest symbols.  With fewer than
    two symbols used, the used one (or symbol 0) and the lowest other get
    one bit each, so that every inflater accepts the code."""
    lengths = [0] * len(freq)
    used = [s for s, f in enumerate(freq) if f]
    if len(used) < 2:
        first = used[0] if used else 0
        lengths[first] = 1
        lengths[1 if first == 0 else 0] = 1
        return lengths
    used.sort(key=lambda s: (freq[s], s))
    a = [freq[s] for s in used]
    m = len(a)
    a[0] += a[1]
    root, leaf = 0, 2
    for nxt in range(1, m - 1):
        if leaf >= m or a[root] < a[leaf]:
            a[nxt] = a[root]
            a[root] = nxt
            root += 1
        else:
            a[nxt] = a[leaf]
            leaf += 1
        if leaf >= m or (root < nxt and a[root] < a[leaf]):
            a[nxt] += a[root]
            a[root] = nxt
            root += 1
        else:
            a[nxt] += a[leaf]
            leaf += 1
    a[m - 2] = 0
    for nxt in range(m - 3, -1, -1):
        a[nxt] = a[a[nxt]] + 1
    avail, used_n, depth = 1, 0, 0
    root, nxt = m - 2, m - 1
    while avail > 0:
        while root >= 0 and a[root] == depth:
            used_n += 1
            root -= 1
        while avail > used_n:
            a[nxt] = depth
            nxt -= 1
            avail -= 1
        avail = 2 * used_n
        depth += 1
        used_n = 0
    count = [0] * 33
    for x in a:
        count[min(x, limit)] += 1
    total = sum(count[i] << (limit - i) for i in range(1, limit + 1))
    while total > 1 << limit:
        count[limit] -= 1
        for i in range(limit - 1, 0, -1):
            if count[i]:
                count[i] -= 1
                count[i + 1] += 2
                break
        total -= 1
    k = m - 1
    for length in range(1, limit + 1):
        for _ in range(count[length]):
            lengths[used[k]] = length
            k -= 1
    return lengths


def canonical_codes(lengths: list[int]) -> list[int]:
    """RFC 1951 canonical codes, bit-reversed for LSB-first output."""
    count = [0] * 16
    for x in lengths:
        count[x] += 1
    count[0] = 0
    nxt = [0] * 16
    code = 0
    for b in range(1, 16):
        code = (code + count[b - 1]) << 1
        nxt[b] = code
    out = []
    for x in lengths:
        if x:
            c = nxt[x]
            nxt[x] += 1
            out.append(int(f"{c:0{x}b}"[::-1], 2))
        else:
            out.append(0)
    return out


def rle_lengths(lengths: list[int]) -> list[tuple[int, int]]:
    """zlib's ``scan_tree``/``send_tree`` run-length code of one tree's
    lengths: (symbol 0-18, extra bits' value)."""
    out: list[tuple[int, int]] = []
    n = len(lengths)
    prev = -1
    nextlen = lengths[0]
    count = 0
    max_count, min_count = (138, 3) if nextlen == 0 else (7, 4)
    for k in range(n):
        cur = nextlen
        nextlen = lengths[k + 1] if k + 1 < n else -1
        count += 1
        if count < max_count and cur == nextlen:
            continue
        if count < min_count:
            out.extend([(cur, 0)] * count)
        elif cur != 0:
            if cur != prev:
                out.append((cur, 0))
                count -= 1
            out.append((16, count - 3))
        elif count <= 10:
            out.append((17, count - 3))
        else:
            out.append((18, count - 11))
        count = 0
        prev = cur
        if nextlen == 0:
            max_count, min_count = 138, 3
        elif cur == nextlen:
            max_count, min_count = 6, 3
        else:
            max_count, min_count = 7, 4
    return out


class _Block:
    """One DEFLATE block's plan (stage 4)."""

    def __init__(self, tokens: np.ndarray, raw_start: int, raw_len: int,
                 stored_only: bool) -> None:
        self.tokens = tokens
        self.raw_start = raw_start
        self.raw_len = raw_len
        is_match = tokens >= 1 << 16
        lit = tokens[~is_match]
        mlen = tokens[is_match] >> 16
        mdist = tokens[is_match] & 0xFFFF
        lf = np.bincount(lit, minlength=286)
        lf += np.bincount(257 + _LCODE[mlen], minlength=286)
        lf[256] += 1
        df = np.bincount(_DCODE[mdist], minlength=30)
        extra = int((_LEXT_A[_LCODE[mlen]]).sum() + (_DEXT_A[_DCODE[mdist]]).sum())
        self.lit_len = huffman_lengths(lf.tolist(), 15)
        self.dist_len = huffman_lengths(df.tolist(), 15)
        hlit = max(257, max(s for s in range(286) if self.lit_len[s]) + 1)
        hdist = max(1, max(s for s in range(30) if self.dist_len[s]) + 1)
        self.hlit, self.hdist = hlit, hdist
        self.rle = (rle_lengths(self.lit_len[:hlit])
                    + rle_lengths(self.dist_len[:hdist]))
        cf = [0] * 19
        for sym, _ in self.rle:
            cf[sym] += 1
        self.cl_len = huffman_lengths(cf, 7)
        hclen = 19
        while hclen > 4 and not self.cl_len[_CL_ORDER[hclen - 1]]:
            hclen -= 1
        self.hclen = hclen
        header = 5 + 5 + 4 + 3 * hclen + sum(
            self.cl_len[s] + _CL_EXT.get(s, 0) for s, _ in self.rle)
        data = int((lf * np.array(self.lit_len)).sum()
                   + (df * np.array(self.dist_len)).sum()) + extra
        fixed = int((lf * _FIXED_LIT[:286]).sum() + 5 * df.sum()) + extra
        dynamic = header + data
        stored = (8 * raw_len + 42 * max(1, -(-raw_len // STORED_MAX))
                  - 3)  # the 3 header bits are counted once, below
        self.kind = 2
        self.bits = 3 + dynamic
        if 3 + fixed < self.bits:
            self.kind, self.bits = 1, 3 + fixed
        if stored_only or 3 + stored < self.bits:
            self.kind = 0


def _blocks_plain(tokens: np.ndarray, level: int) -> list[_Block]:
    nsym = len(tokens)
    if not nsym:
        return []
    nb = -(-nsym // BLOCK_SYMBOLS)
    raw = np.where(tokens >= 1 << 16, tokens >> 16, 1)
    raw_end = np.cumsum(raw)
    blocks = []
    for k in range(nb):
        a, z = k * nsym // nb, (k + 1) * nsym // nb
        start = int(raw_end[a - 1]) if a else 0
        blocks.append(_Block(tokens[a:z], start, int(raw_end[z - 1]) - start,
                             LEVELS[level][3] == 0))
    return blocks


class _Bits:
    """LSB-first bit fields (value, width <= 32) at absolute bit offsets."""

    def __init__(self) -> None:
        self.pos: list[np.ndarray] = []
        self.val: list[np.ndarray] = []
        self.wid: list[np.ndarray] = []

    def add(self, start: int, values, widths) -> int:
        v = np.asarray(values, np.int64)
        w = np.asarray(widths, np.int64)
        off = np.cumsum(w) - w + start
        self.pos.append(off)
        self.val.append(v)
        self.wid.append(w)
        return start + int(w.sum())

    def words(self, nwords: int) -> np.ndarray:
        pos = np.concatenate(self.pos) if self.pos else np.zeros(0, np.int64)
        val = np.concatenate(self.val) if self.val else np.zeros(0, np.int64)
        wid = np.concatenate(self.wid) if self.wid else np.zeros(0, np.int64)
        keep = wid > 0
        pos, val = pos[keep], val[keep]
        sh = pos & 31
        lo = (val << sh) & 0xFFFFFFFF
        hi = val >> (32 - sh)  # bits spilling into the next word
        acc = np.zeros(nwords + 1, np.int64)
        # Fields are bit-disjoint, so sums are ORs (exact in float64).
        acc += np.bincount(pos >> 5, weights=lo, minlength=nwords + 1).astype(np.int64)
        acc += np.bincount((pos >> 5) + 1, weights=np.where(sh > 0, hi, 0),
                           minlength=nwords + 2)[: nwords + 1].astype(np.int64)
        return acc[:nwords]


def _emit_block(bits: _Bits, bk: _Block, start: int) -> int:
    """A Huffman block's fields from bit ``start``; returns its end bit."""
    t = bk.tokens
    is_match = t >= 1 << 16
    if bk.kind == 1:
        lit_len = _FIXED_LIT.tolist()  # codes over all 288 symbols
        dist_len = [5] * 30
        pos = bits.add(start, [0b010], [3])  # BFINAL 0, BTYPE 01
    else:
        lit_len, dist_len = bk.lit_len, bk.dist_len
        cl_codes = canonical_codes(bk.cl_len)
        hv = [0b100, bk.hlit - 257, bk.hdist - 1, bk.hclen - 4]
        hw = [3, 5, 5, 4]
        hv += [bk.cl_len[s] for s in _CL_ORDER[: bk.hclen]]
        hw += [3] * bk.hclen
        for sym, ext in bk.rle:
            hv += [cl_codes[sym], ext]
            hw += [bk.cl_len[sym], _CL_EXT.get(sym, 0)]
        pos = bits.add(start, hv, hw)
    lit_code = np.array(canonical_codes(lit_len), np.int64)
    dist_code = np.array(canonical_codes(dist_len), np.int64)
    lit_len_a = np.array(lit_len, np.int64)
    dist_len_a = np.array(dist_len, np.int64)
    # Two fields per symbol: the literal/length code with its extra bits,
    # the distance code with its extra bits (empty for a literal).
    ml = t >> 16
    md = t & 0xFFFF
    lc = np.where(is_match, 257 + _LCODE[ml], t)
    lx = np.where(is_match, _LEXT_A[_LCODE[ml]], 0)
    lxv = np.where(is_match, ml - _LBASE_A[_LCODE[ml]], 0)
    dc = _DCODE[md]
    dx = np.where(is_match, _DEXT_A[dc], 0)
    dxv = np.where(is_match, md - _DBASE_A[dc], 0)
    f1 = lit_code[lc] | (lxv << lit_len_a[lc])
    w1 = lit_len_a[lc] + lx
    f2 = np.where(is_match, dist_code[dc] | (dxv << dist_len_a[dc]), 0)
    w2 = np.where(is_match, dist_len_a[dc] + dx, 0)
    vals = np.stack([f1, f2], 1).reshape(-1).tolist() + [int(lit_code[256])]
    wids = np.stack([w1, w2], 1).reshape(-1).tolist() + [lit_len[256]]
    return bits.add(pos, vals, wids)


def _layout(blocks: list[_Block]):
    """Stage 4's sequential pass: each Huffman block's start bit and the
    merged stored runs (start bit, raw start, raw length); the end bit."""
    starts: list[int] = []
    runs: list[tuple[int, int, int]] = []
    bit = 0
    k = 0
    while k < len(blocks):
        if blocks[k].kind:
            starts.append(bit)
            bit += blocks[k].bits
            k += 1
            continue
        raw0, raw_len = blocks[k].raw_start, 0
        while k < len(blocks) and not blocks[k].kind:
            starts.append(-1)
            raw_len += blocks[k].raw_len
            k += 1
        runs.append((bit, raw0, raw_len))
        chunks = -(-raw_len // STORED_MAX)
        bit = 8 * ((bit + 3 + 7) // 8 + 4 + raw_len + 5 * (chunks - 1))
    return starts, runs, bit


def deflate_plain(data: np.ndarray, level: int) -> tuple[np.ndarray, int, int]:
    """Plain version of one call: (n,) uint8 -> (compressed bytes, S1, S2)
    (stage 6's sums; see the module docstring)."""
    b = np.ascontiguousarray(data, np.uint8)
    n = len(b)
    mlen, mdist = matches_plain(b, level)
    tokens = parse_plain(b, mlen, mdist, level)
    blocks = _blocks_plain(tokens, level)
    starts, runs, end = _layout(blocks)
    bits = _Bits()
    for bk, start in zip(blocks, starts):
        if start >= 0:
            _emit_block(bits, bk, start)
    stored_bytes = []
    for bit, raw0, raw_len in runs:
        byte = (bit + 3 + 7) // 8
        for c in range(0, raw_len, STORED_MAX):
            ln = min(STORED_MAX, raw_len - c)
            if c:
                byte += 1  # the next chunk's 3 header bits, padded
            bits.add(8 * byte, [ln, ln ^ 0xFFFF], [16, 16])
            stored_bytes.append((byte + 4, raw0 + c, ln))
            byte += 4 + ln
    sync = (end + 3 + 7) // 8
    bits.add(8 * sync + 16, [0xFFFF], [16])
    nbytes = sync + 4
    out = bits.words(-(-nbytes // 4)).astype("<u4").view(np.uint8)[:nbytes].copy()
    for at, raw0, ln in stored_bytes:
        out[at : at + ln] = b[raw0 : raw0 + ln]
    x = b.astype(np.int64)
    s1 = int(x.sum())
    s2 = int((x * (n - np.arange(n))).sum())
    return out, s1, s2


def adler32_of(s1: int, s2: int, n: int) -> int:
    """A GOP's adler32 from its stage-6 sums."""
    return ((1 + s1) % 65521) | (((n + s2) % 65521) << 16)


def zlib_level(level: int) -> int:
    """``level`` as zlib reads it: -1 (``Z_DEFAULT_COMPRESSION``) is 6;
    anything else outside 0-9 raises."""
    if level == zlib.Z_DEFAULT_COMPRESSION:
        return 6
    if level not in LEVELS:
        raise ValueError(f"zlib level {level} is not 0-9")
    return level


def zlib_header(level: int) -> bytes:
    """The two bytes ``zlib.compress`` writes at ``level`` (-1 or 0-9):
    CMF 0x78, then FLEVEL and the check bits."""
    level = zlib_level(level)
    flevel = 0 if level < 2 else 1 if level < 6 else 2 if level == 6 else 3
    return bytes([0x78, flevel << 6 | (31 - (0x7800 | flevel << 6) % 31) % 31])


def zlib_stream(span: bytes, level: int, s1: int, s2: int, n: int) -> bytes:
    """One call's span (of ``n`` input bytes, with its stage-6 sums) as a
    whole zlib stream: ``zlib_header(level)``, the span, an empty final
    fixed block (``03 00``) and the big-endian adler32."""
    return (zlib_header(level) + span + b"\x03\x00"
            + struct.pack(">I", adler32_of(s1, s2, n)))


# ----------------------------------------------------------------------------
# The wrapper
# ----------------------------------------------------------------------------


def out_capacity(cap: int) -> int:
    """Bytes of output a call may write for a buffer of ``cap`` bytes: a
    block costs at most its stored price (5.25 bytes over its data), a
    block holds at least 16384 bytes unless it is the segment's or the
    GOP's last, plus the sync and the words the emit rounds up to."""
    return cap + 6 * (cap // BLOCK_SYMBOLS + 3) + 16


class Workspace:
    """The card's scratch for GOPs of up to ``cap`` bytes, kept across
    calls (one GOP at a time: one workspace a thread).  The
    chains' buffer later holds the segments' tokens, the matches' buffer
    the compacted symbols."""

    def __init__(self, cap: int, device: torch.device) -> None:
        self.cap = cap

        def empty(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device=device)

        self.prev = empty(2 * cap + 4)  # prev3, 4, 8 as uint16; then tokens, repairs
        self.match = empty(cap + 4)  # length << 16 | distance; then symbols
        self.seg_count = empty(cap // SEGMENT + 2)
        self.pieces = empty(cap // SEGMENT + 2, 33, 4)  # the parse's joins
        self.desc = empty(cap // BLOCK_SYMBOLS + 2, 1024)  # csrc BlockDesc
        self.out = empty(out_capacity(cap) // 4 + 4)
        self.info = empty(INFO_WORDS, dtype=torch.int64)


def deflate(packed: torch.Tensor, total_bits: torch.Tensor, level: int,
            ws: Workspace | None = None):
    """One GOP's DEFLATE span from its bytes at ``level`` (-1 or 0-9).

    ``packed``: (cap,) uint8, the GOP's bytes (Exp-Golomb, the carried
    partial byte included) in its first ``total_bits // 8``, then the
    partial byte; ``total_bits``: a 0-d int64 tensor on the same device,
    read by the kernels, never by the host.  ``ws``: a Workspace to reuse.
    Returns ``(out, info)``: ``out`` a uint8 tensor whose first
    ``info[I_OUT_BYTES]`` bytes are the span, ``info`` the (INFO_WORDS,)
    int64 record (total bits, span bytes, S1, S2, the partial byte or 0,
    symbol and block counts; the plain version leaves the counts 0).  On
    the card nothing is synchronised: the caller reads ``info`` first,
    then the span."""
    if packed.dtype != torch.uint8 or packed.dim() != 1:
        raise ValueError("deflate takes a (cap,) uint8 buffer")
    level = zlib_level(level)
    if packed.device.type == "cpu":
        bits = int(total_bits)
        out, s1, s2 = deflate_plain(packed[: bits // 8].numpy(), level)
        tail = int(packed[bits // 8]) if bits % 8 else 0
        info = torch.tensor([bits, len(out), s1, s2, tail, 0, 0, 0], dtype=torch.int64)
        return torch.from_numpy(out), info
    kernels.check_cuda("deflate", packed, total_bits)
    cap = packed.numel()
    if ws is None or ws.cap < cap or ws.out.device != packed.device:
        ws = Workspace(cap, packed.device)
    greedy, lazy, nice, depth = LEVELS[level]
    kernels.launch("deflate", packed.device, packed, total_bits, cap, int(greedy),
                   lazy, nice, depth, ws.prev, ws.match, ws.seg_count, ws.pieces,
                   ws.desc, ws.out, ws.info)
    return ws.out.view(torch.uint8), ws.info


class Deflater:
    """One thread's driver of the card's DEFLATE at ``level`` (-1 or 0-9),
    one GOP a call, keeping its ``Workspace`` (grown to the largest GOP)
    and one ``staging.HostBuffer``.  ``timer`` gets a ``deflate`` stage a
    call (the input's whole bytes) and inside it a ``deflate_out`` stage
    (the span's copy; its bytes)."""

    def __init__(self, level: int, timer: StageTimer | None = None) -> None:
        self.level = zlib_level(level)
        self.timer = timer or StageTimer()
        self._ws: Workspace | None = None
        self._host = staging.HostBuffer()

    def __call__(self, packed: torch.Tensor, total_bits: torch.Tensor
                 ) -> tuple[bytes, int, int, int, int]:
        """``deflate`` on the current stream; the host waits once for the
        record, once for the span.  Returns (span, total bits, S1, S2, the
        partial byte or 0)."""
        with self.timer.stage("deflate"):
            if self._ws is None or self._ws.cap < packed.numel():
                self._ws = Workspace(packed.numel(), packed.device)
            out, info = deflate(packed, total_bits, self.level, self._ws)
            total, nout, s1, s2, tail = self._host.read(info, I_TAIL + 1).tolist()
            self.timer.add_bytes("deflate", total // 8)
            with self.timer.stage("deflate_out", nout):
                span = self._host.read(out, nout).numpy().tobytes()
        return span, total, s1, s2, tail
