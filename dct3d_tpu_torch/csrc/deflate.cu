// DEFLATE of one GOP's Exp-Golomb bytes (ops/deflate.py, which documents
// the engine stage by stage and holds its plain version, equal byte for
// byte).  Replaces no TPU kernel: the JAX package deflates on the host.
//
// One entry point, dct3d_deflate, launches the pipeline on one stream:
//   chains  - per 20 KiB tile, three warps insert the tile and the 32 KiB
//             before it, 32 positions a step, into three shared head
//             tables (3-, 4- and 8-byte hashes): each position's distance
//             back to the nearest earlier one with its hash.  Bound by the
//             insertion's dependent steps, one warp a table
//   match   - per 8 KiB tile, 1024 threads walk the 4- and 8-byte chains
//             in a shared copy of the window (bytes and chain links): the
//             longest match of every position.  Bound by the walk: up to
//             depth * 5 / 4 dependent shared-memory reads a position
//   parse   - per 32 KiB segment, zlib's lazy (or greedy) parse over the
//             precomputed matches: 32 lanes parse a part each from a fresh
//             state, then one lane joins the parts where the true parse
//             meets each lane's (parse_kernel)
//   compact - the segments' symbols into one run
//   plan    - per block of ~16K symbols: histograms, Huffman codes,
//             header, the smallest block type
//   layout  - one thread: each block's start bit, stored runs, the span's
//             length; the span's words zeroed, its sync flush written
//   emit    - per block: header and symbols OR-ed in at scanned offsets
//   adler   - the GOP's adler32 sums
// The GOP's byte count is read from total_bits on the device; every grid
// is sized by the buffer's capacity and its blocks past the GOP return.
#include "common.cuh"

namespace dct3d {
namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kWindow = 32768;
constexpr int kMaxMatch = 258;
constexpr int kTooFar = 4096;
constexpr int kHashBits = 15;
constexpr int kHashSize = 1 << kHashBits;
constexpr int kHash8Bits = 14;
constexpr int kHash8Size = 1 << kHash8Bits;
constexpr int kSegment = 32768;       // ops/deflate.py SEGMENT
constexpr int kBlockSymbols = 16384;  // ops/deflate.py BLOCK_SYMBOLS
constexpr int kStoredMax = 65535;
constexpr int kChainTile = 20480;  // window + tile < 65535: u16 entries
constexpr int kChainThreads = 256;  // three warps insert
constexpr int kMatchTile = 8192;
constexpr int kMatchThreads = 1024;
constexpr int kParseThreads = 256;
constexpr int kLanes = 32;                  // parts of a segment, one lane each
constexpr int kPart = kSegment / kLanes;
constexpr int kPlanThreads = 256;
constexpr int kEmitThreads = 256;
constexpr uint16_t kNone = 0xFFFF;

// info[] fields (ops/deflate.py I_*)
constexpr int kTotalBits = 0, kOutBytes = 1, kS1 = 2, kS2 = 3, kTail = 4,
              kSymbols = 5, kBlocks = 6;

// BlockDesc: kDescWords int32 per block
constexpr int kDescWords = 1024;
constexpr int dKind = 0, dBits = 1, dRawLen = 2, dTok0 = 3, dTok1 = 4,
              dHlit = 5, dHdist = 6, dHclen = 7, dNrle = 8, dStart = 9,
              dRunRaw = 10, dRunOff = 11, dRunLen = 12, dRawStart = 13;
constexpr int dLit = 16;            // 288 codes: reversed code | len << 16
constexpr int dDist = dLit + 288;   // 30 codes
constexpr int dCl = dDist + 30;     // 19 codes
constexpr int dRle = dCl + 19;      // up to 316 entries: symbol | extra << 8
static_assert(dRle + 316 <= kDescWords, "BlockDesc overflows its row");

__constant__ int kLBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23,
                               27, 31, 35, 43, 51, 59, 67, 83, 99, 115, 131,
                               163, 195, 227, 258};
__constant__ int kDBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65,
                               97, 129, 193, 257, 385, 513, 769, 1025, 1537,
                               2049, 3073, 4097, 6145, 8193, 12289, 16385,
                               24577};
__constant__ int kClOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                 11, 4, 12, 3, 13, 2, 14, 1, 15};

__device__ __forceinline__ int64_t gop_bytes(const int64_t* total_bits) {
  return total_bits[0] >> 3;
}

// RFC 1951 3.2.5's length code of len (3..258) and its extra bits.
__device__ __forceinline__ int len_code(int len) {
  if (len == 258) return 28;
  const int l = len - 3;
  if (l < 8) return l;
  const int b = 31 - __clz(l);
  return 4 * (b - 1) + ((l >> (b - 2)) & 3);
}

__device__ __forceinline__ int len_extra(int code) {
  return code < 8 || code == 28 ? 0 : (code - 4) >> 2;
}

// The distance code of dist (1..32768) and its extra bits.
__device__ __forceinline__ int dist_code(int dist) {
  const int d = dist - 1;
  if (d < 4) return d;
  const int b = 31 - __clz(d);
  return 2 * b + ((d >> (b - 1)) & 1);
}

__device__ __forceinline__ int dist_extra(int code) {
  return code < 4 ? 0 : (code - 2) >> 1;
}

__device__ __forceinline__ int fixed_lit_len(int s) {
  return s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8;
}

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  return ((a << 10) ^ (b << 5) ^ c) & (kHashSize - 1);
}

__device__ __forceinline__ uint32_t hash4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  const uint32_t v = (a << 24) | (b << 16) | (c << 8) | d;
  return (v * 2654435761u) >> (32 - kHashBits);
}

// The 8 bytes at w as two little-endian words, mixed.
__device__ __forceinline__ uint32_t hash8(const uint8_t* w) {
  const uint32_t lo = w[0] | w[1] << 8 | w[2] << 16 | (uint32_t)w[3] << 24;
  const uint32_t hi = w[4] | w[5] << 8 | w[6] << 16 | (uint32_t)w[7] << 24;
  return (lo * 2654435761u ^ hi * 2246822519u) >> (32 - kHash8Bits);
}

// ---------------------------------------------------------------------------
// chains
// ---------------------------------------------------------------------------

// One block a tile: its threads copy the window's bytes into shared
// memory, then warp k inserts the window's positions into table k (3-,
// 4- and 8-byte hashes) 32 at a time, in order, the three warps at once:
// a lane's predecessor is the highest lower lane with its hash, else the
// table's entry; the group's highest lane then writes the entry.  Entries
// hold positions relative to the window's start (< 53248), kNone for none.
__global__ void __launch_bounds__(kChainThreads)
chains_kernel(const uint8_t* __restrict__ data, const int64_t* total_bits,
              uint16_t* __restrict__ prev3, uint16_t* __restrict__ prev4,
              uint16_t* __restrict__ prev8) {
  extern __shared__ uint32_t heads_raw[];
  uint16_t* heads = reinterpret_cast<uint16_t*>(heads_raw);
  uint8_t* w = reinterpret_cast<uint8_t*>(heads + 2 * kHashSize + kHash8Size);
  const int64_t n = gop_bytes(total_bits);
  const int64_t tile0 = (int64_t)blockIdx.x * kChainTile;
  if (tile0 >= n) return;
  const int64_t win = tile0 > kWindow ? tile0 - kWindow : 0;
  const int64_t tile1 = tile0 + kChainTile < n ? tile0 + kChainTile : n;
  const int64_t wend = tile1 + 7 < n ? tile1 + 7 : n;
  for (int k = threadIdx.x; k < kHashSize + kHash8Size / 2; k += kChainThreads)
    heads_raw[k] = 0xFFFFFFFFu;
  for (int64_t k = threadIdx.x; k < wend - win; k += kChainThreads) w[k] = data[win + k];
  __syncthreads();
  const int table = threadIdx.x >> 5;
  if (table > 2) return;
  const int need = table == 0 ? 3 : table == 1 ? 4 : 8;  // bytes hashed
  uint16_t* head = heads + table * kHashSize;
  uint16_t* prev = table == 0 ? prev3 : table == 1 ? prev4 : prev8;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  const unsigned above = lane == 31 ? 0u : ~((2u << lane) - 1);
  for (int64_t base = win; base < tile1; base += 32) {
    const int64_t p = base + lane;
    const int r = (int)(p - win);
    const bool in = p < tile1;
    const bool valid = in && p + need <= n;
    uint32_t key = kHashSize + lane;  // invalid lanes: keys no hash takes
    if (valid) {
      if (table == 0) key = hash3(w[r], w[r + 1], w[r + 2]);
      else if (table == 1) key = hash4(w[r], w[r + 1], w[r + 2], w[r + 3]);
      else key = hash8(w + r);
    }
    const unsigned group = __match_any_sync(kFull, key);
    int64_t q = -1;
    if (valid) {
      if (group & below) q = base + (31 - __clz(group & below));
      else if (head[key] != kNone) q = win + head[key];
    }
    __syncwarp();
    if (valid && !(group & above)) head[key] = (uint16_t)r;
    __syncwarp();
    if (in && p >= tile0) prev[p] = (q >= 0 && p - q <= kWindow) ? (uint16_t)(p - q) : 0;
  }
}

// ---------------------------------------------------------------------------
// match
// ---------------------------------------------------------------------------

// The 4 bytes at w[x], from two aligned words (w is 4-byte aligned and
// has 8 readable bytes past its data).
__device__ __forceinline__ uint32_t load4(const uint8_t* w, int x) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(w + (x & ~3));
  return __funnelshift_r(p[0], p[1], (x & 3) * 8);
}

// Common prefix of w[i:] and w[j:], at most cap bytes (i + cap is within
// the data).
__device__ __forceinline__ int common_len(const uint8_t* w, int i, int j,
                                          int cap) {
  int k = 0;
  for (; k + 4 <= cap; k += 4) {
    const uint32_t x = load4(w, i + k) ^ load4(w, j + k);
    if (x) return k + ((__ffs(x) - 1) >> 3);
  }
  while (k < cap && w[i + k] == w[j + k]) ++k;
  return k;
}

// Walks one chain (links in shared memory, distances back, 0 ending it)
// from position i for up to `steps` candidates, nearest first, within
// the window; a candidate wins only if strictly longer than `best`.
__device__ __forceinline__ void walk(const uint8_t* w, const uint16_t* link,
                                     int i, int steps, int cap, int stop,
                                     int& best, int& bdist) {
  int d = link[i];
  int j = i - d;
  uint8_t next = w[i + best];  // a longer match matches this byte too
  for (int step = 0; d && step < steps; ++step) {
    if (w[j + best] == next) {  // best < stop <= cap: in range
      const int len = common_len(w, i, j, cap);
      if (len > best) {
        best = len;
        bdist = i - j;
        if (best >= stop) return;
        next = w[i + best];
      }
    }
    d = link[j];
    if (!d) return;
    j -= d;
    if (i - j > kWindow) return;
  }
}

// Shared: prev4 and prev8 over [ws, tile1) and the bytes [ws, min(n,
// tile1 + 258)), ws = max(0, tile0 - 32768).  A match word is length << 16
// | distance, 0 for none.
__global__ void __launch_bounds__(kMatchThreads)
match_kernel(const uint8_t* __restrict__ data, const int64_t* total_bits,
             const uint16_t* __restrict__ prev3,
             const uint16_t* __restrict__ prev4,
             const uint16_t* __restrict__ prev8, uint32_t* __restrict__ match,
             int greedy, int nice, int depth) {
  extern __shared__ uint32_t smem_raw[];
  const int64_t n = gop_bytes(total_bits);
  const int64_t tile0 = (int64_t)blockIdx.x * kMatchTile;
  if (tile0 >= n) return;
  const int64_t ws = tile0 > kWindow ? tile0 - kWindow : 0;
  const int64_t tile1 = tile0 + kMatchTile < n ? tile0 + kMatchTile : n;
  const int64_t we = tile1 + kMaxMatch < n ? tile1 + kMaxMatch : n;
  const int nlink = (int)(tile1 - ws);
  const int stride = (nlink + 1) & ~1;  // keeps the bytes 4-byte aligned
  uint16_t* link4 = reinterpret_cast<uint16_t*>(smem_raw);
  uint16_t* link8 = link4 + stride;
  uint8_t* w = reinterpret_cast<uint8_t*>(link8 + stride);
  for (int k = threadIdx.x; k < (int)(we - ws); k += kMatchThreads)
    w[k] = data[ws + k];
  for (int k = threadIdx.x; k < nlink; k += kMatchThreads) {
    link4[k] = prev4[ws + k];
    link8[k] = prev8[ws + k];
  }
  __syncthreads();
  for (int64_t p = tile0 + threadIdx.x; p < tile1; p += kMatchThreads) {
    const int64_t seg_end =
        (p / kSegment + 1) * kSegment < n ? (p / kSegment + 1) * kSegment : n;
    const int cap = (int)(seg_end - p < kMaxMatch ? seg_end - p : kMaxMatch);
    const int i = (int)(p - ws);
    int best = 2, bdist = 0;
    if (depth > 0 && cap >= 3) {
      const int stop = nice < cap ? nice : cap;
      const int d3 = prev3[p];
      if (d3) {
        const int len = common_len(w, i, i - d3, cap);
        if (len > best) { best = len; bdist = d3; }
      }
      if (cap >= 4 && best < stop) walk(w, link4, i, depth / 4, cap, stop, best, bdist);
      if (cap >= 8 && best < stop) walk(w, link8, i, depth, cap, stop, best, bdist);
    }
    bool found = best >= 3;
    if (!greedy && best == 3 && bdist > kTooFar) found = false;
    match[p] = found ? ((uint32_t)best << 16 | (uint32_t)bdist) : 0u;
  }
}

// ---------------------------------------------------------------------------
// parse, compact
// ---------------------------------------------------------------------------

// The parse's state between two positions: at position i, either fresh
// (nothing pending) or with the decision on position i - 1 pending, whose
// match is then the precomputed one (zlib's match_available), so that
// (i, avail) determines the rest of the parse.
struct ParseState {
  int i;
  bool avail;
};

// One step of ops/deflate.py's parse_plain from state (i, avail) over the
// segment's matches m and bytes b: appends at most one token to out[k++].
__device__ __forceinline__ void parse_step(const uint32_t* m, const uint8_t* b,
                                           int greedy, int lazy, int& i,
                                           bool& avail, uint32_t* out, int& k) {
  const uint32_t here = m[i];
  if (greedy) {
    if (here) { out[k++] = here; i += here >> 16; }
    else { out[k++] = b[i]; ++i; }
    return;
  }
  int plen = 2;
  uint32_t pdist = 0;
  if (avail) {
    plen = (int)(m[i - 1] >> 16);
    if (plen < 3) plen = 2;
    pdist = m[i - 1] & 0xFFFF;
  }
  int cur = plen < lazy ? (int)(here >> 16) : 0;
  if (cur < 3) cur = 2;
  if (plen >= 3 && cur <= plen) {
    out[k++] = (uint32_t)plen << 16 | pdist;
    i += plen - 1;
    avail = false;
    return;
  }
  if (avail) out[k++] = b[i - 1];
  avail = true;
  ++i;
}

// Tokens as ops/deflate.py's parse_plain (a literal is its byte, a match
// length << 16 | distance), one segment a block.  The block's threads copy
// the segment's matches and bytes into shared memory; then each lane of
// the first warp parses its 1/32 of the segment from a fresh state, writing
// its tokens at its part's offset in `tokens` and noting, for each position
// where it was fresh, its token count there.  Lane 0 then follows the true
// parse across the parts: where it enters a part in a state that part's
// lane passed through, the rest of the part is the lane's; else it parses
// on (into `repair`) until it meets the lane's path or leaves the part.
// pieces[seg][p] = {repair from, repair count, lane tokens from, count}
// for parts p = 0..31, then the final pending literal as part 32's repair.
__global__ void __launch_bounds__(kParseThreads)
parse_kernel(const uint8_t* __restrict__ data, const int64_t* total_bits,
             const uint32_t* __restrict__ match, uint32_t* __restrict__ tokens,
             uint32_t* __restrict__ repair, int32_t* __restrict__ pieces,
             int32_t* __restrict__ seg_count, int greedy, int lazy) {
  extern __shared__ uint32_t seg_match[];
  int16_t* fresh_at = reinterpret_cast<int16_t*>(seg_match + kSegment);
  uint8_t* seg_data = reinterpret_cast<uint8_t*>(fresh_at + kSegment);
  const int64_t n = gop_bytes(total_bits);
  const int64_t s = (int64_t)blockIdx.x * kSegment;
  if (s >= n) return;
  const int len = (int)(s + kSegment < n ? kSegment : n - s);
  for (int k = threadIdx.x; k < len; k += kParseThreads) {
    seg_match[k] = match[s + k];
    seg_data[k] = data[s + k];
    fresh_at[k] = -1;
  }
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int part0 = min(lane * kPart, len), part1 = min(part0 + kPart, len);
  uint32_t* out = tokens + s + part0;
  int k = 0, i = part0;
  bool avail = false;
  while (i < part1) {
    if (!avail) fresh_at[i] = (int16_t)k;
    parse_step(seg_match, seg_data, greedy, lazy, i, avail, out, k);
  }
  const int count = k;
  const ParseState end_state = {i, avail};
  __syncwarp();
  int32_t* piece = pieces + (int64_t)blockIdx.x * (kLanes + 1) * 4;
  // lane 0 joins the parts, learning each lane's count and end state in
  // turn; its own part is the true parse's
  ParseState cur = end_state;
  uint32_t* rep = repair + s;
  int nrep = 0, total = count;
  if (lane == 0) {
    piece[0] = 0; piece[1] = 0; piece[2] = 0; piece[3] = count;
  }
  for (int l = 1; l < kLanes; ++l) {
    const int n_l = __shfl_sync(kFull, count, l);
    const int e_i = __shfl_sync(kFull, end_state.i, l);
    const bool e_a = __shfl_sync(kFull, end_state.avail, l);
    if (lane) continue;
    const int p0 = min(l * kPart, len), p1 = min(p0 + kPart, len);
    int32_t* pc = piece + 4 * l;
    pc[0] = nrep; pc[1] = 0; pc[2] = n_l; pc[3] = 0;
    if (cur.i >= p1) continue;  // the true parse has passed this part
    int ri = cur.i;
    bool ra = cur.avail;
    const int rep0 = nrep;
    while (ri < p1 && (ra || fresh_at[ri] < 0))
      parse_step(seg_match, seg_data, greedy, lazy, ri, ra, rep, nrep);
    pc[1] = nrep - rep0;
    total += nrep - rep0;
    if (ri < p1) {  // met the lane's path
      pc[2] = fresh_at[ri];
      pc[3] = n_l - fresh_at[ri];
      total += n_l - fresh_at[ri];
      cur = {e_i, e_a};
    } else {
      cur = {ri, ra};
    }
  }
  if (lane == 0) {
    int32_t* pc = piece + 4 * kLanes;
    pc[0] = nrep; pc[1] = 0; pc[2] = 0; pc[3] = 0;
    if (cur.avail) {  // the pending last literal
      rep[nrep++] = seg_data[cur.i - 1];
      pc[1] = 1;
      ++total;
    }
    seg_count[blockIdx.x] = total;
  }
}

// The segments' pieces into one run of symbols.
__global__ void __launch_bounds__(256)
compact_kernel(const int64_t* total_bits, const uint32_t* __restrict__ tokens,
               const uint32_t* __restrict__ repair,
               const int32_t* __restrict__ pieces,
               const int32_t* __restrict__ seg_count,
               uint32_t* __restrict__ symbols, int64_t* info) {
  __shared__ int64_t part[256];
  const int64_t n = gop_bytes(total_bits);
  const int seg = blockIdx.x;
  if ((int64_t)seg * kSegment >= n) return;
  int64_t acc = 0;
  for (int k = threadIdx.x; k < seg; k += 256) acc += seg_count[k];
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = 128; s; s >>= 1) {
    if ((int)threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  int64_t off = part[0];
  const int64_t s0 = (int64_t)seg * kSegment;
  const int32_t* pc = pieces + (int64_t)seg * (kLanes + 1) * 4;
  for (int l = 0; l <= kLanes; ++l, pc += 4) {
    const uint32_t* rep = repair + s0 + pc[0];
    for (int k = threadIdx.x; k < pc[1]; k += 256) symbols[off + k] = rep[k];
    off += pc[1];
    const uint32_t* own = tokens + s0 + l * kPart + pc[2];
    for (int k = threadIdx.x; k < pc[3]; k += 256) symbols[off + k] = own[k];
    off += pc[3];
  }
  const int64_t nsegs = (n + kSegment - 1) / kSegment;
  if (seg == nsegs - 1 && threadIdx.x == 0) info[kSymbols] = off;
}

// ---------------------------------------------------------------------------
// plan: Huffman codes and the block type
// ---------------------------------------------------------------------------

// ops/deflate.py huffman_lengths, from the used symbols sorted by
// (frequency, symbol): `sorted` holds them, `a` is scratch of m ints.
__device__ void huffman_from_sorted(const uint32_t* freq, const int* sorted,
                                    int m, int n, int limit, int* a,
                                    int* lengths) {
  for (int s = 0; s < n; ++s) lengths[s] = 0;
  if (m < 2) {
    const int first = m ? sorted[0] : 0;
    lengths[first] = 1;
    lengths[first == 0 ? 1 : 0] = 1;
    return;
  }
  for (int k = 0; k < m; ++k) a[k] = (int)freq[sorted[k]];
  a[0] += a[1];
  int root = 0, leaf = 2;
  for (int nxt = 1; nxt < m - 1; ++nxt) {
    if (leaf >= m || a[root] < a[leaf]) { a[nxt] = a[root]; a[root] = nxt; ++root; }
    else { a[nxt] = a[leaf]; ++leaf; }
    if (leaf >= m || (root < nxt && a[root] < a[leaf])) {
      a[nxt] += a[root]; a[root] = nxt; ++root;
    } else { a[nxt] += a[leaf]; ++leaf; }
  }
  a[m - 2] = 0;
  for (int nxt = m - 3; nxt >= 0; --nxt) a[nxt] = a[a[nxt]] + 1;
  int avail = 1, used = 0, dpth = 0;
  root = m - 2;
  int nxt = m - 1;
  while (avail > 0) {
    while (root >= 0 && a[root] == dpth) { ++used; --root; }
    while (avail > used) { a[nxt] = dpth; --nxt; --avail; }
    avail = 2 * used;
    ++dpth;
    used = 0;
  }
  int count[33];
  for (int k = 0; k < 33; ++k) count[k] = 0;
  for (int k = 0; k < m; ++k) ++count[a[k] < limit ? a[k] : limit];
  int64_t total = 0;
  for (int k = 1; k <= limit; ++k) total += (int64_t)count[k] << (limit - k);
  while (total > ((int64_t)1 << limit)) {
    --count[limit];
    for (int k = limit - 1; k > 0; --k) {
      if (count[k]) { --count[k]; count[k + 1] += 2; break; }
    }
    --total;
  }
  int k = m - 1;
  for (int len = 1; len <= limit; ++len)
    for (int c = 0; c < count[len]; ++c) lengths[sorted[k--]] = len;
}

// Canonical codes, bit-reversed for LSB-first output: code | len << 16.
__device__ void canonical(const int* lengths, int n, int32_t* out) {
  int count[16] = {0};
  for (int s = 0; s < n; ++s) ++count[lengths[s]];
  count[0] = 0;
  int next[16];
  int code = 0;
  next[0] = 0;
  for (int b = 1; b < 16; ++b) {
    code = (code + count[b - 1]) << 1;
    next[b] = code;
  }
  for (int s = 0; s < n; ++s) {
    const int len = lengths[s];
    int32_t v = 0;
    if (len) {
      const uint32_t c = (uint32_t)next[len]++;
      v = (int32_t)((__brev(c) >> (32 - len)) | ((uint32_t)len << 16));
    }
    out[s] = v;
  }
}

// zlib's scan_tree over one tree's lengths, appended to rle (symbol |
// extra << 8); returns the new count.
__device__ int rle_tree(const int* lengths, int n, int32_t* rle, int nr) {
  int prev = -1, nextlen = lengths[0], count = 0;
  int max_count = nextlen == 0 ? 138 : 7, min_count = nextlen == 0 ? 3 : 4;
  for (int k = 0; k < n; ++k) {
    const int cur = nextlen;
    nextlen = k + 1 < n ? lengths[k + 1] : -1;
    ++count;
    if (count < max_count && cur == nextlen) continue;
    if (count < min_count) {
      for (int c = 0; c < count; ++c) rle[nr++] = cur;
    } else if (cur != 0) {
      if (cur != prev) { rle[nr++] = cur; --count; }
      rle[nr++] = 16 | (count - 3) << 8;
    } else if (count <= 10) {
      rle[nr++] = 17 | (count - 3) << 8;
    } else {
      rle[nr++] = 18 | (count - 11) << 8;
    }
    count = 0;
    prev = cur;
    if (nextlen == 0) { max_count = 138; min_count = 3; }
    else if (cur == nextlen) { max_count = 6; min_count = 3; }
    else { max_count = 7; min_count = 4; }
  }
  return nr;
}

__device__ __forceinline__ int cl_extra(int sym) {
  return sym == 16 ? 2 : sym == 17 ? 3 : sym == 18 ? 7 : 0;
}

__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const uint32_t* __restrict__ symbols, const int64_t* info,
            int32_t* __restrict__ desc_all, int stored_only) {
  __shared__ uint32_t lf[286], df[30];
  __shared__ uint32_t wlf[kPlanThreads / 32][286], wdf[kPlanThreads / 32][30];
  __shared__ int sorted_l[286], sorted_d[30];
  __shared__ int m_l, m_d;
  __shared__ int a[286];
  __shared__ int len_l[288], len_d[30];
  __shared__ unsigned long long raw_sum, extra_sum;
  const int64_t nsym = info[kSymbols];
  const int64_t nb = (nsym + kBlockSymbols - 1) / kBlockSymbols;
  const int b = blockIdx.x;
  if (b >= nb) return;
  const int64_t t0 = b * nsym / nb, t1 = (b + 1) * nsym / nb;
  const int warp = threadIdx.x >> 5;
  for (int s = threadIdx.x; s < (kPlanThreads / 32) * 286; s += kPlanThreads)
    (&wlf[0][0])[s] = 0;
  for (int s = threadIdx.x; s < (kPlanThreads / 32) * 30; s += kPlanThreads)
    (&wdf[0][0])[s] = 0;
  if (threadIdx.x == 0) { raw_sum = 0; extra_sum = 0; m_l = 0; m_d = 0; }
  __syncthreads();
  unsigned long long raw = 0, extra = 0;
  for (int64_t k = t0 + threadIdx.x; k < t1; k += kPlanThreads) {
    const uint32_t t = symbols[k];
    if (t >= 65536u) {
      const int len = (int)(t >> 16), dist = (int)(t & 0xFFFF);
      const int lc = len_code(len), dc = dist_code(dist);
      atomicAdd(&wlf[warp][257 + lc], 1u);
      atomicAdd(&wdf[warp][dc], 1u);
      extra += len_extra(lc) + dist_extra(dc);
      raw += len;
    } else {
      atomicAdd(&wlf[warp][t], 1u);
      raw += 1;
    }
  }
  atomicAdd(&raw_sum, raw);
  atomicAdd(&extra_sum, extra);
  __syncthreads();
  for (int s = threadIdx.x; s < 286 + 30; s += kPlanThreads) {
    uint32_t sum = s == 256;  // the end-of-block symbol
    for (int v = 0; v < kPlanThreads / 32; ++v) sum += s < 286 ? wlf[v][s] : wdf[v][s - 286];
    if (s < 286) lf[s] = sum; else df[s - 286] = sum;
  }
  __syncthreads();
  // sort the used symbols by (frequency, symbol): each finds its rank
  for (int s = threadIdx.x; s < 286 + 30; s += kPlanThreads) {
    const bool lit = s < 286;
    const int sym = lit ? s : s - 286;
    const uint32_t* f = lit ? lf : df;
    const int n = lit ? 286 : 30;
    if (!f[sym]) continue;
    int rank = 0;
    for (int t = 0; t < n; ++t)
      rank += f[t] && (f[t] < f[sym] || (f[t] == f[sym] && t < sym));
    (lit ? sorted_l : sorted_d)[rank] = sym;
    atomicAdd(lit ? &m_l : &m_d, 1);
  }
  __syncthreads();
  if (threadIdx.x) return;
  int32_t* desc = desc_all + (int64_t)b * kDescWords;
  huffman_from_sorted(lf, sorted_l, m_l, 286, 15, a, len_l);
  huffman_from_sorted(df, sorted_d, m_d, 30, 15, a, len_d);
  int hlit = 257, hdist = 1;
  for (int s = 0; s < 286; ++s) if (len_l[s] && s + 1 > hlit) hlit = s + 1;
  for (int s = 0; s < 30; ++s) if (len_d[s] && s + 1 > hdist) hdist = s + 1;
  int32_t* rle = desc + dRle;
  int nr = rle_tree(len_l, hlit, rle, 0);
  nr = rle_tree(len_d, hdist, rle, nr);
  uint32_t cf[19];
  for (int s = 0; s < 19; ++s) cf[s] = 0;
  for (int r = 0; r < nr; ++r) ++cf[rle[r] & 0xFF];
  int cl_sorted[19], m_c = 0;  // insertion sort by (frequency, symbol)
  for (int s = 0; s < 19; ++s) {
    if (!cf[s]) continue;
    int k = m_c++;
    while (k > 0 && cf[cl_sorted[k - 1]] > cf[s]) { cl_sorted[k] = cl_sorted[k - 1]; --k; }
    cl_sorted[k] = s;
  }
  int len_c[19];
  huffman_from_sorted(cf, cl_sorted, m_c, 19, 7, a, len_c);
  int hclen = 19;
  while (hclen > 4 && !len_c[kClOrder[hclen - 1]]) --hclen;
  int64_t header = 5 + 5 + 4 + 3 * hclen;
  for (int r = 0; r < nr; ++r) {
    const int sym = rle[r] & 0xFF;
    header += len_c[sym] + cl_extra(sym);
  }
  int64_t data = (int64_t)extra_sum, fixed = (int64_t)extra_sum;
  for (int s = 0; s < 286; ++s) {
    data += (int64_t)lf[s] * len_l[s];
    fixed += (int64_t)lf[s] * fixed_lit_len(s);
  }
  for (int s = 0; s < 30; ++s) {
    data += (int64_t)df[s] * len_d[s];
    fixed += (int64_t)df[s] * 5;
  }
  const int64_t rawl = (int64_t)raw_sum;
  const int64_t chunks = rawl ? (rawl + kStoredMax - 1) / kStoredMax : 1;
  int kind = 2;
  int64_t bits = 3 + header + data;
  if (3 + fixed < bits) { kind = 1; bits = 3 + fixed; }
  if (stored_only || 8 * rawl + 42 * chunks < bits) kind = 0;
  len_l[286] = len_l[287] = 0;
  if (kind == 1) {  // the fixed code counts all 288 symbols
    for (int s = 0; s < 288; ++s) len_l[s] = fixed_lit_len(s);
    for (int s = 0; s < 30; ++s) len_d[s] = 5;
  }
  canonical(len_l, 288, desc + dLit);
  canonical(len_d, 30, desc + dDist);
  canonical(len_c, 19, desc + dCl);
  desc[dKind] = kind;
  desc[dBits] = (int32_t)bits;
  desc[dRawLen] = (int32_t)rawl;
  desc[dTok0] = (int32_t)t0;
  desc[dTok1] = (int32_t)t1;
  desc[dHlit] = hlit;
  desc[dHdist] = hdist;
  desc[dHclen] = hclen;
  desc[dNrle] = nr;
}

// ---------------------------------------------------------------------------
// layout, emit
// ---------------------------------------------------------------------------

__device__ __forceinline__ void put_bits(uint32_t* words, int64_t pos,
                                         uint32_t val, int width) {
  if (!width) return;
  const int64_t wi = pos >> 5;
  const int sh = (int)(pos & 31);
  atomicOr(&words[wi], val << sh);
  if (sh + width > 32) atomicOr(&words[wi + 1], val >> (32 - sh));
}

__global__ void __launch_bounds__(1024)
layout_kernel(const int64_t* total_bits, int32_t* __restrict__ desc_all,
              uint32_t* __restrict__ out, int64_t* info) {
  __shared__ int64_t out_bytes;
  const int64_t nsym = info[kSymbols];
  const int64_t nb = (nsym + kBlockSymbols - 1) / kBlockSymbols;
  if (threadIdx.x == 0) {
    int64_t bit = 0, raw = 0;
    int64_t b = 0;
    while (b < nb) {
      int32_t* d = desc_all + b * kDescWords;
      d[dRawStart] = (int32_t)raw;
      if (d[dKind]) {
        d[dStart] = (int32_t)bit;
        bit += d[dBits];
        raw += d[dRawLen];
        ++b;
        continue;
      }
      const int64_t run0 = b, run_raw = raw;
      int64_t run_len = 0;
      while (b < nb && !desc_all[b * kDescWords + dKind]) {
        int32_t* e = desc_all + b * kDescWords;
        e[dRawStart] = (int32_t)raw;
        e[dStart] = (int32_t)bit;
        e[dRunRaw] = (int32_t)run_raw;
        e[dRunOff] = (int32_t)run_len;
        run_len += e[dRawLen];
        raw += e[dRawLen];
        ++b;
      }
      for (int64_t k = run0; k < b; ++k)
        desc_all[k * kDescWords + dRunLen] = (int32_t)run_len;
      const int64_t chunks = (run_len + kStoredMax - 1) / kStoredMax;
      bit = 8 * ((bit + 3 + 7) / 8 + 4 + run_len + 5 * (chunks - 1));
    }
    const int64_t sync = (bit + 3 + 7) / 8;
    out_bytes = sync + 4;
    info[kOutBytes] = sync + 4;
    info[kBlocks] = nb;
    info[kTotalBits] = total_bits[0];
  }
  __syncthreads();
  const int64_t nwords = (out_bytes + 3) / 4 + 1;
  for (int64_t k = threadIdx.x; k < nwords; k += 1024) out[k] = 0;
  __syncthreads();
  if (threadIdx.x == 0) put_bits(out, 8 * (out_bytes - 2), 0xFFFFu, 16);
}

__global__ void __launch_bounds__(kEmitThreads)
emit_kernel(const uint8_t* __restrict__ data, const uint32_t* __restrict__ symbols,
            const int32_t* __restrict__ desc_all, const int64_t* info,
            uint32_t* __restrict__ out) {
  __shared__ int32_t lit[288], dst[30], lbase[29], dbase[30];
  __shared__ int64_t start;
  __shared__ int scan[kEmitThreads];
  const int64_t nsym = info[kSymbols];
  const int64_t nb = (nsym + kBlockSymbols - 1) / kBlockSymbols;
  const int b = blockIdx.x;
  if (b >= nb) return;
  const int32_t* d = desc_all + (int64_t)b * kDescWords;
  const int kind = d[dKind];
  if (kind == 0) {
    // this block's bytes of its stored run: chunks of 65535, each after
    // LEN and NLEN; the run's first chunk after its 3 header bits, padded
    const int64_t a0 = ((int64_t)d[dStart] + 3 + 7) / 8;
    const int64_t off = d[dRunOff], len = d[dRawLen], run_len = d[dRunLen];
    const uint8_t* src = data + d[dRawStart];
    for (int64_t k = threadIdx.x; k < len; k += kEmitThreads) {
      const int64_t r = off + k;  // offset in the run
      const int64_t c = r / kStoredMax;
      const int64_t at = a0 + 4 + r + 5 * c;
      put_bits(out, 8 * at, src[k], 8);
      if (r % kStoredMax == 0) {
        const int64_t ln = run_len - r < kStoredMax ? run_len - r : kStoredMax;
        put_bits(out, 8 * (at - 4), (uint32_t)ln | ((uint32_t)(ln ^ 0xFFFF) << 16), 32);
      }
    }
    return;
  }
  for (int s = threadIdx.x; s < 286; s += kEmitThreads) lit[s] = d[dLit + s];
  if (threadIdx.x < 30) {
    dst[threadIdx.x] = d[dDist + threadIdx.x];
    dbase[threadIdx.x] = kDBase[threadIdx.x];
  }
  if (threadIdx.x < 29) lbase[threadIdx.x] = kLBase[threadIdx.x];
  if (threadIdx.x == 0) {
    int64_t pos = d[dStart];
    if (kind == 1) {
      put_bits(out, pos, 2u, 3);
      pos += 3;
    } else {
      const int hclen = d[dHclen];
      put_bits(out, pos, 4u, 3);
      put_bits(out, pos + 3, (uint32_t)(d[dHlit] - 257), 5);
      put_bits(out, pos + 8, (uint32_t)(d[dHdist] - 1), 5);
      put_bits(out, pos + 13, (uint32_t)(hclen - 4), 4);
      pos += 17;
      const int32_t* cl = d + dCl;
      for (int k = 0; k < hclen; ++k, pos += 3)
        put_bits(out, pos, (uint32_t)cl[kClOrder[k]] >> 16, 3);
      const int nr = d[dNrle];
      for (int r = 0; r < nr; ++r) {
        const int sym = d[dRle + r] & 0xFF, ext = d[dRle + r] >> 8;
        const int w = cl[sym] >> 16;
        put_bits(out, pos, (uint32_t)cl[sym] & 0xFFFF, w);
        pos += w;
        put_bits(out, pos, (uint32_t)ext, cl_extra(sym));
        pos += cl_extra(sym);
      }
    }
    start = pos;
  }
  __syncthreads();
  const int64_t t0 = d[dTok0], t1 = d[dTok1];
  for (int64_t base = t0; base < t1; base += kEmitThreads) {
    const int64_t k = base + threadIdx.x;
    uint32_t f1 = 0, f2 = 0;
    int w1 = 0, w2 = 0;
    if (k < t1) {
      const uint32_t t = symbols[k];
      if (t >= 65536u) {
        const int len = (int)(t >> 16), dist = (int)(t & 0xFFFF);
        const int lc = len_code(len), dc = dist_code(dist);
        const int32_t c1 = lit[257 + lc], c2 = dst[dc];
        const int l1 = c1 >> 16, l2 = c2 >> 16;
        f1 = ((uint32_t)c1 & 0xFFFF) | (uint32_t)(len - lbase[lc]) << l1;
        w1 = l1 + len_extra(lc);
        f2 = ((uint32_t)c2 & 0xFFFF) | (uint32_t)(dist - dbase[dc]) << l2;
        w2 = l2 + dist_extra(dc);
      } else {
        const int32_t c1 = lit[t];
        f1 = (uint32_t)c1 & 0xFFFF;
        w1 = c1 >> 16;
      }
    }
    // exclusive scan of the symbols' widths over the block's threads
    scan[threadIdx.x] = w1 + w2;
    __syncthreads();
    for (int s = 1; s < kEmitThreads; s <<= 1) {
      const int y = threadIdx.x >= (unsigned)s ? scan[threadIdx.x - s] : 0;
      __syncthreads();
      scan[threadIdx.x] += y;
      __syncthreads();
    }
    const int64_t pos = start + scan[threadIdx.x] - (w1 + w2);
    put_bits(out, pos, f1, w1);
    put_bits(out, pos + w1, f2, w2);
    __syncthreads();
    if (threadIdx.x == kEmitThreads - 1) start += scan[kEmitThreads - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0) put_bits(out, start, (uint32_t)lit[256] & 0xFFFF, lit[256] >> 16);
}

// ---------------------------------------------------------------------------
// adler32 sums
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(256)
adler_kernel(const uint8_t* __restrict__ data, const int64_t* total_bits,
             int64_t* info) {
  const int64_t n = gop_bytes(total_bits);
  unsigned long long s1 = 0, s2 = 0;
  for (int64_t k = (int64_t)blockIdx.x * 256 + threadIdx.x; k < n;
       k += (int64_t)gridDim.x * 256) {
    const unsigned long long x = data[k];
    s1 += x;
    s2 += x * (unsigned long long)(n - k);
  }
  for (int s = 16; s; s >>= 1) {
    s1 += __shfl_down_sync(kFull, s1, s);
    s2 += __shfl_down_sync(kFull, s2, s);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(reinterpret_cast<unsigned long long*>(&info[kS1]), s1);
    atomicAdd(reinterpret_cast<unsigned long long*>(&info[kS2]), s2);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0)
    info[kTail] = (total_bits[0] & 7) ? data[n] : 0;
}

}  // namespace
}  // namespace dct3d

// data: (cap,) u8, the GOP's bytes in its first total_bits[0] / 8;
// total_bits: one i64 on the device.  prev: 2 * cap u32 (the chains as
// 3 * cap u16, then the segments' tokens and the parse's repairs); match:
// cap u32 (the matches, then the compacted symbols); seg_count: cap / 32768
// + 1 i32; pieces: (cap / 32768 + 1, 33, 4) i32; desc: (cap / 16384 + 2, 1024)
// i32; out: the span's u32 words (ops/deflate.py out_capacity); info: 8
// i64, zeroed here.  Level parameters as ops/deflate.py LEVELS.
DCT3D_EXPORT int dct3d_deflate(const void* data, const void* total_bits,
                               int cap, int greedy, int lazy, int nice,
                               int depth, void* prev, void* match,
                               void* seg_count, void* pieces, void* desc,
                               void* out, void* info, void* stream) {
  using namespace dct3d;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* d = (const uint8_t*)data;
  const int64_t* tb = (const int64_t*)total_bits;
  uint16_t* prev3 = (uint16_t*)prev;
  uint16_t* prev4 = prev3 + cap;
  uint16_t* prev8 = prev4 + cap;
  uint32_t* tokens = (uint32_t*)prev;
  uint32_t* repair = tokens + cap;
  uint32_t* m = (uint32_t*)match;
  int64_t* inf = (int64_t*)info;
  const unsigned segs = (unsigned)((cap + kSegment - 1) / kSegment);
  const unsigned blocks = (unsigned)(cap / kBlockSymbols + 2);
  const int chain_smem = (2 * kHashSize + kHash8Size) * (int)sizeof(uint16_t) + kWindow +
                         kChainTile + 8;
  const int parse_smem = kSegment * 7;
  const int match_smem = 2 * (kWindow + kMatchTile) * (int)sizeof(uint16_t) +
                         kWindow + kMatchTile + kMaxMatch + 8;
  cudaFuncSetAttribute(chains_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       chain_smem);
  cudaFuncSetAttribute(match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       match_smem);
  cudaFuncSetAttribute(parse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       parse_smem);
  cudaMemsetAsync(info, 0, 8 * sizeof(int64_t), st);
  chains_kernel<<<(unsigned)((cap + kChainTile - 1) / kChainTile), kChainThreads,
                  chain_smem, st>>>(
      d, tb, prev3, prev4, prev8);
  match_kernel<<<(unsigned)((cap + kMatchTile - 1) / kMatchTile), kMatchThreads,
                 match_smem, st>>>(d, tb, prev3, prev4, prev8, m, greedy, nice, depth);
  parse_kernel<<<segs, kParseThreads, parse_smem, st>>>(
      d, tb, m, tokens, repair, (int32_t*)pieces, (int32_t*)seg_count, greedy, lazy);
  compact_kernel<<<segs, 256, 0, st>>>(tb, tokens, repair, (int32_t*)pieces,
                                       (int32_t*)seg_count, m, inf);
  plan_kernel<<<blocks, kPlanThreads, 0, st>>>(m, inf, (int32_t*)desc, depth == 0);
  layout_kernel<<<1, 1024, 0, st>>>(tb, (int32_t*)desc, (uint32_t*)out, inf);
  emit_kernel<<<blocks, kEmitThreads, 0, st>>>(d, m, (int32_t*)desc, inf,
                                                (uint32_t*)out);
  adler_kernel<<<264, 256, 0, st>>>(d, tb, inf);
  return (int)cudaGetLastError();
}
