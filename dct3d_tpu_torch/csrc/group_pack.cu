// Level 1 of the Exp-Golomb bit pack: group_bits, K2 group_pack_values and
// K5 group_pack_codes.
//
// Replaces dct3d_tpu/ops/group_pack.py:125 group_pack_values_pallas (K2;
// bodies _kernel_values, _pack_body, _cumsum_lanes), the per-group width sum
// of dct3d_tpu/ops/bitpack.py:248 _geometry (group_bits; XLA on the TPU),
// and dct3d_tpu/ops/group_pack.py:159 group_pack_pallas (K5; body _kernel).
// Per group of 256 codewords: the in-group exclusive prefix sum of the field
// widths, and each codeword written MSB-first into the group's row of
// 32-bit words, starting at the group's global bit phase (gstart & 31).  K2
// and group_bits derive each codeword from an int32 coefficient (code =
// map(v) + 1, width 2*bitlen(code) - 1); K5 reads precomputed code and width
// arrays (bitpack.pack_bits: the carry pseudo-codeword and the zero-width
// pads of a batch that is not whole groups).  Word bits are MSB-first within
// a uint32 value; the byte swap to stream byte order happens in K3's store.
//
// What bounds them on an H100 (3.35 TB/s): bytes.  At one 1080p 8x8x8 GOP
// (64,800 groups, 16.6M values) group_bits reads the 66.4 MB of values and
// writes 0.26 MB of counts: 20 us.  K2 reads the values again and writes
// only the words that hold the group's bits, ~11 a group on the bench clip
// (2.8 MB): ~21 us.  Writing every one of a row's w_words = 218 words
// would add 54 MB (16 us) of zeros that K3 never reads, so K2 does not.
// K5, at one padded-portrait 4x4x4 GOP (46,368 groups), reads 95 MB of
// codes and widths and writes ~1.7 MB of content words: ~29 us; its whole
// rows (w_words = 186) would add 33 MB, so it too writes words [0, nw) only.
//
// Design: one warp per group, eight groups per block.  Lane l loads slots
// [8l, 8l + 8) with 16-byte loads: group_bits and K2 the values, from which
// they compute codewords and widths in registers, K5 the codes and widths.
// group_bits sums the widths with one warp reduction.  K2 and K5 scan the
// lanes' bit counts with __shfl_up (the in-group offsets), then each lane
// writes its 8 fields into the warp's row in shared memory.  Only
// __syncwarp orders the zeroing of words [0, nw), the fragments and the
// coalesced copy of those words to the output; there is no block barrier.
// The TPU kernel instead sums one masked select per output word (w_words
// unrolled compare/select/reduce passes), because Mosaic has no scatter.
//
// K2's lane runs its codewords through a 64-bit accumulator (acc << wid |
// code), storing words it covers whole and ORing its first and last
// partial words with shared atomicOr (neighbouring lanes share them).  That
// OR is right only for well-formed codewords.  K5 keeps the TPU kernel's
// sum semantics instead: each field is split into its fragment in word0
// and its spill into word0 + 1, and fragments are added, as the TPU kernel
// and the einsum add them, so codes with bits above their width give the
// same words; for real codewords the fragments are bit-disjoint and the
// sum is their OR.  A lane adds its fragments that land in one word in a
// register and puts the sum into the row with one shared atomicAdd per word
// it touches (about two per lane on typical content, against one or two
// per codeword).  Widths are 0..32; a zero-width slot writes nothing (its
// shift could reach 32, which is undefined; the JAX body masks it with
// `where`).
//
// In all three, bits landing past word w_words-1 are dropped, as in the TPU
// kernel.

#include "common.cuh"

namespace dct3d {
namespace {

constexpr int kGroupsPerBlock = 8;  // one warp per group
constexpr int kWarpThreads = 32 * kGroupsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

// Signed Exp-Golomb code number + 1 of v (ops/expgolomb.py): c = m + 1 with
// m = 2v - 1 for v > 0, else -2v; its field is 2*bitlen(c) - 1 bits.
__device__ __forceinline__ uint32_t eg_code(int32_t v) {
  return (uint32_t)(v > 0 ? 2 * v - 1 : -2 * v) + 1u;
}
__device__ __forceinline__ int eg_width(uint32_t code) {
  return 2 * (32 - __clz(code)) - 1;
}

__global__ void __launch_bounds__(kWarpThreads)
group_bits_kernel(const int32_t* __restrict__ values, int32_t* __restrict__ bits,
                  int groups) {
  const int64_t g = (int64_t)blockIdx.x * kGroupsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (g >= groups) return;  // whole warps leave together
  int32_t v[kPerLane];
  load8(values + g * kGroup + lane * kPerLane, v);
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) sum += eg_width(eg_code(v[i]));
  sum = __reduce_add_sync(kFull, sum);
  if (lane == 0) bits[g] = sum;
}

__global__ void __launch_bounds__(kWarpThreads)
group_pack_values_kernel(const int32_t* __restrict__ values,
                         const int32_t* __restrict__ phase,
                         uint32_t* __restrict__ out, int groups, int w_words) {
  extern __shared__ uint32_t rows[];  // kGroupsPerBlock rows of w_words
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t g = (int64_t)blockIdx.x * kGroupsPerBlock + warp;
  if (g >= groups) return;
  uint32_t* row = rows + warp * w_words;

  int32_t v[kPerLane];
  load8(values + g * kGroup + lane * kPerLane, v);
  uint32_t code[kPerLane];
  int wid[kPerLane], bits = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    code[i] = eg_code(v[i]);
    wid[i] = eg_width(code[i]);
    bits += wid[i];
  }
  int incl = bits;  // inclusive scan of the lanes' bit counts
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += y;
  }
  const int p0 = phase[g];
  const int end = p0 + __shfl_sync(kFull, incl, 31);  // row bit after the group
  const int nw = min((end + 31) >> 5, w_words);       // words K3 reads
  for (int j = lane; j < nw; j += 32) row[j] = 0;
  __syncwarp();

  // MSB-first bit writer: acc holds nb pending bits, right-aligned; it
  // starts with the off & 31 bits of earlier lanes as zeros.
  const int off = p0 + incl - bits;
  int word = off >> 5, nb = off & 31;
  bool shared_word = nb != 0;  // the first word holds earlier lanes' bits
  uint64_t acc = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    acc = (acc << wid[i]) | code[i];  // nb + wid <= 63
    nb += wid[i];
    if (nb >= 32) {
      nb -= 32;
      const uint32_t w = (uint32_t)(acc >> nb);
      if (word < w_words) {
        if (shared_word) atomicOr(&row[word], w);
        else row[word] = w;  // this lane covers all 32 bits
      }
      shared_word = false;
      ++word;
    }
  }
  if (nb > 0 && word < w_words) atomicOr(&row[word], (uint32_t)(acc << (32 - nb)));
  __syncwarp();
  uint32_t* dst = out + g * w_words;
  for (int j = lane; j < nw; j += 32) dst[j] = row[j];
}

// A lane's running sum for one row word: fragments of consecutive
// codewords that land in the same word are added in a register, and the
// sum goes into the shared row with one atomicAdd when the lane moves on
// (neighbouring lanes may share the word).  Words past w_words are dropped.
struct WordSum {
  int word = -1;
  uint32_t sum = 0;
  __device__ __forceinline__ void add(int w, uint32_t v, uint32_t* row,
                                      int w_words) {
    if (w != word) {
      flush(row, w_words);
      word = w;
      sum = 0;
    }
    sum += v;
  }
  __device__ __forceinline__ void flush(uint32_t* row, int w_words) const {
    if (word >= 0 && word < w_words) atomicAdd(&row[word], sum);
  }
};

__global__ void __launch_bounds__(kWarpThreads)
group_pack_codes_kernel(const int32_t* __restrict__ code,
                        const int32_t* __restrict__ width,
                        const int32_t* __restrict__ phase,
                        uint32_t* __restrict__ out, int groups, int w_words) {
  extern __shared__ uint32_t rows[];  // kGroupsPerBlock rows of w_words
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t g = (int64_t)blockIdx.x * kGroupsPerBlock + warp;
  if (g >= groups) return;  // whole warps leave together
  uint32_t* row = rows + warp * w_words;

  int32_t c[kPerLane], wid[kPerLane];
  load8(code + g * kGroup + lane * kPerLane, c);
  load8(width + g * kGroup + lane * kPerLane, wid);
  int bits = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) bits += wid[i];
  int incl = bits;  // inclusive scan of the lanes' bit counts
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += y;
  }
  const int p0 = phase[g];
  const int end = p0 + __shfl_sync(kFull, incl, 31);  // row bit after the group
  const int nw = min((end + 31) >> 5, w_words);       // words K3 reads
  for (int j = lane; j < nw; j += 32) row[j] = 0;
  __syncwarp();

  int off = p0 + incl - bits;
  WordSum acc;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const uint32_t v = (uint32_t)c[i];
    const int word0 = off >> 5;
    const int over = (off & 31) + wid[i] - 32;  // bits spilling into word0 + 1
    if (wid[i] == 0) {
      // nothing to write
    } else if (over > 0) {
      // 1 <= over <= 31 here, so neither shift reaches 32.
      acc.add(word0, v >> over, row, w_words);
      acc.add(word0 + 1, v << (32 - over), row, w_words);
    } else {
      acc.add(word0, v << -over, row, w_words);  // 0 <= -over <= 31
    }
    off += wid[i];
  }
  acc.flush(row, w_words);
  __syncwarp();
  uint32_t* dst = out + g * w_words;
  for (int j = lane; j < nw; j += 32) dst[j] = row[j];
}

unsigned warp_blocks(int groups) {
  return (unsigned)((groups + kGroupsPerBlock - 1) / kGroupsPerBlock);
}

}  // namespace
}  // namespace dct3d

// values: (groups, 256) i32, 16-byte aligned; bits: (groups,) i32, each
// group's codeword bits (sum of 2*bitlen(map(v) + 1) - 1).
DCT3D_EXPORT int dct3d_group_bits(const void* values, void* bits, int groups,
                                  void* stream) {
  using namespace dct3d;
  group_bits_kernel<<<warp_blocks(groups), kWarpThreads, 0,
                      (cudaStream_t)stream>>>((const int32_t*)values,
                                              (int32_t*)bits, groups);
  return (int)cudaGetLastError();
}

// values: (groups, 256) i32 with |v| < 2^15 (codewords of at most 31 bits),
// 16-byte aligned; phase: (groups,) i32 in [0, 32); out: (groups, w_words)
// u32.  Words [0, nw) of each row are written, nw = ceil((phase + bits) /
// 32) capped at w_words (exactly the words K3 reads); the rest are left
// as they were.
DCT3D_EXPORT int dct3d_group_pack_values(const void* values, const void* phase,
                                         void* out, int groups, int w_words,
                                         void* stream) {
  using namespace dct3d;
  group_pack_values_kernel<<<warp_blocks(groups), kWarpThreads,
                             kGroupsPerBlock * w_words * sizeof(uint32_t),
                             (cudaStream_t)stream>>>(
      (const int32_t*)values, (const int32_t*)phase, (uint32_t*)out, groups,
      w_words);
  return (int)cudaGetLastError();
}

// code: (groups, 256) u32 and width: (groups, 256) i32 in [0, 32], both
// 16-byte aligned; phase: (groups,) i32 in [0, 32); out: (groups, w_words)
// u32.  Words [0, nw) of each row are written, nw = ceil((phase + bits) /
// 32) capped at w_words, bits the sum of the row's widths (exactly the
// words K3 reads); the rest are left as they were.
DCT3D_EXPORT int dct3d_group_pack_codes(const void* code, const void* width,
                                        const void* phase, void* out,
                                        int groups, int w_words,
                                        void* stream) {
  using namespace dct3d;
  group_pack_codes_kernel<<<warp_blocks(groups), kWarpThreads,
                            kGroupsPerBlock * w_words * sizeof(uint32_t),
                            (cudaStream_t)stream>>>(
      (const int32_t*)code, (const int32_t*)width, (const int32_t*)phase,
      (uint32_t*)out, groups, w_words);
  return (int)cudaGetLastError();
}
