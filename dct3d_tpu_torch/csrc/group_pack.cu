// K2 group_pack_values: level 1 of the Exp-Golomb bit pack.
//
// Replaces dct3d_tpu/ops/group_pack.py group_pack_values_pallas (bodies
// _kernel_values, _pack_body, _cumsum_lanes).  Per group of 256 int32
// coefficients: the signed Exp-Golomb code number code = map(v) + 1 and its
// field width 2*bitlen(code) - 1, the in-group exclusive prefix sum of the
// widths, and each codeword written MSB-first into at most two 32-bit words
// of a zero-filled row that starts at the group's global bit phase
// (gstart & 31).  Word bits are MSB-first within a uint32 value; the byte
// swap to stream byte order happens in K3's store.
//
// The TPU kernel sums one masked select per output word (w_words unrolled
// compare/select/reduce passes) because Mosaic has no scatter; here each
// thread ORs its codeword into a shared-memory row with atomicOr, one
// 256-thread block per group, and the prefix sum is a warp shuffle scan.
// Bound: latency of the scan and the shared atomics; device memory traffic
// is 1 KB in and 4*w_words bytes out per group.
//
// Codewords must be at most 32 bits wide (|v| < 2^15; quantized 8x8x8
// coefficients of 8-bit video are at most 27).  Bits landing past word
// w_words-1 are dropped, as in the TPU kernel.

#include "common.cuh"

namespace dct3d {
namespace {

constexpr int kWarps = kGroup / 32;

__global__ void __launch_bounds__(kGroup)
group_pack_values_kernel(const int32_t* __restrict__ values,
                         const int32_t* __restrict__ phase,
                         uint32_t* __restrict__ out, int w_words) {
  extern __shared__ uint32_t row[];
  __shared__ int warp_total[kWarps];
  const int64_t g = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int j = t; j < w_words; j += kGroup) row[j] = 0;

  const int v = values[g * kGroup + t];
  const uint32_t code = (uint32_t)(v > 0 ? 2 * v - 1 : -2 * v) + 1u;
  const int width = 2 * (32 - __clz(code)) - 1;

  int incl = width;  // inclusive scan of the widths within the warp
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();  // also orders the row zeroing before the atomics
  int off = phase[g] + incl - width;
  for (int w = 0; w < warp; ++w) off += warp_total[w];

  const int word0 = off >> 5;
  const int over = (off & 31) + width - 32;  // bits spilling into word0 + 1
  if (over > 0) {
    // 1 <= over <= 31 here, so neither shift reaches 32 (the JAX body masks
    // the undefined shift-by-32 with `where`; this branch never forms it).
    if (word0 < w_words) atomicOr(&row[word0], code >> over);
    if (word0 + 1 < w_words) atomicOr(&row[word0 + 1], code << (32 - over));
  } else if (word0 < w_words) {
    atomicOr(&row[word0], code << -over);
  }
  __syncthreads();
  for (int j = t; j < w_words; j += kGroup) out[g * w_words + j] = row[j];
}

}  // namespace
}  // namespace dct3d

// values: (groups, 256) i32; phase: (groups,) i32 in [0, 32);
// out: (groups, w_words) u32 (every word written).
DCT3D_EXPORT int dct3d_group_pack_values(const void* values, const void* phase,
                                         void* out, int groups, int w_words,
                                         void* stream) {
  using namespace dct3d;
  group_pack_values_kernel<<<groups, kGroup, w_words * sizeof(uint32_t),
                             (cudaStream_t)stream>>>(
      (const int32_t*)values, (const int32_t*)phase, (uint32_t*)out, w_words);
  return (int)cudaGetLastError();
}
