// K2 group_pack_values and K5 group_pack_codes: level 1 of the Exp-Golomb
// bit pack.
//
// Replace dct3d_tpu/ops/group_pack.py group_pack_values_pallas (bodies
// _kernel_values, _pack_body, _cumsum_lanes) and group_pack_pallas (body
// _kernel).  Per group of 256 codewords: the in-group exclusive prefix sum
// of the field widths, and each codeword written MSB-first into at most two
// 32-bit words of a zero-filled row that starts at the group's global bit
// phase (gstart & 31).  K2 derives each codeword from an int32 coefficient
// (code = map(v) + 1, width 2*bitlen(code) - 1); K5 reads precomputed code
// and width arrays (bitpack.pack_bits: the carry pseudo-codeword and the
// zero-width pads of a batch that is not whole groups).  Word bits are
// MSB-first within a uint32 value; the byte swap to stream byte order
// happens in K3's store.
//
// The TPU kernel sums one masked select per output word (w_words unrolled
// compare/select/reduce passes) because Mosaic has no scatter, which is why
// the JAX package keeps K5 to w_words <= 64.  Here each thread adds its
// fragments into a shared-memory row with atomicAdd, one 256-thread block
// per group, and the prefix sum is a warp shuffle scan; one kernel serves
// every w_words.  Fragments are added, as the TPU kernel and the einsum
// add them, so codes with bits above their width give the same words; for
// real codewords the fragments are bit-disjoint and the sum is their OR.
// Bound: latency of the scan and the shared atomics; device memory traffic
// is 1 KB (K2) or 2 KB (K5) in and 4*w_words bytes out per group.
//
// Widths are 0..32.  A zero-width slot writes nothing (its shift could
// reach 32, which is undefined; the JAX body masks it with `where`).  Bits
// landing past word w_words-1 are dropped, as in the TPU kernel.

#include "common.cuh"

namespace dct3d {
namespace {

constexpr int kWarps = kGroup / 32;

// One thread's codeword into the group's shared row; every thread of the
// block calls it once.  `row` must hold w_words zeroed words before the
// call's __syncthreads and is complete after its second one.
__device__ __forceinline__ void pack_row(uint32_t code, int width, int phase,
                                         uint32_t* row, int w_words) {
  __shared__ int warp_total[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = width;  // inclusive scan of the widths within the warp
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();  // also orders the row zeroing before the atomics
  int off = phase + incl - width;
  for (int w = 0; w < warp; ++w) off += warp_total[w];

  const int word0 = off >> 5;
  const int over = (off & 31) + width - 32;  // bits spilling into word0 + 1
  if (width == 0) {
    // nothing to write
  } else if (over > 0) {
    // 1 <= over <= 31 here, so neither shift reaches 32.
    if (word0 < w_words) atomicAdd(&row[word0], code >> over);
    if (word0 + 1 < w_words) atomicAdd(&row[word0 + 1], code << (32 - over));
  } else if (word0 < w_words) {
    atomicAdd(&row[word0], code << -over);  // 0 <= -over <= 31
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kGroup)
group_pack_values_kernel(const int32_t* __restrict__ values,
                         const int32_t* __restrict__ phase,
                         uint32_t* __restrict__ out, int w_words) {
  extern __shared__ uint32_t row[];
  const int64_t g = blockIdx.x;
  const int t = threadIdx.x;
  for (int j = t; j < w_words; j += kGroup) row[j] = 0;
  const int v = values[g * kGroup + t];
  const uint32_t code = (uint32_t)(v > 0 ? 2 * v - 1 : -2 * v) + 1u;
  pack_row(code, 2 * (32 - __clz(code)) - 1, phase[g], row, w_words);
  for (int j = t; j < w_words; j += kGroup) out[g * w_words + j] = row[j];
}

__global__ void __launch_bounds__(kGroup)
group_pack_codes_kernel(const uint32_t* __restrict__ code,
                        const int32_t* __restrict__ width,
                        const int32_t* __restrict__ phase,
                        uint32_t* __restrict__ out, int w_words) {
  extern __shared__ uint32_t row[];
  const int64_t g = blockIdx.x;
  const int t = threadIdx.x;
  for (int j = t; j < w_words; j += kGroup) row[j] = 0;
  pack_row(code[g * kGroup + t], width[g * kGroup + t], phase[g], row,
           w_words);
  for (int j = t; j < w_words; j += kGroup) out[g * w_words + j] = row[j];
}

}  // namespace
}  // namespace dct3d

// values: (groups, 256) i32 with |v| < 2^15 (codewords of at most 31 bits);
// phase: (groups,) i32 in [0, 32); out: (groups, w_words) u32 (every word
// written).
DCT3D_EXPORT int dct3d_group_pack_values(const void* values, const void* phase,
                                         void* out, int groups, int w_words,
                                         void* stream) {
  using namespace dct3d;
  group_pack_values_kernel<<<groups, kGroup, w_words * sizeof(uint32_t),
                             (cudaStream_t)stream>>>(
      (const int32_t*)values, (const int32_t*)phase, (uint32_t*)out, w_words);
  return (int)cudaGetLastError();
}

// code: (groups, 256) u32; width: (groups, 256) i32 in [0, 32]; phase:
// (groups,) i32 in [0, 32); out: (groups, w_words) u32 (every word written).
DCT3D_EXPORT int dct3d_group_pack_codes(const void* code, const void* width,
                                        const void* phase, void* out,
                                        int groups, int w_words,
                                        void* stream) {
  using namespace dct3d;
  group_pack_codes_kernel<<<groups, kGroup, w_words * sizeof(uint32_t),
                            (cudaStream_t)stream>>>(
      (const uint32_t*)code, (const int32_t*)width, (const int32_t*)phase,
      (uint32_t*)out, w_words);
  return (int)cudaGetLastError();
}
