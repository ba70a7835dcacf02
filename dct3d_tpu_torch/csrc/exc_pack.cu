// K6 compact_groups: per-group exception compaction of the turbo profile.
//
// Replaces dct3d_tpu/ops/exc_pack.py compact_groups_pallas (body _kernel).
// Per group of 256 int32 values, the values outside the nibble range
// [-8, 7] are listed in stream order, skipping flat positions that are a
// multiple of dc_stride (the dense DC stream carries those); slot s of the
// group's row gets the s-th such value's lane and value, and the row's
// count is the number of such values.  Contract: ops/exc_pack.py.
//
// The TPU kernel sums one masked lane per slot over the whole block
// (slots+1 full-width reductions, because Mosaic has no scatter) and emits
// (lane << 16) | value words the wrapper unpacks.  Here the exclusive rank
// of every exception in its group is a warp ballot and popcount plus the
// preceding warps' counts from shared memory, and each exception writes its
// own slot directly: one read of the values, one write of the tables.
//
// One 256-thread block per group, one value per thread.  Bound: bytes (a
// 1080p GOP reads 66 MB of values and writes 3.4 MB of tables at 16 slots).
// The same kernel serves every slots value from 1 to 256, so the overflow
// retry at slots = 256 needs no second route.

#include "common.cuh"

namespace dct3d {
namespace {

constexpr int kThreads = kGroup;  // one thread per value of the group
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
compact_groups_kernel(const int32_t* __restrict__ values,
                      uint8_t* __restrict__ lidx, int16_t* __restrict__ vals,
                      int32_t* __restrict__ counts, int slots, int dc_stride) {
  __shared__ int warp_count[kWarps];
  const int64_t g = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t v = values[g * kGroup + lane];
  bool exc = v < -8 || v > 7;
  if (dc_stride > 0) {
    const int64_t flat = g * kGroup + lane;
    const int64_t rem = (dc_stride & (dc_stride - 1)) == 0
                            ? (flat & (dc_stride - 1))
                            : flat % dc_stride;
    exc = exc && rem != 0;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, exc);
  const int w = lane >> 5, l = lane & 31;
  if (l == 0) warp_count[w] = __popc(ballot);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    const int c = warp_count[i];
    before += i < w ? c : 0;
    total += c;
  }
  const int rank = before + __popc(ballot & ((1u << l) - 1u));
  uint8_t* row_idx = lidx + g * slots;
  int16_t* row_val = vals + g * slots;
  if (exc && rank < slots) {
    row_idx[rank] = (uint8_t)lane;
    row_val[rank] = (int16_t)v;  // wrapping cast, as the TPU kernel's & 0xFFFF
  }
  for (int s = total + lane; s < slots; s += kThreads) {  // zero padding
    row_idx[s] = 0;
    row_val[s] = 0;
  }
  if (lane == 0) counts[g] = total;
}

}  // namespace
}  // namespace dct3d

// values: (groups, 256) i32; lidx: (groups, slots) u8; vals: (groups, slots)
// i16; counts: (groups,) i32.  1 <= slots <= 256, dc_stride >= 0 (0: no DC
// exclusion).  Every output element is written.
DCT3D_EXPORT int dct3d_compact_groups(const void* values, void* lidx,
                                      void* vals, void* counts, int groups,
                                      int slots, int dc_stride, void* stream) {
  using namespace dct3d;
  compact_groups_kernel<<<(unsigned)groups, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)values, (uint8_t*)lidx, (int16_t*)vals,
      (int32_t*)counts, slots, dc_stride);
  return (int)cudaGetLastError();
}
