// K6 compact_groups: per-group exception compaction of the turbo profile.
//
// Replaces dct3d_tpu/ops/exc_pack.py:62 compact_groups_pallas (body
// _kernel).  Per group of 256 int32 values, the values outside the nibble
// range [-8, 7] are listed in stream order, skipping flat positions that are
// a multiple of dc_stride (the dense DC stream carries those); slot s of the
// group's row gets the s-th such value's lane and value, and the row's count
// is the number of such values.  Contract: ops/exc_pack.py.
//
// The TPU kernel sums one masked lane per slot over the whole block
// (slots+1 full-width reductions, because Mosaic has no scatter) and emits
// (lane << 16) | value words the wrapper unpacks.
//
// What bounds it on an H100 (3.35 TB/s): bytes.  One 1080p 8x8x8 GOP
// (64,800 groups) reads 66.4 MB of values and writes 3.4 MB of tables at 16
// slots (1 + 2 bytes a slot, 4 for the count): 20.8 us.  To reach it, each
// warp keeps 1 KB of loads in flight and waits on no block barrier.
//
// Design: one warp per group, eight groups per block.  Lane l loads values
// [8l, 8l + 8) with two 16-byte loads, tests them in registers (the DC test
// on flat index g*256 + 8l + i, by mask when dc_stride is a power of two)
// and counts its exceptions; an exclusive __shfl_up scan of the counts
// gives each exception its rank.  The lane writes its exceptions' lanes and
// values into the warp's staging rows in shared memory, and after a
// __syncwarp the warp stores the group's slots as contiguous runs, zeros
// from the count on.  No block barrier.  One kernel serves every slots value
// from 1 to 256, so the overflow retry at slots = 256 needs no second route.

#include "common.cuh"

namespace dct3d {
namespace {

constexpr int kGroupsPerBlock = 8;  // one warp per group
constexpr int kThreads = 32 * kGroupsPerBlock;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
compact_groups_kernel(const int32_t* __restrict__ values,
                      uint8_t* __restrict__ lidx, int16_t* __restrict__ vals,
                      int32_t* __restrict__ counts, int groups, int slots,
                      int dc_stride) {
  __shared__ uint8_t stage_idx[kGroupsPerBlock][kGroup];
  __shared__ int16_t stage_val[kGroupsPerBlock][kGroup];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t g = (int64_t)blockIdx.x * kGroupsPerBlock + warp;
  if (g >= groups) return;  // whole warps leave together

  int32_t v[kPerLane];
  const int64_t flat0 = g * kGroup + lane * kPerLane;
  load8(values + flat0, v);
  unsigned mask = 0;  // bit i: value i of this lane is an exception
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) mask |= (unsigned)(v[i] < -8 || v[i] > 7) << i;
  if (dc_stride > 0 && mask) {
    if ((dc_stride & (dc_stride - 1)) == 0) {
      const unsigned r0 = (unsigned)flat0 & (unsigned)(dc_stride - 1);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        if (((r0 + i) & (unsigned)(dc_stride - 1)) == 0) mask &= ~(1u << i);
    } else {
      const unsigned r0 = (unsigned)(flat0 % dc_stride);
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        if ((r0 + i) % (unsigned)dc_stride == 0) mask &= ~(1u << i);
    }
  }
  const int mine = __popc(mask);
  int incl = mine;  // inclusive scan of the lanes' exception counts
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, s);
    if (lane >= s) incl += y;
  }
  const int total = __shfl_sync(kFull, incl, 31);

  uint8_t* s_idx = stage_idx[warp];
  int16_t* s_val = stage_val[warp];
  int rank = incl - mine;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    if (mask >> i & 1) {
      if (rank < slots) {
        s_idx[rank] = (uint8_t)(lane * kPerLane + i);
        s_val[rank] = (int16_t)v[i];  // wrapping cast, as the TPU kernel's & 0xFFFF
      }
      ++rank;
    }
  }
  __syncwarp();
  uint8_t* row_idx = lidx + g * slots;
  int16_t* row_val = vals + g * slots;
  for (int s = lane; s < slots; s += 32) {
    const bool used = s < total;
    row_idx[s] = used ? s_idx[s] : (uint8_t)0;
    row_val[s] = used ? s_val[s] : (int16_t)0;
  }
  if (lane == 0) counts[g] = total;
}

}  // namespace
}  // namespace dct3d

// values: (groups, 256) i32, 16-byte aligned; lidx: (groups, slots) u8;
// vals: (groups, slots) i16; counts: (groups,) i32.  1 <= slots <= 256,
// dc_stride >= 0 (0: no DC exclusion).  Every output element is written.
DCT3D_EXPORT int dct3d_compact_groups(const void* values, void* lidx,
                                      void* vals, void* counts, int groups,
                                      int slots, int dc_stride, void* stream) {
  using namespace dct3d;
  const unsigned blocks =
      (unsigned)((groups + kGroupsPerBlock - 1) / kGroupsPerBlock);
  compact_groups_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)values, (uint8_t*)lidx, (int16_t*)vals,
      (int32_t*)counts, groups, slots, dc_stride);
  return (int)cudaGetLastError();
}
