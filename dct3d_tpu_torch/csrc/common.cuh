// Shared definitions of the port's Hopper kernels.
//
// Every kernel is exported through a plain C entry point that takes raw
// device pointers and the launching stream (cudaStream_t passed as void*),
// launches on that stream, never synchronises, allocates nothing, and
// returns cudaGetLastError() so the ctypes wrapper can raise on a refused
// launch.  Built by dct3d_tpu_torch/kernels.py: each source with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -c -o <source>.o csrc/<source>.cu
// (all at once), then the objects linked with -shared into
// _build/libkernels.so.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define DCT3D_EXPORT extern "C" __attribute__((visibility("default")))

namespace dct3d {

// Cube edge and size of the reference profile (8x8x8 cubes).
constexpr int kEdge = 8;
constexpr int kCube = kEdge * kEdge * kEdge;

// Codewords per level-1 bit-pack group (bitpack.pack_values' `group`).
constexpr int kGroup = 256;

// Warp-per-group kernels (K2, group_bits, K5, K6): lane l holds values
// [8l, 8l + 8) of its group, loaded as two 16-byte loads.
constexpr int kPerLane = kGroup / 32;

// The 8 int32 values at p, which must be 16-byte aligned (the wrappers
// check the base pointer; a group's row is 1 KB).
__device__ __forceinline__ void load8(const int32_t* __restrict__ p,
                                      int32_t (&v)[kPerLane]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

}  // namespace dct3d
