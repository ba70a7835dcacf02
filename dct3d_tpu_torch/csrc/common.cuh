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

}  // namespace dct3d
