// K7 plane_to_wire and K8 wire_to_plane: the turbo wire's byte transpose.
//
// Replaces dct3d_tpu/ops/relayout.py plane_to_wire (body _wire_peel_kernel)
// and wire_words (body _wire_kernel; wire_to_plane bitcasts its words).
// The turbo member stores the (cubes, 256) nibble plane transposed,
// coefficient-pair-major: wire byte [p, c] is plane byte [c, p].  Mosaic
// cannot transpose bytes, so the TPU kernels transpose int32 words (four
// plane bytes each) and peel or pack the bytes with shifts around it, and
// pad the cube axis to 128.  Here the transpose is direct, on bytes.
//
// Bound: bytes (8.3 MB each way for a 1080p GOP).  Design: one 256-thread
// block per 64 x 64-byte tile; the tile is read along the input rows with
// 4-byte loads into shared memory, then written along the output rows with
// 4-byte stores, each store gathering one byte from four tile rows.  Edge
// tiles are masked, so any cube count works without a padded copy; where a
// row length is not a multiple of 4 (odd cube counts), that side falls back
// to byte accesses.

#include "common.cuh"

namespace dct3d {
namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kPitch = kTile + 4;  // bytes per shared row (4-byte aligned)

// in: (rows, cols) u8 -> out: (cols, rows) u8.  kVecIn needs cols % 4 == 0,
// kVecOut needs rows % 4 == 0 (and 4-byte aligned bases).
template <bool kVecIn, bool kVecOut>
__global__ void __launch_bounds__(kThreads)
transpose_u8_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int rows, int cols, int col_tiles) {
  __shared__ __align__(16) uint8_t tile[kTile][kPitch];
  const int r0 = (blockIdx.x / col_tiles) * kTile;
  const int c0 = (blockIdx.x % col_tiles) * kTile;
  if (kVecIn) {
    for (int e = threadIdx.x; e < kTile * kTile / 4; e += kThreads) {
      const int r = e / (kTile / 4), c = (e % (kTile / 4)) * 4;
      if (r0 + r < rows && c0 + c < cols) {
        *reinterpret_cast<uint32_t*>(&tile[r][c]) =
            *reinterpret_cast<const uint32_t*>(in + (int64_t)(r0 + r) * cols +
                                               c0 + c);
      }
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int r = e / kTile, c = e % kTile;
      if (r0 + r < rows && c0 + c < cols) {
        tile[r][c] = in[(int64_t)(r0 + r) * cols + c0 + c];
      }
    }
  }
  __syncthreads();
  if (kVecOut) {
    for (int e = threadIdx.x; e < kTile * kTile / 4; e += kThreads) {
      const int c = e / (kTile / 4), r = (e % (kTile / 4)) * 4;
      if (c0 + c < cols && r0 + r < rows) {
        const uint32_t w = (uint32_t)tile[r][c] |
                           ((uint32_t)tile[r + 1][c] << 8) |
                           ((uint32_t)tile[r + 2][c] << 16) |
                           ((uint32_t)tile[r + 3][c] << 24);
        *reinterpret_cast<uint32_t*>(out + (int64_t)(c0 + c) * rows + r0 + r) =
            w;
      }
    }
  } else {
    for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
      const int c = e / kTile, r = e % kTile;
      if (c0 + c < cols && r0 + r < rows) {
        out[(int64_t)(c0 + c) * rows + r0 + r] = tile[r][c];
      }
    }
  }
}

int launch_transpose(const void* in, void* out, int rows, int cols,
                     cudaStream_t stream) {
  const int col_tiles = (cols + kTile - 1) / kTile;
  const int64_t blocks = (int64_t)((rows + kTile - 1) / kTile) * col_tiles;
  const bool vin = cols % 4 == 0 && (uintptr_t)in % 4 == 0;
  const bool vout = rows % 4 == 0 && (uintptr_t)out % 4 == 0;
  const uint8_t* src = (const uint8_t*)in;
  uint8_t* dst = (uint8_t*)out;
  if (vin && vout) {
    transpose_u8_kernel<true, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        src, dst, rows, cols, col_tiles);
  } else if (vin) {
    transpose_u8_kernel<true, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        src, dst, rows, cols, col_tiles);
  } else if (vout) {
    transpose_u8_kernel<false, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        src, dst, rows, cols, col_tiles);
  } else {
    transpose_u8_kernel<false, false><<<(unsigned)blocks, kThreads, 0,
                                        stream>>>(src, dst, rows, cols,
                                                  col_tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dct3d

// plane: (cubes, hc) u8 transport nibble plane -> wire: (hc, cubes) u8.
DCT3D_EXPORT int dct3d_plane_to_wire(const void* plane, void* wire, int cubes,
                                     int hc, void* stream) {
  return dct3d::launch_transpose(plane, wire, cubes, hc, (cudaStream_t)stream);
}

// wire: (hc, cubes) u8 -> plane: (cubes, hc) u8.
DCT3D_EXPORT int dct3d_wire_to_plane(const void* wire, void* plane, int cubes,
                                     int hc, void* stream) {
  return dct3d::launch_transpose(wire, plane, hc, cubes, (cudaStream_t)stream);
}
