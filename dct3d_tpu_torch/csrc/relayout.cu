// K1 frames_to_cubes and K4 cubes_to_frames: the frame <-> cube relayout.
//
// Replaces dct3d_tpu/ops/relayout.py frames_to_cubes_perm (+ the one-hot
// unscramble_matrix matmul and the f32 cast in codec/transform._frames_to_q)
// and cubes_perm_to_frames (+ the inv_sigma column permutation and the clamp
// / truncating cast of codec/transform._finish_frames).  The TPU kernels
// emit a sigma-permuted column order because Mosaic cannot express the cube
// byte order; here every thread computes its own offsets, so both kernels
// produce the natural order of codec/framing.py directly.
//
// Bound: bytes.  A 1080p GOP is 16.6 MB of u8 frames and 66 MB of f32
// cubes.  Design: one block per (GOP, block row, run of kChunk block
// columns) stages the 8 frames x 8 rows x (8*kChunk) bytes in shared memory
// with 8-byte loads along the rows (neighbouring threads on neighbouring
// addresses), then walks the cubes with 16-byte float4 accesses, so both
// the frame side and the cube side are coalesced.

#include "common.cuh"

namespace dct3d {
namespace {

constexpr int kChunk = 16;   // block columns (cubes) per thread block
constexpr int kThreads = 256;

// One 8-byte cube row per entry: tile[k][i][c] holds frame k, row i of cube c.
struct Tile {
  uint2 row[kEdge][kEdge][kChunk];
};

__device__ __forceinline__ int byte_sum(uint32_t w) {
  return (w & 255) + ((w >> 8) & 255) + ((w >> 16) & 255) + (w >> 24);
}

__device__ __forceinline__ uint32_t clamp_trunc_u8(float x) {
  // jnp.clip(x, 0, 255).astype(uint8): clamp, then truncate toward zero.
  return (uint32_t)__float2int_rz(fminf(fmaxf(x, 0.0f), 255.0f));
}

struct Place {
  int64_t frame0;  // first frame of the GOP
  int by;          // block row
  int bx0;         // first block column of this thread block
  int ncols;       // block columns this thread block covers (<= kChunk)
  int64_t cube0;   // index of the first cube this thread block covers
};

__device__ __forceinline__ Place place(int nbh, int nbw, int nchunks) {
  int b = blockIdx.x;
  const int chunk = b % nchunks;
  b /= nchunks;
  Place p;
  p.by = b % nbh;
  const int g = b / nbh;
  p.frame0 = (int64_t)g * kEdge;
  p.bx0 = chunk * kChunk;
  p.ncols = min(kChunk, nbw - p.bx0);
  p.cube0 = ((int64_t)g * nbh + p.by) * nbw + p.bx0;
  return p;
}

__global__ void __launch_bounds__(kThreads)
frames_to_cubes_kernel(const uint8_t* __restrict__ frames,
                       float* __restrict__ cubes, int32_t* __restrict__ sums,
                       int height, int width, int nbh, int nbw, int nchunks) {
  __shared__ Tile tile;
  const Place p = place(nbh, nbw, nchunks);
  for (int e = threadIdx.x; e < kEdge * kEdge * kChunk; e += kThreads) {
    const int c = e % kChunk, i = (e / kChunk) % kEdge, k = e / (kChunk * kEdge);
    if (c < p.ncols) {
      const int64_t row = ((p.frame0 + k) * height + p.by * kEdge + i) * width;
      tile.row[k][i][c] = *reinterpret_cast<const uint2*>(
          frames + row + (int64_t)(p.bx0 + c) * kEdge);
    }
  }
  __syncthreads();
  // float4 q of a cube holds elements 4q..4q+3 = frame q/16, row (q/2)%8,
  // columns 4*(q%2)..+3 (intra-cube layout [frame][row][col]).
  for (int e = threadIdx.x; e < (kCube / 4) * p.ncols; e += kThreads) {
    const int c = e / (kCube / 4), q = e % (kCube / 4);
    const uint2 r = tile.row[q >> 4][(q >> 1) & 7][c];
    const uint32_t w = (q & 1) ? r.y : r.x;
    reinterpret_cast<float4*>(cubes + (p.cube0 + c) * kCube)[q] = make_float4(
        (float)(w & 255), (float)((w >> 8) & 255), (float)((w >> 16) & 255),
        (float)(w >> 24));
  }
  // Exact integer pixel sum of each cube (exact_dc_quant's input): one warp
  // per cube, 64 rows of 8 bytes over 32 lanes.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < p.ncols; c += kThreads / 32) {
    int s = 0;
    for (int r = lane; r < kEdge * kEdge; r += 32) {
      const uint2 v = tile.row[r >> 3][r & 7][c];
      s += byte_sum(v.x) + byte_sum(v.y);
    }
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) sums[p.cube0 + c] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
cubes_to_frames_kernel(const float* __restrict__ pixels,
                       uint8_t* __restrict__ frames, int height, int width,
                       int nbh, int nbw, int nchunks) {
  __shared__ Tile tile;
  const Place p = place(nbh, nbw, nchunks);
  for (int e = threadIdx.x; e < (kCube / 4) * p.ncols; e += kThreads) {
    const int c = e / (kCube / 4), q = e % (kCube / 4);
    const float4 f =
        reinterpret_cast<const float4*>(pixels + (p.cube0 + c) * kCube)[q];
    const uint32_t w = clamp_trunc_u8(f.x) | (clamp_trunc_u8(f.y) << 8) |
                       (clamp_trunc_u8(f.z) << 16) | (clamp_trunc_u8(f.w) << 24);
    uint2& r = tile.row[q >> 4][(q >> 1) & 7][c];
    if (q & 1) r.y = w; else r.x = w;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kEdge * kEdge * kChunk; e += kThreads) {
    const int c = e % kChunk, i = (e / kChunk) % kEdge, k = e / (kChunk * kEdge);
    if (c < p.ncols) {
      const int64_t row = ((p.frame0 + k) * height + p.by * kEdge + i) * width;
      *reinterpret_cast<uint2*>(frames + row + (int64_t)(p.bx0 + c) * kEdge) =
          tile.row[k][i][c];
    }
  }
}

int64_t grid_for(int gops, int height, int width, int* nchunks) {
  *nchunks = (width / kEdge + kChunk - 1) / kChunk;
  return (int64_t)gops * (height / kEdge) * *nchunks;
}

}  // namespace
}  // namespace dct3d

// frames: (gops*8, height, width) u8, 8-byte aligned; cubes: (n, 512) f32;
// sums: (n,) i32, n = gops * height/8 * width/8.  height, width % 8 == 0.
DCT3D_EXPORT int dct3d_frames_to_cubes(const void* frames, void* cubes,
                                       void* sums, int gops, int height,
                                       int width, void* stream) {
  using namespace dct3d;
  int nchunks;
  const int64_t blocks = grid_for(gops, height, width, &nchunks);
  frames_to_cubes_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (float*)cubes, (int32_t*)sums, height, width,
      height / kEdge, width / kEdge, nchunks);
  return (int)cudaGetLastError();
}

// pixels: (n, 512) f32 natural cube order; frames: (gops*8, height, width) u8.
DCT3D_EXPORT int dct3d_cubes_to_frames(const void* pixels, void* frames,
                                       int gops, int height, int width,
                                       void* stream) {
  using namespace dct3d;
  int nchunks;
  const int64_t blocks = grid_for(gops, height, width, &nchunks);
  cubes_to_frames_kernel<<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)pixels, (uint8_t*)frames, height, width, height / kEdge,
      width / kEdge, nchunks);
  return (int)cudaGetLastError();
}

DCT3D_EXPORT const char* dct3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
