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
// Each is one template with two forms: float32 cubes (the reference
// profile) and bfloat16 cubes (the bf16 profile, compute_dtype="bfloat16",
// which the JAX package runs through the same TPU kernels and a cast).
// Every uint8 pixel is exact in bfloat16 (8 significant bits), and every
// bfloat16 value is exact in float32, so the forms cast, clamp and
// truncate exactly as the plain versions do.
//
// Bound: bytes.  A 1080p GOP is 16.6 MB of u8 frames and 66.4 MB of f32
// cubes (33.2 MB in bf16).  Design: one block per (GOP, block row, run of
// kChunk block columns) stages the 8 frames x 8 rows x (8*kChunk) bytes in
// shared memory with 8-byte loads along the rows (neighbouring threads on
// neighbouring addresses), then walks the cubes with 16-byte accesses (4
// f32 pixels, or 8 bf16 pixels: one cube row), so both the frame side and
// the cube side are coalesced.

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

// bfloat16 bits of an integer 0..255: the upper half of its float32 bits
// (exact, the lower half is zero).
__device__ __forceinline__ uint32_t bf16_bits(uint32_t b) {
  return __float_as_uint((float)b) >> 16;
}

// Two bfloat16 pixels (low half first) -> two clamped, truncated bytes.
__device__ __forceinline__ uint32_t bf16x2_to_u8x2(uint32_t v) {
  return clamp_trunc_u8(__uint_as_float(v << 16)) |
         (clamp_trunc_u8(__uint_as_float(v & 0xffff0000u)) << 8);
}

// Pixels of type T in one 16-byte access, and such accesses per cube.
template <typename T>
constexpr int kPix = 16 / (int)sizeof(T);
template <typename T>
constexpr int kUnits = kCube / kPix<T>;

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

// T: float (cube elements float32) or uint16_t (bfloat16 bits).
template <typename T>
__global__ void __launch_bounds__(kThreads)
frames_to_cubes_kernel(const uint8_t* __restrict__ frames,
                       T* __restrict__ cubes, int32_t* __restrict__ sums,
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
  // Access u of a cube holds elements kPix*u.. = cube row r = kPix*u/8
  // (frame r/8, row r%8; intra-cube layout [frame][row][col]): in f32 half
  // of it (word u%2), in bf16 all of it.
  for (int e = threadIdx.x; e < kUnits<T> * p.ncols; e += kThreads) {
    const int c = e / kUnits<T>, u = e % kUnits<T>;
    const int r = u * kPix<T> / kEdge;
    const uint2 row = tile.row[r >> 3][r & 7][c];
    uint4 v;
    if constexpr (kPix<T> == 4) {
      const uint32_t w = (u & 1) ? row.y : row.x;
      v = make_uint4(__float_as_uint((float)(w & 255)),
                     __float_as_uint((float)((w >> 8) & 255)),
                     __float_as_uint((float)((w >> 16) & 255)),
                     __float_as_uint((float)(w >> 24)));
    } else {
      v = make_uint4(bf16_bits(row.x & 255) | (bf16_bits((row.x >> 8) & 255) << 16),
                     bf16_bits((row.x >> 16) & 255) | (bf16_bits(row.x >> 24) << 16),
                     bf16_bits(row.y & 255) | (bf16_bits((row.y >> 8) & 255) << 16),
                     bf16_bits((row.y >> 16) & 255) | (bf16_bits(row.y >> 24) << 16));
    }
    reinterpret_cast<uint4*>(cubes + (p.cube0 + c) * kCube)[u] = v;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
cubes_to_frames_kernel(const T* __restrict__ pixels,
                       uint8_t* __restrict__ frames, int height, int width,
                       int nbh, int nbw, int nchunks) {
  __shared__ Tile tile;
  const Place p = place(nbh, nbw, nchunks);
  for (int e = threadIdx.x; e < kUnits<T> * p.ncols; e += kThreads) {
    const int c = e / kUnits<T>, u = e % kUnits<T>;
    const int r = u * kPix<T> / kEdge;
    const uint4 v =
        reinterpret_cast<const uint4*>(pixels + (p.cube0 + c) * kCube)[u];
    uint2& row = tile.row[r >> 3][r & 7][c];
    if constexpr (kPix<T> == 4) {
      const uint32_t w = clamp_trunc_u8(__uint_as_float(v.x)) |
                         (clamp_trunc_u8(__uint_as_float(v.y)) << 8) |
                         (clamp_trunc_u8(__uint_as_float(v.z)) << 16) |
                         (clamp_trunc_u8(__uint_as_float(v.w)) << 24);
      if (u & 1) row.y = w; else row.x = w;
    } else {
      row = make_uint2(bf16x2_to_u8x2(v.x) | (bf16x2_to_u8x2(v.y) << 16),
                       bf16x2_to_u8x2(v.z) | (bf16x2_to_u8x2(v.w) << 16));
    }
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

template <typename T>
int launch_frames_to_cubes(const void* frames, void* cubes, void* sums,
                           int gops, int height, int width, void* stream) {
  int nchunks;
  const int64_t blocks = grid_for(gops, height, width, &nchunks);
  frames_to_cubes_kernel<T><<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const uint8_t*)frames, (T*)cubes, (int32_t*)sums, height, width,
      height / kEdge, width / kEdge, nchunks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cubes_to_frames(const void* pixels, void* frames, int gops,
                           int height, int width, void* stream) {
  int nchunks;
  const int64_t blocks = grid_for(gops, height, width, &nchunks);
  cubes_to_frames_kernel<T><<<(unsigned)blocks, kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const T*)pixels, (uint8_t*)frames, height, width, height / kEdge,
      width / kEdge, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dct3d

// frames: (gops*8, height, width) u8, 8-byte aligned; cubes: (n, 512) f32
// (bf16: _bf16 form), 16-byte aligned; sums: (n,) i32, n = gops * height/8
// * width/8.  height, width % 8 == 0.
DCT3D_EXPORT int dct3d_frames_to_cubes(const void* frames, void* cubes,
                                       void* sums, int gops, int height,
                                       int width, void* stream) {
  return dct3d::launch_frames_to_cubes<float>(frames, cubes, sums, gops,
                                              height, width, stream);
}

DCT3D_EXPORT int dct3d_frames_to_cubes_bf16(const void* frames, void* cubes,
                                            void* sums, int gops, int height,
                                            int width, void* stream) {
  return dct3d::launch_frames_to_cubes<uint16_t>(frames, cubes, sums, gops,
                                                 height, width, stream);
}

// pixels: (n, 512) f32 (bf16: _bf16 form) natural cube order, 16-byte
// aligned; frames: (gops*8, height, width) u8.
DCT3D_EXPORT int dct3d_cubes_to_frames(const void* pixels, void* frames,
                                       int gops, int height, int width,
                                       void* stream) {
  return dct3d::launch_cubes_to_frames<float>(pixels, frames, gops, height,
                                              width, stream);
}

DCT3D_EXPORT int dct3d_cubes_to_frames_bf16(const void* pixels, void* frames,
                                            int gops, int height, int width,
                                            void* stream) {
  return dct3d::launch_cubes_to_frames<uint16_t>(pixels, frames, gops, height,
                                                 width, stream);
}

DCT3D_EXPORT const char* dct3d_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
