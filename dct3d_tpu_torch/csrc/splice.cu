// K3 splice: level 2 of the Exp-Golomb bit pack.
//
// Replaces dct3d_tpu/ops/splice.py splice (body _kernel), the level-2
// design that Mosaic rejected on the TPU (data-dependent word offsets are
// not VMEM-tile aligned), so the JAX package runs the XLA row gather
// bitpack._place instead.  Contract: bitpack.pack_values' stream buffer.
//
// Each group's words were packed by K2 (or K5) at the group's global bit
// phase, so word j of group g IS stream word sw[g] + j.  Only words
// [0, nw) of a row are read, nw the words through the one holding bit
// gend - 1: K2 defines exactly those and leaves the rest of the row
// unwritten.  Only a group's first and last
// word can hold another group's bits: the TPU kernel runs its grid in order
// and carries that shared word in scratch memory, but blocks here run in no
// order, so those two words are merged with atomicOr into a zeroed buffer
// and the interior words are plain stores.  Words are byte-swapped on the
// way out (MSB-first stream: byte 4w is bits 31..24 of word w, as
// bitpack._place emits them), so the buffer reads as the stream's bytes.
//
// One warp per group; lanes copy consecutive words.  Bound: launch latency
// and the few words per group (about 1.2 bits per value on typical content,
// ~10 words per group); device traffic is the stream itself.

#include "common.cuh"

namespace dct3d {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
splice_kernel(const uint32_t* __restrict__ groups_buf,
              const int32_t* __restrict__ sw, const int32_t* __restrict__ gend,
              uint32_t* __restrict__ out, int groups, int w_words,
              int nwords) {
  const int64_t g = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= groups) return;
  const int start = sw[g];
  // Words from the start word through the word holding bit gend - 1.
  const int nw = ((gend[g] - 1) >> 5) - start + 1;
  const uint32_t* src = groups_buf + g * w_words;
  for (int j = lane; j < nw && j < w_words && start + j < nwords; j += 32) {
    const uint32_t v = __byte_perm(src[j], 0, 0x0123);
    if (j == 0 || j == nw - 1) {
      atomicOr(&out[start + j], v);
    } else {
      out[start + j] = v;
    }
  }
}

}  // namespace
}  // namespace dct3d

// groups_buf: (groups, w_words) u32 from K2 or K5 (carry lead already in
// word 0 of group 0), words past each group's content unread; sw: (groups,)
// i32 start word; gend: (groups,) i32 end bit (exclusive); out: (nwords,)
// u32, ZEROED by the caller.
DCT3D_EXPORT int dct3d_splice(const void* groups_buf, const void* sw,
                              const void* gend, void* out, int groups,
                              int w_words, int nwords, void* stream) {
  using namespace dct3d;
  const int64_t blocks = ((int64_t)groups * 32 + kThreads - 1) / kThreads;
  splice_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)groups_buf, (const int32_t*)sw, (const int32_t*)gend,
      (uint32_t*)out, groups, w_words, nwords);
  return (int)cudaGetLastError();
}
