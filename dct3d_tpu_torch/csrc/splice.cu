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
// gend - 1: K2 and K5 define exactly those (bits past the group's end in
// the last of them zero) and leave the rest of the row unwritten.
//
// Output contract: stream words [0, ceil(total_bits / 32)) are each
// written exactly once, total_bits = gend[groups - 1]; words past them are
// unspecified, as in the TPU kernel.  Words are byte-swapped on the way out
// (MSB-first stream: byte 4w is bits 31..24 of word w, as bitpack._place
// emits them), so the buffer reads as the stream's bytes.
//
// Design: each stream word has one writer, the group in which the word
// starts ("owner writes").  The groups tile the stream (group g + 1 starts
// at bit gend[g]), so group g owns words [ceil(gend[g-1] / 32),
// ceil(gend[g] / 32)) (group 0 from word 0, for the carry bits before it),
// and consecutive groups own consecutive runs.  An owned word is the
// group's row word, ORed in its last owned word with word 0 of group g + 1
// when gend[g] is not word-aligned.  That covers every bit because at most
// two groups with bits meet in one word (bitpack.pack_bits: every group but
// the last holds >= 255 bits; zero-width slots only lead or trail, so a
// group after the last one with bits holds none).  No global atomics and
// no zeroed buffer: the TPU kernel's ordered grid carried the shared word
// in scratch memory; here the owner reads both halves itself.
//
// One warp per run of kGroupsPerWarp groups (about 90 words on typical
// content, ~11 a group), eight warps a block: each lane finds its word's
// group among the warp's eight by comparing with the run ends held in
// registers, and the lanes store consecutive words, so stores coalesce and
// no lane idles on short groups.  Bound: bytes (the content words read, the
// stream written: 5.9 MB, 1.8 us at one 1080p GOP), far below the launch
// and tail latency of a grid this small.

#include "common.cuh"

namespace dct3d {
namespace {

constexpr int kThreads = 256;
constexpr int kGroupsPerWarp = 8;
constexpr int kGroupsPerBlock = kGroupsPerWarp * (kThreads / 32);
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int words_through(int bit) {  // ceil(bit / 32)
  return (int)(((unsigned)bit + 31u) >> 5);
}

__global__ void __launch_bounds__(kThreads)
splice_kernel(const uint32_t* __restrict__ groups_buf,
              const int32_t* __restrict__ sw, const int32_t* __restrict__ gend,
              uint32_t* __restrict__ out, int groups, int w_words,
              int nwords) {
  const int lane = threadIdx.x & 31;
  const int g0 = blockIdx.x * kGroupsPerBlock + (threadIdx.x >> 5) * kGroupsPerWarp;
  if (g0 >= groups) return;  // whole warps leave together
  // Lanes 0..7 hold one group of the run each; groups past the last repeat
  // its end, so they own no words.
  const int mine = min(g0 + min(lane, kGroupsPerWarp - 1), groups - 1);
  const int my_sw = sw[mine], my_end = gend[mine];
  const int lo = g0 ? words_through(gend[g0 - 1]) : 0;  // run's first word
  int owned_end[kGroupsPerWarp];  // exclusive end word of each group's run
#pragma unroll
  for (int k = 0; k < kGroupsPerWarp; ++k)
    owned_end[k] = words_through(__shfl_sync(kFull, my_end, k));
  const int hi = min(owned_end[kGroupsPerWarp - 1], nwords);

  for (int base = lo; base < hi; base += 32) {  // uniform trip count
    const int w = base + lane;
    int k = 0;  // the group of the run in which word w starts
#pragma unroll
    for (int j = 0; j < kGroupsPerWarp - 1; ++j) k += w >= owned_end[j];
    const int start = __shfl_sync(kFull, my_sw, k);
    const int end = __shfl_sync(kFull, my_end, k);
    if (w >= hi) continue;
    const int64_t g = g0 + k;
    const int j = w - start;  // < 0 only before a group 0 that starts late
    uint32_t v = (unsigned)j < (unsigned)w_words ? groups_buf[g * w_words + j] : 0u;
    // The last owned word also holds the head of group g + 1, whose row
    // word 0 is defined whenever its phase (end & 31) is not 0.
    if ((end & 31) && w == (end >> 5) && g + 1 < groups)
      v |= groups_buf[(g + 1) * w_words];
    out[w] = __byte_perm(v, 0, 0x0123);
  }
}

}  // namespace
}  // namespace dct3d

// groups_buf: (groups, w_words) u32 from K2 or K5 (carry lead already in
// word 0 of group 0), each row's words [0, nw) defined; sw: (groups,) i32
// start word; gend: (groups,) i32 end bit (exclusive), nondecreasing, and
// group g + 1 starts at bit gend[g]; out: (nwords,) u32.  Words [0,
// ceil(gend[groups - 1] / 32)) are written (those below nwords), the rest
// are left as they were.
DCT3D_EXPORT int dct3d_splice(const void* groups_buf, const void* sw,
                              const void* gend, void* out, int groups,
                              int w_words, int nwords, void* stream) {
  using namespace dct3d;
  const int blocks = (groups + kGroupsPerBlock - 1) / kGroupsPerBlock;
  splice_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)groups_buf, (const int32_t*)sw, (const int32_t*)gend,
      (uint32_t*)out, groups, w_words, nwords);
  return (int)cudaGetLastError();
}
