// Helpers shared by the one-warp-per-node kernels: the level range of a
// node's peers (score.cu, gsf_score.cu), Hopper's 1-D bulk copies
// (cp.async.bulk) completing on an mbarrier in shared memory
// (gsf_score.cu), and the 16-byte alignment test (score.cu,
// gsf_score.cu, merge.cu).

#pragma once

#include <cuda_runtime.h>

namespace wtpu {

// The level-l mask of node id covers words [w0, w0 + nw) with the same
// word mask pm in each: the range [base, base + half) is aligned to its
// power-of-two length, so it is either whole words or inside one word.
// (`_emask_for` of wittgenstein_tpu/ops/pallas_score.py.)
struct Range {
  int w0, nw;
  unsigned pm;
};

__device__ __forceinline__ Range level_range(int id, int lvl) {
  const int h = lvl > 0 ? 1 << min(max(lvl - 1, 0), 30) : 0;
  const int h_nz = max(h, 1);
  const int base =
      h > 0 ? (id & ~(2 * h_nz - 1)) + ((id & h_nz) ? 0 : h_nz) : 0;
  Range rg;
  rg.w0 = base >> 5;
  rg.nw = h >= 32 ? h >> 5 : 1;
  rg.pm = h >= 32 ? 0xffffffffu
                  : h == 0 ? 0u : ((1u << h) - 1u) << (base & 31);
  return rg;
}

__device__ __forceinline__ unsigned emask_of(const Range& rg, int w) {
  return (unsigned)(w - rg.w0) < (unsigned)rg.nw ? rg.pm : 0u;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Initialise an mbarrier expecting one arrival (one thread); then
// bar_init_fence() before the barriers are used.
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(1)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival of the barrier's phase, which then also waits for
// `bytes` of bulk copies (one thread).
__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

inline bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

}  // namespace wtpu
