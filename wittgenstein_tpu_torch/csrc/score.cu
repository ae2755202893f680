// Handel verification scoring: four popcount summaries per queue entry.
//
// Replaces: wittgenstein_tpu/ops/pallas_score.py, `_score_kernel` with
// `_emask_for` and `_popcount_u32` (launched by `score_queue_pallas`).
//
// Function, per queue entry (node m, slot q) of level l: emask is the
// W-word mask of node m's level-l peer range; with inc_e, ver_e, agg_e
// the node's total-incoming, verified and aggregate rows under emask,
//   s_inc     = popcount((disjoint(sig, inc_e) ? sig | inc_e : sig) | ver_e)
//   pc_sig    = popcount(sig)
//   pc_sv     = popcount(sig | ver_e)
//   inter_agg = (sig & agg_e) != 0 anywhere.
//
// What bounds it on an H100: memory.  The [M, Q, W] sig plane dominates
// the bytes (8.4 MB of ~10.6 MB at 2048 nodes, Q 16, W 64: ~3 us at
// 3.35 TB/s); the arithmetic is a few bit ops and one popcount per word.
//
// Design: one warp per entry, each lane taking words lane, lane+32, ...
// so a warp reads one sig row in coalesced 128-byte lines.  The level
// mask is built in registers from (id, level) arithmetic, never read.
// Since s_inc is popcount(sig | inc_e | ver_e) when the entry is disjoint
// from inc_e and pc_sv otherwise, one pass accumulates both and the
// warp-wide OR of (sig & inc_e) picks one: __popc per word,
// __reduce_add_sync and __reduce_or_sync across the warp.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ unsigned low_mask(int k) {
  return k >= 32 ? 0xffffffffu : ((1u << k) - 1u);
}

__global__ void __launch_bounds__(THREADS)
score_kernel(const unsigned* __restrict__ q_sig, const int* __restrict__ q_lvl,
             const int* __restrict__ ids, const unsigned* __restrict__ inc,
             const unsigned* __restrict__ ver,
             const unsigned* __restrict__ agg, int* __restrict__ s_inc,
             int* __restrict__ pc_sig, int* __restrict__ pc_sv,
             int* __restrict__ inter_agg, int M, int Q, int W) {
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (e >= (long long)M * Q) return;          // whole warp leaves together
  const int m = (int)(e / Q);
  const int id = ids[m], lvl = q_lvl[e];
  const int half = lvl > 0 ? 1 << min(max(lvl - 1, 0), 30) : 0;
  const int half_nz = max(half, 1);
  int base = (id & ~(2 * half_nz - 1)) + ((id & half_nz) ? 0 : half_nz);
  base = half > 0 ? base : 0;

  unsigned n_all = 0, n_sig = 0, n_sv = 0, hit_inc = 0, hit_agg = 0;
  for (int w = lane; w < W; w += 32) {
    const int wlo = w * 32;
    const int lo = min(max(base - wlo, 0), 32);
    const int hi = min(max(base + half - wlo, 0), 32);
    const unsigned emask = low_mask(hi) & ~low_mask(lo);
    const unsigned sig = q_sig[e * W + w];
    const unsigned inc_e = inc[(size_t)m * W + w] & emask;
    const unsigned ver_e = ver[(size_t)m * W + w] & emask;
    const unsigned agg_e = agg[(size_t)m * W + w] & emask;
    hit_inc |= sig & inc_e;
    hit_agg |= sig & agg_e;
    n_all += __popc(sig | inc_e | ver_e);
    n_sig += __popc(sig);
    n_sv += __popc(sig | ver_e);
  }
  n_all = __reduce_add_sync(0xffffffffu, n_all);
  n_sig = __reduce_add_sync(0xffffffffu, n_sig);
  n_sv = __reduce_add_sync(0xffffffffu, n_sv);
  hit_inc = __reduce_or_sync(0xffffffffu, hit_inc);
  hit_agg = __reduce_or_sync(0xffffffffu, hit_agg);
  if (lane == 0) {
    s_inc[e] = (int)(hit_inc ? n_sv : n_all);
    pc_sig[e] = (int)n_sig;
    pc_sv[e] = (int)n_sv;
    inter_agg[e] = hit_agg != 0;
  }
}

}  // namespace

extern "C" int wtpu_score(const unsigned* q_sig, const int* q_lvl,
                          const int* ids, const unsigned* inc,
                          const unsigned* ver, const unsigned* agg,
                          int* s_inc, int* pc_sig, int* pc_sv, int* inter_agg,
                          int M, int Q, int W, void* stream) {
  const long long entries = (long long)M * Q;
  if (entries == 0) return 0;
  const unsigned blocks = (unsigned)((entries + WARPS - 1) / WARPS);
  score_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      q_sig, q_lvl, ids, inc, ver, agg, s_inc, pc_sig, pc_sv, inter_agg, M,
      Q, W);
  return (int)cudaGetLastError();
}
