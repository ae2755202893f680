// GSF verification scoring: six popcount summaries per queue entry.
//
// Replaces: wittgenstein_tpu/ops/pallas_score.py, `_gsf_score_kernel`
// with `_emask_for` and `_popcount_u32` (launched by `gsf_score_pallas`).
//
// Function, per queue entry (node m, slot q) of level l: emask is the
// W-word mask of node m's level-l peer range; with ver_l and indiv_l the
// node's verified and individually-verified rows under emask and
// wi = indiv_l | sig,
//   ver_l_card = popcount(ver_l)       card_sig  = popcount(sig)
//   inter      = (sig & ver_l) != 0    pc_wi     = popcount(wi)
//   pc_wv      = popcount(wi | ver_l)  inter_ind = (sig & indiv_l) != 0
// The two intersections are written as the bytes of torch bool tensors.
//
// What bounds it on an H100: memory.  The [M, Q, W] sig plane dominates
// the bytes (33.6 MB of ~39 MB at 4096 nodes, Q 16, W 128: ~12 us at
// 3.35 TB/s); the arithmetic is a few bit ops and four popcounts a word.
//
// Design: as score.cu, one warp per entry, each lane taking words lane,
// lane+32, ... so a warp reads one sig row in coalesced 128-byte lines.
// The level mask is built in registers from (id, level) arithmetic,
// never read.  One pass over the row accumulates all six outputs;
// __reduce_add_sync and __reduce_or_sync finish them across the warp.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ unsigned low_mask(int k) {
  return k >= 32 ? 0xffffffffu : ((1u << k) - 1u);
}

__global__ void __launch_bounds__(THREADS)
gsf_score_kernel(const unsigned* __restrict__ q_sig,
                 const int* __restrict__ q_lvl, const int* __restrict__ ids,
                 const unsigned* __restrict__ ver,
                 const unsigned* __restrict__ ind, int* __restrict__ vlc,
                 int* __restrict__ cs, unsigned char* __restrict__ inter,
                 int* __restrict__ pwi, int* __restrict__ pwv,
                 unsigned char* __restrict__ inter_ind, int M, int Q,
                 int W) {
  const int lane = threadIdx.x & 31;
  const long long e = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (e >= (long long)M * Q) return;          // whole warp leaves together
  const int m = (int)(e / Q);
  const int id = ids[m], lvl = q_lvl[e];
  const int half = lvl > 0 ? 1 << min(max(lvl - 1, 0), 30) : 0;
  const int half_nz = max(half, 1);
  int base = (id & ~(2 * half_nz - 1)) + ((id & half_nz) ? 0 : half_nz);
  base = half > 0 ? base : 0;

  unsigned n_vl = 0, n_sig = 0, n_wi = 0, n_wv = 0, hit_v = 0, hit_i = 0;
  for (int w = lane; w < W; w += 32) {
    const int wlo = w * 32;
    const int lo = min(max(base - wlo, 0), 32);
    const int hi = min(max(base + half - wlo, 0), 32);
    const unsigned emask = low_mask(hi) & ~low_mask(lo);
    const unsigned sig = q_sig[e * W + w];
    const unsigned ver_l = ver[(size_t)m * W + w] & emask;
    const unsigned ind_l = ind[(size_t)m * W + w] & emask;
    const unsigned wi = ind_l | sig;
    hit_v |= sig & ver_l;
    hit_i |= sig & ind_l;
    n_vl += __popc(ver_l);
    n_sig += __popc(sig);
    n_wi += __popc(wi);
    n_wv += __popc(wi | ver_l);
  }
  n_vl = __reduce_add_sync(0xffffffffu, n_vl);
  n_sig = __reduce_add_sync(0xffffffffu, n_sig);
  n_wi = __reduce_add_sync(0xffffffffu, n_wi);
  n_wv = __reduce_add_sync(0xffffffffu, n_wv);
  hit_v = __reduce_or_sync(0xffffffffu, hit_v);
  hit_i = __reduce_or_sync(0xffffffffu, hit_i);
  if (lane == 0) {
    vlc[e] = (int)n_vl;
    cs[e] = (int)n_sig;
    inter[e] = hit_v != 0;
    pwi[e] = (int)n_wi;
    pwv[e] = (int)n_wv;
    inter_ind[e] = hit_i != 0;
  }
}

}  // namespace

extern "C" int wtpu_gsf_score(const unsigned* q_sig, const int* q_lvl,
                              const int* ids, const unsigned* ver,
                              const unsigned* ind, int* vlc, int* cs,
                              unsigned char* inter, int* pwi, int* pwv,
                              unsigned char* inter_ind, int M, int Q, int W,
                              void* stream) {
  const long long entries = (long long)M * Q;
  if (entries == 0) return 0;
  const unsigned blocks = (unsigned)((entries + WARPS - 1) / WARPS);
  gsf_score_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      q_sig, q_lvl, ids, ver, ind, vlc, cs, inter, pwi, pwv, inter_ind, M,
      Q, W);
  return (int)cudaGetLastError();
}
