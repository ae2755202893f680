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
// What bounds it on an H100: memory, once the popcounts and the
// latency of warp-wide reductions are few.  The
// [M, Q, W] sig plane dominates the bytes (33.6 MB of ~39 MB at 4096
// nodes, Q 16, W 128: ~12 us at 3.35 TB/s).  The first design (one warp
// per entry, four popcounts a word over every word, six warp reductions
// and scattered single-element stores per entry) ran at 2.5x that
// bound (29.7 us, NVIDIA H100 80GB HBM3, 700 W): an SM runs 16
// popcounts a clock, and four a word over the sig plane are ~1M warp
// instructions.  But outside the level range ver_l and indiv_l are 0,
// so there pc_wi = pc_wv = card_sig: with
//   pc_wi = card_sig + popcount(indiv_l & ~sig)
//   pc_wv = pc_wi + popcount(ver_l & ~wi)
// only card_sig needs every word, and the other three only the range's.
//
// Design: one warp per node row m, several nodes per warp (the grid
// holds as many blocks as fit on the card at once).  Each warp keeps a
// ring of STAGES stages in shared memory; lane 0 fills a stage with
// Hopper's 1-D bulk copies (cp.async.bulk, completing on the stage's
// mbarrier): the node's verified and ver_indiv rows and a piece of its
// sig slab, QC entries ([QC, W] contiguous words).  The next piece is
// in flight while this one is reduced.  In a piece each entry has
// 32 / QC lanes (QC rounded up to a power of two), each reading every
// (32 / QC)-th 16-byte vector of the entry's row from the stage: one
// popcount a word for card_sig over the whole row, the other three and
// the intersections over the vectors of the level range only (a
// level's range is aligned to its power-of-two length, so it is whole
// vectors or lies inside one).  The lanes of an entry meet in a few
// shuffles, and lanes 0..QC-1 store each output array of the piece as
// one coalesced row.  Where the rows are not 16-byte multiples or
// addresses (W % 4 != 0, say W 2 at 64 nodes) or a row is longer than
// a stage allows, the same kernel reads device memory with ordinary
// loads, every word of every entry in turn (kBulk false).

#include <cuda_runtime.h>

#include <algorithm>

#include "warp_util.cuh"

using namespace wtpu;

namespace {

constexpr int WARPS = 4;                  // nodes in flight per block
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 2;
constexpr int STAGE_MAX = 5 * 1024;       // bytes of one stage
constexpr unsigned FULL = 0xffffffffu;

// ----------------------------------------------- ordinary-load path

struct Acc {
  unsigned vl, sig, wi, wv, hit_v, hit_i;
};

__device__ __forceinline__ void acc_word(Acc& a, unsigned sig, unsigned ver,
                                         unsigned ind, unsigned emask) {
  const unsigned ver_l = ver & emask, ind_l = ind & emask;
  const unsigned wi = ind_l | sig;
  a.hit_v |= sig & ver_l;
  a.hit_i |= sig & ind_l;
  a.vl += __popc(ver_l);
  a.sig += __popc(sig);
  a.wi += __popc(wi);
  a.wv += __popc(wi | ver_l);
}

// ------------------------------------------------------ bulk path

template <bool kBulk>
__global__ void __launch_bounds__(THREADS, 6)
gsf_score_kernel(const unsigned* __restrict__ q_sig,
                 const int* __restrict__ q_lvl, const int* __restrict__ ids,
                 const unsigned* __restrict__ ver,
                 const unsigned* __restrict__ ind, int* __restrict__ vlc,
                 int* __restrict__ cs, unsigned char* __restrict__ inter,
                 int* __restrict__ pwi, int* __restrict__ pwv,
                 unsigned char* __restrict__ inter_ind, int M, int Q,
                 int W, int QC) {
  extern __shared__ __align__(16) unsigned stage_mem[];
  __shared__ __align__(8) unsigned long long bars[WARPS][STAGES];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long nwarps = (long long)gridDim.x * WARPS;
  const long long gw = (long long)blockIdx.x * WARPS + warp;
  // This warp's pieces: nodes gw, gw + nwarps, ...; QC entries each.
  const int per_node = (Q + QC - 1) / QC;
  const long long nodes = gw < M ? (M - gw + nwarps - 1) / nwarps : 0;
  const long long pieces = nodes * per_node;
  const int stage_words = (QC + 2) * W;
  const int nvec = W / 4;
  unsigned* ring = stage_mem + (size_t)warp * STAGES * stage_words;
  unsigned long long* bar = bars[warp];

  auto piece = [&](long long p, int* m, int* q0, int* nq) {
    *m = (int)(gw + (p / per_node) * nwarps);
    *q0 = (int)(p % per_node) * QC;
    *nq = min(QC, Q - *q0);
  };
  auto fetch = [&](long long p) {      // lane 0 only
    int m, q0, nq;
    piece(p, &m, &q0, &nq);
    unsigned* st = ring + (p % STAGES) * stage_words;
    unsigned long long* b = bar + p % STAGES;
    const unsigned row = (unsigned)W * 4u;
    // The stage was last read with ordinary loads: order those reads
    // before the async proxy writes it again.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_expect(b, row * (2u + (unsigned)nq));
    bulk_g2s(st, ver + (size_t)m * W, row, b);
    bulk_g2s(st + W, ind + (size_t)m * W, row, b);
    bulk_g2s(st + 2 * W, q_sig + ((size_t)m * Q + q0) * W, row * nq, b);
  };

  if (kBulk) {
    if (lane == 0) {
      for (int s = 0; s < STAGES; ++s) bar_init(bar + s);
      bar_init_fence();
      for (long long p = 0; p < pieces && p < STAGES; ++p) fetch(p);
    }
    __syncwarp();
  }

  for (long long p = 0; p < pieces; ++p) {
    int m, q0, nq;
    piece(p, &m, &q0, &nq);
    const size_t e0 = (size_t)m * Q + q0;
    const int id = ids[m];
    const int my_lvl = lane < nq ? q_lvl[e0 + lane] : 0;
    int o_vl = 0, o_sig = 0, o_wi = 0, o_wv = 0;
    unsigned o_hits = 0;
    if (kBulk) {
      // Lane l works on entry e = l % ne (ne: nq rounded up to a power
      // of two) and on every parts-th vector of its row, from its part
      // l / ne on; the parts' sums meet in log2(parts) shuffles.
      const int ne = nq <= 1 ? 1 : 1 << (32 - __clz(nq - 1));
      const int parts = 32 / ne;
      const int e = lane & (ne - 1), part = lane / ne;
      const bool live = e < nq;
      const Range rg = level_range(id, __shfl_sync(FULL, my_lvl, e));
      bar_wait(bar + p % STAGES, (unsigned)((p / STAGES) & 1));
      const unsigned* st = ring + (p % STAGES) * stage_words;
      const uint4* v_ver = reinterpret_cast<const uint4*>(st);
      const uint4* v_ind = reinterpret_cast<const uint4*>(st + W);
      const uint4* v_sig = reinterpret_cast<const uint4*>(st + 2 * W) +
                           (size_t)e * nvec;
      unsigned n_sig = 0, n_vl = 0, x_wi = 0, x_wv = 0, hits = 0;
      if (live) {
        // card_sig over the whole row; entry e starts e vectors in, so
        // the entries' lanes hit different banks.
        const int es = e % nvec;
        for (int k = part; k < nvec; k += parts) {
          const int v = k + es < nvec ? k + es : k + es - nvec;
          const uint4 s4 = v_sig[v];
          n_sig += __popc(s4.x) + __popc(s4.y) + __popc(s4.z) +
                   __popc(s4.w);
        }
        // The rest over the level range's vectors only: the range is
        // whole vectors from v0, or inside vector v0.
        if (rg.pm != 0u) {
          const int v0 = rg.w0 >> 2;
          const int v1 = min(nvec, v0 + (rg.nw >= 4 ? rg.nw >> 2 : 1));
          for (int v = v0 + part; v < v1; v += parts) {
            const uint4 s4 = v_sig[v], r4 = v_ver[v], i4 = v_ind[v];
            const unsigned sg[4] = {s4.x, s4.y, s4.z, s4.w};
            const unsigned vr[4] = {r4.x, r4.y, r4.z, r4.w};
            const unsigned in[4] = {i4.x, i4.y, i4.z, i4.w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const unsigned em = emask_of(rg, 4 * v + k);
              const unsigned ver_l = vr[k] & em, ind_l = in[k] & em;
              n_vl += __popc(ver_l);
              x_wi += __popc(ind_l & ~sg[k]);
              x_wv += __popc(ver_l & ~(ind_l | sg[k]));
              hits |= (sg[k] & ver_l ? 1u : 0u) | (sg[k] & ind_l ? 2u : 0u);
            }
          }
        }
      }
      // A row has fewer than 65536 bits (W * 4 bytes fit a stage), so
      // two sums share a word.
      unsigned p1 = n_sig | (x_wv << 16), p2 = n_vl | (x_wi << 16);
      for (int o = ne; o < 32; o <<= 1) {
        p1 += __shfl_xor_sync(FULL, p1, o);
        p2 += __shfl_xor_sync(FULL, p2, o);
        hits |= __shfl_xor_sync(FULL, hits, o);
      }
      o_sig = (int)(p1 & 0xffffu);
      o_vl = (int)(p2 & 0xffffu);
      o_wi = o_sig + (int)(p2 >> 16);
      o_wv = o_wi + (int)(p1 >> 16);
      o_hits = hits;
      __syncwarp();                     // every lane is done with the stage
      if (lane == 0 && p + STAGES < pieces) fetch(p + STAGES);
    } else {
      const unsigned* row_v = ver + (size_t)m * W;
      const unsigned* row_i = ind + (size_t)m * W;
      for (int qq = 0; qq < nq; ++qq) {
        int lvl = __shfl_sync(FULL, my_lvl, qq);
        const Range rg = level_range(id, lvl);
        const unsigned* sig = q_sig + (e0 + qq) * W;
        Acc a = {};
        for (int w = lane; w < W; w += 32)
          acc_word(a, sig[w], row_v[w], row_i[w], emask_of(rg, w));
        const unsigned vl = __reduce_add_sync(FULL, a.vl);
        const unsigned sg = __reduce_add_sync(FULL, a.sig);
        const unsigned wi = __reduce_add_sync(FULL, a.wi);
        const unsigned wv = __reduce_add_sync(FULL, a.wv);
        const unsigned hits = __reduce_or_sync(
            FULL, (a.hit_v != 0 ? 1u : 0u) | (a.hit_i != 0 ? 2u : 0u));
        if (lane == qq) {
          o_vl = (int)vl;
          o_sig = (int)sg;
          o_wi = (int)wi;
          o_wv = (int)wv;
          o_hits = hits;
        }
      }
    }
    if (lane < nq) {
      vlc[e0 + lane] = o_vl;
      cs[e0 + lane] = o_sig;
      inter[e0 + lane] = o_hits & 1u;
      pwi[e0 + lane] = o_wi;
      pwv[e0 + lane] = o_wv;
      inter_ind[e0 + lane] = (o_hits >> 1) & 1u;
    }
  }
}

// The staged kernel's dynamic shared memory for Q entries of W words a
// row (0: the unstaged kernel, which takes none); `aligned` says whether
// the q_sig, verified and ver_indiv rows are 16-byte aligned.
// wtpu_gsf_score launches with it, and wtpu_gsf_score_smem exports it.
size_t launch_smem(int Q, int W, bool aligned) {
  const long long row = 4LL * W;
  if (!(W > 0 && W % 4 == 0 && aligned && 3 * row <= STAGE_MAX)) return 0;
  const int qc = (int)std::min<long long>(std::min(Q, 32),
                                          STAGE_MAX / row - 2);
  return (size_t)WARPS * STAGES * (qc + 2) * row;
}

}  // namespace

// The launcher's shared-memory figure for aligned rows (launch_smem).
extern "C" long long wtpu_gsf_score_smem(int Q, int W) {
  return (long long)launch_smem(Q, W, true);
}

extern "C" int wtpu_gsf_score(const unsigned* q_sig, const int* q_lvl,
                              const int* ids, const unsigned* ver,
                              const unsigned* ind, int* vlc, int* cs,
                              unsigned char* inter, int* pwi, int* pwv,
                              unsigned char* inter_ind, int M, int Q, int W,
                              void* stream) {
  if ((long long)M * Q == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long row = 4LL * W;
  const size_t smem =
      launch_smem(Q, W, aligned16(q_sig) && aligned16(ver) && aligned16(ind));
  const bool bulk = smem > 0;
  const unsigned node_blocks = (unsigned)((M + WARPS - 1) / WARPS);
  cudaError_t e;
  if (bulk) {
    const int qc = (int)std::min<long long>(std::min(Q, 32),
                                            STAGE_MAX / row - 2);
    const void* fn = (const void*)gsf_score_kernel<true>;
    if (smem > 32 * 1024) {
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    // As many blocks as are resident at once, so each warp walks
    // several nodes and its ring stays full.
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
      return (int)e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, fn, THREADS, smem)) != cudaSuccess)
      return (int)e;
    const unsigned blocks =
        std::min<unsigned>(node_blocks, (unsigned)std::max(1, sms * per_sm));
    gsf_score_kernel<true><<<blocks, THREADS, smem, s>>>(
        q_sig, q_lvl, ids, ver, ind, vlc, cs, inter, pwi, pwv, inter_ind, M,
        Q, W, qc);
  } else {
    gsf_score_kernel<false><<<node_blocks, THREADS, 0, s>>>(
        q_sig, q_lvl, ids, ver, ind, vlc, cs, inter, pwi, pwv, inter_ind, M,
        Q, W, 32);
  }
  return (int)cudaGetLastError();
}
