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
//   inter_agg = (sig & agg_e) != 0 anywhere, written as the bytes of a
//               torch bool tensor.
//
// What bounds it on an H100: memory.  The [M, Q, W] sig plane dominates
// the bytes (8.4 MB of ~10.4 MB at 2048 nodes, Q 16, W 64: ~3.1 us at
// 3.35 TB/s).  The first design (one warp per entry, scalar loads behind
// a chain of dependent index loads, three popcounts a word, five warp
// reductions and four scattered stores per entry, each node's three rows
// fetched again for each of its entries) ran at a quarter of that bound
// (13.3 us cold, NVIDIA H100 80GB HBM3, 700 W).  inc_e, ver_e and agg_e
// are 0 outside the level range, so with
//   n_all = pc_sig + popcount((inc_e | ver_e) & ~sig)
//   n_sv  = pc_sig + popcount(ver_e & ~sig)
// (s_inc = hit_inc ? n_sv : n_all, pc_sv = n_sv) only pc_sig needs every
// word, and the rest only the range's.
//
// Design: a warp takes the entries of one node, or half of them where
// that still fits the grid in one wave of 32 warps a streaming
// multiprocessor (two warps a node at 2048 nodes, Q 16).  No instruction
// is wasted on the range outside its words, and few on the lanes: the
// kernel is bound by issue as much as by bytes, so the design counts
// instructions.  A row of W words is nv = W / 4 vectors of 16 bytes; an
// entry gets L lanes (a power of two, about nv / 4, so each lane takes
// about four vectors: L 4 and eight entries a pass at W 64), and lane j
// of an entry takes vectors j, j + L, ...  A lane issues the loads of
// its vectors (BATCH at a time) before it reduces any and takes one
// popcount a word for pc_sig; then it walks only the vectors of the
// entry's level range that are its own (v = j mod L; a level's range is
// aligned to its power-of-two length, so it is whole vectors or lies
// inside one), read again from L1, with the node's three rows, which
// were started toward L1 with the first loads.  An entry's lanes meet in
// log2(L) shuffles of two packed words; lanes 0..31 collect a chunk of
// 32 entries and store each output array as one coalesced row.  Lane
// counts are powers of two, so the index math is shifts.  Where rows are
// not 16-byte multiples or addresses (W % 4 != 0, say W 2 at 64 nodes)
// or too long for the packed sums (W >= 1024), the same kernel reads
// device memory with ordinary loads, every word of every entry in turn
// (kVec false).

#include <cuda_runtime.h>

#include "warp_util.cuh"

using namespace wtpu;

namespace {

constexpr int WARPS = 8;                  // nodes per block
constexpr int THREADS = WARPS * 32;
constexpr int BATCH = 4;                  // sig vectors in flight a lane
constexpr int VECS_A_LANE = 4;            // a row's vectors a lane takes
constexpr int WARPS_PER_SM = 32;          // resident at 64 registers
constexpr int W_PACKED = 1024;            // packed sums: bits < 2^15
constexpr unsigned FULL = 0xffffffffu;

// Sums of one entry's lanes: pc_sig | x_sv << 16 and x_all | flags << 16
// (flags: the count of vectors with a hit on inc_e in bits 16-23, on
// agg_e in bits 24-31; a row of fewer than 1024 words has fewer than
// 256 vectors and 2^15 bits, so no field carries into the next).
struct Part {
  unsigned p1, p2;
};

__device__ __forceinline__ void add_vec(Part& a, const uint4& s4,
                                        const uint4& i4, const uint4& v4,
                                        const uint4& g4, const Range& rg,
                                        int v) {
  const unsigned sg[4] = {s4.x, s4.y, s4.z, s4.w};
  const unsigned in[4] = {i4.x, i4.y, i4.z, i4.w};
  const unsigned vr[4] = {v4.x, v4.y, v4.z, v4.w};
  const unsigned ag[4] = {g4.x, g4.y, g4.z, g4.w};
  unsigned x_all = 0, x_sv = 0, hit_inc = 0, hit_agg = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned em = emask_of(rg, 4 * v + k);
    const unsigned inc_e = in[k] & em, ver_e = vr[k] & em;
    x_all += __popc((inc_e | ver_e) & ~sg[k]);
    x_sv += __popc(ver_e & ~sg[k]);
    hit_inc |= sg[k] & inc_e;
    hit_agg |= sg[k] & ag[k] & em;
  }
  a.p1 += x_sv << 16;
  a.p2 += x_all | (hit_inc ? 1u << 16 : 0u) | (hit_agg ? 1u << 24 : 0u);
}

// Vector path: entries [q_lo, q_hi) of node m, L lanes an entry (a
// power of two), E = 32 / L entries a pass.  Lane j of an entry takes
// its row's vectors j, j + L, ... (kv of them): the loads of a batch are
// issued before any is reduced, and the rows' vectors are read (from L1
// after the first warp of the node) only where they lie in the range.
__device__ __forceinline__ void score_vec(
    const unsigned* __restrict__ q_sig, const int* __restrict__ q_lvl,
    const unsigned* __restrict__ inc, const unsigned* __restrict__ ver,
    const unsigned* __restrict__ agg, int* __restrict__ s_inc,
    int* __restrict__ pc_sig, int* __restrict__ pc_sv,
    unsigned char* __restrict__ inter_agg, int id, int m, int q_lo,
    int q_hi, int Q, int W, int lg_l, int lane) {
  // Shifts, not divisions: L and E are powers of two.
  const int nv = W >> 2, L = 1 << lg_l, lg_e = 5 - lg_l, E = 1 << lg_e;
  const int j = lane & (L - 1), g = lane >> lg_l;
  const int kv = (nv + L - 1) >> lg_l;      // vectors a lane, an entry
  const uint4* rv_inc = reinterpret_cast<const uint4*>(inc) + (size_t)m * nv;
  const uint4* rv_ver = reinterpret_cast<const uint4*>(ver) + (size_t)m * nv;
  const uint4* rv_agg = reinterpret_cast<const uint4*>(agg) + (size_t)m * nv;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  const size_t e_row = (size_t)m * Q;
  const uint4* sig_v = reinterpret_cast<const uint4*>(q_sig) + e_row * nv;
  // Start the node's three rows toward L1 with the sig loads, so that the
  // range vectors read after those land do not wait a second round trip.
  const int lines = (W + 31) >> 5;          // 128-byte lines a row
  for (int t = lane; t < 3 * lines; t += 32) {
    const int r = t < lines ? 0 : t < 2 * lines ? 1 : 2;
    const unsigned* row = (r == 0 ? inc : r == 1 ? ver : agg) + (size_t)m * W;
    asm volatile("prefetch.global.L1 [%0];" ::"l"(row + (t - r * lines) * 32));
  }

  for (int c0 = q_lo; c0 < q_hi; c0 += 32) {
    const int nq = min(32, q_hi - c0);
    const int my_lvl = lane < nq ? q_lvl[e_row + c0 + lane] : 0;
    unsigned o1 = 0, o2 = 0;                // entry `lane`'s sums
    for (int pass = 0; pass * E < nq; ++pass) {
      const int e = pass * E + g;
      const bool live = e < nq;
      const uint4* row = sig_v + (size_t)(c0 + min(e, nq - 1)) * nv;
      Part a = {0u, 0u};
      // pc_sig over every vector of the lane's part of the row.
      for (int k0 = 0; k0 < kv; k0 += BATCH) {
        uint4 s[BATCH];
#pragma unroll
        for (int b = 0; b < BATCH; ++b) {
          const int v = j + (k0 + b) * L;
          s[b] = live && k0 + b < kv && v < nv ? row[v] : zero;
        }
#pragma unroll
        for (int b = 0; b < BATCH; ++b)
          a.p1 += __popc(s[b].x) + __popc(s[b].y) + __popc(s[b].z) +
                  __popc(s[b].w);
      }
      // The rest over the range's vectors of this lane's part only (v =
      // j mod L), read again from L1: the range is whole vectors from
      // v0, or inside vector v0.
      const Range rg =
          level_range(id, __shfl_sync(FULL, my_lvl, min(e, nq - 1)));
      if (live && rg.pm != 0u) {
        const int v0 = rg.w0 >> 2;
        const int v1 = min(nv, (rg.w0 + rg.nw + 3) >> 2);
        for (int v = v0 + ((j - v0) & (L - 1)); v < v1; v += L)
          add_vec(a, __ldg(row + v), __ldg(rv_inc + v), __ldg(rv_ver + v),
                  __ldg(rv_agg + v), rg, v);
      }
      for (int o = 1; o < L; o <<= 1) {
        a.p1 += __shfl_xor_sync(FULL, a.p1, o);
        a.p2 += __shfl_xor_sync(FULL, a.p2, o);
      }
      // Lane t collects entry t = pass * E + t % E from the first lane
      // of group t % E.
      const int from = (lane & (E - 1)) << lg_l;
      const unsigned t1 = __shfl_sync(FULL, a.p1, from);
      const unsigned t2 = __shfl_sync(FULL, a.p2, from);
      if (lane >> lg_e == pass) {
        o1 = t1;
        o2 = t2;
      }
    }
    if (lane < nq) {
      const int n_sig = (int)(o1 & 0xffffu);
      const int n_sv = n_sig + (int)(o1 >> 16);
      const int n_all = n_sig + (int)(o2 & 0xffffu);
      const size_t e = e_row + c0 + lane;
      s_inc[e] = (o2 >> 16) & 0xffu ? n_sv : n_all;
      pc_sig[e] = n_sig;
      pc_sv[e] = n_sv;
      inter_agg[e] = (o2 >> 24) != 0u;
    }
  }
}

// kVec: 16-byte vectors, 2^lg_l lanes an entry; else ordinary loads.
// Warp gw takes entries [part * EW, (part + 1) * EW) of node
// gw >> lg_nw, part = gw mod 2^lg_nw (EW = Q >> lg_nw).
template <bool kVec>
__global__ void __launch_bounds__(THREADS, 4)
score_kernel(const unsigned* __restrict__ q_sig, const int* __restrict__ q_lvl,
             const int* __restrict__ ids, const unsigned* __restrict__ inc,
             const unsigned* __restrict__ ver,
             const unsigned* __restrict__ agg, int* __restrict__ s_inc,
             int* __restrict__ pc_sig, int* __restrict__ pc_sv,
             unsigned char* __restrict__ inter_agg, int M, int Q, int W,
             int EW, int lg_nw, int lg_l) {
  const int lane = threadIdx.x & 31;
  const int gw = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (gw >= M << lg_nw) return;             // whole warp leaves together
  const int m = gw >> lg_nw, q_lo = (gw & ((1 << lg_nw) - 1)) * EW;
  const int q_hi = min(Q, q_lo + EW);
  const int id = ids[m];
  const size_t e_row = (size_t)m * Q;

  if (kVec) {
    score_vec(q_sig, q_lvl, inc, ver, agg, s_inc, pc_sig, pc_sv, inter_agg,
              id, m, q_lo, q_hi, Q, W, lg_l, lane);
  } else {
    const unsigned* row_i = inc + (size_t)m * W;
    const unsigned* row_v = ver + (size_t)m * W;
    const unsigned* row_a = agg + (size_t)m * W;
    for (int c0 = q_lo; c0 < q_hi; c0 += 32) {
      const int nq = min(32, q_hi - c0);
      const int my_lvl = lane < nq ? q_lvl[e_row + c0 + lane] : 0;
      int o_inc = 0, o_sig = 0, o_sv = 0, o_agg = 0;
      for (int qq = 0; qq < nq; ++qq) {
        const Range rg = level_range(id, __shfl_sync(FULL, my_lvl, qq));
        const unsigned* sig = q_sig + (e_row + c0 + qq) * W;
        unsigned n_all = 0, n_sig = 0, n_sv = 0, hit_inc = 0, hit_agg = 0;
        for (int w = lane; w < W; w += 32) {
          const unsigned em = emask_of(rg, w);
          const unsigned s = sig[w], inc_e = row_i[w] & em;
          const unsigned ver_e = row_v[w] & em;
          hit_inc |= s & inc_e;
          hit_agg |= s & row_a[w] & em;
          n_all += __popc(s | inc_e | ver_e);
          n_sig += __popc(s);
          n_sv += __popc(s | ver_e);
        }
        n_all = __reduce_add_sync(FULL, n_all);
        n_sig = __reduce_add_sync(FULL, n_sig);
        n_sv = __reduce_add_sync(FULL, n_sv);
        hit_inc = __reduce_or_sync(FULL, hit_inc);
        hit_agg = __reduce_or_sync(FULL, hit_agg);
        if (lane == qq) {
          o_inc = (int)(hit_inc ? n_sv : n_all);
          o_sig = (int)n_sig;
          o_sv = (int)n_sv;
          o_agg = hit_agg != 0;
        }
      }
      if (lane < nq) {
        const size_t e = e_row + c0 + lane;
        s_inc[e] = o_inc;
        pc_sig[e] = o_sig;
        pc_sv[e] = o_sv;
        inter_agg[e] = (unsigned char)o_agg;
      }
    }
  }
}

}  // namespace

extern "C" int wtpu_score(const unsigned* q_sig, const int* q_lvl,
                          const int* ids, const unsigned* inc,
                          const unsigned* ver, const unsigned* agg,
                          int* s_inc, int* pc_sig, int* pc_sv,
                          unsigned char* inter_agg, int M, int Q, int W,
                          void* stream) {
  if ((long long)M * Q == 0) return 0;
  const bool vec = W > 0 && W % 4 == 0 && W < W_PACKED && aligned16(q_sig) &&
                   aligned16(inc) && aligned16(ver) && aligned16(agg);
  // Lanes an entry: a power of two, about nv / 4 (so a lane takes about
  // four vectors of a row), at most 32.  Entries a warp: all of a
  // node's, halved while the grid stays within WARPS_PER_SM a streaming
  // multiprocessor and a warp keeps at least one full pass (32 / L).
  int lg_l = 0, lg_nw = 0, ew = Q;
  if (vec) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    while (lg_l < 5 && (VECS_A_LANE << lg_l) < W / 4) ++lg_l;
    while (ew % 2 == 0 && ew / 2 >= 32 >> lg_l &&
           (long long)M << (lg_nw + 1) <= (long long)sms * WARPS_PER_SM) {
      ew /= 2;
      ++lg_nw;
    }
  }
  const long long warps = (long long)M << lg_nw;
  const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    score_kernel<true><<<blocks, THREADS, 0, s>>>(
        q_sig, q_lvl, ids, inc, ver, agg, s_inc, pc_sig, pc_sv, inter_agg, M,
        Q, W, ew, lg_nw, lg_l);
  else
    score_kernel<false><<<blocks, THREADS, 0, s>>>(
        q_sig, q_lvl, ids, inc, ver, agg, s_inc, pc_sig, pc_sv, inter_agg, M,
        Q, W, ew, 0, 5);
  return (int)cudaGetLastError();
}
