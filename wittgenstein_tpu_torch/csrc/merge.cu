// Handel's bounded verification-queue merge, one node row per warp.
//
// Replaces: wittgenstein_tpu/ops/pallas_merge.py, `_merge_kernel`
// (launched by `merge_queue_pallas`).
//
// Function, per node row: the C = Q + S candidates are the Q queued
// entries then the S inbox slots.  A later inbox slot with the same
// (sender, level) wins over an earlier one (dup); a surviving inbox entry
// supersedes a queued entry with the same key.  Valid candidates get the
// key rank * (C + 1) + position and invalid ones BIG0 + position, so
// every key of a row is unique; the Q smallest keys are kept in
// ascending order and every column (from, lvl, rank, bad, the W-word sig
// row) is gathered through that order.  *evicted gains, per row, the
// queued entries that survived superseding but were pushed out (an
// integer atomicAdd, so the sum does not depend on warp order).  The
// bool columns (bad, ok) are read and written as the bytes of torch's
// bool tensors.
//
// What bounds it on an H100: memory.  It must read the small columns
// once, the Q sig rows it keeps per node (of the C candidates' rows) and
// write the new [M, Q, W] plane: at 2048 nodes, Q 16, S 12, W 64 that is
// 2 x 8.39 MB of sig words plus 1.17 MB of columns, about 17.95 MB or
// ~5.4 us at 3.35 TB/s (chip_smoke.py's bound).  The first design (one
// 256-thread block per node, 28 threads doing the key work behind five
// block barriers, then a scalar gather of the sig rows) took two round
// trips to device memory one after the other, in two waves of blocks:
// 16.0 us cold (NVIDIA H100 80GB HBM3, 700 W).
//
// Design: one warp per node row, eight nodes a block, no block barrier
// (2048 warps are one wave on the card).  While C <= 32, lane c holds
// candidate c: __match_any_sync on the packed (from, lvl) key finds the
// duplicates and the superseded entries, and a candidate's output
// position is the number of smaller keys (all keys are unique), C
// shuffles.  The gather then copies 16-byte vectors of the kept rows
// from device memory, each lane issuing up to BATCH loads before its
// first store; the columns go out through the position map as coalesced
// rows.  Rows that are not 16-byte multiples or addresses
// (W % 4 != 0) are copied word by word from device memory.  C > 32 (up
// to the guard C <= 255) takes a second, simple path in the same kernel
// (kWide): each lane takes candidates lane, lane + 32, ... through
// per-warp arrays in shared memory, with loops in place of the matches.

#include <cuda_runtime.h>

#include "warp_util.cuh"

using namespace wtpu;

namespace {

constexpr int WARPS = 8;                  // nodes per block
constexpr int THREADS = WARPS * 32;
constexpr int BIG0 = 0x7FFFFF00;
constexpr int BATCH = 8;                  // gather loads in flight a lane
constexpr unsigned FULL = 0xffffffffu;

template <bool kWide>
__global__ void __launch_bounds__(THREADS)
merge_kernel(const int* __restrict__ q_from, const int* __restrict__ q_lvl,
             const int* __restrict__ q_rank,
             const unsigned char* __restrict__ q_bad,
             const int* __restrict__ q_sig, const int* __restrict__ src,
             const int* __restrict__ level, const int* __restrict__ rank,
             const unsigned char* __restrict__ ok,
             const int* __restrict__ sig_all, int* __restrict__ o_from,
             int* __restrict__ o_lvl, int* __restrict__ o_rank,
             unsigned char* __restrict__ o_bad,
             int* __restrict__ o_sig, int* __restrict__ o_evicted, int M,
             int Q, int S, int W, bool vec, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = blockIdx.x * WARPS + warp;
  if (m >= M) return;                       // whole warp leaves together
  const int C = Q + S;
  int* from_c = reinterpret_cast<int*>(dyn + (size_t)warp * warp_bytes);
  const size_t qrow = (size_t)m * Q, srow = (size_t)m * S;
  int evict;

  if (!kWide) {
    // Lane c holds candidate c: queued entries, then inbox slots.
    int from = -1, lvl = 0, rnk = 0, bad = 0;
    bool raw_ok = false;
    if (lane < Q) {
      from = q_from[qrow + lane];
      lvl = q_lvl[qrow + lane];
      rnk = q_rank[qrow + lane];
      bad = q_bad[qrow + lane] != 0;
    } else if (lane < C) {
      from = src[srow + lane - Q];
      lvl = level[srow + lane - Q];
      rnk = rank[srow + lane - Q];
      raw_ok = ok[srow + lane - Q] != 0;
    }
    const bool inbox = lane >= Q && lane < C;
    const unsigned peers = __match_any_sync(
        FULL, ((unsigned long long)(unsigned)from << 32) | (unsigned)lvl);
    const unsigned later = FULL << lane << 1;
    // dup: a LATER ok inbox slot with the same (sender, level) wins.
    const unsigned ok_inbox = __ballot_sync(FULL, inbox && raw_ok);
    const bool keep_inc = inbox && raw_ok && !(peers & ok_inbox & later);
    // superseded: a queued entry displaced by a surviving inbox entry.
    const unsigned kept_inbox = __ballot_sync(FULL, keep_inc);
    const bool ex_keep = lane < Q && from >= 0 && !(peers & kept_inbox);
    const bool valid = lane < Q ? ex_keep : keep_inc;
    const int key = valid ? rnk * (C + 1) + lane : BIG0 + lane;
    int pos = 0;
    for (int c = 0; c < C; ++c) pos += __shfl_sync(FULL, key, c) < key;
    if (lane < C && pos < Q) from_c[pos] = lane;
    evict = __popc(__ballot_sync(FULL, ex_keep)) -
            __popc(__ballot_sync(FULL, ex_keep && pos < Q));
    __syncwarp();
    // Columns: output row p (lane p) from candidate from_c[p].
    const int c = lane < Q ? from_c[lane] : 0;
    const int f = __shfl_sync(FULL, valid ? from : -1, c);
    const int l = __shfl_sync(FULL, lvl, c);
    const int r = __shfl_sync(FULL, rnk, c);
    const int b = __shfl_sync(FULL, bad, c);
    if (lane < Q) {
      o_from[qrow + lane] = f;
      o_lvl[qrow + lane] = l;
      o_rank[qrow + lane] = r;
      o_bad[qrow + lane] = (unsigned char)b;
    }
  } else {
    int* u_from = from_c + Q;
    int* u_lvl = u_from + C;
    int* u_rank = u_lvl + C;
    int* u_bad = u_rank + C;
    int* u_ok = u_bad + C;                  // raw ok of the inbox slots
    int* u_key = u_ok + C;
    int* u_valid = u_key + C;
    for (int c = lane; c < C; c += 32) {
      const bool q = c < Q;
      u_from[c] = q ? q_from[qrow + c] : src[srow + c - Q];
      u_lvl[c] = q ? q_lvl[qrow + c] : level[srow + c - Q];
      u_rank[c] = q ? q_rank[qrow + c] : rank[srow + c - Q];
      u_bad[c] = q ? q_bad[qrow + c] != 0 : 0;
      u_ok[c] = q ? 0 : ok[srow + c - Q] != 0;
    }
    __syncwarp();
    for (int c = Q + lane; c < C; c += 32) {
      bool keep = u_ok[c];
      for (int c2 = c + 1; c2 < C && keep; ++c2)
        if (u_ok[c2] && u_from[c2] == u_from[c] && u_lvl[c2] == u_lvl[c])
          keep = false;
      u_valid[c] = keep;
    }
    __syncwarp();
    for (int c = lane; c < Q; c += 32) {
      bool keep = u_from[c] >= 0;
      for (int s = Q; s < C && keep; ++s)
        if (u_valid[s] && u_from[s] == u_from[c] && u_lvl[s] == u_lvl[c])
          keep = false;
      u_valid[c] = keep;
    }
    __syncwarp();
    for (int c = lane; c < C; c += 32)
      u_key[c] = u_valid[c] ? u_rank[c] * (C + 1) + c : BIG0 + c;
    __syncwarp();
    int n_keep = 0, kept = 0;
    for (int c = lane; c < C; c += 32) {
      int pos = 0;
      const int k = u_key[c];
      for (int c2 = 0; c2 < C; ++c2) pos += u_key[c2] < k;
      if (pos < Q) from_c[pos] = c;
      if (c < Q && u_valid[c]) {
        ++n_keep;
        kept += pos < Q;
      }
    }
    evict = __reduce_add_sync(FULL, n_keep - kept);
    __syncwarp();
    for (int p = lane; p < Q; p += 32) {
      const int c = from_c[p];
      o_from[qrow + p] = u_valid[c] ? u_from[c] : -1;
      o_lvl[qrow + p] = u_lvl[c];
      o_rank[qrow + p] = u_rank[c];
      o_bad[qrow + p] = (unsigned char)u_bad[c];
    }
  }
  if (lane == 0 && evict != 0) atomicAdd(o_evicted, evict);

  // Gather the kept sig rows: output row p from candidate from_c[p].
  if (vec) {
    const int nv = W >> 2;                  // 16-byte vectors a row
    const int total = Q * nv;
    const int4* qs = reinterpret_cast<const int4*>(q_sig);
    const int4* sa = reinterpret_cast<const int4*>(sig_all);
    int4* os = reinterpret_cast<int4*>(o_sig) + qrow * nv;
    // Vector v = p * nv + j of the output rows; v advances by 32 a step,
    // so (p, j) advance by (dp, dj) with one carry, not a division.
    const int dp = 32 / nv, dj = 32 - dp * nv;
    int p = lane / nv, j = lane - p * nv;
    for (int v0 = 0; v0 < total; v0 += 32 * BATCH) {
      int4 buf[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        if (v0 + 32 * k + lane < total) {
          const int c = from_c[p];
          const int4* row =
              c < Q ? qs + (qrow + c) * nv : sa + (srow + c - Q) * nv;
          buf[k] = row[j];
        }
        p += dp;
        j += dj;
        if (j >= nv) {
          j -= nv;
          ++p;
        }
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int v = v0 + 32 * k + lane;
        if (v < total) os[v] = buf[k];
      }
    }
  } else {
    for (int e = lane; e < Q * W; e += 32) {
      const int p = e / W, w = e - p * W, c = from_c[p];
      o_sig[qrow * W + e] = c < Q ? q_sig[(qrow + c) * W + w]
                                  : sig_all[(srow + c - Q) * W + w];
    }
  }
}

}  // namespace

extern "C" int wtpu_merge(const int* q_from, const int* q_lvl,
                          const int* q_rank, const unsigned char* q_bad,
                          const int* q_sig, const int* src, const int* level,
                          const int* rank, const unsigned char* ok,
                          const int* sig_all, int* o_from, int* o_lvl,
                          int* o_rank, unsigned char* o_bad,
                          int* o_sig, int* o_evicted, int M, int Q, int S,
                          int W, void* stream) {
  if (M == 0 || Q == 0) return 0;
  const int C = Q + S;
  if (C > 255) return (int)cudaErrorInvalidValue;
  const bool wide = C > 32;
  // The vector gather needs 16-byte rows and addresses.
  const bool vec = W > 0 && W % 4 == 0 && aligned16(q_sig) &&
                   aligned16(sig_all) && aligned16(o_sig);
  // A warp's shared memory: the position map and, on the wide path,
  // seven candidate arrays; 16-byte aligned.
  const int warp_bytes = (4 * Q + (wide ? 7 * 4 * C : 0) + 15) & ~15;
  const size_t smem = (size_t)WARPS * warp_bytes;
  const void* fn = wide ? (const void*)merge_kernel<true>
                        : (const void*)merge_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((M + WARPS - 1) / WARPS);
  const cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    merge_kernel<true><<<blocks, THREADS, smem, s>>>(
        q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank, ok, sig_all,
        o_from, o_lvl, o_rank, o_bad, o_sig, o_evicted, M, Q, S, W, vec,
        warp_bytes);
  else
    merge_kernel<false><<<blocks, THREADS, smem, s>>>(
        q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank, ok, sig_all,
        o_from, o_lvl, o_rank, o_bad, o_sig, o_evicted, M, Q, S, W, vec,
        warp_bytes);
  return (int)cudaGetLastError();
}
