// Handel's bounded verification-queue merge, one node row per block.
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
// integer atomicAdd, so the sum does not depend on block order).  The
// bool columns (bad, ok) are read and written as the bytes of torch's
// bool tensors.
//
// What bounds it on an H100: memory.  It must read the small columns
// once, the Q sig rows it keeps per node (of the C candidates' rows) and
// write the new [M, Q, W] plane: at 2048 nodes, Q 16, S 12, W 64 that is
// 2 x 8.39 MB of sig words plus 1.17 MB of columns, about 17.95 MB or
// ~5.4 us at 3.35 TB/s (chip_smoke.py's bound).  The key work is
// C^2 = 784 integer compares per row.
//
// Design: since every key is unique, a candidate's output position is
// the number of smaller keys in its row, so one thread per candidate
// finds its place with C compares in shared memory -- no sort and no
// selection rounds.  The block then copies the kept sig rows with all
// its threads, coalesced along W.  The output is a fresh tensor (the
// wrapper allocates it), so the old plane is read while the new one is
// written without a staging copy.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;          // >= C, the guard is C <= 255
constexpr int BIG0 = 0x7FFFFF00;

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
             int* __restrict__ o_sig, int* __restrict__ o_evicted, int Q,
             int S, int W) {
  __shared__ int u_from[THREADS], u_lvl[THREADS], u_rank[THREADS];
  __shared__ int u_bad[THREADS], key[THREADS], inc_ok[THREADS];
  __shared__ int ex_keep[THREADS], from_c[THREADS];
  const int m = blockIdx.x, t = threadIdx.x, C = Q + S;

  // Raw candidate columns: queued entries, then inbox slots.
  if (t < Q) {
    u_from[t] = q_from[m * Q + t];
    u_lvl[t] = q_lvl[m * Q + t];
    u_rank[t] = q_rank[m * Q + t];
    u_bad[t] = q_bad[m * Q + t] != 0;
  } else if (t < C) {
    const int s = t - Q;
    u_from[t] = src[m * S + s];
    u_lvl[t] = level[m * S + s];
    u_rank[t] = rank[m * S + s];
    u_bad[t] = 0;
    inc_ok[s] = ok[m * S + s] != 0;
  }
  __syncthreads();

  // dup: a LATER valid inbox slot with the same (sender, level) wins.
  bool keep_inc = false;
  if (t >= Q && t < C) {
    keep_inc = inc_ok[t - Q];
    for (int s2 = t + 1; s2 < C && keep_inc; ++s2)
      if (inc_ok[s2 - Q] && u_from[s2] == u_from[t] && u_lvl[s2] == u_lvl[t])
        keep_inc = false;
  }
  __syncthreads();
  if (t >= Q && t < C) inc_ok[t - Q] = keep_inc;
  __syncthreads();

  // superseded: a queued entry displaced by a surviving inbox entry.
  if (t < Q) {
    bool keep = u_from[t] >= 0;
    for (int s = 0; s < S && keep; ++s)
      if (inc_ok[s] && u_from[Q + s] == u_from[t] && u_lvl[Q + s] == u_lvl[t])
        keep = false;
    ex_keep[t] = keep;
  }
  __syncthreads();

  if (t < C) {
    const bool valid = t < Q ? ex_keep[t] : inc_ok[t - Q];
    if (!valid) u_from[t] = -1;
    key[t] = valid ? u_rank[t] * (C + 1) + t : BIG0 + t;
  }
  __syncthreads();

  // Output position = number of smaller keys (all keys are unique).
  int pos = THREADS;
  if (t < C) {
    pos = 0;
    const int k = key[t];
    for (int c = 0; c < C; ++c) pos += key[c] < k;
    if (pos < Q) {
      from_c[pos] = t;
      o_from[m * Q + pos] = u_from[t];
      o_lvl[m * Q + pos] = u_lvl[t];
      o_rank[m * Q + pos] = u_rank[t];
      o_bad[m * Q + pos] = (unsigned char)u_bad[t];
    }
  }
  const int kept = __syncthreads_count(t < Q && u_from[t] >= 0 && pos < Q);
  const int n_keep = __syncthreads_count(t < Q && ex_keep[t]);
  if (t == 0 && n_keep != kept) atomicAdd(o_evicted, n_keep - kept);

  // Gather the kept sig rows, coalesced along W.
  for (int e = t; e < Q * W; e += THREADS) {
    const int p = e / W, w = e - p * W, c = from_c[p];
    o_sig[(size_t)m * Q * W + e] =
        c < Q ? q_sig[((size_t)m * Q + c) * W + w]
              : sig_all[((size_t)m * S + (c - Q)) * W + w];
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
  if (M == 0) return 0;
  if (Q + S > THREADS - 1) return (int)cudaErrorInvalidValue;
  merge_kernel<<<M, THREADS, 0, (cudaStream_t)stream>>>(
      q_from, q_lvl, q_rank, q_bad, q_sig, src, level, rank, ok, sig_all,
      o_from, o_lvl, o_rank, o_bad, o_sig, o_evicted, Q, S, W);
  return (int)cudaGetLastError();
}
