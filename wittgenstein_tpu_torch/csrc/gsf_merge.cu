// GSF's three-tier verification-queue merge, one node row per block.
//
// Replaces: wittgenstein_tpu/ops/pallas_gsf_merge.py, `_gsf_kernel`
// (launched by `gsf_merge_pallas`).
//
// Function, per node row: the C = Q + 2S candidates are the Q queued
// entries (kept where ex_keep), the S incoming aggregates (where agg_ok)
// and the S incoming individuals (where ind_ok), in that order.  A valid
// candidate c gets the key (tier * (L + 1) + lvl_term) * C + c, with tier
// 0 for a queued individual, 1 for an aggregate (queued or incoming,
// lvl_term its level) and 2 for an incoming individual (lvl_term 0); an
// invalid one gets BIG0 + c and from = -1.  Every key of a row is unique;
// the Q smallest are kept in ascending order, and every column is
// gathered through that order: from, lvl, indiv (queued: its flag,
// aggregate 0, individual 1) and the W-word sig row, which is the queued
// row, the sig_all row, or for an incoming individual the one-bit row of
// its sender (a zero row where !ind_ok).  got_add is the OR of the sender
// bits of the admitted incoming individuals; kept_ex_agg counts the kept
// queued non-individual entries that were valid.  The bool columns
// (indiv, ex_keep, agg_ok, ind_ok) are read and written as the bytes of
// torch's bool tensors.
//
// What bounds it on an H100: memory.  It must read the small columns
// once, the Q sig rows it keeps per node (a one-bit row costs nothing to
// read) and write the new [M, Q, W] plane and the [M, W] got_add rows:
// at 4096 nodes, Q 16, S 16, W 128 that is at most 2 x 33.6 MB of sig
// words, ~20 us at 3.35 TB/s (chip_smoke.py counts the rows a run keeps).
// The key work is C^2 = 2304 integer compares per row.
//
// Design: as in merge.cu, a candidate's output slot is the number of
// smaller keys in its row, so one thread per candidate finds its place
// with C compares in shared memory: no sort and no selection rounds.
// got_add is built in shared memory with atomicOr (an OR does not
// depend on the order of the atomics) and written as one row.  The block
// then copies the kept sig rows with all its threads, coalesced along W.
// The output is a fresh tensor (the TPU kernel aliases the plane in
// place, but a kept entry can move to another slot).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;          // >= C, the guard is C <= 255
constexpr int BIG0 = 0x7FFFFF00;

__global__ void __launch_bounds__(THREADS)
gsf_merge_kernel(const int* __restrict__ q_from,
                 const int* __restrict__ q_lvl,
                 const unsigned char* __restrict__ q_indiv,
                 const unsigned char* __restrict__ ex_keep,
                 const int* __restrict__ q_sig, const int* __restrict__ src,
                 const int* __restrict__ level,
                 const unsigned char* __restrict__ agg_ok,
                 const unsigned char* __restrict__ ind_ok,
                 const int* __restrict__ sig_all, int* __restrict__ o_from,
                 int* __restrict__ o_lvl,
                 unsigned char* __restrict__ o_indiv,
                 int* __restrict__ o_sig, int* __restrict__ o_got,
                 int* __restrict__ o_kept, int Q, int S, int W, int L) {
  extern __shared__ unsigned got[];             // [W]
  __shared__ int key[THREADS], from_c[THREADS];
  const int m = blockIdx.x, t = threadIdx.x, C = Q + 2 * S;

  for (int w = t; w < W; w += THREADS) got[w] = 0u;

  // Candidate t: its columns, validity and key.
  int f = -1, lv = 0, ind = 0, tier = 1;
  bool valid = false;
  if (t < Q) {
    valid = ex_keep[m * Q + t] != 0;
    f = q_from[m * Q + t];
    lv = q_lvl[m * Q + t];
    ind = q_indiv[m * Q + t] != 0;
    tier = ind ? 0 : 1;
  } else if (t < Q + S) {
    const int s = t - Q;
    valid = agg_ok[m * S + s] != 0;
    f = src[m * S + s];
    lv = level[m * S + s];
  } else if (t < C) {
    const int s = t - Q - S;
    valid = ind_ok[m * S + s] != 0;
    f = src[m * S + s];
    lv = level[m * S + s];
    ind = 1;
    tier = 2;
  }
  if (!valid) f = -1;
  valid = f >= 0;
  if (t < C)
    key[t] = valid ? (tier * (L + 1) + (tier == 1 ? lv : 0)) * C + t
                   : BIG0 + t;
  __syncthreads();

  // Output position = number of smaller keys (all keys are unique).
  int pos = THREADS;
  if (t < C) {
    pos = 0;
    const int k = key[t];
    for (int c = 0; c < C; ++c) pos += key[c] < k;
    if (pos < Q) {
      from_c[pos] = t;
      o_from[m * Q + pos] = f;
      o_lvl[m * Q + pos] = lv;
      o_indiv[m * Q + pos] = (unsigned char)ind;
      if (tier == 2 && valid)
        atomicOr(&got[f >> 5], 1u << (f & 31));
    }
  }
  const int kept =
      __syncthreads_count(t < Q && pos < Q && valid && !ind);
  if (t == 0) o_kept[m] = kept;
  for (int w = t; w < W; w += THREADS)
    o_got[(size_t)m * W + w] = (int)got[w];

  // Gather the kept sig rows, coalesced along W.
  for (int e = t; e < Q * W; e += THREADS) {
    const int p = e / W, w = e - p * W, c = from_c[p];
    int v;
    if (c < Q) {
      v = q_sig[((size_t)m * Q + c) * W + w];
    } else if (c < Q + S) {
      v = sig_all[((size_t)m * S + (c - Q)) * W + w];
    } else {
      const int s = c - Q - S;
      const int id = src[m * S + s];
      v = (ind_ok[m * S + s] && w == (id >> 5)) ? (int)(1u << (id & 31))
                                                : 0;
    }
    o_sig[(size_t)m * Q * W + e] = v;
  }
}

// The dynamic shared memory of a block: the node's W-word OR-delta.
// wtpu_gsf_merge launches with it, and wtpu_gsf_merge_smem exports it.
size_t launch_smem(int W) { return (size_t)W * sizeof(unsigned); }

}  // namespace

// The launcher's shared-memory figure (launch_smem).
extern "C" long long wtpu_gsf_merge_smem(int W) {
  return (long long)launch_smem(W);
}

extern "C" int wtpu_gsf_merge(const int* q_from, const int* q_lvl,
                              const unsigned char* q_indiv,
                              const unsigned char* ex_keep, const int* q_sig,
                              const int* src, const int* level,
                              const unsigned char* agg_ok,
                              const unsigned char* ind_ok,
                              const int* sig_all, int* o_from, int* o_lvl,
                              unsigned char* o_indiv, int* o_sig, int* o_got,
                              int* o_kept, int M, int Q, int S, int W, int L,
                              void* stream) {
  if (M == 0) return 0;
  if (Q + 2 * S > THREADS - 1) return (int)cudaErrorInvalidValue;
  const size_t smem = launch_smem(W);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gsf_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  gsf_merge_kernel<<<M, THREADS, smem, (cudaStream_t)stream>>>(
      q_from, q_lvl, q_indiv, ex_keep, q_sig, src, level, agg_ok, ind_ok,
      sig_all, o_from, o_lvl, o_indiv, o_sig, o_got, o_kept, Q, S, W, L);
  return (int)cudaGetLastError();
}
