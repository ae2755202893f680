// Mailbox-ring binning: one batch of unicast messages into the [H, N, C]
// ring, per seed.
//
// Replaces: wittgenstein_tpu/ops/pallas_route.py, `_make_kernel` (the
// Pallas kernel launched by `_route_call` from `bin_into_ring_planes`).
//
// Function: a message goes to ring row arrival mod H.  Its rank is its
// place, in INPUT order, among the batch's valid messages with the same
// (row, dest); its slot is count[row, dest] + rank and it is accepted iff
// slot < C.  Dropped messages still take up rank.  Accepted messages
// write their payload, src and size cells; count advances by accepted
// messages only; the kernel adds its drops to dropped[r].  `valid` is
// read as the bytes of a torch bool tensor.
//
// What bounds it on an H100: memory.  The work is a few integer ops per
// message; the bytes it must move are a byte of `valid` per message, the
// arrival and dest of each valid one, F + 2 words read and written per
// accepted message and the touched count cells read and written: about
// 1.62 MB, ~0.48 us at 3.35 TB/s, for chip_smoke.py's route case at 2048
// nodes x 21 sends.  What makes it hard is that the rank is stable input
// order while blocks run in no order: a slot taken from the order of
// atomics would differ from run to run.
//
// Design: the grid is (destination block, seed).  Each block owns DBLK
// destinations, keeps their [H, DBLK] running member counts in shared
// memory, and walks the WHOLE message vector in input order, one tile
// of blockDim messages at a time.  Per tile the block compacts its own
// members (ballot + warp prefix, which keeps input order), then warp 0
// ranks the compacted list 32 at a time with __match_any_sync and
// advances the running counts; no other block touches those counts, so
// no atomics decide an order.  Accepted messages are written straight
// into the ring planes, which are updated in place.  The price of this
// simple design is that every block re-reads the message vector
// (N/DBLK times, from L2): a later PR can bucket messages by destination
// block once instead.

#include <cuda_runtime.h>

namespace {

constexpr int DBLK = 16;        // destinations per block
constexpr int THREADS = 1024;   // messages per tile

__global__ void __launch_bounds__(THREADS)
route_kernel(const int* __restrict__ arrival,
             const int* __restrict__ dest,
             const unsigned char* __restrict__ valid,
             const int* __restrict__ msrc,
             const int* __restrict__ msize, const int* __restrict__ pay,
             int* __restrict__ data, int* __restrict__ src,
             int* __restrict__ size, int* __restrict__ count,
             int* __restrict__ dropped, int M, int F, int H, int N, int C) {
  extern __shared__ int smem[];
  int* run = smem;                    // [H * DBLK] running member counts
  int* lkey = run + H * DBLK;         // [THREADS] compacted (row, dest)
  int* lidx = lkey + THREADS;         // [THREADS] compacted message index
  __shared__ int warp_off[THREADS / 32 + 1];

  const int r = blockIdx.y;
  const int d0 = blockIdx.x * DBLK;
  const int nd = min(DBLK, N - d0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t cnt0 = (size_t)r * H * N;

  for (int i = tid; i < H * DBLK; i += THREADS) {
    const int hh = i / DBLK, dd = i % DBLK;
    run[i] = dd < nd ? count[cnt0 + (size_t)hh * N + d0 + dd] : 0;
  }
  __syncthreads();

  const size_t mo = (size_t)r * M;
  int drops = 0;                      // warp 0's lanes only
  for (int base = 0; base < M; base += THREADS) {
    const int i = base + tid;
    bool mem = false;
    int key = 0;
    if (i < M && valid[mo + i]) {
      const int dd = dest[mo + i] - d0;
      if (dd >= 0 && dd < nd) {
        mem = true;
        const int row = arrival[mo + i] % H;
        key = (row < 0 ? row + H : row) * DBLK + dd;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mem);
    if (lane == 0) warp_off[warp] = __popc(ballot);
    __syncthreads();
    if (tid == 0) {
      int acc = 0;
      for (int w = 0; w < THREADS / 32; ++w) {
        const int c = warp_off[w];
        warp_off[w] = acc;
        acc += c;
      }
      warp_off[THREADS / 32] = acc;
    }
    __syncthreads();
    if (mem) {
      const int pos = warp_off[warp] + __popc(ballot & ((1u << lane) - 1u));
      lkey[pos] = key;
      lidx[pos] = i;
    }
    const int total = warp_off[THREADS / 32];
    __syncthreads();
    if (warp == 0) {
      for (int c = 0; c < total; c += 32) {
        const int j = c + lane;
        const bool act = j < total;
        const int k = act ? lkey[j] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, k);
        const int before = act ? run[k] : 0;
        __syncwarp();
        if (act) {
          const int slot = before + __popc(peers & ((1u << lane) - 1u));
          if (lane == 31 - __clz(peers)) run[k] = before + __popc(peers);
          if (slot < C) {
            const int mi = lidx[j];
            const int hh = k / DBLK, d = d0 + k % DBLK;
            const size_t cell = ((size_t)hh * N + d) * C + slot;
            const size_t plane = (size_t)H * N * C;
            for (int f = 0; f < F; ++f)
              data[((size_t)r * F + f) * plane + cell] =
                  pay[(mo + mi) * F + f];
            src[(size_t)r * plane + cell] = msrc[mo + mi];
            size[(size_t)r * plane + cell] = msize[mo + mi];
          } else {
            ++drops;
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }

  // count advances by the accepted members only: of the members that
  // went to a cell holding c0, min(C - c0, members) were accepted.
  for (int i = tid; i < H * DBLK; i += THREADS) {
    const int hh = i / DBLK, dd = i % DBLK;
    if (dd < nd) {
      const size_t at = cnt0 + (size_t)hh * N + d0 + dd;
      const int c0 = count[at];
      const int acc = max(0, min(C - c0, run[i] - c0));
      count[at] = c0 + acc;
    }
  }
  if (warp == 0) {
    drops = __reduce_add_sync(0xffffffffu, drops);
    if (lane == 0 && drops) atomicAdd(dropped + r, drops);
  }
}

}  // namespace

extern "C" int wtpu_route(const int* arrival, const int* dest,
                          const unsigned char* valid,
                          const int* msrc, const int* msize, const int* pay,
                          int* data, int* src, int* size, int* count,
                          int* dropped, int R, int M, int F, int H, int N,
                          int C, void* stream) {
  if (R == 0 || N == 0) return 0;
  const size_t smem = ((size_t)H * DBLK + 2 * THREADS) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + DBLK - 1) / DBLK, R);
  route_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      arrival, dest, valid, msrc, msize, pay, data, src, size, count,
      dropped, M, F, H, N, C);
  return (int)cudaGetLastError();
}
