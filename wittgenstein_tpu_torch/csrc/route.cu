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
// What bounds it on an H100: latency, not bytes.  The bytes the batch
// needs are a byte of `valid` per message, the arrival and dest of each
// valid one, F + 2 words read and written per accepted message and the
// touched count cells read and written: about 1.62 MB (0.48 us at
// 3.35 TB/s) for chip_smoke.py's route case at 2048 nodes x 21 sends.
// The rank is stable input order while blocks run in no order, so no
// slot may come from the order of atomics.  The first design gave each
// block 16 destinations and had every block walk the whole message
// vector, three block barriers and a serial prefix per tile: 95 us at
// Handel shapes and 186 us at GSF shapes (NVIDIA H100 80GB HBM3, 700 W).
// Two more costs showed on the card: the accepted messages' writes,
// spread over the whole ring (0.4-1.3 GB) when a block owns a few
// destinations of every row, and the deepest bucket's ranking chain.
//
// Design: bucket the messages by ring cell once, then rank each bucket
// alone.  A bucket is CB consecutive cells of the [H, N] cell order
// (row-major, CB at least 4096), so its writes fall in one window of
// each plane.  Two launches on the caller's stream:
//
// 1. route_bucket_kernel, grid (tiles of TILE messages, R).  A block
//    reads its tile once and sorts its members stably by bucket into
//    the tile's own stretch of the bucket lists, and writes the tile's
//    segment starts off[r, tile, 0..B] (b's members of the tile lie at
//    off[b] .. off[b+1]; no scan across tiles is needed).  An entry
//    carries what the ranking and the writes need: the cell within the
//    bucket, the cell's count before the batch, and the message's src,
//    size and payload, all read here in parallel over the whole batch
//    and written through shared memory as whole lines (a scattered
//    4-byte store into a line the L2 does not hold costs a read of it).
//    In-warp order comes from __match_any_sync, the order across warps
//    from a [32 warps x B] table of 16-bit counts in shared memory (CB
//    grows with the ring so that B <= MAX_B).  Block (0, r) also sets
//    dropped[r] to 0.
// 2. route_rank_kernel, grid (B, R), RT threads.  A block walks only its
//    bucket, RT entries at a time, in order: for each tile, the segment
//    off[b] .. off[b+1].  The next 2 x RT entries are loaded while
//    this chunk is ranked.  A chunk takes two block barriers: each warp's
//    group leaders post their group sizes in a [warps x CB] byte table,
//    and each member's slot is the cell's count before the batch, plus
//    the bucket's running member count of the cell (CB ints), plus the
//    sizes posted by earlier warps, plus its rank in its warp.  The last
//    warp holding a cell advances its running count and writes its new
//    count, so only touched count cells are written.  Both tables live
//    in shared memory, or in device scratch where CB is too large.
//
// Cost: two launches; scratch from the wrapper (wtpu_route_scratch):
// 4 + F ints per message rounded up to the tile, and B + 1 ints per
// tile.  The message vector is read once and the bucket lists, which
// fit in L2, written and read once.  What is serial is two block
// barriers per RT members of a bucket, so the deepest bucket (a hot
// cell) sets the floor.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 1024;       // messages per tile = bucket-kernel threads
constexpr int RT = 512;          // rank-kernel threads
constexpr int NW = RT / 32;      // rank-kernel warps
constexpr int MAXF = 4;          // payload words read ahead in registers
constexpr int CB_MIN = 4096;     // cells per bucket, at least
constexpr int MAX_B = 2048;      // buckets, at most
constexpr unsigned FULL = 0xffffffffu;
// The rank kernel's tables in shared memory up to this size, else in
// device scratch.
constexpr size_t RANK_SMEM = 96 * 1024;

// [32 x B] uint16 warp counts + B segment starts.
__host__ __device__ inline size_t bucket_smem(int B) {
  return (size_t)B * (32 * sizeof(unsigned short) + sizeof(int));
}

// A bucket's running counts (CB ints) and warp sizes (NW x CB bytes).
__host__ __device__ inline size_t rank_tables(int CB) {
  return (size_t)CB * (sizeof(int) + NW);
}

// Exclusive scan of one int per thread over the block (NT threads);
// `ws` holds 33 ints.  Every thread of the block must call it.
template <int NT>
__device__ int block_excl_scan(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int s = lane < NT / 32 ? ws[lane] : 0;
    int incl = s;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    ws[lane] = incl - s;
    if (lane == 31) ws[32] = incl;
  }
  __syncthreads();
  const int res = ws[warp] + x - v;
  *total = ws[32];
  __syncthreads();
  return res;
}

// The bucket lists: per entry the member's cell within its bucket, the
// count of that cell before the batch, its src, size and F payload words
// (plane f at pay + f * stride).
struct Lists {
  int *key, *cnt0, *src, *size, *pay;
  size_t stride;
};

__global__ void __launch_bounds__(TILE)
route_bucket_kernel(const int* __restrict__ arrival,
                    const int* __restrict__ dest,
                    const unsigned char* __restrict__ valid,
                    const int* __restrict__ msrc,
                    const int* __restrict__ msize,
                    const int* __restrict__ pay,
                    const int* __restrict__ count, Lists lists,
                    int* __restrict__ off, int* __restrict__ dropped, int M,
                    int F, int H, int N, int CB, int B, int T) {
  extern __shared__ int4 smem4[];
  __shared__ int ws[33];
  __shared__ int stage[TILE];
  const int r = blockIdx.y, t = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t mo = (size_t)r * M;
  const int i = t * TILE + tid;
  // Every field is read up front, independent of the others.
  bool ok = false;
  int d = 0, a = 0, ms = 0, mz = 0, pw[MAXF];
  if (i < M) {
    ok = valid[mo + i];
    d = dest[mo + i];
    a = arrival[mo + i];
    ms = msrc[mo + i];
    mz = msize[mo + i];
  }
#pragma unroll
  for (int f = 0; f < MAXF; ++f)
    pw[f] = i < M && f < F ? pay[(mo + i) * F + f] : 0;
  int b = -1, key = 0, cnt0 = 0;
  if (ok && d >= 0 && d < N) {
    int row = a % H;
    row = row < 0 ? row + H : row;
    const long long cell = (long long)row * N + d;
    b = (int)(cell / CB);
    key = (int)(cell - (long long)b * CB);
    cnt0 = count[(size_t)r * H * N + cell];
  }
  if (t == 0 && tid == 0) dropped[r] = 0;
  const unsigned peers = __match_any_sync(FULL, b);
  const int leader = __ffs(peers) - 1;
  const int rank_w = __popc(peers & ((1u << lane) - 1u));

  unsigned short* wc = reinterpret_cast<unsigned short*>(smem4);  // [32][B]
  int* seg = reinterpret_cast<int*>(smem4) + 16 * B;               // [B]
  for (int k = tid; k < 4 * B; k += TILE) smem4[k] = make_int4(0, 0, 0, 0);
  __syncthreads();
  if (b >= 0 && lane == leader) wc[warp * B + b] = __popc(peers);
  __syncthreads();
  int* row_off = off + ((size_t)r * T + t) * (B + 1);
  int carry = 0;
  for (int base = 0; base < B; base += TILE) {
    const int bb = base + tid;
    int s = 0;
    if (bb < B) {
      for (int w = 0; w < TILE / 32; ++w) {     // exclusive over warps
        const int c = wc[w * B + bb];
        wc[w * B + bb] = (unsigned short)s;
        s += c;
      }
    }
    int tot;
    const int ex = block_excl_scan<TILE>(s, ws, &tot);
    if (bb < B) {
      seg[bb] = carry + ex;
      row_off[bb] = carry + ex;
    }
    carry += tot;
  }
  if (tid == 0) row_off[B] = carry;
  __syncthreads();
  // Each field goes through shared memory in sorted order and out as
  // whole lines: the tile's stretch of a list is written, not scattered.
  const int pos = b >= 0 ? seg[b] + wc[warp * B + b] + rank_w : -1;
  const size_t base = ((size_t)r * T + t) * TILE;
  auto put = [&](int* dst, int v) {
    if (pos >= 0) stage[pos] = v;
    __syncthreads();
    if (tid < carry) dst[base + tid] = stage[tid];
    __syncthreads();
  };
  put(lists.key, key);
  put(lists.cnt0, cnt0);
  put(lists.src, ms);
  put(lists.size, mz);
#pragma unroll
  for (int f = 0; f < MAXF; ++f)
    if (f < F) put(lists.pay + f * lists.stride, pw[f]);
  for (int f = MAXF; f < F; ++f)
    put(lists.pay + f * lists.stride, i < M ? pay[(mo + i) * F + f] : 0);
}

// One entry of a bucket list, read ahead of its chunk.
struct Entry {
  int key, cnt0, src, size, pay[MAXF];
};

__device__ __forceinline__ size_t load_entry(const Lists& L, const int* pre,
                                             const int* segst, int ntile,
                                             size_t list0, int j, int F,
                                             Entry& e) {
  int lo = 0, hi = ntile - 1;             // last segment starting <= j
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= j) lo = mid; else hi = mid - 1;
  }
  const size_t at = list0 + segst[lo] + (j - pre[lo]);
  e.key = L.key[at];
  e.cnt0 = L.cnt0[at];
  e.src = L.src[at];
  e.size = L.size[at];
#pragma unroll
  for (int f = 0; f < MAXF; ++f)
    if (f < F) e.pay[f] = L.pay[f * L.stride + at];
  return at;
}

__global__ void __launch_bounds__(RT)
route_rank_kernel(Lists lists, const int* __restrict__ off,
                  int* __restrict__ data, int* __restrict__ src,
                  int* __restrict__ size, int* __restrict__ count,
                  int* __restrict__ dropped, int* tables_g, int F, int H,
                  int N, int C, int CB, int B, int T) {
  extern __shared__ int4 smem4[];
  __shared__ int pre[RT];       // a tile group's member prefix
  __shared__ int segst[RT];     // ... and where each segment starts
  __shared__ int ws[33];
  const int b = blockIdx.x, r = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int4* tab = tables_g ? reinterpret_cast<int4*>(
                             tables_g + ((size_t)r * B + b) *
                                            (rank_tables(CB) / sizeof(int)))
                       : smem4;
  int* run = reinterpret_cast<int*>(tab);                          // [CB]
  unsigned char* wsz = reinterpret_cast<unsigned char*>(run + CB);  // [NW][CB]
  for (size_t k = tid; k < rank_tables(CB) / sizeof(int4); k += RT)
    tab[k] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const long long cell0 = (long long)b * CB;
  const size_t plane = (size_t)H * N * C;
  const size_t list0 = (size_t)r * T * TILE;
  int drops = 0;
  for (int t0 = 0; t0 < T; t0 += RT) {
    const int t = t0 + tid;
    int len = 0, st = 0;
    if (t < T) {
      const int* o = off + ((size_t)r * T + t) * (B + 1) + b;
      st = o[0];
      len = o[1] - st;
    }
    int total;
    const int ex = block_excl_scan<RT>(len, ws, &total);
    pre[tid] = ex;
    segst[tid] = t * TILE + st;
    __syncthreads();
    const int ntile = min(RT, T - t0);
    // The next two chunks' entries are in flight while one is ranked.
    Entry cur, nxt, nx2;
    size_t at = 0, at_nxt = 0, at_nx2 = 0;
    bool act = tid < total, act_nxt = RT + tid < total;
    if (act) at = load_entry(lists, pre, segst, ntile, list0, tid, F, cur);
    if (act_nxt)
      at_nxt = load_entry(lists, pre, segst, ntile, list0, RT + tid, F, nxt);
    for (int c0 = 0; c0 < total; c0 += RT) {
      const bool act_nx2 = c0 + 2 * RT + tid < total;
      if (act_nx2)
        at_nx2 = load_entry(lists, pre, segst, ntile, list0,
                            c0 + 2 * RT + tid, F, nx2);
      const int key = act ? cur.key : -1;
      const unsigned peers = __match_any_sync(FULL, key);
      const int leader = __ffs(peers) - 1;
      const bool lead = act && lane == leader;
      if (lead) wsz[warp * CB + key] = (unsigned char)__popc(peers);
      __syncthreads();
      int bf = 0;
      bool last = true;
      if (lead) {
        int earlier = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const int c = wsz[w * CB + key];
          if (w < warp) earlier += c;
          if (w > warp && c) last = false;
        }
        bf = run[key] + earlier;
      }
      const int before = __shfl_sync(FULL, bf, leader);
      __syncthreads();
      if (lead) {
        wsz[warp * CB + key] = 0;
        if (last) {
          // count advances by the accepted members only: of the n
          // members so far of a cell that held c0, min(C - c0, n).
          const int n = bf + __popc(peers);
          run[key] = n;
          count[(size_t)r * H * N + cell0 + key] =
              cur.cnt0 + max(0, min(C - cur.cnt0, n));
        }
      }
      if (act) {
        const int slot =
            cur.cnt0 + before + __popc(peers & ((1u << lane) - 1u));
        if (slot < C) {
          const size_t cell = (size_t)(cell0 + key) * C + slot;
#pragma unroll
          for (int f = 0; f < MAXF; ++f)
            if (f < F) data[((size_t)r * F + f) * plane + cell] = cur.pay[f];
          for (int f = MAXF; f < F; ++f)
            data[((size_t)r * F + f) * plane + cell] =
                lists.pay[f * lists.stride + at];
          src[(size_t)r * plane + cell] = cur.src;
          size[(size_t)r * plane + cell] = cur.size;
        } else {
          ++drops;
        }
      }
      cur = nxt;
      at = at_nxt;
      act = act_nxt;
      nxt = nx2;
      at_nxt = at_nx2;
      act_nxt = act_nx2;
    }
    __syncthreads();
  }
  drops = __reduce_add_sync(FULL, drops);
  if (lane == 0 && drops) atomicAdd(dropped + r, drops);
}

struct Dims {
  int T, CB, B;
  bool tables_in_smem;
};

Dims dims(int M, int H, int N) {
  Dims d;
  const long long cells = (long long)H * N;
  d.T = M > 0 ? (M + TILE - 1) / TILE : 1;
  long long cb = (cells + MAX_B - 1) / MAX_B;
  cb = cb < CB_MIN ? CB_MIN : (cb + 15) / 16 * 16;  // int4-sized tables
  d.CB = (int)cb;
  d.B = cells > 0 ? (int)((cells + cb - 1) / cb) : 1;
  d.tables_in_smem = rank_tables(d.CB) <= RANK_SMEM;
  return d;
}

// The dynamic shared memory the launches take: part 0 the bucket
// kernel's, part 1 the rank kernel's (0 where its tables are in device
// scratch); part 2 is 1 where the rank tables sit in shared memory.
// wtpu_route launches with it, and wtpu_route_smem exports it.
size_t launch_smem(const Dims& d, int part) {
  if (part == 0) return bucket_smem(d.B);
  if (part == 1) return d.tables_in_smem ? rank_tables(d.CB) : 0;
  return d.tables_in_smem ? 1 : 0;
}

// Dynamic shared memory past 48 KB, static included, must be asked for.
cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// Int32 elements of device scratch that wtpu_route needs for these
// shapes: where a bucket's tables do not fit in shared memory, those
// tables; the bucket lists (4 + F ints per entry); the per-tile segment
// starts.
extern "C" long long wtpu_route_scratch(int R, int M, int F, int H, int N) {
  const Dims d = dims(M, H, N);
  long long n = (long long)R * d.T * ((4LL + F) * TILE + d.B + 1);
  if (!d.tables_in_smem)
    n += (long long)R * d.B * (long long)(rank_tables(d.CB) / sizeof(int));
  return n;
}

// The launcher's shared-memory figure for these shapes (see launch_smem).
extern "C" long long wtpu_route_smem(int M, int H, int N, int part) {
  return (long long)launch_smem(dims(M, H, N), part);
}

extern "C" int wtpu_route(const int* arrival, const int* dest,
                          const unsigned char* valid,
                          const int* msrc, const int* msize, const int* pay,
                          int* data, int* src, int* size, int* count,
                          int* dropped, int* scratch, int R, int M, int F,
                          int H, int N, int C, void* stream) {
  if (R == 0) return 0;
  const Dims d = dims(M, H, N);
  const cudaStream_t s = (cudaStream_t)stream;
  // The rank tables first: int4 stores need them 16-byte aligned.
  int* tables_g = d.tables_in_smem ? nullptr : scratch;
  int* p = scratch + (d.tables_in_smem ? 0
                                       : (size_t)R * d.B *
                                             (rank_tables(d.CB) / sizeof(int)));
  const size_t nl = (size_t)R * d.T * TILE;
  const Lists lists = {p, p + nl, p + 2 * nl, p + 3 * nl, p + 4 * nl, nl};
  int* off = p + (4 + (size_t)F) * nl;
  const size_t sm1 = launch_smem(d, 0);
  cudaError_t e = allow_smem((const void*)route_bucket_kernel, sm1);
  if (e != cudaSuccess) return (int)e;
  route_bucket_kernel<<<dim3(d.T, R), TILE, sm1, s>>>(
      arrival, dest, valid, msrc, msize, pay, count, lists, off, dropped, M,
      F, H, N, d.CB, d.B, d.T);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t sm2 = launch_smem(d, 1);
  e = allow_smem((const void*)route_rank_kernel, sm2);
  if (e != cudaSuccess) return (int)e;
  route_rank_kernel<<<dim3(d.B, R), RT, sm2, s>>>(
      lists, off, data, src, size, count, dropped, tables_g, F, H, N, C,
      d.CB, d.B, d.T);
  return (int)cudaGetLastError();
}
