// Per-segment top-k row indices for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segment_topk/kernel.py::segment_topk_pallas.
// For every segment s in [0, S), the rows of its k largest values, values
// clipped below at 0, ties to the lower row; rows whose segment lies
// outside [0, S) are dropped.  Output (S, k) int32, -1 where a segment has
// fewer than k rows.
//
// Each row packs into one 64-bit key, (clip(v, 0) << 32) | (0xFFFFFFFF -
// row): a larger key is a larger value or, on equal values, the lower row,
// so the descending key order is the stable composite-sort order of
// ref.py.  No real key is 0, so 0 means "empty".
//
// Bound: reading each row once (int32 value + int32 segment) and writing
// the output, R*8 + S*k*4 bytes: 8.4 MB or 2.5 us at 3.35 TB/s for
// R = 2^20.  The first design (the TPU kernel's k selection rounds, one
// launch each) issued a memset, k round launches that each re-streamed
// all R rows and merged through global atomics, and a decode launch: k + 2
// stream operations per call.  Running the k rounds inside a block's
// shared memory instead still costs k passes of random 64-bit shared
// loads and atomics per row, which took longer than the rows' traffic.
//
// This design reads the rows once, runs no round over all of them, and
// launches at most twice (once up to 8,192 rows); no memset.
//   Stage 1 (topk_block_kernel, 1024 threads, at most one block per SM):
//   each block takes a contiguous share of rows in passes of 8,192 (8 a
//   thread, in registers, from 16-byte loads).  A pass buckets its rows by
//   segment in shared memory: a 32-bit atomicAdd per row counts the
//   segment and gives the row its slot, a block scan gives each bucket its
//   start, and the keys (with their segments) are scattered into their
//   buckets.  In a bucket of at most 64 keys a thread per key counts the
//   larger keys of its bucket (neighbouring lanes mostly read one bucket:
//   broadcast reads); a larger bucket gives its k largest to a warp, by k
//   rounds of a warp max (two 32-bit REDUX reductions, not shuffles).
//   The winners then lead their buckets, descending.  With one block
//   stage 1 writes the (S, k) rows itself.  Otherwise each block writes
//   each segment's winners and their count into an [S][blocks][k]
//   scratch (entries past the count are never written); a later pass
//   merges its winners into that list.
//   Stage 2 (topk_merge_kernel, a block per segment): two lower bounds on
//   the segment's k-th key, a full list's k-th key and the k-th largest
//   list head, prune the lists to a small pool in shared memory, where a
//   thread per key counts the larger ones: rank j < k is the j-th winner.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

#define TOPK_THREADS 1024
#define TOPK_MAX_SEGMENTS 2048
#define TOPK_MAX_K 16
#define ROWS_PER_THREAD 8        // a pass: 8 rows a thread, in registers
#define PASS_ROWS (ROWS_PER_THREAD * TOPK_THREADS)
#define RANK_MAX 64              // buckets ranked a thread per key
#define MERGE_THREADS 128        // stage 2: a block per segment
#define MERGE_LISTS 2            // lists a stage-2 thread loads
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ u64 pack_key(int v, long long row) {
  const unsigned hi = v > 0 ? (unsigned)v : 0u;
  return ((u64)hi << 32) | (u64)(0xFFFFFFFFu - (unsigned)row);
}

__device__ __forceinline__ int key_row(u64 key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}

// the largest x of the warp: two 32-bit warp reductions (REDUX), the
// high halves, then the low halves of the lanes holding the high maximum
__device__ __forceinline__ u64 warp_max(u64 x) {
  const unsigned hi = __reduce_max_sync(FULL_MASK, (unsigned)(x >> 32));
  const unsigned lo = __reduce_max_sync(
      FULL_MASK, (unsigned)(x >> 32) == hi ? (unsigned)x : 0u);
  return ((u64)hi << 32) | lo;
}

// off[i] = cnt[0] + ... + cnt[i-1] for i < s; wsum: 32 ints of scratch.
// Every thread of the block calls it.
__device__ void bucket_starts(const int* cnt, int* off, int* wsum, int s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int per = (s + nt - 1) / nt;
  const int a = min(tid * per, s), e = min(a + per, s);
  int local = 0;
  for (int i = a; i < e; ++i) local += cnt[i];
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(FULL_MASK, incl, d);
    if (lane >= d) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < (nt >> 5) ? wsum[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int t = __shfl_up_sync(FULL_MASK, wi, d);
      if (lane >= d) wi += t;
    }
    wsum[lane] = wi - w;
  }
  __syncthreads();
  int run = wsum[warp] + incl - local;
  for (int i = a; i < e; ++i) {
    off[i] = run;
    run += cnt[i];
  }
  __syncthreads();
}

// Rows [b * rows_per_block, ...) of block b.  One block: out (S, k) rows.
// Several: keys_out [S][blocks][k], counts_out [S][blocks].
__global__ void __launch_bounds__(TOPK_THREADS, 1)
topk_block_kernel(const int* __restrict__ values, const int* __restrict__ seg,
                  long long r, int s, int k, long long rows_per_block,
                  u64* __restrict__ keys_out,
                  unsigned char* __restrict__ counts_out,
                  int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* sorted = reinterpret_cast<u64*>(smem_raw);     // [PASS_ROWS] keys
  int* cnt = reinterpret_cast<int*>(sorted + PASS_ROWS);  // [s]
  int* off = cnt + s;                                // [s]
  int* wsum = off + s;                               // [32]
  unsigned short* sseg =                             // [PASS_ROWS]
      reinterpret_cast<unsigned short*>(wsum + 32);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int nb = gridDim.x, b = blockIdx.x;
  const bool direct = nb == 1;
  const long long lo = (long long)b * rows_per_block;
  const long long hi = lo + rows_per_block < r ? lo + rows_per_block : r;
  const long long n_all = hi > lo ? hi - lo : 0;
  const int passes = n_all ? (int)((n_all + PASS_ROWS - 1) / PASS_ROWS) : 1;

  for (int p = 0; p < passes; ++p) {
    const long long plo = lo + (long long)p * PASS_ROWS;
    const int n = (int)(hi - plo < PASS_ROWS ? (hi > plo ? hi - plo : 0)
                                             : PASS_ROWS);
    for (int i = tid; i < s; i += nt) cnt[i] = 0;
    __syncthreads();
    // this pass's rows: 4-row groups q = tid + m * nt, 16-byte loads
    // where aligned (plo is a multiple of 4 rows)
    const int* vb = values + plo;
    const int* sb = seg + plo;
    const bool aligned = ((reinterpret_cast<uintptr_t>(vb) |
                           reinterpret_cast<uintptr_t>(sb)) & 15) == 0;
    u64 key[ROWS_PER_THREAD];
    int gs[ROWS_PER_THREAD], slot[ROWS_PER_THREAD];
#pragma unroll
    for (int m = 0; m < ROWS_PER_THREAD / 4; ++m) {
      const int q = tid + m * nt;
      int vv[4] = {0, 0, 0, 0}, ss[4] = {-1, -1, -1, -1};
      if (aligned && 4 * q + 4 <= n) {
        const int4 v4 = __ldg(reinterpret_cast<const int4*>(vb) + q);
        const int4 s4 = __ldg(reinterpret_cast<const int4*>(sb) + q);
        vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
        ss[0] = s4.x; ss[1] = s4.y; ss[2] = s4.z; ss[3] = s4.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (4 * q + u < n) {
            vv[u] = vb[4 * q + u];
            ss[u] = sb[4 * q + u];
          }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * m + u;
        key[e] = pack_key(vv[u], plo + 4 * q + u);
        gs[e] = (unsigned)ss[u] < (unsigned)s ? ss[u] : -1;
      }
    }
    // bucket: count each segment and take a slot in it
#pragma unroll
    for (int e = 0; e < ROWS_PER_THREAD; ++e)
      slot[e] = gs[e] >= 0 ? atomicAdd(cnt + gs[e], 1) : 0;
    __syncthreads();
    bucket_starts(cnt, off, wsum, s);
#pragma unroll
    for (int e = 0; e < ROWS_PER_THREAD; ++e)
      if (gs[e] >= 0) {
        const int at = off[gs[e]] + slot[e];
        sorted[at] = key[e];
        sseg[at] = (unsigned short)gs[e];
      }
    const int valid = off[s - 1] + cnt[s - 1];
    __syncthreads();

    // a bucket of at most RANK_MAX keys: a thread per key counts the
    // larger keys of its bucket (lanes on neighbouring keys mostly read
    // one bucket: broadcast reads)
    int won[ROWS_PER_THREAD];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i) {
      const int at = tid + i * nt;
      won[i] = -1;
      if (at < valid) {
        const int g = sseg[at], c = cnt[g];
        if (c <= RANK_MAX) {
          const u64* bucket = sorted + off[g];
          const u64 x = sorted[at];
          int rank = 0;
#pragma unroll 4
          for (int t = 0; t < c; ++t) rank += bucket[t] > x;
          if (rank < k) {
            won[i] = off[g] + rank;
            key[i] = x;
          }
        }
      }
    }
    // a larger bucket: a warp takes its k largest by k rounds of a warp
    // max, then writes them to the bucket's first k slots
    for (int g = warp; g < s; g += nwarps) {
      const int c = cnt[g];
      if (c <= RANK_MAX) continue;
      u64* bucket = sorted + off[g];
      u64 lim = ~0ull, mine = 0ull;
      for (int j = 0; j < k; ++j) {
        u64 best = 0ull;
        for (int t = lane; t < c; t += 32) {
          const u64 x = bucket[t];
          if (x < lim && x > best) best = x;
        }
        best = warp_max(best);
        if (lane == j) mine = best;
        lim = best;
      }
      if (lane < k) bucket[lane] = mine;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i)
      if (won[i] >= 0) sorted[won[i]] = key[i];
    __syncthreads();

    // each segment's m = min(c, k) winners, descending, lead its bucket
    if (direct) {
      for (int i = tid; i < s * k; i += nt) {
        const int g = i / k, j = i - g * k;
        out[i] = j < cnt[g] ? key_row(sorted[off[g] + j]) : -1;
      }
    } else if (p == 0) {
      for (int i = tid; i < s * k; i += nt) {
        const int g = i / k, j = i - g * k, c = cnt[g];
        if (j < c) keys_out[((size_t)g * nb + b) * k + j] = sorted[off[g] + j];
        if (j == 0) counts_out[(size_t)g * nb + b] =
            (unsigned char)(c < k ? c : k);
      }
    } else {
      // merge into the earlier passes' list, a warp per segment: lanes
      // 0-15 hold that list, lanes 16-31 this pass's winners; rank of
      // each among the 32
      for (int g = warp; g < s; g += nwarps) {
        u64* list = keys_out + ((size_t)g * nb + b) * k;
        unsigned char* count = counts_out + (size_t)g * nb + b;
        const int old = *count, c = cnt[g], m = c < k ? c : k;
        const u64 x = lane < TOPK_MAX_K
                          ? (lane < old ? list[lane] : 0ull)
                          : (lane - TOPK_MAX_K < m
                                 ? sorted[off[g] + lane - TOPK_MAX_K] : 0ull);
        int rank = 0;
        for (int t = 0; t < 32; ++t)
          rank += __shfl_sync(FULL_MASK, x, t) > x;
        if (x && rank < k) list[rank] = x;
        if (lane == 0) *count = (unsigned char)(old + m < k ? old + m : k);
      }
    }
    __syncthreads();
  }
}

// One block per segment: the k largest of the stage-1 blocks' sorted
// lists.  Two lower bounds on the segment's k-th key prune the lists: a
// full list's k-th key, and the k-th largest of the lists' heads (k lists
// hold a key at least that large).  Only keys at or above both go into a
// shared-memory pool (each list's prefix, a warp-aggregated slot per key),
// and a thread per pooled key counts the larger ones: a key of rank j < k
// is the j-th winner.
__global__ void __launch_bounds__(MERGE_THREADS)
topk_merge_kernel(const u64* __restrict__ keys,
                  const unsigned char* __restrict__ counts, int s, int nb,
                  int k, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  u64* heads = reinterpret_cast<u64*>(smem_raw);     // [nb]
  u64* pool = heads + nb;                            // [nb * k]
  __shared__ u64 wfloor[MERGE_THREADS / 32];
  __shared__ int npool;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x;
  const u64* base = keys + (size_t)g * nb * k;
  const unsigned char* cg = counts + (size_t)g * nb;
  if (tid == 0) npool = 0;
  int c[MERGE_LISTS];
  u64 floor = 0ull;
#pragma unroll
  for (int m = 0; m < MERGE_LISTS; ++m) {
    const int bl = tid + m * MERGE_THREADS;
    c[m] = bl < nb ? cg[bl] : 0;
    if (bl < nb) heads[bl] = c[m] ? base[(size_t)bl * k] : 0ull;
    if (c[m] == k) {
      const u64 x = base[(size_t)bl * k + k - 1];
      floor = x > floor ? x : floor;
    }
  }
  __syncthreads();
  // the head of rank k - 1 (keys are unique; empty heads are 0)
#pragma unroll
  for (int m = 0; m < MERGE_LISTS; ++m) {
    const int bl = tid + m * MERGE_THREADS;
    if (bl >= nb || !c[m]) continue;
    const u64 x = heads[bl];
    int rank = 0;
    // the early exit is tested every 8 keys: tested on each key, it made
    // every shared-memory read wait on the one before
    for (int t = 0; t < nb && rank < k; t += 8)
#pragma unroll
      for (int u = 0; u < 8; ++u) rank += t + u < nb && heads[t + u] > x;
    if (rank == k - 1) floor = x > floor ? x : floor;
  }
  floor = warp_max(floor);
  if (lane == 0) wfloor[warp] = floor;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < MERGE_THREADS / 32; ++w)
    floor = wfloor[w] > floor ? wfloor[w] : floor;
  // each list's keys at or above the floor (a prefix) into the pool
#pragma unroll
  for (int m = 0; m < MERGE_LISTS; ++m) {
    const int bl = tid + m * MERGE_THREADS;
    u64 list[TOPK_MAX_K];
#pragma unroll
    for (int t = 0; t < TOPK_MAX_K; ++t)
      list[t] = t < c[m] ? base[(size_t)bl * k + t] : 0ull;
#pragma unroll
    for (int t = 0; t < TOPK_MAX_K; ++t) {
      const bool keep = t < c[m] && list[t] >= floor;
      const unsigned mask = __ballot_sync(FULL_MASK, keep);
      if (!mask) continue;
      int at = 0;
      if (lane == 0) at = atomicAdd(&npool, __popc(mask));
      at = __shfl_sync(FULL_MASK, at, 0);
      if (keep) pool[at + __popc(mask & ((1u << lane) - 1u))] = list[t];
    }
  }
  __syncthreads();
  const int n = npool;
  for (int i = tid; i < n; i += MERGE_THREADS) {
    const u64 x = pool[i];
    int rank = 0;
    for (int t = 0; t < n && rank < k; t += 8)
#pragma unroll
      for (int u = 0; u < 8; ++u) rank += t + u < n && pool[t + u] > x;
    if (rank < k) out[(size_t)g * k + rank] = key_row(x);
  }
  for (int j = n + tid; j < k; j += MERGE_THREADS) out[(size_t)g * k + j] = -1;
}

template <typename F>
static cudaError_t allow_smem(F* fn, int bytes, int* granted) {
  // the attribute is per device; set it once for the most bytes asked
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= 48 * 1024 || bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) granted[dev] = bytes;
  return err;
}

// values, seg: (r,) int32; out: (s, k) int32.  blocks and rows_per_block
// come from kernel.py's geometry(); scratch: s * blocks * (8 * k + 1)
// bytes when blocks > 1 (keys, then counts), else unused.  Takes
// 1 <= s <= 2048, 1 <= k <= 16, 0 < r < 2^31, 1 <= blocks <= 256, and one
// block only for r <= 8,192 (one pass).
extern "C" int segment_topk(const void* values, const void* seg, long long r,
                            int s, int k, int blocks,
                            long long rows_per_block, void* scratch,
                            void* out, void* stream) {
  static int granted[64];
  if (s < 1 || s > TOPK_MAX_SEGMENTS || k < 1 || k > TOPK_MAX_K || r < 1 ||
      r >= (1ll << 31) || blocks < 1 ||
      blocks > MERGE_THREADS * MERGE_LISTS ||
      rows_per_block < 1 || rows_per_block % 4 ||
      (long long)blocks * rows_per_block < r ||
      (blocks == 1 && r > PASS_ROWS) || (blocks > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const int smem = PASS_ROWS * (8 + 2) + (2 * s + 32) * 4;
  cudaError_t err = allow_smem(topk_block_kernel, smem, granted);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  u64* keys = (u64*)scratch;
  unsigned char* counts =
      blocks > 1 ? (unsigned char*)(keys + (size_t)s * blocks * k) : nullptr;
  topk_block_kernel<<<blocks, TOPK_THREADS, smem, st>>>(
      (const int*)values, (const int*)seg, r, s, k, rows_per_block, keys,
      counts, (int*)out);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks == 1) return (int)err;
  topk_merge_kernel<<<s, MERGE_THREADS, (size_t)blocks * (k + 1) * 8, st>>>(
      keys, counts, s, blocks, k, (int*)out);
  return (int)cudaGetLastError();
}
