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
// Round j (k rounds) picks, per segment, the largest key strictly below
// round j-1's winner: the TPU kernel's tournament without its "already
// taken" scan, since a key names its row.  Within a round a block keeps
// an S-entry table of keys in shared memory (with the previous round's
// winners beside it, 2 x 16 KB at S = 2048), folds its rows in with 64-bit
// atomicMax, then merges the table into the round's global row with one
// atomicMax per touched segment.  Rows are read in ascending order per
// thread and a row only issues its atomic when it beats the value it
// reads first, so with a handful of segments (group_by("safety_level"))
// the atomics stay rare after each block's first rows instead of
// serialising every row on a few shared addresses.  A last pass decodes
// the (k, S) keys into the (S, k) int32 output.  All k + 1 launches and
// the zeroing of the key table are issued by the one C entry point.
//
// Bound: reading each row once (int32 value + int32 segment) and writing
// the output: R*8 + S*k*4 bytes, 8.4 MB or 2.5 us at 3.35 TB/s for
// R = 2^20.  The k rounds re-stream R*8*k bytes (mostly from L2 when R*8
// fits its 50 MB), so at k = 16 the kernel moves 16x its bound.

#include <cuda_runtime.h>

typedef unsigned long long u64;

__device__ __forceinline__ u64 pack_key(int v, long long row) {
  const unsigned hi = v > 0 ? (unsigned)v : 0u;
  return ((u64)hi << 32) | (u64)(0xFFFFFFFFu - (unsigned)row);
}

// One selection round: out[g] = the largest key of segment g strictly
// below limit[g] (no limit in round 0, limit == nullptr).
__global__ void topk_round_kernel(const int* __restrict__ values,
                                  const int* __restrict__ seg, long long r,
                                  int s, const u64* __restrict__ limit,
                                  u64* __restrict__ out) {
  extern __shared__ u64 smem[];
  u64* best = smem;        // this block's winners of the round
  u64* lim = smem + s;     // the previous round's winners
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    best[i] = 0ull;
    lim[i] = limit ? limit[i] : ~0ull;
  }
  __syncthreads();
  volatile u64* vbest = best;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < r; i += stride) {
    const int g = seg[i];
    if ((unsigned)g >= (unsigned)s) continue;
    const u64 key = pack_key(values[i], i);
    // the read only filters: best[g] only grows, so a stale value can
    // cost a needless atomic but never skip a needed one
    if (key < lim[g] && key > vbest[g]) atomicMax(best + g, key);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s; i += blockDim.x) {
    const u64 b = best[i];
    if (b) atomicMax(out + i, b);
  }
}

// (k, S) keys -> (S, k) row indices, -1 for an empty key
__global__ void topk_decode_kernel(const u64* __restrict__ table, int s,
                                   int k, int* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= s * k) return;
  const int g = i / k, j = i - g * k;
  const u64 key = table[(long long)j * s + g];
  out[i] = key ? (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull)) : -1;
}

// values, seg: (r,) int32; table: (k, s) 64-bit scratch (zeroed here);
// out: (s, k) int32.  Takes 1 <= s <= 2048 (two s-entry key tables in
// shared memory) and r < 2^31.
extern "C" int segment_topk(const void* values, const void* seg, long long r,
                            int s, int k, void* table, void* out,
                            void* stream) {
  if (s < 1 || s > 2048 || k < 1 || r < 0 || r >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  u64* tab = (u64*)table;
  cudaError_t err =
      cudaMemsetAsync(tab, 0, (size_t)k * (size_t)s * sizeof(u64), st);
  if (err != cudaSuccess) return (int)err;
  const int threads = 512;
  long long want = (r + threads * 8 - 1) / (threads * 8);
  const int blocks = (int)(want < 1 ? 1 : (want > 2 * 132 ? 2 * 132 : want));
  const size_t shmem = 2 * (size_t)s * sizeof(u64);
  for (int j = 0; j < k; ++j) {
    topk_round_kernel<<<blocks, threads, shmem, st>>>(
        (const int*)values, (const int*)seg, r, s,
        j ? tab + (size_t)(j - 1) * s : nullptr, tab + (size_t)j * s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int n = s * k;
  topk_decode_kernel<<<(n + 255) / 256, 256, 0, st>>>(tab, s, k, (int*)out);
  return (int)cudaGetLastError();
}
