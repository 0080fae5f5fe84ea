// Group-by segment sum for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segment_reduce/kernel.py::segment_sum_pallas.
// out[s] = sum of values[r] over the rows with seg[r] == s; rows whose
// segment lies outside [0, S) are dropped.  A null values pointer is the
// count mode: every row adds 1 (int32).
//
// The TPU has no atomics, so its kernel turns the scatter into a one-hot
// matrix product on the MXU.  Hopper has atomics in shared memory and in
// L2.  Bound: each row reads its value and its segment and each output is
// written once, 8.1 MB at the feed's 1,000,192 int32 rows into 16,385
// segments (2.4 us at 3.35 TB/s).  What held the first design (one global
// atomicAdd per row) back was the atomics: the read path's calls put up
// to 2^20 rows onto 128-256 segments, often 6 real groups, and every
// atomic on one address queues in one L2 slice.
//
// One persistent grid-stride kernel, 16-byte loads of 4 rows a thread
// (values and segments, int32 or int64 ids), in one of three modes that
// kernel.py's plan() picks from R and S:
//   direct  one block (R and S <= 8,192): sums in shared memory, then
//           writes every output itself: one launch, no memset;
//   shared  S * itemsize fits in shared memory and S is small against the
//           rows a block reads: each block sums in shared memory, then
//           adds each touched segment into the output with one global
//           atomic (S per block against thousands of rows);
//   global  otherwise (the feed's 16,385 segments, where a block's flush
//           would cost as many atomics as its rows): one global atomic a
//           row, bound by the rate of L2 atomics.
// In the shared-memory modes a warp first merges its lanes' rows that
// share a segment (__match_any_sync, then a shuffle tree over the peers),
// so one atomic goes to shared memory per segment and warp step.  The
// shared and global modes zero the output with a memset in this call.
// int64 sums use 64-bit integer atomics (two's-complement wrap, like the
// CPU); float sums depend on the order of the atomics.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define SUM_THREADS 512
#define SUM_MAX_SMEM 232448
#define FULL_MASK 0xffffffffu

enum { MODE_DIRECT = 0, MODE_SHARED = 1, MODE_GLOBAL = 2 };

__device__ __forceinline__ void atomic_add(int* a, int v) { atomicAdd(a, v); }
__device__ __forceinline__ void atomic_add(long long* a, long long v) {
  atomicAdd((unsigned long long*)a, (unsigned long long)v);
}
__device__ __forceinline__ void atomic_add(float* a, float v) {
  atomicAdd(a, v);
}
__device__ __forceinline__ void atomic_add(double* a, double v) {
  atomicAdd(a, v);
}

// integer sums wrap (two's complement), as the atomics and the CPU do
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ long long wrap_add(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ float wrap_add(float a, float b) { return a + b; }
__device__ __forceinline__ double wrap_add(double a, double b) {
  return a + b;
}

// The sum of x over the lanes in ``peers`` (this lane among them), valid
// in the lowest of them: a tree over the peers' relative positions (each
// step, a lane at an even position takes its next peer's sum).  Every lane
// of the warp must call it.
template <typename T>
__device__ __forceinline__ T reduce_peers(unsigned peers, T x) {
  const int lane = threadIdx.x & 31;
  unsigned rel = __popc(peers & ((1u << lane) - 1u));
  peers &= 0xfffffffeu << lane;          // peers above this lane
  while (__any_sync(FULL_MASK, peers)) {
    const int next = __ffs(peers);
    const T t = __shfl_sync(FULL_MASK, x, next ? next - 1 : lane);
    if (next) x = wrap_add(x, t);
    peers &= ~__ballot_sync(FULL_MASK, rel & 1u);
    rel >>= 1;
  }
  return x;
}

template <typename X>
__device__ __forceinline__ void load4(const X* p, X (&o)[4]) {
  const int4* q = reinterpret_cast<const int4*>(p);
  const int4 a = __ldg(q);
  if constexpr (sizeof(X) == 4) {
    memcpy(o, &a, 16);
  } else {
    const int4 b = __ldg(q + 1);
    memcpy(o, &a, 16);
    memcpy(o + 2, &b, 16);
  }
}

template <typename T, typename G>
__global__ void __launch_bounds__(SUM_THREADS)
segment_sum_kernel(const T* __restrict__ values, const G* __restrict__ seg,
                   long long r, int s, int mode, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* part = reinterpret_cast<T*>(smem_raw);
  const bool priv = mode != MODE_GLOBAL;
  T* acc = priv ? part : out;
  if (priv) {
    for (int i = threadIdx.x; i < s; i += blockDim.x) part[i] = T(0);
    __syncthreads();
  }
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(values) |
                     reinterpret_cast<uintptr_t>(seg)) & 15) == 0;
  const long long nq = vec ? r >> 2 : 0;
  if (priv) {
    // whole warps step together (match and shuffles need every lane)
    for (long long q = gtid; __any_sync(FULL_MASK, q < nq); q += stride) {
      const bool ok = q < nq;
      G g4[4] = {G(-1), G(-1), G(-1), G(-1)};
      T v4[4] = {T(1), T(1), T(1), T(1)};
      if (ok) {
        load4(seg + 4 * q, g4);
        if (values) load4(values + 4 * q, v4);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int key = ok && g4[u] >= 0 && g4[u] < s ? (int)g4[u] : -1;
        const unsigned peers = __match_any_sync(FULL_MASK, key);
        const T x = reduce_peers(peers, key >= 0 ? v4[u] : T(0));
        if (key >= 0 && (int)(threadIdx.x & 31) == __ffs(peers) - 1)
          atomic_add(part + key, x);
      }
    }
  } else {
    for (long long q = gtid; q < nq; q += stride) {
      G g4[4];
      T v4[4] = {T(1), T(1), T(1), T(1)};
      load4(seg + 4 * q, g4);
      if (values) load4(values + 4 * q, v4);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (g4[u] >= 0 && g4[u] < s) atomic_add(out + g4[u], v4[u]);
    }
  }
  // the rows past the last 4-row group (all rows when unaligned)
  for (long long i = 4 * nq + gtid; i < r; i += stride) {
    const G g = seg[i];
    if (g >= 0 && g < s) atomic_add(acc + g, values ? values[i] : T(1));
  }
  if (priv) {
    __syncthreads();
    for (int i = threadIdx.x; i < s; i += blockDim.x) {
      const T p = part[i];
      if (mode == MODE_DIRECT)
        out[i] = p;
      else if (p != T(0))                // adding 0 changes no output
        atomic_add(out + i, p);
    }
  }
}

template <typename T, typename G>
static cudaError_t launch(const void* values, const void* seg, long long r,
                          int s, int mode, int blocks, void* out,
                          cudaStream_t st) {
  const int smem = mode == MODE_GLOBAL ? 0 : s * (int)sizeof(T);
  // the attribute is per device; set it once for the most bytes asked
  static int granted[64];
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (smem > granted[dev]) {
      err = cudaFuncSetAttribute(segment_sum_kernel<T, G>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return err;
      granted[dev] = smem;
    }
  }
  if (mode != MODE_DIRECT) {
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)s * sizeof(T), st);
    if (err != cudaSuccess) return err;
  }
  segment_sum_kernel<T, G><<<blocks, SUM_THREADS, smem, st>>>(
      (const T*)values, (const G*)seg, r, s, mode, (T*)out);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_seg(const void* values, const void* seg,
                              long long r, int s, int seg_bytes, int mode,
                              int blocks, void* out, cudaStream_t st) {
  return seg_bytes == 8
             ? launch<T, long long>(values, seg, r, s, mode, blocks, out, st)
             : launch<T, int>(values, seg, r, s, mode, blocks, out, st);
}

// dtype: 0 int32, 1 int64, 2 float32, 3 float64; values null: count mode
// (dtype 0).  seg_bytes: 4 (int32 ids) or 8 (int64).  mode and blocks come
// from kernel.py's plan(): 0 direct (one block), 1 shared, 2 global.
extern "C" int segment_sum(const void* values, const void* seg, long long r,
                           int s, int dtype, int seg_bytes, int mode,
                           int blocks, void* out, void* stream) {
  static const int itemsize[4] = {4, 8, 4, 8};
  if (r < 0 || s < 1 || dtype < 0 || dtype > 3 || blocks < 1 ||
      (seg_bytes != 4 && seg_bytes != 8) || mode < MODE_DIRECT ||
      mode > MODE_GLOBAL || (mode == MODE_DIRECT && blocks != 1) ||
      (values == nullptr && dtype != 0) ||
      (mode != MODE_GLOBAL && (long long)s * itemsize[dtype] > SUM_MAX_SMEM))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_seg<int>(values, seg, r, s, seg_bytes, mode, blocks, out,
                            st);
      break;
    case 1:
      err = launch_seg<long long>(values, seg, r, s, seg_bytes, mode, blocks,
                                  out, st);
      break;
    case 2:
      err = launch_seg<float>(values, seg, r, s, seg_bytes, mode, blocks,
                              out, st);
      break;
    default:
      err = launch_seg<double>(values, seg, r, s, seg_bytes, mode, blocks,
                               out, st);
  }
  return (int)err;
}
