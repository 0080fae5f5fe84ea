// Group-by segment sum for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segment_reduce/kernel.py::segment_sum_pallas.
// out[s] = sum of values[r] over the rows with seg[r] == s; rows whose
// segment lies outside [0, S) are dropped.
//
// The TPU has no atomics, so its kernel turns the scatter into a one-hot
// matrix product on the MXU.  Hopper has fast atomics in L2, so this is
// the plain form: a grid-stride loop, one atomicAdd per row into the (S,)
// output, which the caller zeroes.  int64 sums use the 64-bit integer
// atomic (two's-complement wrap, like the CPU), so no 64-bit input needs
// another path.  Float sums are order-nondeterministic.
//
// Bound: each row reads its value and its int32 segment and each output
// is written once — 8.1 MB at the slice's largest call (1,000,192 int32
// rows into 16,385 segments), ~2.4 us at 3.35 TB/s.  The atomics land in
// L2; with few segments and many rows they serialize per address.

#include <cuda_runtime.h>

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

template <typename T>
__global__ void segment_sum_kernel(const T* __restrict__ values,
                                   const int* __restrict__ seg,
                                   long long r, int s, T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < r; i += stride) {
    const int g = seg[i];
    if (g >= 0 && g < s) atomic_add(out + g, values[i]);
  }
}

template <typename T>
static void launch(const void* values, const void* seg, long long r, int s,
                   void* out, cudaStream_t stream) {
  const int threads = 256;
  long long want = (r + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? (want > 0 ? want : 1)
                                           : 132 * 16);
  segment_sum_kernel<T><<<blocks, threads, 0, stream>>>(
      (const T*)values, (const int*)seg, r, s, (T*)out);
}

// dtype: 0 int32, 1 int64, 2 float32, 3 float64
extern "C" int segment_sum(const void* values, const void* seg, long long r,
                           int s, int dtype, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: launch<int>(values, seg, r, s, out, st); break;
    case 1: launch<long long>(values, seg, r, s, out, st); break;
    case 2: launch<float>(values, seg, r, s, out, st); break;
    case 3: launch<double>(values, seg, r, s, out, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
