// Equi-join probe of a sorted int64 key column, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hash_probe/kernel.py::sorted_probe_pallas.
// The TPU kernel compares dense (block_b x block_r) tiles on (hi, lo) int32
// halves because its vector unit has no 64-bit lanes and no fast gather.
// Hopper has native int64 compares and a cached gather, so this is the
// binary search that kernel's docstring names: one thread per probe key,
// a lower-bound search over the ascending, KEY_SENTINEL-padded column.
//
// Semantics (bit-equal to ref.py): idx = lower_bound(keys, p) clamped to
// R-1; found = keys[idx] == p and p != sentinel; idx = -1 where not found.
// Duplicate keys resolve to the leftmost match.
//
// Bound: B*8 bytes of probes read, B*5 bytes written, ~B*log2(R) key reads
// that mostly hit L2 (the column is 0.4 MB at the slice's R = 50,176).
// At the slice's shape (B = 6,720) the memory bound is ~0.15 us, far below
// one launch, so the kernel is launch-latency bound; nothing here tries
// to do better than one short, fully parallel pass.

#include <cuda_runtime.h>

__global__ void sorted_probe_kernel(const long long* __restrict__ probe,
                                    const long long* __restrict__ keys,
                                    int b, int r, long long sentinel,
                                    int* __restrict__ idx,
                                    unsigned char* __restrict__ found) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  long long p = probe[i];
  int lo = 0, hi = r;
  while (lo < hi) {
    int mid = lo + ((hi - lo) >> 1);
    if (__ldg(keys + mid) < p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int at = lo < r ? lo : r - 1;
  bool hit = r > 0 && p != sentinel && __ldg(keys + at) == p;
  idx[i] = hit ? at : -1;
  found[i] = hit ? 1 : 0;
}

extern "C" int sorted_probe(const void* probe, const void* keys, int b,
                            int r, long long sentinel, void* idx,
                            void* found, void* stream) {
  const int threads = 256;
  int blocks = (b + threads - 1) / threads;
  sorted_probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)probe, (const long long*)keys, b, r, sentinel,
      (int*)idx, (unsigned char*)found);
  return (int)cudaGetLastError();
}
