// Equi-join probe of a sorted int64 key column, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/hash_probe/kernel.py::sorted_probe_pallas.
// The TPU kernel compares dense (block_b x block_r) tiles on (hi, lo) int32
// halves because its vector unit has no 64-bit lanes and no fast gather.
// Hopper has native int64 compares and a cached gather, so this is the
// lower-bound search that kernel's docstring names.
//
// Semantics (bit-equal to ref.py): idx = lower_bound(keys, p) clamped to
// R-1; found = keys[idx] == p and p != sentinel; idx = -1 where not found.
// Duplicate keys resolve to the leftmost match.
//
// Bound: B*8 bytes of probes read, R*8 of keys, B*5 written: ~0.15 us at
// the feed's shape (6,720 probes into 50,176 keys), far below one launch.
// So the design target is the launch floor, and what sets the time is the
// chain of dependent reads.  A binary search of one thread per probe in
// blocks of 256 (the first design) left 105 of 132 SMs idle at B = 6,720
// and made ~16 dependent reads per probe.  A splitter table of 4,096 keys
// gathered into each block's shared memory (the second design, measured
// and dropped) cost more to load than the levels it saved.  Here:
//   - PROBE_LANES lanes search one probe together, PROBE_THREADS /
//     PROBE_LANES probes a block: B = 6,720 gives 420 blocks, every SM
//     (a warp a probe, 33 keys a round, measured slower: more lanes'
//     loads for one fewer round);
//   - each round the lanes read PROBE_LANES keys spread evenly over the
//     probe's range at once and a ballot keeps the piece between the last
//     key below the probe and the first at or above it: the range shrinks
//     17x a round, so 4 dependent reads at R = 50,176 and 5 at 1,000,192,
//     the first of them (the same keys for every probe) from L1;
//   - the key at the answer is carried from the round that found it, so
//     no read follows the search.

#include <cuda_runtime.h>

#define PROBE_LANES 16   // below 32: a group is part of a warp
#define PROBE_THREADS 256

__global__ void __launch_bounds__(PROBE_THREADS)
sorted_probe_kernel(const long long* __restrict__ probe,
                    const long long* __restrict__ keys, int b, int r,
                    long long sentinel, int* __restrict__ idx,
                    unsigned char* __restrict__ found) {
  const int g = threadIdx.x & (PROBE_LANES - 1);
  const int i = (blockIdx.x * PROBE_THREADS + threadIdx.x) / PROBE_LANES;
  const unsigned group = ((1u << PROBE_LANES) - 1)
                         << (threadIdx.x & 31 & ~(PROBE_LANES - 1));
  const long long p = i < b ? probe[i] : 0;
  // the answer lies in [lo, hi]: keys[lo - 1] < p (or lo == 0), and
  // keys[hi] == kz >= p (or hi == r)
  int lo = 0, hi = i < b ? r : 0;
  long long kz = 0;
  while (lo < hi) {
    const int n = hi - lo;
    const bool take = n <= PROBE_LANES ? g < n : true;
    const int pos =
        n <= PROBE_LANES
            ? lo + g
            : lo + (int)((long long)(g + 1) * n / (PROBE_LANES + 1));
    const long long key = take ? __ldg(keys + pos) : 0;
    // the lanes whose key is below p are a prefix of the group
    const unsigned below = __ballot_sync(group, take && key < p) & group;
    const int c = __popc(below);
    const int cap = n <= PROBE_LANES ? n : PROBE_LANES;
    const int base = threadIdx.x & 31 & ~(PROBE_LANES - 1);
    // the first key at or above p, and the last below it
    const int pos_c = __shfl_sync(group, pos, base + (c < cap ? c : 0));
    const long long key_c = __shfl_sync(group, key, base + (c < cap ? c : 0));
    const int pos_b = __shfl_sync(group, pos, base + (c > 0 ? c - 1 : 0));
    if (c < cap) {
      hi = pos_c;
      kz = key_c;
    }
    if (c > 0) lo = pos_b + 1;
  }
  if (g == 0 && i < b) {
    const bool hit = hi < r && p != sentinel && kz == p;
    idx[i] = hit ? hi : -1;
    found[i] = hit ? 1 : 0;
  }
}

extern "C" int sorted_probe(const void* probe, const void* keys, int b,
                            int r, long long sentinel, void* idx,
                            void* found, void* stream) {
  if (b < 1 || r < 0) return (int)cudaErrorInvalidValue;
  const int per_block = PROBE_THREADS / PROBE_LANES;
  const int blocks = (b + per_block - 1) / per_block;
  sorted_probe_kernel<<<blocks, PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      (const long long*)probe, (const long long*)keys, b, r, sentinel,
      (int*)idx, (unsigned char*)found);
  return (int)cudaGetLastError();
}
