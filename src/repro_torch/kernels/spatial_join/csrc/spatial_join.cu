// Spatial radius top-k join for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/spatial_join/kernel.py::radius_join_pallas.
// For each probe point: the k nearest valid reference points within
// `radius` (d2 = dx*dx + dy*dy, nearest first, ties to the lower reference
// index) and the number of valid reference points within `radius`.
//
// The TPU kernel computes dense (block_b x block_r) distance tiles and
// extracts k minima per tile with min/iota reductions.  Here one warp owns
// P probes; the block's reference points stream through shared memory in
// tiles, lane t takes the tile's points t, t+32, ..., and keeps, per probe,
// a sorted in-radius top-K of (d2, index) in registers.  Only points inside
// the radius can reach the output, so a lane inserts only those (a
// fraction ~1e-4 of pairs at the slice's density).  At the end the warp
// merges its 32 sorted lists with k rounds of a butterfly (d2, index) min.
//
// Rounding: products and sums use __fmul_rn / __fadd_rn / __fsub_rn, so no
// FMA contraction changes d2 — the plain PyTorch version (separate
// rounded elementwise ops) gives the same bits, and a point on the radius
// boundary lands on the same side on both.
//
// Bound: 5 float ops per (probe, reference) pair (2 sub, 2 mul, 1 add);
// the inputs are 12 bytes per reference point and 8 per probe.  At the
// slice's shape (6,720 x 50,176 pairs) that is ~1.7 GFLOP against a few
// hundred KB: compute bound, ~25 us at the H100's 67 TFLOP/s float32.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>

#define WARPS 8
#define TILE 2048

template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K],
                                              float d, int j) {
  // bd ascending; entries equal to d stay ahead of it (lower index wins,
  // since references arrive in ascending index order per lane)
  if (!(d < bd[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (bd[s - 1] > d) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (bd[s] > d) {
      bd[s] = d;
      bi[s] = j;
    }
  }
  if (bd[0] > d) {
    bd[0] = d;
    bi[0] = j;
  }
}

template <int K>
__device__ __forceinline__ void pop_front(float (&bd)[K], int (&bi)[K]) {
#pragma unroll
  for (int s = 0; s < K - 1; ++s) {
    bd[s] = bd[s + 1];
    bi[s] = bi[s + 1];
  }
  bd[K - 1] = CUDART_INF_F;
  bi[K - 1] = INT_MAX;
}

template <int K, int P>
__global__ void __launch_bounds__(WARPS * 32)
radius_join_kernel(const float* __restrict__ px,
                   const float* __restrict__ py,
                   const float* __restrict__ rx,
                   const float* __restrict__ ry,
                   const unsigned char* __restrict__ valid, int b, int r,
                   float r2, int k_out, int* __restrict__ out_idx,
                   float* __restrict__ out_d2, int* __restrict__ out_count) {
  __shared__ float sx[TILE];
  __shared__ float sy[TILE];
  __shared__ unsigned char sv[TILE];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p0 = (blockIdx.x * WARPS + warp) * P;

  float qx[P], qy[P];
  float bd[P][K];
  int bi[P][K];
  int cnt[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    int g = p0 + p;
    qx[p] = g < b ? px[g] : 0.0f;
    qy[p] = g < b ? py[g] : 0.0f;
    cnt[p] = 0;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[p][s] = CUDART_INF_F;
      bi[p][s] = INT_MAX;
    }
  }

  for (int base = 0; base < r; base += TILE) {
    const int n = min(TILE, r - base);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      sx[t] = rx[base + t];
      sy[t] = ry[base + t];
      sv[t] = valid ? valid[base + t] : 1;
    }
    __syncthreads();
    for (int t = lane; t < n; t += 32) {
      if (!sv[t]) continue;
      const float x = sx[t], y = sy[t];
      const int j = base + t;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float dx = __fsub_rn(qx[p], x);
        const float dy = __fsub_rn(qy[p], y);
        const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (d <= r2) {
          cnt[p] += 1;
          insert_sorted<K>(bd[p], bi[p], d, j);
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int g = p0 + p;
    int total = cnt[p];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      total += __shfl_xor_sync(0xffffffffu, total, off);
    for (int s = 0; s < k_out; ++s) {
      float md = bd[p][0];
      int mi = bi[p][0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, md, off);
        const int oi = __shfl_xor_sync(0xffffffffu, mi, off);
        if (od < md || (od == md && oi < mi)) {
          md = od;
          mi = oi;
        }
      }
      // indices are unique across lanes, so exactly one lane pops
      if (mi != INT_MAX && bi[p][0] == mi) pop_front<K>(bd[p], bi[p]);
      if (lane == 0 && g < b) {
        const bool in = mi != INT_MAX;
        out_idx[(long long)g * k_out + s] = in ? mi : -1;
        out_d2[(long long)g * k_out + s] = in ? md : CUDART_INF_F;
      }
    }
    if (lane == 0 && g < b) out_count[g] = total;
  }
}

template <int K, int P>
static void launch(const void* px, const void* py, const void* rx,
                   const void* ry, const void* valid, int b, int r,
                   float r2, int k, void* idx, void* d2, void* count,
                   cudaStream_t stream) {
  const int per_block = WARPS * P;
  const int blocks = (b + per_block - 1) / per_block;
  radius_join_kernel<K, P><<<blocks, WARPS * 32, 0, stream>>>(
      (const float*)px, (const float*)py, (const float*)rx,
      (const float*)ry, (const unsigned char*)valid, b, r, r2, k,
      (int*)idx, (float*)d2, (int*)count);
}

extern "C" int radius_join(const void* px, const void* py, const void* rx,
                           const void* ry, const void* valid, int b, int r,
                           float r2, int k, void* idx, void* d2,
                           void* count, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 1) {
    launch<1, 4>(px, py, rx, ry, valid, b, r, r2, k, idx, d2, count, s);
  } else if (k <= 2) {
    launch<2, 4>(px, py, rx, ry, valid, b, r, r2, k, idx, d2, count, s);
  } else if (k <= 4) {
    launch<4, 4>(px, py, rx, ry, valid, b, r, r2, k, idx, d2, count, s);
  } else if (k <= 8) {
    launch<8, 4>(px, py, rx, ry, valid, b, r, r2, k, idx, d2, count, s);
  } else if (k <= 16) {
    launch<16, 2>(px, py, rx, ry, valid, b, r, r2, k, idx, d2, count, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
