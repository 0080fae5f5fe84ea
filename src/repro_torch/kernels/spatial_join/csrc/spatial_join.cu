// Spatial radius top-k join for Hopper (sm_90a): a spatial-grid join.
//
// Replaces: src/repro/kernels/spatial_join/kernel.py::radius_join_pallas.
// For each probe point: the k nearest valid reference points within
// `radius` (d2 = dx*dx + dy*dy, nearest first, ties to the lower reference
// index) and the number of valid reference points within `radius`.
//
// Why cells and not tiles.  The TPU kernel computes dense (block_b x
// block_r) distance tiles, because a TPU has no cheap gather; its own
// docstring names the GPU design ("bucket by spatial grid and chase
// neighbor lists").  At the feed's Q4 shape (6,720 probes, 50,176
// references, r = 1.5 over 120 x 360 degrees) a dense scan visits 337 M
// pairs for ~8 hits per probe.  Here the references are binned into cells
// of side c ~ r, so a probe visits the 3 x 3 cells around it: ~23 points
// of its own cells and ~27 of other cells that share their buckets (one
// bucket per 2-4 rows, kernel.py: bucket_count), ~1,000x fewer pairs.
//
// Four launches, no memset, no host sync (the wrapper allocates one
// scratch with torch.empty and never reads the data's extent back):
//   1. grid_zero     zero the bucket counts and the done counter;
//   2. grid_count    rank each binnable reference in its bucket (32-bit
//                    atomicAdd); the last block to finish turns the counts
//                    into bucket starts (an exclusive scan, in place; the
//                    total of binned points after the last bucket);
//   3. grid_scatter  write each reference as (x, y, index) into its
//                    bucket's slot, one 16-byte store;
//   4. grid_probe    GROUP lanes per probe: lane g takes the g-th cell of
//                    the probe's box, the group flattens its cells' buckets
//                    and each lane takes every GROUP-th candidate (FLAT
//                    loads in flight) and keeps an in-register top-K by
//                    (d2, index); the group ranks its lists' entries in
//                    shared memory (a butterfly (d2, index) min per slot
//                    past MERGE_CAP entries).
// The scan is one block's: it reads the counts in tiles of a 16-byte load
// a thread (a contiguous chunk a thread made every access its own
// transaction, 34 us at 65,536 buckets); fewer buckets make it shorter
// and the probes' candidate lists longer, and one per 2-4 rows took the
// least in all (PERF.md, §6).
// A reference is binnable when it is valid and both coordinates are
// finite.  The dense version never counts another: it masks invalid rows
// to inf, a non-finite coordinate gives a d2 of inf or NaN, and the
// wrapper takes only a finite r2.
//
// The cell function, one for binning and probing: cell(v) =
// clamp(floor(v * inv_c), INT_MIN, largest float below 2^31), monotone in
// v.  Buckets hash (cell x, cell y) into a power-of-two table; two cells
// may share a bucket, so a probe accepts from a visited cell's bucket only
// the points whose own cell is that cell: each point is seen once.
//
// Rounding: d2 uses __fmul_rn / __fadd_rn / __fsub_rn (no FMA contraction),
// the plain PyTorch version's bits.  If d2 <= r2 then fl(dx*dx) <= r2, so
// |dx| <= sqrt(r2)(1 + u/2) and the exact |px - x| <= |dx| / (1 - u) <
// sqrt(r2)(1 + 2u) (u = 2^-24).  The wrapper's widened radius rw =
// sqrt(r2)(1 + 2^-20), rounded up to float32, bounds it.  The probe visits
// cells cell(fl(px - rw)) .. cell(fl(px + rw)); since rounding and cell()
// are monotone and x = fl(x) lies in [px - rw, px + rw], cell(x) lies in
// that range.  A probe whose box spans more than GROUP cells (coordinates
// so large that rw is below their ulp), or whose buckets hold as many
// candidates as the table has points, scans every bucket once: a mode
// decided on the device per probe, not a fallback.
//
// Bound: the inputs these calls need are B*8 bytes of probes, R*9 of
// reference coordinates and flags, B*k*8 + B*4 out (~0.29 us at the Q4
// shape at 3.35 TB/s).  Four launches sit far above it: the design target
// is a few launch floors.  The scan-every-bucket mode does the dense work
// (5 float operations a pair) and is compute-bound.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>

#define GROUP 16            // lanes per probe
#define MAX_CELLS GROUP     // cells a probe visits, one per lane
#define PROBE_THREADS 256   // grid_probe's block: 16 probes
#define BUILD_THREADS 256   // grid_zero's and grid_scatter's block
#define SCAN_THREADS 1024   // grid_count's block; the last one scans
#define MIN_BUCKETS 4096    // one scan tile: a 16-byte load a scan thread
#define MERGE_CAP 32        // list entries a group ranks in shared memory
#define FLAT 4              // candidates a probe lane loads at once

#define FULL 0xffffffffu

__device__ __forceinline__ int cell_of(float v, float inv) {
  float f = floorf(__fmul_rn(v, inv));
  f = fminf(fmaxf(f, -2147483648.0f), 2147483520.0f);
  return (int)f;
}

__device__ __forceinline__ unsigned bucket_of(int cx, int cy,
                                              unsigned mask) {
  // two odd multipliers, then murmur3's finalizer: neighbouring and
  // mirrored cells land in unrelated buckets
  unsigned h = (unsigned)cx * 0x9E3779B1u + (unsigned)cy * 0x7FEB352Du;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h & mask;
}

__device__ __forceinline__ bool binnable(const float* rx, const float* ry,
                                         const unsigned char* valid, int j,
                                         float& x, float& y) {
  x = rx[j];
  y = ry[j];
  return (valid == nullptr || valid[j]) && isfinite(x) && isfinite(y);
}

__global__ void grid_zero(int* __restrict__ starts, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    starts[i] = 0;
}

// counts[0..nb) ranks, counts[nb] the total after the scan, counts[nb + 1]
// the done counter
__global__ void __launch_bounds__(SCAN_THREADS)
grid_count(const float* __restrict__ rx, const float* __restrict__ ry,
           const unsigned char* __restrict__ valid, int r, float inv,
           int nb, int* counts, int* __restrict__ rank) {
  __shared__ int warp_sums[SCAN_THREADS / 32];
  __shared__ bool last;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  float x, y;
  if (j < r && binnable(rx, ry, valid, j, x, y)) {
    const unsigned b = bucket_of(cell_of(x, inv), cell_of(y, inv),
                                 (unsigned)nb - 1);
    rank[j] = atomicAdd(counts + b, 1);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counts + nb + 1, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block: exclusive scan of counts[0..nb) in place, read
  // through L2 (the other blocks' atomics live there), in tiles of one
  // 16-byte load a thread, neighbouring threads on neighbouring bytes; the
  // next tile's load is in flight during each scan
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = nb / (SCAN_THREADS * 4);
  int4* tile = reinterpret_cast<int4*>(counts) + threadIdx.x;
  int carry = 0;
  int4 cur = __ldcg(tile);
  for (int t = 0; t < tiles; ++t) {
    int4 next = cur;
    if (t + 1 < tiles) next = __ldcg(tile + (t + 1) * SCAN_THREADS);
    const int sum = cur.x + cur.y + cur.z + cur.w;
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(FULL, w, off);
        if (lane >= off) w += o;
      }
      warp_sums[lane] = w;   // inclusive over warps
    }
    __syncthreads();
    int4 o;
    o.x = carry + incl - sum + (warp ? warp_sums[warp - 1] : 0);
    o.y = o.x + cur.x;
    o.z = o.y + cur.y;
    o.w = o.z + cur.z;
    tile[t * SCAN_THREADS] = o;
    carry += warp_sums[31];
    __syncthreads();         // warp_sums is rewritten by the next tile
    cur = next;
  }
  if (threadIdx.x == 0) counts[nb] = carry;
}

__global__ void __launch_bounds__(BUILD_THREADS)
grid_scatter(const float* __restrict__ rx, const float* __restrict__ ry,
             const unsigned char* __restrict__ valid, int r, float inv,
             int nb, const int* __restrict__ starts,
             const int* __restrict__ rank, float4* __restrict__ pts) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  float x, y;
  if (j < r && binnable(rx, ry, valid, j, x, y)) {
    const unsigned b = bucket_of(cell_of(x, inv), cell_of(y, inv),
                                 (unsigned)nb - 1);
    pts[starts[b] + rank[j]] = make_float4(x, y, __int_as_float(j), 0.0f);
  }
}

__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// bd/bi ascending by (d2, index): candidates arrive in any order
template <int K>
__device__ __forceinline__ void insert_sorted(float (&bd)[K], int (&bi)[K],
                                              float d, int j) {
  if (!before(d, j, bd[K - 1], bi[K - 1])) return;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (before(d, j, bd[s - 1], bi[s - 1])) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (before(d, j, bd[s], bi[s])) {
      bd[s] = d;
      bi[s] = j;
    }
  }
  if (before(d, j, bd[0], bi[0])) {
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

template <int K>
__device__ __forceinline__ void consider(float qx, float qy, float4 p,
                                         float r2, float (&bd)[K],
                                         int (&bi)[K], int& cnt) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  if (d <= r2) {
    cnt += 1;
    insert_sorted<K>(bd, bi, d, __float_as_int(p.z));
  }
}

// points src[t], src[t + step], ... below end, four loads in flight; the
// count takes no branch, and the lists are touched only when one of the
// four beats the list's last entry (rarely, once the lists are full)
template <int K>
__device__ __forceinline__ void run(float qx, float qy,
                                    const float4* __restrict__ src, int t,
                                    int end, int step, float r2,
                                    float (&bd)[K], int (&bi)[K], int& cnt) {
  for (; t + 3 * step < end; t += 4 * step) {
    float4 p[4];
    float d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) p[u] = src[t + u * step];
    const float thr = fminf(r2, bd[K - 1]);
    bool any = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float dx = __fsub_rn(qx, p[u].x);
      const float dy = __fsub_rn(qy, p[u].y);
      d[u] = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      cnt += d[u] <= r2 ? 1 : 0;
      any |= d[u] <= thr;
    }
    if (any) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (d[u] <= r2) insert_sorted<K>(bd, bi, d[u], __float_as_int(p[u].z));
    }
  }
  for (; t < end; t += step) consider<K>(qx, qy, src[t], r2, bd, bi, cnt);
}

template <int K>
__global__ void __launch_bounds__(PROBE_THREADS)
grid_probe(const float* __restrict__ px, const float* __restrict__ py,
           int b, const float4* __restrict__ pts,
           const int* __restrict__ starts, int nb, float r2, float rw,
           float inv, int k_out, int* __restrict__ out_idx,
           float* __restrict__ out_d2, int* __restrict__ out_count) {
  __shared__ float sd[PROBE_THREADS / GROUP][MERGE_CAP];
  __shared__ int si[PROBE_THREADS / GROUP][MERGE_CAP];
  const int g = threadIdx.x & (GROUP - 1);
  const int slot = threadIdx.x / GROUP;
  // the group's lanes: each group runs on its own (GROUP == 16)
  const unsigned gm = 0xFFFFu << (threadIdx.x & 16);
  const int q = blockIdx.x * (PROBE_THREADS / GROUP) + slot;
  const bool live = q < b;
  const float qx = live ? px[q] : 0.0f, qy = live ? py[q] : 0.0f;
  const bool finite = live && isfinite(qx) && isfinite(qy);
  const int nvalid = __ldg(starts + nb);

  const int x0 = cell_of(__fsub_rn(qx, rw), inv);
  const int x1 = cell_of(__fadd_rn(qx, rw), inv);
  const int y0 = cell_of(__fsub_rn(qy, rw), inv);
  const int y1 = cell_of(__fadd_rn(qy, rw), inv);
  const long long nx = (long long)x1 - x0 + 1, ny = (long long)y1 - y0 + 1;
  bool scan_all = nx * ny > MAX_CELLS;

  // lane g's cell and its bucket's range
  int cx = 0, cy = 0, cstart = 0, csize = 0;
  if (finite && !scan_all && g < nx * ny) {
    cx = x0 + (int)(g % nx);
    cy = y0 + (int)(g / nx);
    const unsigned bk = bucket_of(cx, cy, (unsigned)nb - 1);
    cstart = __ldg(starts + bk);
    csize = __ldg(starts + bk + 1) - cstart;
  }
  int incl = csize;
#pragma unroll
  for (int off = 1; off < GROUP; off <<= 1) {
    const int o = __shfl_up_sync(gm, incl, off, GROUP);
    if (g >= off) incl += o;
  }
  const int excl = incl - csize;
  int total = __shfl_sync(gm, incl, GROUP - 1, GROUP);
  // buckets that hold the whole table (a radius as wide as the data, or
  // cells sharing buckets): read every point once, with no own-cell test
  if (total >= nvalid) scan_all = true;
  if (scan_all) total = nvalid;
  if (!finite) total = 0;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = INT_MAX;
  }
  int cnt = 0;
  if (scan_all) {
    // every bucket once: the binned points in order, each point once
    run<K>(qx, qy, pts, g, total, GROUP, r2, bd, bi, cnt);
  } else {
    // the group's lanes share the candidates of its cells evenly, FLAT
    // a lane a round with their loads in flight together
    for (int base = 0; base < total; base += FLAT * GROUP) {
      int oc[FLAT];
      float4 p[FLAT];
#pragma unroll
      for (int u = 0; u < FLAT; ++u) {
        const int t = base + u * GROUP + g;
        // the lane whose cell holds candidate t: the number of lanes
        // whose inclusive sum is <= t
        int own = 0;
#pragma unroll
        for (int step = GROUP / 2; step > 0; step >>= 1) {
          const int v = __shfl_sync(gm, incl, own + step - 1, GROUP);
          if (v <= t) own += step;
        }
        own &= GROUP - 1;
        const int ostart = __shfl_sync(gm, cstart, own, GROUP);
        const int oexcl = __shfl_sync(gm, excl, own, GROUP);
        oc[u] = own;
        p[u] = t < total ? __ldg(pts + ostart + (t - oexcl))
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < FLAT; ++u) {
        const int ocx = __shfl_sync(gm, cx, oc[u], GROUP);
        const int ocy = __shfl_sync(gm, cy, oc[u], GROUP);
        if (base + u * GROUP + g < total && cell_of(p[u].x, inv) == ocx &&
            cell_of(p[u].y, inv) == ocy)
          consider<K>(qx, qy, p[u], r2, bd, bi, cnt);
      }
    }
  }

  // merge: every lane's list holds its min(hits, K) best; the group's k
  // best are among them.  Up to MERGE_CAP entries are ranked in shared
  // memory, more by k rounds of a butterfly (d2, index) min.
  const int mine = min(cnt, K);
  int m_incl = mine;
#pragma unroll
  for (int off = 1; off < GROUP; off <<= 1) {
    const int o = __shfl_up_sync(gm, m_incl, off, GROUP);
    if (g >= off) m_incl += o;
  }
  const int n = __shfl_sync(gm, m_incl, GROUP - 1, GROUP);
  int total_cnt = cnt;
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1)
    total_cnt += __shfl_xor_sync(gm, total_cnt, off);
  const long long row = (long long)q * k_out;
  if (n <= MERGE_CAP) {
    const int at = m_incl - mine;
#pragma unroll
    for (int e = 0; e < K; ++e) {
      if (e < mine) {
        sd[slot][at + e] = bd[e];
        si[slot][at + e] = bi[e];
      }
    }
    __syncwarp(gm);
    for (int e = g; e < n; e += GROUP) {
      const float d = sd[slot][e];
      const int i = si[slot][e];
      int rank = 0;
      for (int j = 0; j < n; ++j)
        rank += before(sd[slot][j], si[slot][j], d, i) ? 1 : 0;
      if (live && rank < k_out) {
        out_idx[row + rank] = i;
        out_d2[row + rank] = d;
      }
    }
    if (live) {
      for (int s = n + g; s < k_out; s += GROUP) {
        out_idx[row + s] = -1;
        out_d2[row + s] = CUDART_INF_F;
      }
    }
  } else {
    for (int s = 0; s < k_out; ++s) {
      float md = bd[0];
      int mi = bi[0];
#pragma unroll
      for (int off = GROUP / 2; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(gm, md, off);
        const int oi = __shfl_xor_sync(gm, mi, off);
        if (before(od, oi, md, mi)) {
          md = od;
          mi = oi;
        }
      }
      // indices are unique across lanes, so exactly one lane pops
      if (mi != INT_MAX && bi[0] == mi) pop_front<K>(bd, bi);
      if (g == 0 && live) {
        const bool in = mi != INT_MAX;
        out_idx[row + s] = in ? mi : -1;
        out_d2[row + s] = in ? md : CUDART_INF_F;
      }
    }
  }
  if (g == 0 && live) out_count[q] = total_cnt;
}

template <int K>
static void probe(const void* px, const void* py, int b, const float4* pts,
                  const int* starts, int nb, float r2, float rw, float inv,
                  int k, void* idx, void* d2, void* count,
                  cudaStream_t stream) {
  const int per_block = PROBE_THREADS / GROUP;
  const int blocks = (b + per_block - 1) / per_block;
  grid_probe<K><<<blocks, PROBE_THREADS, 0, stream>>>(
      (const float*)px, (const float*)py, b, pts, starts, nb, r2, rw, inv,
      k, (int*)idx, (float*)d2, (int*)count);
}

// scratch: starts int32[nb + 2], padded to 16 bytes, then the binned
// points float4[r], then the ranks int32[r] (kernel.py: grid_plan)
extern "C" int radius_join(const void* px, const void* py, const void* rx,
                           const void* ry, const void* valid, int b, int r,
                           float r2, float rw, float inv, int nb, int k,
                           void* scratch, void* idx, void* d2, void* count,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (b < 1 || r < 0 || k < 1 || k > 16 || nb < MIN_BUCKETS ||
      (nb & (nb - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  char* base = (char*)scratch;
  int* starts = (int*)base;
  const size_t off = (((size_t)nb + 2) * 4 + 15) / 16 * 16;
  float4* pts = (float4*)(base + off);
  int* rank = (int*)(base + off + (size_t)r * 16);
  const float* fx = (const float*)rx;
  const float* fy = (const float*)ry;
  const unsigned char* v = (const unsigned char*)valid;
  const int rb = r > 0 ? r : 1;
  grid_zero<<<(nb + 2 + BUILD_THREADS - 1) / BUILD_THREADS, BUILD_THREADS,
              0, s>>>(starts, nb + 2);
  grid_count<<<(rb + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0,
               s>>>(fx, fy, v, r, inv, nb, starts, rank);
  grid_scatter<<<(rb + BUILD_THREADS - 1) / BUILD_THREADS, BUILD_THREADS, 0,
                 s>>>(fx, fy, v, r, inv, nb, starts, rank, pts);
  if (k <= 1) {
    probe<1>(px, py, b, pts, starts, nb, r2, rw, inv, k, idx, d2, count, s);
  } else if (k <= 2) {
    probe<2>(px, py, b, pts, starts, nb, r2, rw, inv, k, idx, d2, count, s);
  } else if (k <= 4) {
    probe<4>(px, py, b, pts, starts, nb, r2, rw, inv, k, idx, d2, count, s);
  } else if (k <= 8) {
    probe<8>(px, py, b, pts, starts, nb, r2, rw, inv, k, idx, d2, count, s);
  } else {
    probe<16>(px, py, b, pts, starts, nb, r2, rw, inv, k, idx, d2, count,
              s);
  }
  return (int)cudaGetLastError();
}
