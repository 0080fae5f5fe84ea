// Causal / non-causal GQA flash attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas.
// q (B, S, H, D), k and v (B, T, Kv, D) in that (JAX) layout, H = Kv * G,
// query head h reading kv head h / G.  o (B, S, H, D) in q's type:
//   s = (q . k) * D^-0.5 in float32, s = -1e30 where masked,
//   causal mask qpos >= kpos with both counted from 0 (top-left, also
//   when S < T), online softmax with running (m, l, acc) in float32,
//   p rounded to v's type before p . v, o = acc / max(l, 1e-30).
// Keys past T score -1e30 like masked ones; rows past S are not stored,
// so any S and T work without padding.
//
// One thread block per (q tile, head, batch).  K and V tiles are staged in
// shared memory and every warp of the block reads them; key tiles wholly
// above a causal q tile are never loaded.  Causal grids start with the
// longest q tiles (blockIdx.x counts down) so the short ones fill the tail.
//
// Two bodies:
//  * bfloat16 with D a multiple of 16 (the serving path: D = 128):
//    mma.sync.m16n8k16 on the tensor cores, bf16 in, f32 accumulate.  Four
//    warps of 16 query rows, 64-key tiles.  S = Q K^T lands in the
//    accumulator layout, which for a pair of 8-key tiles is exactly the
//    A-operand layout of P V, so P never leaves registers.  K's B operand
//    is a 32-bit shared load (two neighbouring d of one key); V's needs two
//    neighbouring keys of one d, built from two 16-bit loads.  Row strides
//    of D + 8 make both fragment reads free of bank conflicts.
//  * float32, and bfloat16 of other D <= 128: CUDA-core FMAs.  Four threads
//    per query row (d = part + 4 i), a shuffle sum per score, 32 rows and
//    32-key float32 tiles per block.
//
// Bound on this card: the causal products, 2 B H S T D operations (half of
// 4 B H S T D), against 989 TFLOP/s dense bf16; the bytes (q, k, v, o once
// each) are 30-100x below that at the serving shapes.  This first kernel
// uses mma.sync, synchronous tile loads and one tile in flight, so it is
// held by shared-memory loads and the softmax, not by the tensor cores:
// wgmma, TMA and a producer warp are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// tensor-core body (bf16, D = 16 * DK)
// ---------------------------------------------------------------------------

constexpr int MMA_BQ = 64;       // 4 warps x 16 query rows
constexpr int MMA_BK = 64;       // keys per tile: 8 accumulator tiles of 8
constexpr int MMA_THREADS = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack_h2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DK>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                 int T, int H, int KV, int G, int causal, float scale) {
  constexpr int D = 16 * DK;
  constexpr int LD = D + 8;          // shared row stride in elements
  constexpr int DN = 2 * DK;         // 8-wide output tiles
  constexpr int CH = D / 8;          // 16-byte chunks per row
  __shared__ __align__(16) bf16 ks[MMA_BK * LD];
  __shared__ __align__(16) bf16 vs[MMA_BK * LD];

  const int nq = (S + MMA_BQ - 1) / MMA_BQ;
  const int iq = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tq = lane & 3;
  const int q0 = iq * MMA_BQ;
  const int r0 = q0 + warp * 16 + gid;   // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;

  const size_t qstride = (size_t)H * D;
  const size_t kstride = (size_t)KV * D;
  const bf16* qb = q + (size_t)bb * S * qstride + (size_t)hh * D;
  const bf16* kb = k + (size_t)bb * T * kstride + (size_t)kvh * D;
  const bf16* vb = v + (size_t)bb * T * kstride + (size_t)kvh * D;

  // Q as A fragments, straight from device memory (rows past S are 0)
  uint32_t qa[DK][4];
#pragma unroll
  for (int kc = 0; kc < DK; ++kc) {
    const int c = kc * 16 + tq * 2;
    qa[kc][0] = r0 < S ? ld32(qb + r0 * qstride + c) : 0u;
    qa[kc][1] = r1 < S ? ld32(qb + r1 * qstride + c) : 0u;
    qa[kc][2] = r0 < S ? ld32(qb + r0 * qstride + c + 8) : 0u;
    qa[kc][3] = r1 < S ? ld32(qb + r1 * qstride + c + 8) : 0u;
  }

  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  // keys past the tile's last row are masked for all its rows
  const int kend = causal ? min(T, q0 + MMA_BQ) : T;
  for (int k0 = 0; k0 < kend; k0 += MMA_BK) {
    __syncthreads();                       // the last tile's readers are done
    for (int i = threadIdx.x; i < MMA_BK * CH; i += MMA_THREADS) {
      const int r = i / CH, c = (i - r * CH) * 8;
      uint4 kx = make_uint4(0u, 0u, 0u, 0u), vx = kx;
      if (k0 + r < T) {
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kstride + c);
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kstride + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kx;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vx;
    }
    __syncthreads();

    // scores of 16 rows x 64 keys: accumulator tile nt holds keys nt*8..+7,
    // this thread's (rows r0 / r1) x (keys nt*8 + tq*2 + {0, 1})
    float sc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const bf16* kp = ks + (nt * 8 + gid) * LD + tq * 2;
#pragma unroll
      for (int kc = 0; kc < DK; ++kc)
        mma_bf16(sc[nt], qa[kc], ld32(kp + kc * 16), ld32(kp + kc * 16 + 8));
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + nt * 8 + tq * 2 + e;
        float s0 = sc[nt][e] * scale, s1 = sc[nt][2 + e] * scale;
        if (key >= T || (causal && r0 < key)) s0 = NEG_INF;
        if (key >= T || (causal && r1 < key)) s1 = NEG_INF;
        sc[nt][e] = s0;
        sc[nt][2 + e] = s1;
        mx0 = fmaxf(mx0, s0);
        mx1 = fmaxf(mx1, s1);
      }
    }
    // the four threads of a quad share rows
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);

    // p = exp(s - m): l sums it in float32, P . V takes it rounded to bf16.
    // Accumulator tiles 2c and 2c+1 are A fragment c (keys c*16..+15):
    // regs {0, 1} from tile 2c, {2, 3} from tile 2c+1.
    uint32_t pa[4][4];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = __expf(sc[nt][0] - mn0), p1 = __expf(sc[nt][1] - mn0);
      const float p2 = __expf(sc[nt][2] - mn1), p3 = __expf(sc[nt][3] - mn1);
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      pa[nt >> 1][(nt & 1) * 2 + 0] = pack_f2(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = pack_f2(p2, p3);
    }
    l0 = l0 * al0 + ls0;                   // per-thread partial sums
    l1 = l1 * al1 + ls1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= al0;
      acc[dn][1] *= al0;
      acc[dn][2] *= al1;
      acc[dn][3] *= al1;
    }
    // B fragment of V for keys c*16 + tq*2 + {0, 1} (and + 8) at d = dn*8 + gid
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bf16* vp = vs + (c * 16 + tq * 2) * LD + gid;
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const bf16* p = vp + dn * 8;
        mma_bf16(acc[dn], pa[c], pack_h2(p[0], p[LD]),
                 pack_h2(p[8 * LD], p[9 * LD]));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  bf16* ob = o + (size_t)bb * S * qstride + (size_t)hh * D + tq * 2;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * qstride + dn * 8) =
          pack_f2(acc[dn][0] / l0, acc[dn][1] / l0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * qstride + dn * 8) =
          pack_f2(acc[dn][2] / l1, acc[dn][3] / l1);
  }
}

// ---------------------------------------------------------------------------
// CUDA-core body (float32, or bf16 with D not a multiple of 16), D <= 128
// ---------------------------------------------------------------------------

constexpr int SC_BQ = 32;        // 4 threads per row
constexpr int SC_BK = 32;
constexpr int SC_THREADS = 128;
constexpr int SC_DMAX = 128;
constexpr int SC_DPT = SC_DMAX / 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename Tin> __device__ __forceinline__ Tin from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename Tin>
__global__ void __launch_bounds__(SC_THREADS)
flash_scalar_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                    const Tin* __restrict__ v, Tin* __restrict__ o, int S,
                    int T, int H, int KV, int G, int D, int causal,
                    float scale) {
  __shared__ float ks[SC_BK * SC_DMAX];
  __shared__ float vs[SC_BK * SC_DMAX];

  const int nq = (S + SC_BQ - 1) / SC_BQ;
  const int iq = causal ? nq - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / G;
  const int part = threadIdx.x & 3;
  const int q0 = iq * SC_BQ;
  const int r = q0 + (threadIdx.x >> 2);

  const size_t qstride = (size_t)H * D;
  const size_t kstride = (size_t)KV * D;
  const Tin* qb = q + (size_t)bb * S * qstride + (size_t)hh * D;
  const Tin* kb = k + (size_t)bb * T * kstride + (size_t)kvh * D;
  const Tin* vb = v + (size_t)bb * T * kstride + (size_t)kvh * D;

  float qr[SC_DPT], acc[SC_DPT];
#pragma unroll
  for (int i = 0; i < SC_DPT; ++i) {
    const int d = part + 4 * i;
    qr[i] = (r < S && d < D) ? to_f(qb[r * qstride + d]) : 0.f;
    acc[i] = 0.f;
  }
  float m = NEG_INF, l = 0.f;

  const int kend = causal ? min(T, q0 + SC_BQ) : T;
  for (int k0 = 0; k0 < kend; k0 += SC_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < SC_BK * D; i += SC_THREADS) {
      const int j = i / D, d = i - j * D;
      const bool in = k0 + j < T;
      ks[j * SC_DMAX + d] = in ? to_f(kb[(size_t)(k0 + j) * kstride + d]) : 0.f;
      vs[j * SC_DMAX + d] = in ? to_f(vb[(size_t)(k0 + j) * kstride + d]) : 0.f;
    }
    __syncthreads();

    float s[SC_BK];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < SC_BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < SC_DPT; ++i)
        if (part + 4 * i < D) dot = fmaf(qr[i], ks[j * SC_DMAX + part + 4 * i], dot);
      // commutative pairs: all four threads of the row get the same sum
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int key = k0 + j;
      float sv = dot * scale;
      if (key >= T || (causal && r < key)) sv = NEG_INF;
      s[j] = sv;
      mx = fmaxf(mx, sv);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < SC_DPT; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < SC_BK; ++j) {
      const float p = expf(s[j] - mn);
      ls += p;
      const float pr = to_f(from_f<Tin>(p));   // p in v's type
#pragma unroll
      for (int i = 0; i < SC_DPT; ++i)
        if (part + 4 * i < D)
          acc[i] = fmaf(pr, vs[j * SC_DMAX + part + 4 * i], acc[i]);
    }
    l = l * alpha + ls;
    m = mn;
  }
  if (r >= S) return;
  l = fmaxf(l, 1e-30f);
  Tin* orow = o + (size_t)bb * S * qstride + (size_t)hh * D + r * qstride;
#pragma unroll
  for (int i = 0; i < SC_DPT; ++i) {
    const int d = part + 4 * i;
    if (d < D) orow[d] = from_f<Tin>(acc[i] / l);
  }
}

// ---------------------------------------------------------------------------
// C entry point
// ---------------------------------------------------------------------------

template <int DK>
static void launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int T, int H, int KV, int causal,
                       float scale, cudaStream_t stream) {
  dim3 grid((S + MMA_BQ - 1) / MMA_BQ, H, B);
  flash_mma_kernel<DK><<<grid, MMA_THREADS, 0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, T, H, KV,
      H / KV, causal, scale);
}

// dtype: 0 float32, 1 bfloat16.  The wrapper checks shapes (B, H <= 65535,
// H % KV == 0, 1 <= D <= 128, T >= 1, S >= 1) and 16-byte alignment.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int T, int H, int KV,
                               int D, int causal, float scale, int dtype,
                               cudaStream_t stream) {
  if (dtype == 1 && D % 16 == 0) {
    switch (D / 16) {
      case 1: launch_mma<1>(q, k, v, o, B, S, T, H, KV, causal, scale, stream); break;
      case 2: launch_mma<2>(q, k, v, o, B, S, T, H, KV, causal, scale, stream); break;
      case 3: launch_mma<3>(q, k, v, o, B, S, T, H, KV, causal, scale, stream); break;
      case 4: launch_mma<4>(q, k, v, o, B, S, T, H, KV, causal, scale, stream); break;
      case 5: launch_mma<5>(q, k, v, o, B, S, T, H, KV, causal, scale, stream); break;
      case 6: launch_mma<6>(q, k, v, o, B, S, T, H, KV, causal, scale, stream); break;
      case 7: launch_mma<7>(q, k, v, o, B, S, T, H, KV, causal, scale, stream); break;
      case 8: launch_mma<8>(q, k, v, o, B, S, T, H, KV, causal, scale, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
  dim3 grid((S + SC_BQ - 1) / SC_BQ, H, B);
  if (dtype == 0)
    flash_scalar_kernel<float><<<grid, SC_THREADS, 0, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, S, T, H,
        KV, H / KV, D, causal, scale);
  else if (dtype == 1)
    flash_scalar_kernel<bf16><<<grid, SC_THREADS, 0, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, S, T, H, KV,
        H / KV, D, causal, scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
