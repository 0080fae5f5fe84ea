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
// Three bodies, a pure function of (dtype, D) (kernel.py's body()):
//  * "wgmma": bfloat16 with D in {64, 128} (the serving path: D = 128).
//    One block per (128-row q tile, head, batch), 384 threads: two
//    consumer warpgroups of 64 query rows and a producer warpgroup, one
//    thread of which issues every copy.  The producer loads Q once, and
//    K and V tiles of 64 keys into a 3-stage ring, with TMA: 4-D tensor
//    maps over the JAX layout, 128-byte swizzle, two 64-wide boxes per
//    row at D = 128, the batch edge and the ragged T edge clipped (zero
//    filled) in hardware.  Each stage has a full and an empty mbarrier.
//    Consumers run S = Q K^T as wgmma m64n64k16 with both operands in
//    shared memory (K-major), mask and softmax in the accumulator layout,
//    and P V as wgmma m64nDk16 with P from registers and V read MN-major
//    (the transpose bit), so V is never transposed.  A warpgroup issues
//    Q K^T of tile j and P V of tile j - 1 together, in turns with the
//    other warpgroup (named barriers, FA3's ping-pong), and runs tile j's
//    softmax while the products run.  setmaxnreg moves registers from the
//    producer warpgroup to the consumers (168 each at entry; 24 and 240
//    after).  Outputs are staged through the warpgroup's own Q rows in
//    shared memory and stored as 16-byte row-contiguous writes.
//  * "mma_sync": bfloat16 with another D that is a multiple of 16:
//    mma.sync.m16n8k16, four warps of 16 query rows, 64-key tiles loaded
//    synchronously.  S = Q K^T lands in the accumulator layout, which for
//    a pair of 8-key tiles is exactly the A-operand layout of P V.  Row
//    strides of D + 8 make the K and V fragment reads conflict-free.
//  * "cuda_core": float32, and bfloat16 of other D <= 128: CUDA-core FMAs.
//    Four threads per query row (d = part + 4 i), a shuffle sum per score,
//    32 rows and 32-key float32 tiles per block.
// Key tiles wholly above a causal q tile are never loaded, and causal
// grids start with the longest q tiles so the short ones fill the tail.
//
// Bound on this card: the causal products, 2 B H S T D operations (half of
// 4 B H S T D), against 989 TFLOP/s dense bf16; the bytes (q, k, v, o once
// each) are 30-100x below that at the serving shapes.  The wgmma body
// reaches a third of that bound at S = T = 1,536 and under half at 4,096
// on an H100 80GB HBM3 at 700 W.

#include <cuda.h>   // CUtensorMap and its enums; no -lcuda (see encoder())
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// mma_sync body (bf16, D = 16 * DK)
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
// cuda_core body (float32, or bf16 with D not a multiple of 16), D <= 128
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
// wgmma body (bf16, D in {64, 128}): TMA ring, producer warpgroup, wgmma
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;        // query rows per block: 2 warpgroups x 64
constexpr int WG_BK = 64;         // keys per ring stage
constexpr int WG_STAGES = 3;      // K/V ring depth: 2 ran slower on an H100
// 2 consumer warpgroups + 1 producer warpgroup, of which one thread issues
// the copies and the other warps only hand their registers back
constexpr int WG_THREADS = 384;
constexpr int WG_ROW = 128;       // bytes of one swizzled box row: 64 bf16
// setmaxnreg draws on the registers the block's own warpgroups release:
// the producer's 128 x (168 - 24) fund the consumers' 256 x (240 - 168).
// That holds only at ptxas's entry count of 168 (65536 / 384), which the
// launcher checks, and for one block per SM, so smaller shared-memory
// requests are padded to WG_ONE_BLOCK_SMEM.
constexpr int WG_ENTRY_REGS = 168;
constexpr int WG_PRODUCER_REGS = 24, WG_CONSUMER_REGS = 240;
static_assert(128 * (WG_ENTRY_REGS - WG_PRODUCER_REGS) >=
                  256 * (WG_CONSUMER_REGS - WG_ENTRY_REGS),
              "setmaxnreg budget");
constexpr int WG_ONE_BLOCK_SMEM = 116 * 1024;
// A wait this long (cycles, ~1 s) is a fault, not a slow copy: trap
// rather than hang the card.
constexpr long long WG_WAIT_LIMIT = 2000000000LL;

template <int D>
struct WgSmem {
  static constexpr int DCH = D / 64;                     // 64-wide boxes
  static constexpr int Q_CHUNK = WG_BQ * WG_ROW;         // 16 KB
  static constexpr int KV_CHUNK = WG_BK * WG_ROW;
  static constexpr int Q_BYTES = DCH * Q_CHUNK;
  static constexpr int STAGE_BYTES = 2 * DCH * KV_CHUNK; // K then V
  static constexpr int V_OFFSET = DCH * KV_CHUNK;
  static constexpr int USED = Q_BYTES + WG_STAGES * STAGE_BYTES;
  // + 1024 to align the swizzle atoms
  static constexpr int LAUNCH = USED + 1024 > WG_ONE_BLOCK_SMEM
                                    ? USED + 1024 : WG_ONE_BLOCK_SMEM;
  static_assert(LAUNCH <= 227 * 1024, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) start = now;
    else if (now - start > WG_WAIT_LIMIT) __trap();
  }
}

// one box of a 4-D tensor map into shared memory, completing on ``bar``
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 at bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// keeps the compiler from touching wgmma registers across the async window
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 64) += A (64 x 16, shared, K-major) . B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64) += A (64 x 16, registers) . B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128) += A (64 x 16, registers) . B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_pv(float (&acc)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&acc)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  wgmma_rs_n64(acc, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&acc)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  wgmma_rs_n128(acc, a, db);
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// S (64 x WG_BK) = Q K^T over D, 16 d per step: 32 bytes into the
// swizzled rows, the second 64-wide box from step 4 on (SBO: 8 rows of
// 128 B).  Issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[WG_BK / 2], uint32_t qa,
                                         uint32_t kb) {
  using L = WgSmem<D>;
  static_assert(WG_BK == 64, "Q K^T is m64n64k16");
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t dk = (kk & 3) * 32;
    wgmma_ss_n64(sc, sw128_desc(qa + (kk >> 2) * L::Q_CHUNK + dk, 16, 1024),
                 sw128_desc(kb + (kk >> 2) * L::KV_CHUNK + dk, 16, 1024),
                 kk > 0);
  }
  wg_commit();
}

// acc += P V over WG_BK keys, 16 keys per step = 2 swizzle atoms of 8 key
// rows (SBO 1024 B); D = 128 spans the two 64-wide V boxes (LBO).  V is
// read MN-major (the transpose bit).  Issued, not waited for.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&pa)[WG_BK / 16][4],
                                         uint32_t vb) {
  pin(acc);
#pragma unroll
  for (int c = 0; c < WG_BK / 16; ++c) pin(pa[c]);
  wg_fence();
#pragma unroll
  for (int c = 0; c < WG_BK / 16; ++c)
    wgmma_pv<D>(acc, pa[c],
                sw128_desc(vb + c * 16 * WG_ROW, WgSmem<D>::KV_CHUNK, 1024));
  wg_commit();
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], float al0,
                                        float al1) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    acc[4 * dn + 0] *= al0;
    acc[4 * dn + 1] *= al0;
    acc[4 * dn + 2] *= al1;
    acc[4 * dn + 3] *= al1;
  }
}

// Turns between the consumer warpgroups (named barriers 3 and 4, 256
// threads: the waiting warpgroup's sync and the other's arrive)
__device__ __forceinline__ void take_turn(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 + (wg ^ 1)) : "memory");
}

// Keys at or past this are masked for all 64 rows from qw on; a
// warpgroup wholly past S has none.
__device__ __forceinline__ int keys_end(int qw, int S, int T, int causal) {
  return qw >= S ? 0 : (causal ? min(T, qw + 64) : T);
}

// what a consumer thread's softmax needs to know of its two rows
struct SoftmaxRows {
  int T, causal, qw, r0, r1, tq;   // qw: the warpgroup's first row
  float scale;
};

// One tile's online softmax in the accumulator layout (sc[4 nt + e]: row
// r0 for e < 2, r1 for e >= 2, key k0 + 8 nt + 2 tq + (e & 1)): scale
// after the dot, mask to -1e30, update (m, l), leave p = exp(s - m) in sc
// and acc's rescale in (al0, al1).  l sums the unrounded p.
__device__ __forceinline__ void tile_softmax(float (&sc)[WG_BK / 2], int k0,
                                             const SoftmaxRows& w, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& al0, float& al1) {
  const bool edge = k0 + WG_BK > w.T || (w.causal && k0 + WG_BK - 1 > w.qw);
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int nt = 0; nt < WG_BK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s0 = sc[4 * nt + e] * w.scale, s1 = sc[4 * nt + 2 + e] * w.scale;
      if (edge) {
        const int key = k0 + nt * 8 + w.tq * 2 + e;
        if (key >= w.T || (w.causal && w.r0 < key)) s0 = NEG_INF;
        if (key >= w.T || (w.causal && w.r1 < key)) s1 = NEG_INF;
      }
      sc[4 * nt + e] = s0;
      sc[4 * nt + 2 + e] = s1;
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
  al0 = __expf(m0 - mn0);
  al1 = __expf(m1 - mn1);
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < WG_BK / 8; ++nt) {
    sc[4 * nt + 0] = __expf(sc[4 * nt + 0] - mn0);
    sc[4 * nt + 1] = __expf(sc[4 * nt + 1] - mn0);
    sc[4 * nt + 2] = __expf(sc[4 * nt + 2] - mn1);
    sc[4 * nt + 3] = __expf(sc[4 * nt + 3] - mn1);
    ls0 += sc[4 * nt + 0] + sc[4 * nt + 1];
    ls1 += sc[4 * nt + 2] + sc[4 * nt + 3];
  }
  l0 = l0 * al0 + ls0;               // per-thread partial sums
  l1 = l1 * al1 + ls1;
  m0 = mn0;
  m1 = mn1;
}

// p rounded to bf16 as P V's A fragments: accumulator tiles 2c and 2c+1
// are A fragment c (keys 16 c .. + 15), regs {0, 1} from tile 2c and
// {2, 3} from tile 2c+1, rows r0 then r1 in each
__device__ __forceinline__ void pack_p(const float (&sc)[WG_BK / 2],
                                       uint32_t (&pa)[WG_BK / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < WG_BK / 8; ++nt) {
    pa[nt >> 1][(nt & 1) * 2 + 0] = pack_f2(sc[4 * nt + 0], sc[4 * nt + 1]);
    pa[nt >> 1][(nt & 1) * 2 + 1] = pack_f2(sc[4 * nt + 2], sc[4 * nt + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   bf16* __restrict__ o, int S, int T, int H, int B, int G,
                   int causal, float scale) {
  using L = WgSmem<D>;
  constexpr int DCH = L::DCH;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * WG_STAGES];
  // swizzle atoms (8 rows x 128 B) must sit on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);
  const uint32_t qbar = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]);                // full[s]
  const uint32_t empty0 = smem_u32(&bars[1 + WG_STAGES]);   // empty[s]

  // block -> (q tile, head, batch); causal grids hand out the longest q
  // tiles (most key tiles) first over all heads and batches
  const int nq = (S + WG_BQ - 1) / WG_BQ;
  const int hb = H * B;
  const int tile = (int)blockIdx.x / hb, rest = (int)blockIdx.x % hb;
  const int iq = causal ? nq - 1 - tile : tile;
  const int hh = rest % H, bb = rest / H;
  const int kvh = hh / G;
  const int q0 = iq * WG_BQ;
  const int ntiles =
      (max(keys_end(q0, S, T, causal), keys_end(q0 + 64, S, T, causal)) +
       WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);         // the producer's expect_tx
      mbar_init(empty0 + 8 * s, 8);        // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, warp-uniform as ptxas can see it (lane 0's value): with a
  // plain threadIdx.x / 128 the consumer loop compiles to slower code
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues every TMA copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        WG_PRODUCER_REGS) : "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < DCH; ++c)
        tma_load_4d(base + c * L::Q_CHUNK, &qmap, qbar, c * 64, hh, q0, bb);
      for (int j = 0; j < ntiles; ++j) {
        const int s = j % WG_STAGES;
        // the first pass over the ring finds every stage empty
        mbar_wait(empty0 + 8 * s, ((j / WG_STAGES) & 1) ^ 1);
        const uint32_t st = base + L::Q_BYTES + s * L::STAGE_BYTES;
        const uint32_t fb = full0 + 8 * s;
        mbar_expect_tx(fb, L::STAGE_BYTES);  // whole boxes, zero-filled too
#pragma unroll
        for (int c = 0; c < DCH; ++c) {
          tma_load_4d(st + c * L::KV_CHUNK, &kmap, fb, c * 64, kvh, j * WG_BK,
                      bb);
          tma_load_4d(st + (DCH + c) * L::KV_CHUNK, &vmap, fb, c * 64, kvh,
                      j * WG_BK, bb);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        WG_CONSUMER_REGS) : "memory");
    const int tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31;
    const int gid = lane >> 2, tq = lane & 3;
    const int qw = q0 + 64 * wg;
    const int r0 = qw + warp * 16 + gid;   // this thread's rows: r0, r0 + 8
    const int r1 = r0 + 8;
    const int my_end = keys_end(qw, S, T, causal);

    // tiles [0, mine) are this warpgroup's: a causal warpgroup's keys end
    // before the block's, so the ones it skips come last
    const int mine = (my_end + WG_BK - 1) / WG_BK;

    // accumulator layout (m64nN f32): acc[4 j + e] is row r0 (e < 2) or r1
    // (e >= 2) at column 8 j + 2 tq + (e & 1)
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float al0 = 1.f, al1 = 1.f;      // acc's rescale before the next P V
    float sc[WG_BK / 2];             // scores, then p, of one tile
    uint32_t pa[WG_BK / 16][4];      // p in bf16 as P V's A fragments
    // this warpgroup's 64 Q rows in each 64-wide D box
    const uint32_t qa = base + wg * 64 * WG_ROW;
    const uint32_t ring = base + L::Q_BYTES;
    const SoftmaxRows rows{T, causal, qw, r0, r1, tq, scale};
    mbar_wait(qbar, 0);

    // Software pipeline with turns (FA3's ping-pong): at step b a
    // warpgroup issues Q K^T of tile b and P V of tile b - 1 in its turn,
    // hands the turn to the other warpgroup, and runs tile b's softmax
    // while its own and then the other's products occupy the tensor
    // cores.  Both warpgroups take ntiles + 1 steps: at step b each waits
    // for tile b's fill and releases tile b - 1's stage, also for the
    // tiles it skips, so the turns and the ring's arrivals pair up.
    // Warpgroup 0 goes first.  The products sit outside any per-step
    // branch, or ptxas serializes them.
    if (wg == 1) pass_turn(1);
    const bool last_turn = wg == 1;   // the turn after the last goes unused
    int b = 0;                        // the next step
    if (mine > 0) {
      mbar_wait(full0, 0);
      take_turn(wg);
      issue_qk<D>(sc, qa, ring);
      pass_turn(wg);                   // step 0 < ntiles
      wg_wait<0>();
      pin(sc);
      tile_softmax(sc, 0, rows, m0, m1, l0, l1, al0, al1);
      pack_p(sc, pa);
      for (b = 1; b < mine; ++b) {
        const int s = b % WG_STAGES, sp = (b - 1) % WG_STAGES;
        mbar_wait(full0 + 8 * s, (b / WG_STAGES) & 1);
        rescale<D>(acc, al0, al1);
        take_turn(wg);
        issue_qk<D>(sc, qa, ring + s * L::STAGE_BYTES);
        issue_pv<D>(acc, pa, ring + sp * L::STAGE_BYTES + L::V_OFFSET);
        pass_turn(wg);                 // b < mine <= ntiles
        wg_wait<1>();                  // Q K^T of tile b has landed
        pin(sc);
        tile_softmax(sc, b * WG_BK, rows, m0, m1, l0, l1, al0, al1);
        wg_wait<0>();                  // P V of tile b - 1 has landed
        pin(acc);
        // this warp is done with tile b - 1's stage
        if (lane == 0) mbar_arrive(empty0 + 8 * sp);
        pack_p(sc, pa);
      }
      // step mine: P V of the last tile of this warpgroup
      const int sp = (mine - 1) % WG_STAGES;
      if (mine < ntiles)
        mbar_wait(full0 + 8 * (mine % WG_STAGES), (mine / WG_STAGES) & 1);
      rescale<D>(acc, al0, al1);
      take_turn(wg);
      issue_pv<D>(acc, pa, ring + sp * L::STAGE_BYTES + L::V_OFFSET);
      if (!(last_turn && mine == ntiles)) pass_turn(wg);
      wg_wait<0>();
      pin(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * sp);
      b = mine + 1;
    }
    // the steps of tiles this warpgroup skips: fills, turns and releases
    for (; b <= ntiles; ++b) {
      if (b < ntiles)
        mbar_wait(full0 + 8 * (b % WG_STAGES), (b / WG_STAGES) & 1);
      take_turn(wg);
      if (!(last_turn && b == ntiles)) pass_turn(wg);
      if (b >= 1 && lane == 0)
        mbar_arrive(empty0 + 8 * ((b - 1) % WG_STAGES));
    }

    if (my_end > 0) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      l0 = fmaxf(l0, 1e-30f);
      l1 = fmaxf(l1, 1e-30f);
      // stage the 64 x D outputs in this warpgroup's Q rows (their last
      // reader, the final Q K^T, has completed), swizzled as TMA left them
      // so both the writes and the reads below are free of bank conflicts
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      uint8_t* const ob = sbase + wg * 64 * WG_ROW;
      const int rr0 = warp * 16 + gid, rr1 = rr0 + 8;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        uint8_t* const cb = ob + (dn >> 3) * L::Q_CHUNK + tq * 4;
        const int u = dn & 7;
        *reinterpret_cast<uint32_t*>(cb + rr0 * WG_ROW +
                                     ((u ^ (rr0 & 7)) << 4)) =
            pack_f2(acc[4 * dn + 0] / l0, acc[4 * dn + 1] / l0);
        *reinterpret_cast<uint32_t*>(cb + rr1 * WG_ROW +
                                     ((u ^ (rr1 & 7)) << 4)) =
            pack_f2(acc[4 * dn + 2] / l1, acc[4 * dn + 3] / l1);
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      constexpr int CPR = D / 8;           // 16-byte chunks per row
      const size_t ostride = (size_t)H * D;
      bf16* const obase = o + ((size_t)bb * S) * ostride + (size_t)hh * D;
#pragma unroll
      for (int it = 0; it < 64 * CPR / 128; ++it) {
        const int i = tid + it * 128;
        const int rr = i / CPR, cc = i - rr * CPR;
        if (qw + rr < S) {
          const int u = cc & 7;
          const uint4 val = *reinterpret_cast<const uint4*>(
              ob + (cc >> 3) * L::Q_CHUNK + rr * WG_ROW +
              ((u ^ (rr & 7)) << 4));
          *reinterpret_cast<uint4*>(obase + (size_t)(qw + rr) * ostride +
                                    cc * 8) = val;
        }
      }
    }
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

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;   // the same pointer on every thread
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// g: kernel.py's TensorMapGeometry.flat(): dims (D, heads, rows, batch),
// byte strides of dims 1..3, box (64, 1, rows per load, 1)
static bool encode_map(CUtensorMap* map, const void* ptr, const long long* g) {
  EncodeTiledFn enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1],
                              (cuuint64_t)g[2], (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5],
                                 (cuuint64_t)g[6]};
  const cuuint32_t box[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8],
                             (cuuint32_t)g[9], (cuuint32_t)g[10]};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once per device: the entry register count setmaxnreg's budget needs
// (another count would leave setmaxnreg.inc waiting forever) and the
// dynamic shared memory.  0 or the error, kept per device.
template <int D>
static int prepare_wgmma() {
  constexpr int MAX_DEVICES = 64;
  static int state[MAX_DEVICES];     // 0 unknown, 1 ready, else -error
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (state[dev] == 0) {
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, flash_wgmma_kernel<D>);
    if (err == cudaSuccess && attr.numRegs != WG_ENTRY_REGS)
      err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 WgSmem<D>::LAUNCH);
    state[dev] = err == cudaSuccess ? 1 : -(int)err;
  }
  return state[dev] == 1 ? 0 : -state[dev];
}

template <int D>
static int launch_wgmma(const CUtensorMap& qm, const CUtensorMap& km,
                        const CUtensorMap& vm, void* o, int B, int S, int T,
                        int H, int KV, int causal, float scale,
                        cudaStream_t stream) {
  const int err = prepare_wgmma<D>();
  if (err != 0) return err;
  const long long blocks = (long long)((S + WG_BQ - 1) / WG_BQ) * H * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_wgmma_kernel<D><<<(unsigned)blocks, WG_THREADS, WgSmem<D>::LAUNCH,
                          stream>>>(qm, km, vm, (bf16*)o, S, T, H, B, H / KV,
                                    causal, scale);
  return (int)cudaGetLastError();
}

// The wgmma body: bf16, D in {64, 128}.  geom holds the q, k and v tensor
// maps' geometry (11 values each, computed and checked by kernel.py); o is
// contiguous (B, S, H, D).  A tensor map that does not encode returns
// cudaErrorInvalidValue.
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, void* o, int B, int S,
                                     int T, int H, int KV, int D, int causal,
                                     float scale, const long long* geom,
                                     cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  if (!encode_map(&qm, q, geom) || !encode_map(&km, k, geom + 11) ||
      !encode_map(&vm, v, geom + 22))
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return launch_wgmma<64>(qm, km, vm, o, B, S, T, H, KV, causal, scale,
                            stream);
  if (D == 128)
    return launch_wgmma<128>(qm, km, vm, o, B, S, T, H, KV, causal, scale,
                             stream);
  return (int)cudaErrorInvalidValue;
}
