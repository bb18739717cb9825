// Masked attention forward with an online (running) max, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels, one instantiation of this source each:
//
//   * K3 `_fwd_kernel` (maskunet_tpu/ops/flash_attention.py:111-161, launched
//     at :285-302): the safe softmax that MASKUNET_SAFE_SOFTMAX=1 puts on
//     both the primal and the training forward of `flash_mha`. Entry point
//     `flash_fwd_online`: bf16 or f32, C in {64, 128, 256}, with or without
//     use_valid. Per (batch, query row):
//
//       s2 = (q * qmul) . k^T + bias   qmul = scale*log2e, q*qmul rounded to
//                                      q's dtype (JAX weak typing)
//       m  = max(-1e30, max_j s2_j)    a running max over the key tiles, NaN
//                                      kept (fmaxf would drop it)
//       p  = exp2(s2 - m) [* valid]    valid = bias > -5e29, a multiply
//       O  = (p_v . v) / max(l, 1e-30) p_v = p rounded to v's dtype, l = sum
//                                      of the f32 p; NaN-keeping floor
//       lse2 = m + log2(max(l, 1e-30)) f32, for the unclamped backward
//
//     Each key tile rescales the sums so far by alpha = exp2(m_prev - m_new).
//     m starts at -1e30, not -inf, as in JAX: a tile with no visible key
//     gives exp2(0) = 1 for its masked keys (not exp2(-inf + inf) = NaN), and
//     the first tile with a visible key zeroes that with alpha = 0. So a
//     fully masked row gives 0 with use_valid and the mean of V without
//     (lse2 = -1e30 either way), exactly as the TPU kernel.
//
//   * K5 `_old_fwd_kernel` (tools/softmax_ab.py:29-60, launched at :69):
//     the same with natural exp, no q scale (the caller scales q), no
//     use_valid, lse = m + ln(max(l, 1e-30)). Entry `flash_fwd_online_exp`,
//     bf16 at C = 64 only (the instantiation its tool launches). On the
//     wgmma body its p = exp(s - m) is ex2(fma(s, log2e, -m log2e)), one
//     FMA a score as K3's subtract (see `natural_exp_args`).
//
//   * K7 `_fwd_kernel_bf16` (tools/bf16_softmax_experiment.py:32-71,
//     launched at :79): natural exp with bf16 scores. Entry
//     `flash_fwd_online_bf16`, bf16 at C = 64 only. It rounds where the TPU
//     kernel does: s (the f32 product) and the bias to bf16, s + bias, the
//     running max (from bf16(-1e30)), s - m and p = exp(s - m) in bf16
//     (packed bf16x2: __hadd2, __hmax2_nan, __hsub2, and exp_bf16x2, which
//     is h2exp but for flushing p < 2^-126 to 0; each is the f32 operation
//     rounded once to bf16, as XLA and PyTorch compute bf16 on the CPU),
//     alpha = exp(f32(bf16(m_prev - m_new))), l the f32 sum of the
//     bf16 p, which is also the P.V operand as it is; lse = f32(m) + ln(l).
//     Its result depends on the key tile, which is the C = 64 key step of
//     both bf16 bodies below (`kKeys64`, 128 keys).
//
// What bounds it on an H100: as the no-max forward (flash_fwd_nomax.cu), the
// two products (4*B*Lq*Lk*C flops, ~0.31 ms at attn6 at the bf16 tensor
// peak) and the B*Lq*Lk exponentials on the special function units (~0.29
// ms), never the bytes. The online max adds, per score, a NaN-keeping max
// and a subtract; per key step and row, two quad shuffles, one exponential
// (alpha) and the rescale of the row's O accumulators. Three bodies:
//
// bf16 (`fwd_online_wgmma`; K3 at every C, K5 and K7 at C = 64): the
// no-max forward's wgmma body (see flash_fwd_nomax.cu's header for its
// parts) with the running max added. A producer warpgroup streams K and V
// by TMA (3-D maps (C, L, B), 128-byte swizzle, so keys past Lk read k =
// v = 0) through an mbarrier ring; consumer warpgroups of 64 queries (two
// a block, one at C = 256) compute S = (q*qmul) K^T by wgmma from shared
// memory and O += P V by wgmma with P packed from the S registers. Step
// j, in FA3's order:
//
//   1. issue S_j and P_{j-1} V_{j-1}; wait for S_j only;
//   2. s + bias, the row's new max n = nanmax(m, max over the tile) by
//      max.NaN and two quad shuffles, alpha = exp2(m - n), p = exp2(s - n)
//      [* valid] into the S registers, l = alpha l + sum p (both partial
//      row sums rescaled), while P_{j-1} V_{j-1} runs;
//   3. wait for P_{j-1} V_{j-1}; only then O *= alpha (rescaling O while a
//      product that writes it is in flight is undefined), and pack p to
//      bf16 A fragments, which step j+1's P_j V_j reads.
//
// Every step rescales (no lazy rescale: it would move p's bf16 rounding
// and K7's exact recurrence). The bias comes a step ahead into registers,
// -inf past Lk (not -1e30, which would put padded slots into a fully
// masked row's mean of V); the first and last steps are peeled, so that
// no wgmma is issued on a divergent path (ptxas would serialise them all:
// C7520); O leaves by a 3-D TMA store that clips rows past Lq, lse by
// plain stores.
//
// bf16 with no key, and every C in the A/B tool's `mma_sync` variant
// (`fwd_online_bf16`): the first design, mma.sync m16n8k16 with 16 query
// rows a warp, a two-stage cp.async K/V ring every thread fills, and
// ldmatrix.
//
// f32 (`fwd_online_f32`): exact f32 (no TF32) on plain FMA, 64x32 tiles.
//
// Entry points: `flash_fwd_online`, `flash_fwd_online_exp`,
// `flash_fwd_online_bf16` and `flash_fwd_online_body` below (plain C,
// bound with ctypes).

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kValidThreshold = -5e29f;  // NEG_INF * 0.5
constexpr float kNegInf = -1e30f;          // NEG_INF: the running max's start
constexpr float kMinL = 1e-30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBQ = 64;                    // query rows per f32 block

// The three functions this source computes (see the header).
enum Mode { kBase2 = 0, kNatural = 1, kBf16Scores = 2 };

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int MODE>
__device__ __forceinline__ float softmax_exp(float x) {
  return MODE == kBase2 ? ex2(x) : __expf(x);
}

// max(a, b) that keeps NaN from either side (fmaxf would drop it).
__device__ __forceinline__ float nanmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// nanmax over the four threads of a quad (the lanes sharing an mma row, or
// the four parts of an f32 row).
__device__ __forceinline__ float quad_max(float x) {
  x = nanmax(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return nanmax(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// max(l, 1e-30) that keeps NaN.
__device__ __forceinline__ float floor_l(float l) {
  return l < kMinL ? kMinL : l;
}

// K5's exp(s - n) on the wgmma body as ex2(fma(s, sc, of)): sc = log2e
// and of = -n log2e, one FMA a score where __expf(s - n) takes a subtract
// and a multiply. A row with no visible key so far has n = -1e30, where
// -n log2e rounds by up to 2^75 and exp(s - n) of its masked keys (s = n)
// would be anything; there sc = 1 and of = -n exactly, so s - n is 0 for
// those keys (exp2(0) = exp(0) = 1) and at most -7.6e22, the spacing of
// floats near 1e30, for any other (both exponentials 0). A NaN n gives NaN.
__device__ __forceinline__ void natural_exp_args(float n, float& sc,
                                                 float& of) {
  const bool none = n <= kValidThreshold;
  sc = none ? 1.f : kLog2e;
  of = none ? -n : -n * kLog2e;
}

template <int MODE>
__device__ __forceinline__ float final_lse(float m, float d) {
  return m + (MODE == kBase2 ? log2f(d) : logf(d));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// K7's p = exp(x) of a bf16 pair, rounded to bf16 and returned as the two
// (exact) f32 values: h2exp's own arithmetic (f32(x) * log2e with its
// constant, ex2, one rounding to bf16) with ex2's flush-to-zero form.
// h2exp's plain ex2 adds a compare and two predicated multiplies per
// element to return subnormal results; the two differ only where p <
// 2^-126, which h2exp gives as a bf16 subnormal and this as 0 (a TPU
// flushes those too).
__device__ __forceinline__ float2 exp_bf16x2(__nv_bfloat162 x) {
  const float log2e = __uint_as_float(0x3fb8aa3cu);
  const float2 f = __bfloat1622float2(x);
  return __bfloat1622float2(
      __floats2bfloat162_rn(ex2(f.x * log2e), ex2(f.y * log2e)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy to shared memory; zero-fills when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane i addresses a row of
// matrix i / 8. `trans` transposes each matrix on the way.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), WARPS warps each owning 16 query
// rows; a thread holds rows g and g + 8 of its warp's 16 and, in the
// accumulator layout, columns 2t and 2t + 1 of every 8.
// ---------------------------------------------------------------------------

template <int C, int BK, int WARPS>
struct Bf16Tile {
  static constexpr int BQ = 16 * WARPS;  // query rows per block
  static constexpr int S = C + 8;        // row stride (elements): ldmatrix
                                         // rows fall on distinct banks
  static constexpr int KV = BK * S;      // elements of one K or V tile
  static constexpr size_t smem =
      size_t(BQ * S + 4 * KV) * sizeof(__nv_bfloat16) +
      2 * size_t(BK) * sizeof(float);
};

template <int C, int BK, int WARPS, int MODE, bool USE_VALID>
__global__ void __launch_bounds__(32 * WARPS)
fwd_online_bf16(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
                float* __restrict__ lse, int lq, int lk, float qmul) {
  using T = Bf16Tile<C, BK, WARPS>;
  constexpr int S = T::S, KV = T::KV, C8 = C / 8, NT = 32 * WARPS;
  static_assert(BK % 16 == 0 && BK <= NT && C % 16 == 0, "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kvs = qs + T::BQ * S;  // [stage][K tile, V tile]
  float* bs = reinterpret_cast<float*>(kvs + 4 * KV);  // [stage][BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * T::BQ;
  const __nv_bfloat16* qb = q + size_t(b) * lq * C;
  const __nv_bfloat16* kb = k + size_t(b) * lk * C;
  const __nv_bfloat16* vb = v + size_t(b) * lk * C;
  const float* biasb = bias + size_t(b) * lk;

  // Keys past lk are zero-filled with bias -inf: they never raise the max
  // and their p is exactly 0 (use_valid or not).
  auto load_kv = [&](int kt, int stage) {
    __nv_bfloat16* ks = kvs + stage * 2 * KV;
    __nv_bfloat16* vs = ks + KV;
    for (int idx = tid; idx < BK * C8; idx += NT) {
      const int row = idx / C8, c8 = idx % C8, gk = kt + row;
      const bool in = gk < lk;
      const size_t off = size_t(in ? gk : 0) * C + c8 * 8;
      cp_async16(ks + row * S + c8 * 8, kb + off, in);
      cp_async16(vs + row * S + c8 * 8, vb + off, in);
    }
    for (int idx = tid; idx < BK; idx += NT) {
      const int gk = kt + idx;
      bs[stage * BK + idx] = gk < lk ? biasb[gk] : __int_as_float(0xff800000);
    }
    cp_async_commit();
  };

  const int ntiles = (lk + BK - 1) / BK;
  if (ntiles > 0) load_kv(0, 0);

  // Q tile, pre-multiplied by qmul and rounded to bf16 like the TPU kernel
  // (qmul = 1 for K5 and K7, whose callers scale q).
  for (int idx = tid; idx < T::BQ * C8; idx += NT) {
    const int row = idx / C8, c8 = idx % C8, gr = q0 + row;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (gr < lq) {
      raw = *reinterpret_cast<const uint4*>(qb + size_t(gr) * C + c8 * 8);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(h[i]);
        h[i] = __floats2bfloat162_rn(f.x * qmul, f.y * qmul);
      }
    }
    *reinterpret_cast<uint4*>(qs + row * S + c8 * 8) = raw;
  }

  float acc[C8][4];
#pragma unroll
  for (int n = 0; n < C8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float l0 = 0.f, l1 = 0.f;  // row sums of rows g and g+8 (this thread's part)
  // Running max of rows g and g+8, the same in the four threads of a quad
  // (for K7 a bf16 value, held exactly in a float).
  float m0 = MODE == kBf16Scores ? __bfloat162float(__float2bfloat16_rn(kNegInf))
                                 : kNegInf;
  float m1 = m0;

  // ldmatrix row addresses of this lane: A (Q) rows lane % 16, column half
  // lane / 16; B (K, V) matrix lane / 8, row lane % 8.
  const __nv_bfloat16* qa = qs + (warp * 16 + (lane & 15)) * S + (lane >> 4) * 8;
  const int mrow = lane & 7, mhalf = (lane >> 3) & 1, mpair = lane >> 4;

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < ntiles) {
      load_kv((it + 1) * BK, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's tiles (and, first time, Q) are in
    const __nv_bfloat16* ks = kvs + stage * 2 * KV;
    const __nv_bfloat16* vs = ks + KV;
    const float* bt = bs + stage * BK;

    // S = Q K^T for this warp's 16 rows and the BK keys of the tile.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qa + kk * 16);
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t bf[4];  // keys j*8.. and (j+1)*8.., channels kk*16..+15
        ldsm_x4(bf, ks + ((j + mpair) * 8 + mrow) * S + kk * 16 + mhalf * 8);
        mma_bf16(s[j], a, bf[0], bf[1]);
        mma_bf16(s[j + 1], a, bf[2], bf[3]);
      }
    }

    // p of the tile as P.V's A operand: pa[j][0] rows g, pa[j][1] rows g+8,
    // columns j*8 + 2t, +1 (bf16x2).
    uint32_t pa[BK / 8][2];
    float alpha0, alpha1;
    if constexpr (MODE == kBf16Scores) {
      // s and bias rounded to bf16, s + bias in bf16, the row max in bf16.
      __nv_bfloat162 x[BK / 8][2];
      __nv_bfloat162 mx0 = __float2bfloat162_rn(m0);
      __nv_bfloat162 mx1 = __float2bfloat162_rn(m1);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int col = j * 8 + 2 * t;
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(bt[col], bt[col + 1]);
        x[j][0] = __hadd2(__floats2bfloat162_rn(s[j][0], s[j][1]), b2);
        x[j][1] = __hadd2(__floats2bfloat162_rn(s[j][2], s[j][3]), b2);
        mx0 = __hmax2_nan(mx0, x[j][0]);
        mx1 = __hmax2_nan(mx1, x[j][1]);
      }
      const float n0 = quad_max(nanmax(__low2float(mx0), __high2float(mx0)));
      const float n1 = quad_max(nanmax(__low2float(mx1), __high2float(mx1)));
      // alpha = exp(f32(bf16(m_prev - m_new)))
      alpha0 = __expf(__bfloat162float(__float2bfloat16_rn(m0 - n0)));
      alpha1 = __expf(__bfloat162float(__float2bfloat16_rn(m1 - n1)));
      const __nv_bfloat162 nb0 = __float2bfloat162_rn(n0);
      const __nv_bfloat162 nb1 = __float2bfloat162_rn(n1);
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 p0 = exp_bf16x2(__hsub2(x[j][0], nb0));
        const float2 p1 = exp_bf16x2(__hsub2(x[j][1], nb1));
        ls0 += p0.x + p0.y;
        ls1 += p1.x + p1.y;
        pa[j][0] = pack_bf16(p0.x, p0.y);
        pa[j][1] = pack_bf16(p1.x, p1.y);
      }
      l0 = alpha0 * l0 + ls0;
      l1 = alpha1 * l1 + ls1;
      m0 = n0;
      m1 = n1;
    } else {
      // s + bias in f32; the new running max of each row, NaN kept.
      float n0 = m0, n1 = m1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += bt[j * 8 + t * 2 + (e & 1)];
          if (e < 2) n0 = nanmax(n0, s[j][e]); else n1 = nanmax(n1, s[j][e]);
        }
      }
      n0 = quad_max(n0);
      n1 = quad_max(n1);
      alpha0 = softmax_exp<MODE>(m0 - n0);
      alpha1 = softmax_exp<MODE>(m1 - n1);
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = softmax_exp<MODE>(s[j][e] - (e < 2 ? n0 : n1));
          if (USE_VALID)
            p[e] *= (bt[j * 8 + t * 2 + (e & 1)] > kValidThreshold) ? 1.f : 0.f;
        }
        ls0 += p[0] + p[1];
        ls1 += p[2] + p[3];
        pa[j][0] = pack_bf16(p[0], p[1]);
        pa[j][1] = pack_bf16(p[2], p[3]);
      }
      l0 = alpha0 * l0 + ls0;
      l1 = alpha1 * l1 + ls1;
      m0 = n0;
      m1 = n1;
    }

    // O = alpha O + P V: the p fragments are the A operand.
#pragma unroll
    for (int n = 0; n < C8; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                             pa[2 * kk + 1][1]};
#pragma unroll
      for (int n = 0; n < C8; n += 2) {
        uint32_t bf[4];  // keys kk*16..+15, channels n*8.. and (n+1)*8..
        ldsm_x4_trans(bf, vs + (kk * 16 + mhalf * 8 + mrow) * S + (n + mpair) * 8);
        mma_bf16(acc[n], a, bf[0], bf[1]);
        mma_bf16(acc[n + 1], a, bf[2], bf[3]);
      }
    }
    __syncthreads();  // the next iteration refills this stage
  }

  // The four threads of a quad hold disjoint columns of the same rows.
  const float d0 = floor_l(quad_sum(l0)), d1 = floor_l(quad_sum(l1));
  const int gr0 = q0 + warp * 16 + g, gr1 = gr0 + 8;
  __nv_bfloat16* ob = o + size_t(b) * lq * C;
#pragma unroll
  for (int n = 0; n < C8; ++n) {
    const int col = n * 8 + t * 2;
    if (gr0 < lq)
      *reinterpret_cast<uint32_t*>(ob + size_t(gr0) * C + col) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (gr1 < lq)
      *reinterpret_cast<uint32_t*>(ob + size_t(gr1) * C + col) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
  if (t == 0) {
    float* lb = lse + size_t(b) * lq;
    if (gr0 < lq) lb[gr0] = final_lse<MODE>(m0, d0);
    if (gr1 < lq) lb[gr1] = final_lse<MODE>(m1, d1);
  }
}

// ---------------------------------------------------------------------------
// bf16: warpgroup products (wgmma) fed by TMA through an mbarrier ring. See
// the header for the design.
// ---------------------------------------------------------------------------

// C values whose bf16 K3 (and, at C = 64, K5 and K7) runs
// `fwd_online_wgmma`; the others and a call with no key run
// `fwd_online_bf16`.
constexpr bool wgmma_body(int c) { return c == 64 || c == 128 || c == 256; }

constexpr int kTile = 64 * 128;   // 64 rows of one 128-byte line
// The schedule and tile shapes per C start from the no-max forward's
// (flash_fwd_nomax.cu); tools/fwd_ab.py --source online tries them again
// here. Unlike K1, K3 gains from ping-pong at C = 64 too: the row max
// puts a reduction between S and the exponentials, and taking turns
// keeps the tensor cores fed meanwhile. K7 runs K3's C = 64 schedule, and
// kKeys64 is also its key tile in both bf16 bodies (its result depends
// on the tile).
constexpr bool kProducerWarp = true;
constexpr bool kPingPong64 = true;
constexpr bool kPingPong128 = true;
constexpr int kConsumers = 2;     // consumer warpgroups (64 queries each)
constexpr int kConsumers256 = 1;  // consumer warpgroups, C 256
constexpr int kKeys64 = 128;      // keys a step, C 64
constexpr int kKeys128 = 64;      // keys a step, C 128
constexpr int kKeys256 = 64;      // keys a step, C 256
constexpr int kStages64 = 4;      // depth of the K / V ring, C 64
constexpr int kStages128 = 4;     // depth of the K / V ring, C 128
constexpr int kStages256 = 3;     // depth of the K / V ring, C 256
// K5's exponential on the wgmma body: ex2 of one FMA a score (true) or
// __expf(s - n), a subtract and a multiply (false); tools/fwd_ab.py
// --source online times both
constexpr bool kExpByFma = true;

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Named barrier over one warpgroup's 128 threads (id 0 is __syncthreads').
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// This thread's shared-memory writes, made visible to the async proxy
// (wgmma operands and TMA stores).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// Copies a shared-memory tile to global memory through `map`; box
// elements outside the tensor are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk operations have read their sources.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at `p` (the swizzle TMA
// writes): 8 rows of 128 bytes a 1024-byte group, groups 1024 bytes apart.
// The leading offset is unused: a K-major k-step stays inside its 128-byte
// line and an MN-major operand is one 64-element line wide.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return uint64_t((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this warpgroup's committed product groups are
// pending (groups complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barrier over both consumer warpgroups (256 threads): one waits
// for its turn at the tensor cores, the other hands it over.
__device__ __forceinline__ void tc_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void tc_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, m64n64k16, bf16 in, f32 out, A and B in shared memory,
// both K-major. `accumulate` = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B, m64n128k16, bf16 in, f32 out, A and B in shared memory,
// both K-major. `accumulate` = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (+)= A B with N = BK keys, B at `b`: one m64n128k16 or m64n64k16
// product a k-step.
template <int BK>
__device__ __forceinline__ void wgmma_scores(float (&d)[BK / 2], uint64_t da,
                                             const unsigned char* b,
                                             int accumulate) {
  if constexpr (BK == 128) {
    wgmma_ss128(d, da, sw128_desc(b), accumulate);
  } else {
    static_assert(BK == 64, "key tile of 64 or 128");
    wgmma_ss64(d, da, sw128_desc(b), accumulate);
  }
}

// d += A B, m64n64k16, A (64 x 16) from registers in the fragment layout
// of the accumulator, B in shared memory read MN-major (the transpose
// bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// Shared memory of a block: byte offsets from a 1024-byte-aligned base.
// A [rows][C] bf16 tile is H = C / 64 regions of [rows][64 channels], one
// 128-byte line a row (the widest line TMA's 128-byte swizzle takes).
template <int C, int BK, int NS, int WGS, bool PW>
struct FwdWgTile {
  static constexpr int H = C / 64;                    // regions a row
  static constexpr int BQ = 64 * WGS;                 // queries a block
  static constexpr int KT = BK * 128;                 // a region of K or V
  static constexpr int Q = 0;                         // [wg][H] q*qmul, O
  static constexpr int K = Q + WGS * H * kTile;       // [NS][H] K tiles
  static constexpr int V = K + NS * H * KT;           // [NS][H] V tiles
  static constexpr int BIAS = V + NS * H * KT;        // [wg][2][BK] f32
  static constexpr int BAR = BIAS + WGS * 2 * BK * 4;
  // threads a block, and the registers of each consumer thread once the
  // producer warpgroup has given up all but 24 of its own (a multiple of
  // 8, at most 240)
  static constexpr int threads = 128 * (WGS + (PW ? 1 : 0));
  static constexpr int consumer_regs =
      (65536 - 128 * 24) / (128 * WGS) / 8 * 8 > 240
          ? 240
          : (65536 - 128 * 24) / (128 * WGS) / 8 * 8;
  static constexpr size_t smem = size_t(BAR + (2 * NS + 1) * 8) + 1024;
  static constexpr uint32_t stage_bytes = 2 * H * KT;  // a K and a V tile
  static_assert(smem <= 232448, "shared memory of one block");
};

// One block: batch row blockIdx.y, queries blockIdx.x * BQ ..; consumer
// warpgroup wg owns queries wg * 64 .. wg * 64 + 63 of them, and with PW
// the last warpgroup streams the tiles; PP: ping-pong; MODE: K3
// (kBase2), K5 (kNatural) or K7 (kBf16Scores). q, k, v, o: 3-D maps (C,
// L, B), box (64, 64 or BK, 1), 128-byte swizzle.
template <int C, int BK, int NS, int WGS, bool PW, bool PP, int MODE,
          bool USE_VALID>
__global__ void __launch_bounds__(FwdWgTile<C, BK, NS, WGS, PW>::threads, 1)
fwd_online_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to,
                 const float* __restrict__ bias, float* __restrict__ lse,
                 int lq, int lk, float qmul) {
  using T = FwdWgTile<C, BK, NS, WGS, PW>;
  constexpr int H = T::H, NB = (BK + 127) / 128;
  static_assert(MODE != kBf16Scores || !USE_VALID, "K7 takes no use_valid");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + T::BAR);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int b = blockIdx.y, q0 = blockIdx.x * T::BQ;
  const int nk = (lk + BK - 1) / BK;
  auto load_stage = [&](int it) {  // one thread
    const int s = it % NS;
    bar_expect_tx(&full[s], T::stage_bytes);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      tma_load_3d(sm + T::K + (s * H + h) * T::KT, &tk, &full[s], 64 * h,
                  it * BK, b);
      tma_load_3d(sm + T::V + (s * H + h) * T::KT, &tv, &full[s], 64 * h,
                  it * BK, b);
    }
  };
  // the block's q tiles once, then the first NS (or, from the producer
  // warp, all) key tiles, each stage once its consumers released it
  auto produce = [&](int upto) {  // one thread
    bar_expect_tx(qbar, WGS * H * kTile);
#pragma unroll
    for (int w = 0; w < WGS; ++w)
#pragma unroll
      for (int h = 0; h < H; ++h)
        tma_load_3d(sm + T::Q + (w * H + h) * kTile, &tq, qbar, 64 * h,
                    q0 + 64 * w, b);
    for (int it = 0; it < upto; ++it) {
      if (it >= NS) bar_wait(&empty[it % NS], (it / NS - 1) & 1);
      load_stage(it);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * WGS);  // one arrival a consumer warp
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if constexpr (PW) {
    if (wg == WGS) {  // the producer warpgroup: one thread loads
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
      if (t == 0) produce(nk);
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     T::consumer_regs)
                 : "memory");
  } else {
    if (tid == 0) produce(nk < NS ? nk : NS);
  }

  const int lane = tid & 31, tq4 = lane & 3;
  const int r0 = 16 * (t >> 5) + (lane >> 2);  // accumulator rows r0, r0 + 8
  const int sw = r0 & 7;                       // their 128-byte swizzle phase
  const int qw = q0 + wg * 64;
  const float* biasb = bias + size_t(b) * lk;
  unsigned char* qsw = sm + T::Q + wg * H * kTile;  // this warpgroup's q
  float* bsw = reinterpret_cast<float*>(sm + T::BIAS) + wg * 2 * BK;
  const int bar_id = 1 + wg;  // this warpgroup's 128 threads
  // ping-pong: warpgroup wg issues its products after `bar.sync 1 + WGS +
  // wg` and hands the tensor cores over to the next warpgroup, round
  // robin, by `bar.arrive` on that one's barrier; warpgroup 0 goes first
  const int tc_mine = 1 + WGS + wg, tc_next = 1 + WGS + (wg + 1) % WGS;
  if (PP && wg == WGS - 1) tc_arrive(1 + WGS);

  bar_wait(qbar, 0);
  if constexpr (MODE == kBase2) {
    // q * qmul rounded to bf16 in place, as the TPU kernel rounds it (JAX's
    // weak typing; K5 and K7 take q as given). qmul is a bf16 value (the
    // wrapper rounds it so), and the product of two bf16 is exact in f32,
    // so one bf16x2 multiply rounds as f32-then-bf16 does.
    const __nv_bfloat162 qm2 = __float2bfloat162_rn(qmul);
#pragma unroll
    for (int i = t; i < H * kTile / 16; i += 128) {
      uint4 raw = reinterpret_cast<const uint4*>(qsw)[i];
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) h2[e] = __hmul2(h2[e], qm2);
      reinterpret_cast<uint4*>(qsw)[i] = raw;
    }
    fence_async_smem();
  }

  float oacc[H][32];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[h][i] = 0.f;
  float st[BK / 2];     // S of key tile j, then its p in f32
  uint32_t pa[BK / 4];  // p of key tile j - 1 as bf16 A fragments
  // Running max of rows r0 and r0 + 8, the same in a quad's four threads
  // (K7: a bf16 value, held exactly); alpha of the last softmax; the row
  // sums, two partial sums a row to halve the chain of dependent adds.
  float m0 = MODE == kBf16Scores
                 ? __bfloat162float(__float2bfloat16_rn(kNegInf))
                 : kNegInf;
  float m1 = m0, alpha0 = 1.f, alpha1 = 1.f;
  float l0 = 0.f, l0b = 0.f, l1 = 0.f, l1b = 0.f;

  // Tile j's bias by plain loads into registers, one key a thread,
  // issued a step ahead so that they land meanwhile (a TMA map needs
  // 16-byte strides, which a bias row of 4 Lk bytes denies). Keys past lk
  // get -inf: they never raise the max, and with their zero-filled K rows
  // p = exp(-inf) = 0.
  float bv[NB];
  auto load_bias = [&](int j) {
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int i = t + 128 * n;
      bv[n] = i < BK && j * BK + i < lk ? biasb[j * BK + i]
                                        : __int_as_float(0xff800000);
    }
  };
  // Waits for tile j's K and V, and moves its bias to shared memory (K7:
  // rounded to bf16 once a key, as its softmax takes it).
  auto wait_tile = [&](int j) {
    float* bt = bsw + (j & 1) * BK;
    bar_wait(&full[j % NS], (j / NS) & 1);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      if (t + 128 * n >= BK) continue;
      if constexpr (MODE == kBf16Scores)
        reinterpret_cast<__nv_bfloat16*>(bt)[t + 128 * n] =
            __float2bfloat16_rn(bv[n]);
      else
        bt[t + 128 * n] = bv[n];
    }
    // this buffer's readers two tiles back are past this sync, and the
    // sync makes the bias (and, first time, q * qmul) visible
    wg_sync(bar_id);
    load_bias(j + 1);
  };
  // This warpgroup's turn at the tensor cores (ping-pong): wait for it,
  // issue the products, hand over. `last`: the last warpgroup's last turn
  // hands over to no one, so that every bar.sync meets its arrivals.
  auto turn = [&]() {
    if (PP) tc_sync(tc_mine);
    fence_acc(st);
#pragma unroll
    for (int h = 0; h < H; ++h) fence_acc(oacc[h]);
    wgmma_fence();
  };
  auto hand_over = [&](bool last) {
    if (PP && (wg != WGS - 1 || !last)) tc_arrive(tc_next);
  };
  // S_j = (q*qmul) K_j^T: 64 queries x BK keys; a k-step is 16 channels,
  // 32 bytes along a region's line
  auto issue_s = [&](int j) {
    const unsigned char* kt = sm + T::K + (j % NS) * H * T::KT;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      wgmma_scores<BK>(st,
                       sw128_desc(qsw + (kk >> 2) * kTile + 32 * (kk & 3)),
                       kt + (kk >> 2) * T::KT + 32 * (kk & 3), kk > 0);
    wgmma_commit();
  };
  // O += P_j V_j: A = P from registers, B = the V tile read MN-major, 16
  // keys (2048 bytes) a k-step, 64 channels a product
  auto issue_pv = [&](int j) {
    const unsigned char* vt = sm + T::V + (j % NS) * H * T::KT;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma_rs(oacc[h], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3], sw128_desc(vt + h * T::KT + 2048 * kk));
    wgmma_commit();
  };
  // Tile j's softmax on the S registers (thread's columns 8 jj + 2 tq4,
  // +1 of rows r0 (st[4 jj], st[4 jj + 1]) and r0 + 8 (st[4 jj + 2],
  // st[4 jj + 3]), as mma.sync's): the new running max n, alpha = exp(m -
  // n), p = exp(s - n) [* valid] into st, l = alpha l + sum p.
  auto softmax = [&](int j) {
    fence_acc(st);
    const float* bt = bsw + (j & 1) * BK;
    float n0, n1;
    if constexpr (MODE == kBf16Scores) {
      // s rounded to bf16, s + bias and the max in bf16 (two chains a row);
      // x (the bf16x2 s + bias) kept as bits in st[4 jj] and st[4 jj + 2]
      const __nv_bfloat16* bth = reinterpret_cast<const __nv_bfloat16*>(bt);
      __nv_bfloat162 mx0 = __float2bfloat162_rn(m0), mx0b = mx0;
      __nv_bfloat162 mx1 = __float2bfloat162_rn(m1), mx1b = mx1;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        const __nv_bfloat162 bb =
            *reinterpret_cast<const __nv_bfloat162*>(bth + 8 * jj + 2 * tq4);
        const __nv_bfloat162 x0 =
            __hadd2(__floats2bfloat162_rn(st[4 * jj], st[4 * jj + 1]), bb);
        const __nv_bfloat162 x1 = __hadd2(
            __floats2bfloat162_rn(st[4 * jj + 2], st[4 * jj + 3]), bb);
        __nv_bfloat162& y0 = jj & 1 ? mx0b : mx0;
        __nv_bfloat162& y1 = jj & 1 ? mx1b : mx1;
        y0 = __hmax2_nan(y0, x0);
        y1 = __hmax2_nan(y1, x1);
        st[4 * jj] = __uint_as_float(as_u32(x0));
        st[4 * jj + 2] = __uint_as_float(as_u32(x1));
      }
      mx0 = __hmax2_nan(mx0, mx0b);
      mx1 = __hmax2_nan(mx1, mx1b);
      n0 = quad_max(nanmax(__low2float(mx0), __high2float(mx0)));
      n1 = quad_max(nanmax(__low2float(mx1), __high2float(mx1)));
      // alpha = exp(f32(bf16(m_prev - m_new)))
      alpha0 = __expf(__bfloat162float(__float2bfloat16_rn(m0 - n0)));
      alpha1 = __expf(__bfloat162float(__float2bfloat16_rn(m1 - n1)));
      l0 *= alpha0;
      l0b *= alpha0;
      l1 *= alpha1;
      l1b *= alpha1;
      const __nv_bfloat162 nb0 = __float2bfloat162_rn(n0);
      const __nv_bfloat162 nb1 = __float2bfloat162_rn(n1);
      // the bf16 p as f32 (exact: its bits in the upper half), from which
      // pack() takes the bf16 halves; a plain copy of the packed bits would
      // let ptxas give the A fragments the S registers, which the next S
      // product overwrites while P V reads them (it then serialises every
      // wgmma: C7511)
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        const uint32_t u0 = __float_as_uint(st[4 * jj]);
        const uint32_t u1 = __float_as_uint(st[4 * jj + 2]);
        const float2 p0 = exp_bf16x2(
            __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u0), nb0));
        const float2 p1 = exp_bf16x2(
            __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u1), nb1));
        (jj & 1 ? l0b : l0) += p0.x + p0.y;
        (jj & 1 ? l1b : l1) += p1.x + p1.y;
        st[4 * jj] = p0.x;
        st[4 * jj + 1] = p0.y;
        st[4 * jj + 2] = p1.x;
        st[4 * jj + 3] = p1.y;
      }
    } else {
      // s + bias in f32; the row's max over the tile, NaN kept, in two
      // chains a row
      float x0 = m0, x0b = m0, x1 = m1, x1b = m1;
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(bt + 8 * jj + 2 * tq4);
        st[4 * jj] += b2.x;
        st[4 * jj + 1] += b2.y;
        st[4 * jj + 2] += b2.x;
        st[4 * jj + 3] += b2.y;
        float& y0 = jj & 1 ? x0b : x0;
        float& y1 = jj & 1 ? x1b : x1;
        y0 = nanmax(y0, nanmax(st[4 * jj], st[4 * jj + 1]));
        y1 = nanmax(y1, nanmax(st[4 * jj + 2], st[4 * jj + 3]));
      }
      n0 = quad_max(nanmax(x0, x0b));
      n1 = quad_max(nanmax(x1, x1b));
      alpha0 = softmax_exp<MODE>(m0 - n0);
      alpha1 = softmax_exp<MODE>(m1 - n1);
      l0 *= alpha0;
      l0b *= alpha0;
      l1 *= alpha1;
      l1b *= alpha1;
      constexpr bool by_fma = MODE == kNatural && kExpByFma;
      float sc0, of0, sc1, of1;
      if constexpr (by_fma) {
        natural_exp_args(n0, sc0, of0);
        natural_exp_args(n1, sc1, of1);
      }
#pragma unroll
      for (int jj = 0; jj < BK / 8; ++jj) {
        float2 b2;
        if (USE_VALID)
          b2 = *reinterpret_cast<const float2*>(bt + 8 * jj + 2 * tq4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p;
          if constexpr (by_fma)
            p = ex2(fmaf(st[4 * jj + e], e < 2 ? sc0 : sc1,
                         e < 2 ? of0 : of1));
          else
            p = softmax_exp<MODE>(st[4 * jj + e] - (e < 2 ? n0 : n1));
          if (USE_VALID)
            p *= ((e & 1) ? b2.y : b2.x) > kValidThreshold ? 1.f : 0.f;
          float& l = e < 2 ? (jj & 1 ? l0b : l0) : (jj & 1 ? l1b : l1);
          l += p;
          st[4 * jj + e] = p;
        }
      }
    }
    m0 = n0;
    m1 = n1;
  };
  // O *= alpha, once no product that writes O is in flight
  auto rescale = [&]() {
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[h][i] *= (i & 2) ? alpha1 : alpha0;
  };
  // P_j as bf16 A fragments, once the last P V has read the old ones
  // (K7's p is bf16 already: its upper halves, by one byte permute)
  auto pack = [&]() {
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lo = st[4 * jj + 2 * r], hi = st[4 * jj + 2 * r + 1];
        pa[2 * jj + r] = MODE == kBf16Scores
                             ? __byte_perm(__float_as_uint(lo),
                                           __float_as_uint(hi), 0x7632)
                             : pack_bf16(lo, hi);
      }
    }
  };
  // once P_j V_j is done, this warp leaves tile j's stage (without a
  // producer warpgroup thread 0 then refills it)
  auto release = [&](int j) {
#pragma unroll
    for (int h = 0; h < H; ++h) fence_acc(oacc[h]);
    if (lane == 0) bar_arrive(&empty[j % NS]);
    if constexpr (!PW) {
      if (tid == 0 && j + NS < nk) {
        bar_wait(&empty[j % NS], (j / NS) & 1);
        load_stage(j + NS);
      }
    }
  };

  // Step j issues S_j and P_{j-1} V_{j-1} in one turn, runs tile j's
  // softmax while P_{j-1} V_{j-1} is still in flight, then rescales O.
  // The first and last steps are peeled, so that no product is issued on
  // a divergent path (ptxas serialises every wgmma of a kernel that does:
  // C7520). Step 0 has no O to rescale.
  load_bias(0);
  wait_tile(0);
  turn();
  issue_s(0);
  hand_over(false);
  wgmma_wait<0>();
  softmax(0);
  pack();
  for (int j = 1; j < nk; ++j) {
    wait_tile(j);
    turn();
    issue_s(j);
    issue_pv(j - 1);
    hand_over(false);
    wgmma_wait<1>();  // S_j (groups complete in order)
    softmax(j);
    wgmma_wait<0>();  // P_{j-1} V_{j-1}
    release(j - 1);
    rescale();
    pack();
  }
  turn();
  issue_pv(nk - 1);
  hand_over(true);
  wgmma_wait<0>();
  release(nk - 1);

  // The four threads of a quad hold disjoint columns of the same rows.
  const float d0 = floor_l(quad_sum(l0 + l0b));
  const float d1 = floor_l(quad_sum(l1 + l1b));

  // O / max(l, 1e-30) as bf16 into this warpgroup's q tile (its last
  // reader, the last S product, has completed), in the swizzle TMA reads;
  // then one 3-D TMA store a region, which clips rows past lq.
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int off = ((j ^ sw) << 4) + 4 * tq4;
      unsigned char* row = qsw + h * kTile + r0 * 128 + off;
      *reinterpret_cast<uint32_t*>(row) =
          pack_bf16(oacc[h][4 * j] / d0, oacc[h][4 * j + 1] / d0);
      *reinterpret_cast<uint32_t*>(row + 8 * 128) =
          pack_bf16(oacc[h][4 * j + 2] / d1, oacc[h][4 * j + 3] / d1);
    }
  fence_async_smem();
  wg_sync(bar_id);
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < H; ++h)
      tma_store_3d(&to, qsw + h * kTile, 64 * h, qw, b);
    bulk_commit();
    bulk_wait_read();  // the tile stays in shared memory until read
  }
  if (tq4 == 0) {
    float* lb = lse + size_t(b) * lq;
    if (qw + r0 < lq) lb[qw + r0] = final_lse<MODE>(m0, d0);
    if (qw + r0 + 8 < lq) lb[qw + r0 + 8] = final_lse<MODE>(m1, d1);
  }
}

// ---------------------------------------------------------------------------
// f32 (K3 only): exact f32 on FMA. 256 threads = 64 rows x 4 parts; a part
// scores 8 of the tile's 32 keys and owns every 4th output channel; the
// four parts of a row are the lanes of a quad.
// ---------------------------------------------------------------------------

constexpr int kBK32 = 32;

template <int C>
struct F32Tile {
  static constexpr int QS = C + 1;       // padded rows: conflict-free reads
  static constexpr int PS = kBK32 + 1;
  static constexpr size_t smem =
      sizeof(float) * (size_t(kBQ) * QS + size_t(kBK32) * QS +
                       size_t(kBK32) * C + size_t(kBQ) * PS + kBK32) +
      sizeof(int) * kBK32;
};

template <int C, bool USE_VALID>
__global__ void __launch_bounds__(256)
fwd_online_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ o, float* __restrict__ lse, int lq, int lk,
               float qmul) {
  using T = F32Tile<C>;
  constexpr int QS = T::QS, PS = T::PS, C4 = C / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kBQ * QS;
  float* vs = ks + kBK32 * QS;
  float* ps = vs + kBK32 * C;
  float* bs = ps + kBQ * PS;
  int* in_range = reinterpret_cast<int*>(bs + kBK32);

  const int tid = threadIdx.x, row = tid >> 2, part = tid & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const float* qb = q + size_t(b) * lq * C;
  const float* kb = k + size_t(b) * lk * C;
  const float* vb = v + size_t(b) * lk * C;
  const float* biasb = bias + size_t(b) * lk;

  for (int idx = tid; idx < kBQ * C4; idx += blockDim.x) {
    const int r = idx / C4, c4 = idx % C4, gr = q0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < lq) x = *reinterpret_cast<const float4*>(qb + size_t(gr) * C + c4 * 4);
    float* dst = qs + r * QS + c4 * 4;
    dst[0] = x.x * qmul; dst[1] = x.y * qmul; dst[2] = x.z * qmul; dst[3] = x.w * qmul;
  }

  float acc[C4];
#pragma unroll
  for (int i = 0; i < C4; ++i) acc[i] = 0.f;
  float l = 0.f, m = kNegInf;

  for (int kt = 0; kt < lk; kt += kBK32) {
    __syncthreads();
    for (int idx = tid; idx < kBK32 * C4; idx += blockDim.x) {
      const int r = idx / C4, c4 = idx % C4, gk = kt + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (gk < lk) {
        kx = *reinterpret_cast<const float4*>(kb + size_t(gk) * C + c4 * 4);
        vx = *reinterpret_cast<const float4*>(vb + size_t(gk) * C + c4 * 4);
      }
      float* kd = ks + r * QS + c4 * 4;
      kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
      *reinterpret_cast<float4*>(vs + r * C + c4 * 4) = vx;
    }
    for (int idx = tid; idx < kBK32; idx += blockDim.x) {
      const int gk = kt + idx;
      bs[idx] = gk < lk ? biasb[gk] : 0.f;
      in_range[idx] = gk < lk;
    }
    __syncthreads();

    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
    const float* qr = qs + row * QS;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float qv = qr[c];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = fmaf(qv, ks[(part * 8 + i) * QS + c], s[i]);
    }
    // s + bias (keys past lk: -inf); the row's new max, NaN kept
    float mn = m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = part * 8 + i;
      s[i] = in_range[col] ? s[i] + bs[col] : __int_as_float(0xff800000);
      mn = nanmax(mn, s[i]);
    }
    mn = quad_max(mn);
    const float alpha = ex2(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < C4; ++i) acc[i] *= alpha;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = part * 8 + i;
      float p = ex2(s[i] - mn);
      if (USE_VALID) p *= (bs[col] > kValidThreshold) ? 1.f : 0.f;
      l += p;
      ps[row * PS + col] = p;
    }
    __syncthreads();

    const float* pr = ps + row * PS;
#pragma unroll 4
    for (int j = 0; j < kBK32; ++j) {
      const float p = pr[j];
      const float* vr = vs + j * C + part;
#pragma unroll
      for (int i = 0; i < C4; ++i) acc[i] = fmaf(p, vr[4 * i], acc[i]);
    }
  }

  const float d = floor_l(quad_sum(l));
  const int gr = q0 + row;
  if (gr < lq) {
    float* orow = o + (size_t(b) * lq + gr) * C + part;
#pragma unroll
    for (int i = 0; i < C4; ++i) orow[4 * i] = acc[i] / d;
    if (part == 0) lse[size_t(b) * lq + gr] = final_lse<kBase2>(m, d);
  }
}

// ---------------------------------------------------------------------------
// Launch helpers.
// ---------------------------------------------------------------------------

// The dynamic shared memory limit is a per-device attribute of each kernel
// instantiation: `set_on` holds one bit per device it was raised on, so
// only the first launch on a device pays for cudaFuncSetAttribute.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem,
                       std::atomic<uint32_t>& set_on) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (set_on.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err == cudaSuccess) set_on.fetch_or(bit, std::memory_order_release);
  return err;
}

struct Args {
  const void *q, *k, *v, *bias;
  void* o;
  float* lse;
  int b, lq, lk;
  float qmul;
  cudaStream_t stream;
};

template <typename Elem, typename Kernel>
cudaError_t launch(Kernel kernel, std::atomic<uint32_t>& set_on, int rows,
                   int threads, size_t smem, const Args& a) {
  cudaError_t err = allow_smem(kernel, smem, set_on);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lq + rows - 1) / rows, a.b);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const Elem*>(a.q), static_cast<const Elem*>(a.k),
      static_cast<const Elem*>(a.v), static_cast<const float*>(a.bias),
      static_cast<Elem*>(a.o), a.lse, a.lq, a.lk, a.qmul);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a driver call, found through the runtime so that
// the library needs no -lcuda; null if the driver lacks it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// 3-D map (C, L, B) of a contiguous bf16 [B, L, C] tensor, box (64, box_l,
// 1), 128-byte swizzle: a box reaching past L reads zeros there (and a
// store drops those rows) instead of running into the next batch row.
bool map_3d(EncodeTiled enc, CUtensorMap* m, const void* base, int c, int l,
            int b, int box_l) {
  const cuuint64_t dims[3] = {cuuint64_t(c), cuuint64_t(l), cuuint64_t(b)};
  const cuuint64_t strides[2] = {cuuint64_t(c) * 2, cuuint64_t(l) * c * 2};
  const cuuint32_t box[3] = {64, cuuint32_t(box_l), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C, int MODE, bool UV>
cudaError_t run_wgmma(const Args& a) {
  constexpr int BK = C == 64 ? kKeys64 : C == 128 ? kKeys128 : kKeys256;
  constexpr int NS = C == 64 ? kStages64 : C == 128 ? kStages128 : kStages256;
  constexpr int WGS = C == 256 ? kConsumers256 : kConsumers;
  constexpr bool PP = C == 64 ? kPingPong64 : C == 128 && kPingPong128;
  using T = FwdWgTile<C, BK, NS, WGS, kProducerWarp>;
  auto kernel = &fwd_online_wgmma<C, BK, NS, WGS, kProducerWarp, PP, MODE, UV>;
  static std::atomic<uint32_t> set_on{0};
  cudaError_t err = allow_smem(kernel, T::smem, set_on);
  if (err != cudaSuccess) return err;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mo;
  const bool ok = map_3d(enc, &mq, a.q, C, a.lq, a.b, 64) &&
                  map_3d(enc, &mk, a.k, C, a.lk, a.b, BK) &&
                  map_3d(enc, &mv, a.v, C, a.lk, a.b, BK) &&
                  map_3d(enc, &mo, a.o, C, a.lq, a.b, 64);
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid((a.lq + T::BQ - 1) / T::BQ, a.b);
  kernel<<<grid, T::threads, T::smem, a.stream>>>(
      mq, mk, mv, mo, static_cast<const float*>(a.bias), a.lse, a.lq, a.lk,
      a.qmul);
  return cudaGetLastError();
}

// K3, K5 and K7 run the wgmma body at the C that `wgmma_body` names, a
// call with no key (a map cannot have length 0; the mma.sync body writes
// o = 0) the mma.sync body, with the no-max kernel's tiles there: 128 f32
// accumulators a thread at C = 256 halve the key tile, at C = 64 a block
// takes 128 queries, and K7's key tile is the wgmma body's (its result
// depends on it).
template <int C, int MODE, bool UV>
cudaError_t run_bf16(const Args& a) {
  if constexpr (wgmma_body(C)) {
    if (a.lk > 0) return run_wgmma<C, MODE, UV>(a);
  }
  constexpr int BK = MODE == kBf16Scores ? kKeys64 : C >= 256 ? 32 : 64;
  constexpr int WARPS = C == 64 ? 8 : 4;
  using T = Bf16Tile<C, BK, WARPS>;
  static std::atomic<uint32_t> set_on{0};
  return launch<__nv_bfloat16>(&fwd_online_bf16<C, BK, WARPS, MODE, UV>,
                               set_on, T::BQ, 32 * WARPS, T::smem, a);
}

template <int C, bool UV>
cudaError_t run(bool bf16, const Args& a) {
  if (bf16) return run_bf16<C, kBase2, UV>(a);
  static std::atomic<uint32_t> f32_set_on{0};
  return launch<float>(&fwd_online_f32<C, UV>, f32_set_on, kBQ, 256,
                       F32Tile<C>::smem, a);
}

template <int C>
cudaError_t run_c(bool bf16, bool use_valid, const Args& a) {
  return use_valid ? run<C, true>(bf16, a) : run<C, false>(bf16, a);
}

}  // namespace

// K3. q, k, v: [B, Lq|Lk, C] contiguous, all bf16 (is_bf16 = 1) or all f32;
// bias: [B, 1, Lk] f32; o: [B, Lq, C] in q's dtype; lse: [B, 1, Lq] f32,
// m + log2(max(l, 1e-30)) of each query row. C in {64, 128, 256}. Launches
// on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_fwd_online(const void* q, const void* k, const void* v,
                                const void* bias, void* o, void* lse, int b,
                                int lq, int lk, int c, int is_bf16,
                                int use_valid, float qmul, void* stream) {
  if (b <= 0 || lq <= 0) return int(cudaSuccess);
  const Args a{q, k, v, bias, o, static_cast<float*>(lse), b, lq, lk, qmul,
               static_cast<cudaStream_t>(stream)};
  const bool bf16 = is_bf16 != 0, uv = use_valid != 0;
  switch (c) {
    case 64: return int(run_c<64>(bf16, uv, a));
    case 128: return int(run_c<128>(bf16, uv, a));
    case 256: return int(run_c<256>(bf16, uv, a));
    default: return int(cudaErrorInvalidValue);
  }
}

// K5 and K7: bf16 q, k, v [B, Lq|Lk, 64] (the caller scales q), bias [B, 1,
// Lk] f32; o [B, Lq, 64] bf16; lse [B, 1, Lq] f32, m + ln(max(l, 1e-30)).
// `c` must be 64. Launch on `stream`; return cudaGetLastError().
extern "C" int flash_fwd_online_exp(const void* q, const void* k,
                                    const void* v, const void* bias, void* o,
                                    void* lse, int b, int lq, int lk, int c,
                                    void* stream) {
  if (c != 64) return int(cudaErrorInvalidValue);
  if (b <= 0 || lq <= 0) return int(cudaSuccess);
  return int(run_bf16<64, kNatural, false>(
      Args{q, k, v, bias, o, static_cast<float*>(lse), b, lq, lk, 1.f,
           static_cast<cudaStream_t>(stream)}));
}

extern "C" int flash_fwd_online_bf16(const void* q, const void* k,
                                     const void* v, const void* bias, void* o,
                                     void* lse, int b, int lq, int lk, int c,
                                     void* stream) {
  if (c != 64) return int(cudaErrorInvalidValue);
  if (b <= 0 || lq <= 0) return int(cudaSuccess);
  return int(run_bf16<64, kBf16Scores, false>(
      Args{q, k, v, bias, o, static_cast<float*>(lse), b, lq, lk, 1.f,
           static_cast<cudaStream_t>(stream)}));
}

// Which body the bf16 K3 runs at C channels (and K5 and K7 at C = 64):
// 2 = wgmma (`fwd_online_wgmma`), 1 = mma.sync (`fwd_online_bf16`), 0 =
// no kernel for that C.
extern "C" int flash_fwd_online_body(int c) {
  if (c != 64 && c != 128 && c != 256) return 0;
  return wgmma_body(c) ? 2 : 1;
}
