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
//     bf16 at C = 64 only (the instantiation its tool launches).
//
//   * K7 `_fwd_kernel_bf16` (tools/bf16_softmax_experiment.py:32-71,
//     launched at :79): natural exp with bf16 scores. Entry
//     `flash_fwd_online_bf16`, bf16 at C = 64 only. It rounds where the TPU
//     kernel does: s (the f32 product) and the bias to bf16, s + bias, the
//     running max (from bf16(-1e30)), s - m and p = exp(s - m) in bf16
//     (packed bf16x2: __hadd2, __hmax2_nan, __hsub2, h2exp; each is the f32
//     operation rounded once to bf16, as XLA and PyTorch compute bf16 on
//     the CPU), alpha = exp(f32(bf16(m_prev - m_new))), l the f32 sum of the
//     bf16 p, which is also the P.V operand as it is; lse = f32(m) + ln(l).
//
// What bounds it on an H100: as the no-max forward (flash_fwd_nomax.cu), the
// two products (4*B*Lq*Lk*C flops) and the B*Lq*Lk exponentials, never the
// bytes. The online max adds, per key tile, a max over the tile and a quad
// shuffle per row, one exponential and a rescale of the C-wide accumulator
// per row. The design is the no-max kernel's (one block per (batch, query
// tile), mma.sync m16n8k16 for bf16 with a two-stage cp.async K/V ring and
// ldmatrix, exact-f32 FMA for f32, p kept in registers as the A operand of
// P.V, any Lq and Lk by masking) with the running max and the rescale added.
//
// No TMA or wgmma yet: those come with the kernel's tuning.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kValidThreshold = -5e29f;  // NEG_INF * 0.5
constexpr float kNegInf = -1e30f;          // NEG_INF: the running max's start
constexpr float kMinL = 1e-30f;
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
  return (a != a || a > b) ? a : b;
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
        const __nv_bfloat162 p0 = h2exp(__hsub2(x[j][0], nb0));
        const __nv_bfloat162 p1 = h2exp(__hsub2(x[j][1], nb1));
        ls0 += __low2float(p0) + __high2float(p0);
        ls1 += __low2float(p1) + __high2float(p1);
        pa[j][0] = as_u32(p0);
        pa[j][1] = as_u32(p1);
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

// bf16 tiles as the no-max kernel: 128 f32 accumulators a thread at C = 256
// halve the key tile there; at C = 64 a block takes 128 queries.
template <int C, int MODE, bool UV>
cudaError_t run_bf16(const Args& a) {
  constexpr int BK = C >= 256 ? 32 : 64;
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
