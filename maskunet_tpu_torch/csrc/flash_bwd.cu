// Merged masked-attention backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (maskunet_tpu/ops/
// flash_attention.py:323-389, launched at :400-437 in `_flash_bwd`), the
// backward rule of `flash_mha`. Per (batch, query i, key j), with lse_i the
// base-2 log row sum of the forward (flash_fwd_nomax.cu, `with_lse`) and
// delta_i = sum_c dO_ic O_ic (computed by the caller):
//
//   s   = (q_i * qmul) . k_j + bias_j   qmul = scale*log2e, q*qmul rounded to
//                                       q's dtype exactly as the forward did
//   s   = min(s, 60)                    NaN-propagating, the no-max forward's
//                                       clamp; `clamp` = 0 skips it (after the
//                                       online-max forward, flash_fwd_online.cu,
//                                       whose lse may exceed 60)
//   p   = exp2(s - lse_i) [* valid_j]   valid only with use_valid
//   dV_j += p (rounded to dO's dtype) * dO_i
//   ds  = p * (dO_i . v_j - delta_i)    f32
//   dK_j += scale * ds' * q_i           ds' = ds rounded to q's dtype; the
//   dQ_i += scale * ds' * k_j           raw q and k (ln2 * log2e cancel)
//
// What bounds it on an H100: five products of 2*B*Lq*Lk*C flops each over
// the visible keys (attn6 at batch 8, ~8,192 visible keys a row: ~0.69
// TFLOP, ~0.69 ms at the 989 TF/s bf16 tensor-core peak) and B*Lq*Lk exp2;
// the bytes (q, k, v, dO, dQ, dK, dV once each) take ~0.04 ms. So it is bound by operations,
// and nothing of size Lq x Lk leaves the SM.
//
// Design (not the TPU's): the TPU kernel runs a (B, nK, nQ) grid, carries
// dK/dV in VMEM across a sequential sweep over query blocks and streams f32
// dQ partials per key block to a [B, nK, Lq, C] buffer that XLA sums; with
// small key tiles that buffer would be gigabytes here. Instead:
//
//   * one thread block owns one (batch, key tile): it loads its K and V
//     tile once, keeps the f32 dK and dV accumulators in registers, loops
//     over every query tile and writes dK and dV once;
//   * q, dO, lse and delta stream through a two-stage cp.async ring; each
//     warp owns 16 keys and computes S^T = K (q*qmul)^T and dP^T = V dO^T
//     for them with mma.sync m16n8k16 (bf16 in, f32 out); P^T and dS^T stay
//     in registers as the A operands of dV += P^T dO and dK += dS^T q;
//   * dS^T goes to shared memory once (bf16), the block's warps compute
//     dQ = dS K for the tile and add it with f32 atomicAdd (float2: two
//     channels an instruction) into a [B, Lq, C] buffer the wrapper zeroes
//     (JAX's sum of the partials over key blocks becomes the atomics; their
//     order, and so dQ's last bits, change from run to run). Each block
//     starts its query sweep at its own tile, so blocks running together
//     add to different rows;
//   * at C = 256 two f32 C-wide accumulators do not fit in one warp's
//     registers, so two warps share each 16 keys, each accumulating half
//     of dK and dV's channels (the S and dP products are computed twice);
//   * f32 inputs stay exact f32 (no TF32) on plain FMA, 32x32 tiles through
//     shared memory, the same atomics for dQ;
//   * any Lq and Lk: keys past Lk are zero-filled with bias -inf (p = 0)
//     and not stored; query rows past Lq get p = 0 and are not stored.
//
// No TMA or wgmma yet: those come with the kernel's tuning.
// Entry point: `flash_bwd` below (plain C, bound with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kValidThreshold = -5e29f;  // NEG_INF * 0.5
constexpr float kClamp = 60.0f;            // _NOMAX_CLAMP

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// min(x, 60) that keeps NaN (fminf(NaN, 60) would return 60).
__device__ __forceinline__ float clamp_hi(float x) {
  return x > kClamp ? kClamp : x;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
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

// A operand (16 rows x 16 k) from an accumulator pair laid out as this
// warp's rows x (16 kk .. 16 kk + 15): the register reuse of the forward's
// P.V, here for P^T dO and dS^T q.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&x)[N][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores. KW warps of 16 keys each (BK = 16 KW keys a block),
// each key group repeated CS times over slices of dK/dV's channels; BQ
// query rows a step of the sweep.
// ---------------------------------------------------------------------------

template <int C, int BQ, int KW, int CS>
struct BwdTile {
  static constexpr int WARPS = KW * CS;
  static constexpr int NT = 32 * WARPS;
  static constexpr int BK = 16 * KW;      // keys per block
  static constexpr int S = C + 8;         // row stride: ldmatrix rows on
  static constexpr int SD = BQ + 8;       // distinct banks
  static constexpr int CW = C / CS;       // dK/dV channels of a warp
  static constexpr int RG = BQ / 16;      // dQ: row groups of 16 queries
  static constexpr int CQ = C / (WARPS / RG);  // dQ channels of a warp
  // K, V tiles; q and dO two stages each; q*qmul; dS^T (bf16 elements)
  static constexpr size_t elems = size_t(2 * BK * S + 5 * BQ * S + BK * SD);
  // bias per key; lse and delta two stages each
  static constexpr size_t smem = elems * sizeof(__nv_bfloat16) +
                                 size_t(BK + 4 * BQ) * sizeof(float);
};

template <int C, int BQ, int KW, int CS, bool USE_VALID, bool CLAMP>
__global__ void __launch_bounds__(32 * KW * CS, 1)
bwd_bf16(const __nv_bfloat16* __restrict__ q,
         const __nv_bfloat16* __restrict__ k,
         const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
         const __nv_bfloat16* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ delta,
         float* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
         __nv_bfloat16* __restrict__ dv, int lq, int lk, float qmul,
         float scale) {
  using T = BwdTile<C, BQ, KW, CS>;
  constexpr int S = T::S, SD = T::SD, BK = T::BK, NT = T::NT, C8 = C / 8;
  constexpr int CW = T::CW, CQ = T::CQ, RG = T::RG;
  static_assert(C % 16 == 0 && BQ % 16 == 0 && CW % 16 == 0 &&
                    CQ % 16 == 0 && T::WARPS % RG == 0,
                "tile shape");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + BK * S;
  __nv_bfloat16* qraw = vs + BK * S;      // [stage][BQ * S]
  __nv_bfloat16* dos = qraw + 2 * BQ * S; // [stage][BQ * S]
  __nv_bfloat16* qss = dos + 2 * BQ * S;  // q * qmul of this step's tile
  __nv_bfloat16* dss = qss + BQ * S;      // dS^T [key][query]
  float* bs = reinterpret_cast<float*>(dss + BK * SD);
  float* lses = bs + BK;                  // [stage][BQ]
  float* dels = lses + 2 * BQ;            // [stage][BQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, k0 = blockIdx.x * BK;
  const __nv_bfloat16* qb = q + size_t(b) * lq * C;
  const __nv_bfloat16* dob = dout + size_t(b) * lq * C;
  const float* lseb = lse + size_t(b) * lq;
  const float* delb = delta + size_t(b) * lq;
  float* dqb = dq + size_t(b) * lq * C;

  // This block's K and V tile (one commit group with the first q/dO tile);
  // keys past lk are zero-filled with bias -inf.
  {
    const __nv_bfloat16* kb = k + size_t(b) * lk * C;
    const __nv_bfloat16* vb = v + size_t(b) * lk * C;
    for (int idx = tid; idx < BK * C8; idx += NT) {
      const int row = idx / C8, c8 = idx % C8, gk = k0 + row;
      const bool in = gk < lk;
      const size_t off = size_t(in ? gk : 0) * C + c8 * 8;
      cp_async16(ks + row * S + c8 * 8, kb + off, in);
      cp_async16(vs + row * S + c8 * 8, vb + off, in);
    }
    for (int idx = tid; idx < BK; idx += NT) {
      const int gk = k0 + idx;
      bs[idx] = gk < lk ? bias[size_t(b) * lk + gk]
                        : __int_as_float(0xff800000);
    }
  }

  const int nq = (lq + BQ - 1) / BQ;
  const int first = nq > 0 ? int(blockIdx.x % nq) : 0;
  auto tile_q0 = [&](int it) { return ((first + it) % nq) * BQ; };
  auto load_q = [&](int it, int stage) {
    const int q0 = tile_q0(it);
    __nv_bfloat16* qd = qraw + stage * BQ * S;
    __nv_bfloat16* dd = dos + stage * BQ * S;
    for (int idx = tid; idx < BQ * C8; idx += NT) {
      const int row = idx / C8, c8 = idx % C8, gr = q0 + row;
      const bool in = gr < lq;
      const size_t off = size_t(in ? gr : 0) * C + c8 * 8;
      cp_async16(qd + row * S + c8 * 8, qb + off, in);
      cp_async16(dd + row * S + c8 * 8, dob + off, in);
    }
    for (int idx = tid; idx < BQ; idx += NT) {
      const int gr = q0 + idx;
      lses[stage * BQ + idx] = gr < lq ? lseb[gr] : 0.f;
      dels[stage * BQ + idx] = gr < lq ? delb[gr] : 0.f;
    }
    cp_async_commit();
  };
  if (nq > 0) load_q(0, 0);
  else cp_async_commit();

  const int kw = warp % KW, cs = warp / KW;
  const int kbase = kw * 16;
  const int mrow = lane & 7, mhalf = (lane >> 3) & 1, mpair = lane >> 4;
  // A-operand rows of this warp's 16 keys (K for S^T, V for dP^T)
  const __nv_bfloat16* ka = ks + (kbase + (lane & 15)) * S + (lane >> 4) * 8;
  const __nv_bfloat16* va = vs + (kbase + (lane & 15)) * S + (lane >> 4) * 8;
  // dQ: this warp's 16 queries and CQ channels of the tile
  const int rg = warp % RG, cg = warp / RG;

  float dka[CW / 8][4], dva[CW / 8][4];
#pragma unroll
  for (int n = 0; n < CW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  for (int it = 0; it < nq; ++it) {
    const int stage = it & 1, q0 = tile_q0(it);
    if (it + 1 < nq) {
      load_q(it + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's tiles (and, first time, K/V) are in
    const __nv_bfloat16* qd = qraw + stage * BQ * S;
    const __nv_bfloat16* dd = dos + stage * BQ * S;
    const float* lt = lses + stage * BQ;
    const float* dt = dels + stage * BQ;

    // q * qmul rounded to bf16, as the forward's Q load rounds it
    for (int idx = tid; idx < BQ * C8; idx += NT) {
      const int row = idx / C8, c8 = idx % C8;
      uint4 raw = *reinterpret_cast<const uint4*>(qd + row * S + c8 * 8);
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(h[i]);
        h[i] = __floats2bfloat162_rn(f.x * qmul, f.y * qmul);
      }
      *reinterpret_cast<uint4*>(qss + row * S + c8 * 8) = raw;
    }
    __syncthreads();

    // S^T = K (q*qmul)^T: this warp's 16 keys x BQ queries
    float st[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, ka + kk * 16);
#pragma unroll
      for (int j = 0; j < BQ / 8; j += 2) {
        uint32_t bf[4];  // queries j*8.. and (j+1)*8.., channels kk*16..
        ldsm_x4(bf, qss + ((j + mpair) * 8 + mrow) * S + kk * 16 + mhalf * 8);
        mma_bf16(st[j], a, bf[0], bf[1]);
        mma_bf16(st[j + 1], a, bf[2], bf[3]);
      }
    }

    // P^T = exp2(min(s + bias, 60) - lse) [* valid]; rows past lq give 0
    const float bb0 = bs[kbase + g], bb1 = bs[kbase + g + 8];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float bb = e < 2 ? bb0 : bb1;
        const float x = st[j][e] + bb;
        float p = ex2((CLAMP ? clamp_hi(x) : x) - lt[col]);
        if (USE_VALID) p *= (bb > kValidThreshold) ? 1.f : 0.f;
        st[j][e] = q0 + col < lq ? p : 0.f;
      }
    }

    // dV += P^T dO over this warp's channel slice
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, st, kk);
#pragma unroll
      for (int n = 0; n < CW / 8; n += 2) {
        uint32_t bf[4];  // queries kk*16.., channels of tiles n, n+1
        ldsm_x4_trans(bf, dd + (kk * 16 + mhalf * 8 + mrow) * S + cs * CW +
                              (n + mpair) * 8);
        mma_bf16(dva[n], a, bf[0], bf[1]);
        mma_bf16(dva[n + 1], a, bf[2], bf[3]);
      }
    }

    // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) in f32
    float dpt[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, va + kk * 16);
#pragma unroll
      for (int j = 0; j < BQ / 8; j += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, dd + ((j + mpair) * 8 + mrow) * S + kk * 16 + mhalf * 8);
        mma_bf16(dpt[j], a, bf[0], bf[1]);
        mma_bf16(dpt[j + 1], a, bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[j][e] *= dpt[j][e] - dt[j * 8 + 2 * t + (e & 1)];

    // dK += dS^T q (raw q) over this warp's channel slice
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, st, kk);
#pragma unroll
      for (int n = 0; n < CW / 8; n += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, qd + (kk * 16 + mhalf * 8 + mrow) * S + cs * CW +
                              (n + mpair) * 8);
        mma_bf16(dka[n], a, bf[0], bf[1]);
        mma_bf16(dka[n + 1], a, bf[2], bf[3]);
      }
    }

    // dS^T (bf16) to shared memory; the CS copies of a key group agree
    if (cs == 0) {
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int col = j * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dss + (kbase + g) * SD + col) =
            pack_bf16(st[j][0], st[j][1]);
        *reinterpret_cast<uint32_t*>(dss + (kbase + g + 8) * SD + col) =
            pack_bf16(st[j][2], st[j][3]);
      }
    }
    __syncthreads();

    // dQ += scale * dS K over this tile's BK keys: 16 queries x CQ channels
    // a warp, added to the f32 buffer with atomics
    {
      float dqa[CQ / 8][4];
#pragma unroll
      for (int n = 0; n < CQ / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];  // dS [query][key] = transposed reads of dS^T
        ldsm_x4_trans(a, dss + (kk * 16 + mpair * 8 + mrow) * SD + rg * 16 +
                             mhalf * 8);
#pragma unroll
        for (int n = 0; n < CQ / 8; n += 2) {
          uint32_t bf[4];  // keys kk*16.., channels of tiles n, n+1
          ldsm_x4_trans(bf, ks + (kk * 16 + mhalf * 8 + mrow) * S + cg * CQ +
                                (n + mpair) * 8);
          mma_bf16(dqa[n], a, bf[0], bf[1]);
          mma_bf16(dqa[n + 1], a, bf[2], bf[3]);
        }
      }
      const int r0 = q0 + rg * 16 + g, r1 = r0 + 8;
#pragma unroll
      for (int n = 0; n < CQ / 8; ++n) {
        const int col = cg * CQ + n * 8 + 2 * t;
        // two neighbouring channels in one 8-byte atomic (sm_90)
        if (r0 < lq)
          atomicAdd(reinterpret_cast<float2*>(dqb + size_t(r0) * C + col),
                    make_float2(scale * dqa[n][0], scale * dqa[n][1]));
        if (r1 < lq)
          atomicAdd(reinterpret_cast<float2*>(dqb + size_t(r1) * C + col),
                    make_float2(scale * dqa[n][2], scale * dqa[n][3]));
      }
    }
    __syncthreads();  // the next step refills this stage and dS^T
  }
  if (nq == 0) cp_async_wait<0>();

  const int gk0 = k0 + kbase + g, gk1 = gk0 + 8;
  __nv_bfloat16* dkb = dk + size_t(b) * lk * C;
  __nv_bfloat16* dvb = dv + size_t(b) * lk * C;
#pragma unroll
  for (int n = 0; n < CW / 8; ++n) {
    const int col = cs * CW + n * 8 + 2 * t;
    if (gk0 < lk) {
      *reinterpret_cast<uint32_t*>(dkb + size_t(gk0) * C + col) =
          pack_bf16(scale * dka[n][0], scale * dka[n][1]);
      *reinterpret_cast<uint32_t*>(dvb + size_t(gk0) * C + col) =
          pack_bf16(dva[n][0], dva[n][1]);
    }
    if (gk1 < lk) {
      *reinterpret_cast<uint32_t*>(dkb + size_t(gk1) * C + col) =
          pack_bf16(scale * dka[n][2], scale * dka[n][3]);
      *reinterpret_cast<uint32_t*>(dvb + size_t(gk1) * C + col) =
          pack_bf16(dva[n][2], dva[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: exact f32 on FMA. 256 threads, 32 keys a block, 32 queries a step;
// thread (row = tid / 8, part = tid % 8) scores query `row` against keys
// part + 8m, then owns key `row` (dK, dV) and query `row` (dQ) over the
// channels part + 8i.
// ---------------------------------------------------------------------------

constexpr int kT32 = 32;

template <int C>
struct BwdF32Tile {
  static constexpr int RS = C + 1;       // padded rows: conflict-free reads
  static constexpr int PS = kT32 + 1;
  static constexpr size_t smem =
      sizeof(float) * (4 * size_t(kT32) * RS + 2 * size_t(kT32) * PS +
                       3 * size_t(kT32));
};

template <int C, bool USE_VALID, bool CLAMP>
__global__ void __launch_bounds__(256)
bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ bias,
        const float* __restrict__ dout, const float* __restrict__ lse,
        const float* __restrict__ delta, float* __restrict__ dq,
        float* __restrict__ dk, float* __restrict__ dv, int lq, int lk,
        float qmul, float scale) {
  using T = BwdF32Tile<C>;
  constexpr int RS = T::RS, PS = T::PS, C4 = C / 4, C8 = C / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kT32 * RS;
  float* qs = vs + kT32 * RS;   // raw q
  float* dos = qs + kT32 * RS;
  float* ps = dos + kT32 * RS;  // P [query][key]
  float* dss = ps + kT32 * PS;  // dS [query][key]
  float* bs = dss + kT32 * PS;
  float* lt = bs + kT32;
  float* dt = lt + kT32;

  const int tid = threadIdx.x, row = tid >> 3, part = tid & 7;
  const int b = blockIdx.y, k0 = blockIdx.x * kT32;
  const float* qb = q + size_t(b) * lq * C;
  const float* dob = dout + size_t(b) * lq * C;
  float* dqb = dq + size_t(b) * lq * C;

  for (int idx = tid; idx < kT32 * C4; idx += blockDim.x) {
    const int r = idx / C4, c4 = idx % C4, gk = k0 + r;
    float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
    if (gk < lk) {
      kx = *reinterpret_cast<const float4*>(k + (size_t(b) * lk + gk) * C + c4 * 4);
      vx = *reinterpret_cast<const float4*>(v + (size_t(b) * lk + gk) * C + c4 * 4);
    }
    float* kd = ks + r * RS + c4 * 4;
    float* vd = vs + r * RS + c4 * 4;
    kd[0] = kx.x; kd[1] = kx.y; kd[2] = kx.z; kd[3] = kx.w;
    vd[0] = vx.x; vd[1] = vx.y; vd[2] = vx.z; vd[3] = vx.w;
  }
  for (int idx = tid; idx < kT32; idx += blockDim.x) {
    const int gk = k0 + idx;
    bs[idx] = gk < lk ? bias[size_t(b) * lk + gk] : __int_as_float(0xff800000);
  }

  float dka[C8], dva[C8];
#pragma unroll
  for (int i = 0; i < C8; ++i) dka[i] = dva[i] = 0.f;

  const int nq = (lq + kT32 - 1) / kT32;
  const int first = nq > 0 ? int(blockIdx.x % nq) : 0;
  for (int it = 0; it < nq; ++it) {
    const int q0 = ((first + it) % nq) * kT32;
    __syncthreads();  // the previous step is done with the tiles
    for (int idx = tid; idx < kT32 * C4; idx += blockDim.x) {
      const int r = idx / C4, c4 = idx % C4, gr = q0 + r;
      float4 qx = make_float4(0.f, 0.f, 0.f, 0.f), dx = qx;
      if (gr < lq) {
        qx = *reinterpret_cast<const float4*>(qb + size_t(gr) * C + c4 * 4);
        dx = *reinterpret_cast<const float4*>(dob + size_t(gr) * C + c4 * 4);
      }
      float* qd = qs + r * RS + c4 * 4;
      float* dd = dos + r * RS + c4 * 4;
      qd[0] = qx.x; qd[1] = qx.y; qd[2] = qx.z; qd[3] = qx.w;
      dd[0] = dx.x; dd[1] = dx.y; dd[2] = dx.z; dd[3] = dx.w;
    }
    for (int idx = tid; idx < kT32; idx += blockDim.x) {
      const int gr = q0 + idx;
      lt[idx] = gr < lq ? lse[size_t(b) * lq + gr] : 0.f;
      dt[idx] = gr < lq ? delta[size_t(b) * lq + gr] : 0.f;
    }
    __syncthreads();

    // scores and dP of query `row` against keys part + 8m
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qr = qs + row * RS;
    const float* dr = dos + row * RS;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float qv = qr[c] * qmul, dv_ = dr[c];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        s[m] = fmaf(qv, ks[(part + 8 * m) * RS + c], s[m]);
        dp[m] = fmaf(dv_, vs[(part + 8 * m) * RS + c], dp[m]);
      }
    }
    const bool row_in = q0 + row < lq;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int j = part + 8 * m;
      const float bb = bs[j];
      const float x = s[m] + bb;
      float p = ex2((CLAMP ? clamp_hi(x) : x) - lt[row]);
      if (USE_VALID) p *= (bb > kValidThreshold) ? 1.f : 0.f;
      p = row_in ? p : 0.f;
      ps[row * PS + j] = p;
      dss[row * PS + j] = p * (dp[m] - dt[row]);
    }
    __syncthreads();

    // key `row`: dV += P^T dO, dK += dS^T q
#pragma unroll 4
    for (int r = 0; r < kT32; ++r) {
      const float pv = ps[r * PS + row], dsv = dss[r * PS + row];
      const float* dr2 = dos + r * RS + part;
      const float* qr2 = qs + r * RS + part;
#pragma unroll
      for (int i = 0; i < C8; ++i) {
        dva[i] = fmaf(pv, dr2[8 * i], dva[i]);
        dka[i] = fmaf(dsv, qr2[8 * i], dka[i]);
      }
    }
    // query `row`: dQ += dS K
    if (row_in) {
      float acc[C8];
#pragma unroll
      for (int i = 0; i < C8; ++i) acc[i] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kT32; ++j) {
        const float d = dss[row * PS + j];
        const float* kr = ks + j * RS + part;
#pragma unroll
        for (int i = 0; i < C8; ++i) acc[i] = fmaf(d, kr[8 * i], acc[i]);
      }
      float* out = dqb + size_t(q0 + row) * C + part;
#pragma unroll
      for (int i = 0; i < C8; ++i) atomicAdd(out + 8 * i, scale * acc[i]);
    }
  }

  const int gk = k0 + row;
  if (gk < lk) {
    float* dkr = dk + (size_t(b) * lk + gk) * C + part;
    float* dvr = dv + (size_t(b) * lk + gk) * C + part;
#pragma unroll
    for (int i = 0; i < C8; ++i) {
      dkr[8 * i] = scale * dka[i];
      dvr[8 * i] = dva[i];
    }
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
  const void *q, *k, *v, *bias, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int b, lq, lk;
  float qmul, scale;
  cudaStream_t stream;
};

template <typename Elem, typename Kernel>
cudaError_t launch(Kernel kernel, std::atomic<uint32_t>& set_on, int keys,
                   int threads, size_t smem, const Args& a) {
  cudaError_t err = allow_smem(kernel, smem, set_on);
  if (err != cudaSuccess) return err;
  dim3 grid((a.lk + keys - 1) / keys, a.b);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const Elem*>(a.q), static_cast<const Elem*>(a.k),
      static_cast<const Elem*>(a.v), static_cast<const float*>(a.bias),
      static_cast<const Elem*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<float*>(a.dq),
      static_cast<Elem*>(a.dk), static_cast<Elem*>(a.dv), a.lq, a.lk, a.qmul,
      a.scale);
  return cudaGetLastError();
}

template <int C, bool UV, bool CL>
cudaError_t run(bool bf16, const Args& a) {
  if (bf16) {
    // C = 64: 8 warps of 16 keys, 64 queries a step. C = 128: 4 warps,
    // 32 queries (dK + dV are 128 f32 registers a thread). C = 256: 4 key
    // groups x 2 channel halves, 32 queries.
    constexpr int BQ = C == 64 ? 64 : 32;
    constexpr int KW = C == 64 ? 8 : 4;
    constexpr int CS = C == 256 ? 2 : 1;
    using T = BwdTile<C, BQ, KW, CS>;
    static std::atomic<uint32_t> bf16_set_on{0};
    return launch<__nv_bfloat16>(&bwd_bf16<C, BQ, KW, CS, UV, CL>,
                                 bf16_set_on, T::BK, T::NT, T::smem, a);
  }
  static std::atomic<uint32_t> f32_set_on{0};
  return launch<float>(&bwd_f32<C, UV, CL>, f32_set_on, kT32, 256,
                       BwdF32Tile<C>::smem, a);
}

template <int C>
cudaError_t run_c(bool bf16, bool use_valid, bool clamp, const Args& a) {
  if (clamp)
    return use_valid ? run<C, true, true>(bf16, a) : run<C, false, true>(bf16, a);
  return use_valid ? run<C, true, false>(bf16, a) : run<C, false, false>(bf16, a);
}

}  // namespace

// q, k, v, dout: [B, Lq|Lk, C] contiguous, all bf16 (is_bf16 = 1) or all
// f32; bias: [B, 1, Lk] f32; lse, delta: [B, 1, Lq] f32; dq: [B, Lq, C] f32,
// zeroed by the caller (the kernel adds to it); dk, dv: [B, Lk, C] in k's
// dtype. C in {64, 128, 256}. `clamp` = 1 clamps s at 60 as the no-max
// forward did; 0 takes exp2(s - lse) as is (the online-max forward's lse).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* bias, const void* dout, const void* lse,
                         const void* delta, void* dq, void* dk, void* dv,
                         int b, int lq, int lk, int c, int is_bf16,
                         int use_valid, int clamp, float qmul, float scale,
                         void* stream) {
  if (b <= 0 || lk <= 0) return int(cudaSuccess);
  const Args a{q, k, v, bias, dout, lse, delta, dq, dk, dv, b, lq, lk,
               qmul, scale, static_cast<cudaStream_t>(stream)};
  const bool bf16 = is_bf16 != 0, uv = use_valid != 0, cl = clamp != 0;
  switch (c) {
    case 64: return int(run_c<64>(bf16, uv, cl, a));
    case 128: return int(run_c<128>(bf16, uv, cl, a));
    case 256: return int(run_c<256>(bf16, uv, cl, a));
    default: return int(cudaErrorInvalidValue);
  }
}
