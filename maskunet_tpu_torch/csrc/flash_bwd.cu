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
// What bounds it on an H100: operations. Five products of 2*B*Lq*Lk*C
// flops each over the visible keys, 10*B*Lq*Lk_visible*C in all, at the
// 989 TF/s bf16 tensor-core peak (attn6 at batch 8, ~8,192 visible keys a
// row: ~0.69 TFLOP, ~0.69 ms), and B*Lq*Lk_visible exp2 on the special
// function units (16 a clock an SM: ~0.32 ms at attn6); the bytes (q, k,
// v, dO, lse, delta once each, dQ in f32, dK, dV) take ~0.04 ms. Nothing of
// size Lq x Lk leaves the SM.
//
// Design (not the TPU's): the TPU kernel runs a (B, nK, nQ) grid, carries
// dK/dV in VMEM across a sequential sweep over query blocks and streams f32
// dQ partials per key block to a [B, nK, Lq, C] buffer that XLA sums; with
// small key tiles that buffer would be gigabytes here. Instead one thread
// block owns one (batch, key tile): it loads its K and V tile once, keeps
// the f32 dK and dV accumulators in registers, sweeps over every query tile
// and writes dK and dV once. Each block starts its sweep at its own query
// tile, so blocks running together add dQ to different rows. Two bodies:
//
// bf16 at C = 64 and 128 (`bwd_wgmma`; the training step's attn1, attn4,
// attn5 and attn6): Hopper's warpgroup products, so that the five products
// can run at the tensor cores' full rate, fed by TMA and mbarriers, with dQ
// leaving by bulk reduction, so that neither address arithmetic nor
// per-element atomics take the SM's issue slots from the softmax.
//
//   * Each warpgroup (4 warps) owns 64 keys; a block holds three of them at
//     C = 64 (BK = 192 keys: 2.9 waves of blocks at attn6 against 4.4 with
//     128, and 12 warps an SM to hide each other's waits) and two at C =
//     128 (shared memory), and sweeps 64 queries a step. Per step and
//     warpgroup, all m64n64k16 wgmma:
//       S^T  = K (q*qmul)^T   A = K tile, B = q*qmul tile, both K-major
//       dP^T = V dO^T         A = V tile, B = dO tile, both K-major
//       dV  += P^T dO         A = P^T from the accumulator registers
//       dK  += dS^T q         A = dS^T likewise; B = dO / raw q, MN-major
//                             (the transpose bit, which bf16 allows)
//       dQ   = dS K           A = dS^T in shared memory read transposed,
//                             B = the K tile read transposed (M = queries)
//     C = 128 runs dV, dK and dQ as two 64-channel products each. Every
//     tile is in the 128-byte swizzle both TMA and the wgmma descriptors
//     name, as 64-channel regions of one 128-byte line a row.
//   * Thread 0 streams q and dO (3-D TMA, box 64 x 64 a region) through a
//     ring of mbarrier-tracked stages (three at C = 64, two at C = 128);
//     each warpgroup's warps release a stage on an `empty` mbarrier once
//     their products have read it, and thread 0 then refills it. lse and
//     delta (64 values a step) come by plain loads issued at the top of the
//     step, so they land while it waits for its tiles: a bulk or TMA copy
//     needs a 16-byte-aligned start, which B * Lq rows of 4 bytes deny when
//     Lq % 4 != 0 (a 1-D map faulted on the card at Lq = 37). No
//     block-wide __syncthreads in the sweep: a warpgroup syncs its own 128
//     threads twice a step (named barriers 1-3), a warp its dQ rows.
//   * q*qmul is formed in the kernel, each warpgroup converting the
//     stage's raw q tile into its own swizzled buffer (same byte offsets:
//     the scaling is elementwise) with bf16x2 multiplies, rounded to bf16
//     as the forward rounds it. Chosen over a pre-scaled copy from the
//     wrapper: that copy would cost an elementwise pass and a third
//     streamed tile (a third more bytes through L2 each step), while the
//     pass here is 4 16-byte loads, multiplies and stores a thread and
//     region, and the C entry point keeps its arguments.
//   * dQ: each warp's 16 x 64 f32 rows (scale folded in) go to shared
//     memory once a step and 64 channels, and are added to the [B, Lq, C]
//     f32 buffer the wrapper zeroes by two `cp.reduce.async.bulk.tensor`
//     adds (one per 32-channel half, 128-byte swizzled to spare banks), not
//     by per-element atomics. The adds' order, and so dQ's last bits, still
//     change from run to run.
//   * Not done: warp specialisation. Each warpgroup runs its products, its
//     softmax and its stores one after another; only the block's other
//     warpgroups (and thread 0's loads) overlap them.
//   * Traps named and avoided. TMA over [B, L, C] uses 3-D maps (C, L, B):
//     a 2-D map over B*L rows would read the next batch's rows at a ragged
//     edge where a 3-D one fills zeros. The dQ reduce uses the same 3-D
//     form, which clips rows past Lq (a plain bulk add of the last tile
//     would write into the next batch row or past the buffer). Rows past
//     Lq read lse = +inf and delta = 0, so their p and dS are 0. The maps
//     reach the kernel as __grid_constant__ parameters, encoded through
//     cudaGetDriverEntryPoint (no -lcuda).
//
// bf16 at C = 256 (`bwd_bf16`, and C = 64 and 128 in the A/B tool's
// `mma_sync` variant): the first design, mma.sync m16n8k16. Each warp owns
// 16 keys; q, dO, lse and delta stream through a two-stage cp.async ring;
// P^T and dS^T stay in registers as the A operands of dV and dK; dS^T goes
// to shared memory for dQ = dS K, added with float2 f32 atomicAdd. At C =
// 256 two warps share each 16 keys, one channel half each. (At C = 256 the
// wgmma body's dK and dV alone would be 256 f32 registers a thread.)
//
// f32 (`bwd_f32`): exact f32 (no TF32) on plain FMA, 32x32 tiles through
// shared memory, the same atomics for dQ.
//
// Any Lq and Lk: keys past Lk are zero-filled with bias -inf (p = 0) and not
// stored; query rows past Lq get p = 0 and are not stored.
// Entry point: `flash_bwd` below (plain C, bound with ctypes).

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
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
// bf16 at C = 64: warpgroup products (wgmma) fed by TMA, mbarrier ring,
// dQ by bulk tensor reduction. See the header for the design.
// ---------------------------------------------------------------------------

// C values whose bf16 backward runs `bwd_wgmma`; the others run `bwd_bf16`.
constexpr bool wgmma_body(int c) { return c == 64 || c == 128; }

constexpr int kBQ = 64;           // queries a step
constexpr int kWarpgroups = 3;    // warpgroups (64 keys each) a block, C 64
constexpr int kStages = 3;        // depth of the q / dO ring, C 64
constexpr int kTile = 64 * 128;   // 64 rows of one 128-byte line

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
// (wgmma operands, TMA stores and reductions).
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

// Adds a shared-memory tile to global memory through `map`, in f32; box
// elements outside the tensor are dropped.
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  const void* src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
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

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// wgmma descriptor of a 128-byte-swizzled tile at `p` (the swizzle TMA
// writes): 8 rows of 128 bytes a 1024-byte group, groups 1024 bytes apart
// (the stride offset, along M/N for a K-major operand and along K for an
// MN-major one). The leading offset is unused by these layouts: a K-major
// k-step stays inside its 128-byte line (the start moves 32 bytes) and an
// MN-major operand is one 64-element line wide.
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

// Waits until this warpgroup's products have completed.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, m64n64k16, bf16 in, f32 out, A and B in shared memory; TA /
// TB = 1 reads the operand MN-major (transposed). `accumulate` = 0
// overwrites d.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// d += A B, m64n64k16, A (64 x 16) from registers in the fragment layout
// of the accumulator (`acc_to_a`), B in shared memory, MN-major when TB.
template <int TB>
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
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1), "n"(TB));
}

// Adds 64 channels (c0 ..) of one step's dQ (scale folded in) to dq, a
// [B, Lq, ldc] f32 buffer: this warp's 16 rows (r0, r0 + 8 of the
// accumulator) go to its rows of the two 64 x 32 f32 staging halves at
// `dqw` (128-byte swizzled), and lane 0 adds each half with one bulk
// tensor reduction, box (32, 16, 1); the map drops rows past lq. No
// warpgroup barrier: a warp waits only for its own last add. (dq, lq,
// ldc: the A/B tool's atomics variant.)
__device__ __forceinline__ void add_dq(const CUtensorMap* tdq,
                                       unsigned char* dqw, float* dq,
                                       const float (&dqa)[32], float scale,
                                       int b, int lq, int ldc, int q0, int c0,
                                       int r0, int sw, int tq4, int lane) {
  if (lane == 0) bulk_wait_read();  // this warp's last add read its rows
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    unsigned char* half = dqw + (j >> 2) * kTile;
    const int c16 = 2 * (j & 3) + (tq4 >> 1);  // 16-byte chunk
    const int off = ((c16 ^ sw) << 4) + 8 * (tq4 & 1);
    *reinterpret_cast<float2*>(half + r0 * 128 + off) =
        make_float2(scale * dqa[4 * j], scale * dqa[4 * j + 1]);
    *reinterpret_cast<float2*>(half + (r0 + 8) * 128 + off) =
        make_float2(scale * dqa[4 * j + 2], scale * dqa[4 * j + 3]);
  }
  fence_async_smem();
  __syncwarp();
  if (lane == 0) {
    const int w16 = r0 - (r0 & 15);  // this warp's first row
    tma_reduce_add_3d(tdq, dqw + w16 * 128, c0, q0 + w16, b);
    tma_reduce_add_3d(tdq, dqw + kTile + w16 * 128, c0 + 32, q0 + w16, b);
    bulk_commit();
  }
}

// Shared memory of a block: byte offsets from a 1024-byte-aligned base.
// A [rows][C] bf16 tile is H = C / 64 regions of [rows][64 channels], one
// 128-byte line a row (the widest line TMA's 128-byte swizzle takes).
template <int C, int WGS, int NS>
struct WgTile {
  static constexpr int H = C / 64;                    // regions a row
  static constexpr int BK = 64 * WGS;                 // keys a block
  static constexpr int KT = BK * 128;                 // a region of K or V
  static constexpr int K = 0;                         // K tile [H][BK]
  static constexpr int V = K + H * KT;                // V tile [H][BK]
  static constexpr int Q = V + H * KT;                // [NS][H] raw q
  static constexpr int DO = Q + NS * H * kTile;       // [NS][H] dO
  static constexpr int QS = DO + NS * H * kTile;      // [WGS][H] q * qmul
  static constexpr int DS = QS + WGS * H * kTile;     // [WGS] dS^T [key][query]
  static constexpr int DQ = DS + WGS * kTile;         // [WGS] dQ f32, 2 halves
  static constexpr int LSE = DQ + WGS * 2 * kTile;    // [WGS][kBQ] f32
  static constexpr int DEL = LSE + WGS * kBQ * 4;     // [WGS][kBQ] f32
  static constexpr int BIAS = DEL + WGS * kBQ * 4;    // [BK] f32
  static constexpr int BAR = BIAS + BK * 4;           // full[NS], empty[NS], kv
  static constexpr size_t smem = size_t(BAR + (2 * NS + 1) * 8) + 1024;
  static constexpr uint32_t stage_bytes = 2 * H * kTile;
  static_assert(smem <= 232448, "shared memory of one block");
};

// One block: batch row blockIdx.y, keys blockIdx.x * BK ..; warpgroup wg
// owns keys wg * 64 .. wg * 64 + 63 of the tile. q, k, v, dO: 3-D maps (C,
// L, B), box (64, 64 or BK, 1), 128-byte swizzle; dq: 3-D f32 map (C, Lq,
// B), box (32, 16, 1), 128-byte swizzle. `dq` itself is the A/B tool's
// atomics variant's.
template <int C, int WGS, int NS, bool USE_VALID, bool CLAMP>
__global__ void __launch_bounds__(128 * WGS, WGS == 1 ? 2 : 1)
bwd_wgmma(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tdq,
          const float* __restrict__ bias, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq,
          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
          int lq, int lk, float qmul, float scale) {
  using T = WgTile<C, WGS, NS>;
  constexpr int H = T::H;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + T::BAR);
  uint64_t* empty = full + NS;
  uint64_t* kvbar = empty + NS;
  float* bs = reinterpret_cast<float*>(sm + T::BIAS);

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int lane = tid & 31, g = lane >> 2, tq4 = lane & 3;
  const int r0 = 16 * (t >> 5) + g;  // accumulator rows r0, r0 + 8
  const int sw = r0 & 7;             // their 128-byte swizzle phase
  const int b = blockIdx.y, k0 = blockIdx.x * T::BK;
  const int nq = (lq + kBQ - 1) / kBQ;
  const int first = nq > 0 ? int(blockIdx.x % nq) : 0;
  auto tile_q0 = [&](int it) { return ((first + it) % nq) * kBQ; };
  auto load_stage = [&](int it) {  // thread 0
    const int s = it % NS, q0 = tile_q0(it);
    bar_expect_tx(&full[s], T::stage_bytes);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      tma_load_3d(sm + T::Q + (s * H + h) * kTile, &tq, &full[s], 64 * h, q0,
                  b);
      tma_load_3d(sm + T::DO + (s * H + h) * kTile, &tdo, &full[s], 64 * h,
                  q0, b);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * WGS);  // one arrival a consumer warp
    }
    bar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < T::BK; i += 128 * WGS) {
    const int gk = k0 + i;
    bs[i] = gk < lk ? bias[size_t(b) * lk + gk] : __int_as_float(0xff800000);
  }
  __syncthreads();
  if (tid == 0) {  // K, V once; the first NS query tiles
    bar_expect_tx(kvbar, 2 * H * T::KT);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      tma_load_3d(sm + T::K + h * T::KT, &tk, kvbar, 64 * h, k0, b);
      tma_load_3d(sm + T::V + h * T::KT, &tv, kvbar, 64 * h, k0, b);
    }
    for (int it = 0; it < NS && it < nq; ++it) load_stage(it);
  }

  // this warpgroup's 64 keys in region h of K / V: kw + h * KT
  unsigned char* kw = sm + T::K + wg * kTile;
  unsigned char* vw = sm + T::V + wg * kTile;
  unsigned char* qsw = sm + T::QS + wg * H * kTile;
  unsigned char* dsw = sm + T::DS + wg * kTile;
  unsigned char* dqw = sm + T::DQ + wg * 2 * kTile;
  float* lt = reinterpret_cast<float*>(sm + T::LSE) + wg * kBQ;
  float* dt = reinterpret_cast<float*>(sm + T::DEL) + wg * kBQ;
  // lse (threads 0-63) or delta (64-127) of query t % 64 of each step
  const float* ld = (t < 64 ? lse : delta) + size_t(b) * lq;
  float* ldw = (t < 64 ? lt : dt) + (t & 63);
  const int bar_id = 1 + wg;
  const __nv_bfloat162 qm2 = __float2bfloat162_rn(qmul);
  const float bb0 = bs[wg * 64 + r0], bb1 = bs[wg * 64 + r0 + 8];

  float dka[H][32], dva[H][32];
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[h][i] = dva[h][i] = 0.f;
  bar_wait(kvbar, 0);

  for (int it = 0; it < nq; ++it) {
    const int s = it % NS, q0 = tile_q0(it);
    const unsigned char* qt = sm + T::Q + s * H * kTile;
    const unsigned char* dot = sm + T::DO + s * H * kTile;
    // lse and delta by plain loads, issued first so that they land while
    // the step waits for its tiles (a bulk or TMA copy needs a 16-byte-
    // aligned start, which Lq % 4 != 0 denies: the card faults). Rows
    // past lq get lse = +inf and delta = 0, so their p and dS are 0.
    const int qi = q0 + (t & 63);
    const float lde = qi < lq ? ld[qi] : (t < 64 ? __int_as_float(0x7f800000)
                                                 : 0.f);
    bar_wait(&full[s], (it / NS) & 1);

    // q * qmul rounded to bf16, as the forward's Q load rounds it, at the
    // same (swizzled) byte offsets: the scaling is elementwise. qmul is a
    // bf16 value (the wrapper rounds it so), and the product of two bf16
    // is exact in f32, so one bf16x2 multiply rounds as f32-then-bf16 does
#pragma unroll
    for (int i = t; i < H * kTile / 16; i += 128) {
      uint4 raw = reinterpret_cast<const uint4*>(qt)[i];
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) h2[e] = __hmul2(h2[e], qm2);
      reinterpret_cast<uint4*>(qsw)[i] = raw;
    }
    *ldw = lde;  // every reader of the last step's is past its sync (2)
    fence_async_smem();
    wg_sync(bar_id);  // (1)

    // S^T = K (q*qmul)^T and dP^T = V dO^T: 64 keys x 64 queries each; a
    // k-step is 16 channels, 32 bytes along a region's line
    float st[32], dpt[32];
    fence_acc(st);
    fence_acc(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const int o = (kk >> 2) * kTile + 32 * (kk & 3);
      wgmma_ss<0, 0>(st, sw128_desc(kw + (kk >> 2) * T::KT + 32 * (kk & 3)),
                     sw128_desc(qsw + o), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const int o = (kk >> 2) * kTile + 32 * (kk & 3);
      wgmma_ss<0, 0>(dpt, sw128_desc(vw + (kk >> 2) * T::KT + 32 * (kk & 3)),
                     sw128_desc(dot + o), kk > 0);
    }
    wgmma_commit();
    wgmma_wait();
    fence_acc(st);
    fence_acc(dpt);

    // P^T = exp2(min(s + bias, 60) - lse) [* valid], dS^T = P^T (dP^T -
    // delta). pa / da: P^T and dS^T as bf16 A fragments
    uint32_t pa[16], da[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tq4;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dt + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bb = e < 2 ? bb0 : bb1;
        const float x = st[4 * j + e] + bb;
        float p = ex2((CLAMP ? clamp_hi(x) : x) - ((e & 1) ? l2.y : l2.x));
        if (USE_VALID) p *= (bb > kValidThreshold) ? 1.f : 0.f;
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      pa[2 * j] = pack_bf16(st[4 * j], st[4 * j + 1]);
      pa[2 * j + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
      da[2 * j] = pack_bf16(dpt[4 * j], dpt[4 * j + 1]);
      da[2 * j + 1] = pack_bf16(dpt[4 * j + 2], dpt[4 * j + 3]);
    }

    // dV += P^T dO and dK += dS^T q (raw q), 64 channels a product; B
    // read MN-major, 16 queries (2048 bytes) a k-step
#pragma unroll
    for (int h = 0; h < H; ++h) {
      fence_acc(dva[h]);
      fence_acc(dka[h]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma_rs<1>(dva[h], pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                    pa[4 * kk + 3], sw128_desc(dot + h * kTile + 2048 * kk));
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
      for (int h = 0; h < H; ++h)
        wgmma_rs<1>(dka[h], da[4 * kk], da[4 * kk + 1], da[4 * kk + 2],
                    da[4 * kk + 3], sw128_desc(qt + h * kTile + 2048 * kk));
    wgmma_commit();

    // dS^T (bf16) to this warpgroup's swizzled [key][query] tile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int off = ((j ^ sw) << 4) + 4 * tq4;
      *reinterpret_cast<uint32_t*>(dsw + r0 * 128 + off) = da[2 * j];
      *reinterpret_cast<uint32_t*>(dsw + (r0 + 8) * 128 + off) = da[2 * j + 1];
    }
    fence_async_smem();
    wg_sync(bar_id);  // (2)

    // dQ = dS K over this warpgroup's 64 keys, 64 channels at a time: A =
    // dS^T read transposed, B = the K region read transposed, 16 keys
    // (2048 bytes) a k-step
#pragma unroll
    for (int h = 0; h < H; ++h) {
      float dqa[32];
      fence_acc(dqa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 64 / 16; ++kk)
        wgmma_ss<1, 1>(dqa, sw128_desc(dsw + 2048 * kk),
                       sw128_desc(kw + h * T::KT + 2048 * kk), kk > 0);
      wgmma_commit();
      wgmma_wait();  // (first time: dV and dK too)
      fence_acc(dqa);
      if (h == 0) {
#pragma unroll
        for (int h2 = 0; h2 < H; ++h2) {
          fence_acc(dva[h2]);
          fence_acc(dka[h2]);
        }
        if (lane == 0) bar_arrive(&empty[s]);  // this warp is done with s
      }
      add_dq(&tdq, dqw, dq, dqa, scale, b, lq, C, q0, 64 * h, r0, sw, tq4,
             lane);
    }

    if (tid == 0 && it + NS < nq) {  // refill stage s once every warp left it
      bar_wait(&empty[s], (it / NS) & 1);
      load_stage(it + NS);
    }
  }
  if (lane == 0) bulk_wait();

  const int gk0 = k0 + wg * 64 + r0, gk1 = gk0 + 8;
  __nv_bfloat16* dkb = dk + size_t(b) * lk * C;
  __nv_bfloat16* dvb = dv + size_t(b) * lk * C;
#pragma unroll
  for (int h = 0; h < H; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * h + 8 * j + 2 * tq4;
      if (gk0 < lk) {
        *reinterpret_cast<uint32_t*>(dkb + size_t(gk0) * C + col) =
            pack_bf16(scale * dka[h][4 * j], scale * dka[h][4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dvb + size_t(gk0) * C + col) =
            pack_bf16(dva[h][4 * j], dva[h][4 * j + 1]);
      }
      if (gk1 < lk) {
        *reinterpret_cast<uint32_t*>(dkb + size_t(gk1) * C + col) =
            pack_bf16(scale * dka[h][4 * j + 2], scale * dka[h][4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dvb + size_t(gk1) * C + col) =
            pack_bf16(dva[h][4 * j + 2], dva[h][4 * j + 3]);
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

// 3-D map (C, L, B) of a contiguous [B, L, C] tensor, box (box_c, box_l,
// 1): a box reaching past L reads zeros there (and a reduction drops those
// rows) instead of running into the next batch row.
bool map_3d(EncodeTiled enc, CUtensorMap* m, const void* base, bool f32,
            int c, int l, int b, int box_c, int box_l) {
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dims[3] = {cuuint64_t(c), cuuint64_t(l), cuuint64_t(b)};
  const cuuint64_t strides[2] = {c * e, cuuint64_t(l) * c * e};
  const cuuint32_t box[3] = {cuuint32_t(box_c), cuuint32_t(box_l), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(base), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// C = 128 takes two warpgroups and two stages: a third stage would pass
// 227 KB of shared memory.
template <int C, bool UV, bool CL>
cudaError_t run_wgmma(const Args& a) {
  constexpr int WGS = C == 64 ? kWarpgroups : 2;
  constexpr int NS = C == 64 ? kStages : 2;
  using T = WgTile<C, WGS, NS>;
  auto kernel = &bwd_wgmma<C, WGS, NS, UV, CL>;
  static std::atomic<uint32_t> set_on{0};
  cudaError_t err = allow_smem(kernel, T::smem, set_on);
  if (err != cudaSuccess) return err;
  const size_t kv_bytes = size_t(a.b) * a.lk * C * sizeof(__nv_bfloat16);
  if (a.lq == 0) {  // no query: dK = dV = 0 (a map cannot have length 0)
    err = cudaMemsetAsync(a.dk, 0, kv_bytes, a.stream);
    return err != cudaSuccess ? err
                              : cudaMemsetAsync(a.dv, 0, kv_bytes, a.stream);
  }
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mdo, mdq;
  const bool ok =
      map_3d(enc, &mq, a.q, false, C, a.lq, a.b, 64, kBQ) &&
      map_3d(enc, &mk, a.k, false, C, a.lk, a.b, 64, T::BK) &&
      map_3d(enc, &mv, a.v, false, C, a.lk, a.b, 64, T::BK) &&
      map_3d(enc, &mdo, a.dout, false, C, a.lq, a.b, 64, kBQ) &&
      map_3d(enc, &mdq, a.dq, true, C, a.lq, a.b, 32, 16);
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid((a.lk + T::BK - 1) / T::BK, a.b);
  kernel<<<grid, 128 * WGS, T::smem, a.stream>>>(
      mq, mk, mv, mdo, mdq, static_cast<const float*>(a.bias),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.lq, a.lk, a.qmul, a.scale);
  return cudaGetLastError();
}

template <int C, bool UV, bool CL>
cudaError_t run(bool bf16, const Args& a) {
  if constexpr (wgmma_body(C)) {
    if (bf16) return run_wgmma<C, UV, CL>(a);
  }
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

// Which body `flash_bwd` runs for bf16 at C channels: 2 = wgmma
// (`bwd_wgmma`), 1 = mma.sync (`bwd_bf16`), 0 = no kernel for that C.
extern "C" int flash_bwd_body(int c) {
  if (c != 64 && c != 128 && c != 256) return 0;
  return wgmma_body(c) ? 2 : 1;
}
