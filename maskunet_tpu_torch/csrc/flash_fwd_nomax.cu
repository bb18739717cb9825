// Masked attention forward without an online max, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fwd_kernel_nomax` (maskunet_tpu/ops/
// flash_attention.py:164-218) in both its launches: `with_lse=False`
// (:247-261, every `flash_mha` primal: serving and the eval step) through
// the entry point `flash_fwd_nomax`, and `with_lse=True` (:267-284, the
// training forward of `flash_mha`'s custom VJP) through
// `flash_fwd_nomax_lse`, which also writes lse2 = log2(max(l, 1e-30)) per
// query row for the backward kernel (flash_bwd.cu). Per (batch, query row):
//
//   s2 = (q * qmul) . k^T              qmul = scale*log2e, q*qmul rounded to
//                                      q's dtype (JAX weak typing)
//   p  = exp2(min(s2 + bias, 60))      NaN-propagating min; bias in {0,-1e30}
//   p *= (bias > -5e29)                only with use_valid (a multiply, as
//                                      the TPU kernel does, so NaN survives)
//   O  = (p_v . v) / max(sum p, 1e-30) p_v = p rounded to v's dtype, the sum
//                                      is over the f32 p; NaN-propagating max
//
// What bounds it on an H100: at the serving shapes the two matrix products
// are 4*B*Lq*Lk*C flops (309 GFLOP at attn6, ~0.31 ms at the 989 TF/s bf16
// tensor-core peak) and the B*Lq*Lk exp2 take about as long on the special
// function units; the bytes (q, k, v, o once each) are ~16 us. So it is
// bound by operations, never by memory, and the design keeps everything of
// size Lq x Lk on chip:
//
//   * one thread block owns one (batch, query tile) and loops over all key
//     tiles, holding the f32 O accumulator and the row sums l in registers;
//     O is written once;
//   * bf16 inputs use tensor cores through mma.sync m16n8k16 (16 query rows
//     a warp; 8 warps at C = 64, 4 above); K and V tiles stream through a
//     two-stage cp.async ring, so the next tile's loads overlap this tile's
//     products, and ldmatrix reads them (.trans gives V's B operand without
//     a transposing copy); the score fragments are reused in registers as
//     the A operand of P.V, so p never touches shared or device memory;
//   * f32 inputs stay exact f32 (no TF32) on plain FMA, 64x32 tiles;
//   * ragged Lq / Lk are masked in the kernel (keys past Lk are zero-filled
//     and get p = 0), so any length works.
//
// No TMA or wgmma yet: those come with the kernel's tuning.
// Entry points: `flash_fwd_nomax` and `flash_fwd_nomax_lse` below (plain C,
// bound with ctypes). The lse output costs one f32 store per query row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kValidThreshold = -5e29f;  // NEG_INF * 0.5
constexpr float kClamp = 60.0f;            // _NOMAX_CLAMP
constexpr float kMinL = 1e-30f;
constexpr int kBQ = 64;                    // query rows per f32 block

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// min(x, 60) that keeps NaN (fminf(NaN, 60) would return 60).
__device__ __forceinline__ float clamp_hi(float x) {
  return x > kClamp ? kClamp : x;
}

// max(l, 1e-30) that keeps NaN.
__device__ __forceinline__ float floor_l(float l) {
  return l < kMinL ? kMinL : l;
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

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), WARPS warps each owning 16 query
// rows. K and V tiles stream through a two-stage cp.async ring in their
// [key][channel] layout; ldmatrix feeds the products (.trans for V).
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

template <int C, int BK, int WARPS, bool USE_VALID>
__global__ void __launch_bounds__(32 * WARPS)
fwd_nomax_bf16(const __nv_bfloat16* __restrict__ q,
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

  // Keys past lk are zero-filled with bias -inf, so their p is exactly 0.
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

  // Q tile, pre-multiplied by qmul and rounded to bf16 like the TPU kernel.
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

    // p = exp2(min(s + bias, 60)) [* valid].
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bb = bt[j * 8 + t * 2 + (e & 1)];
        float p = ex2(clamp_hi(s[j][e] + bb));
        if (USE_VALID) p *= (bb > kValidThreshold) ? 1.f : 0.f;
        if (e < 2) l0 += p; else l1 += p;
        s[j][e] = p;
      }
    }

    // O += P V: the score fragments are the A operand (rounded to bf16).
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
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
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = floor_l(l0), d1 = floor_l(l1);
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
  if (lse != nullptr && t == 0) {  // lse2 = log2(max(l, 1e-30)), NaN kept
    float* lb = lse + size_t(b) * lq;
    if (gr0 < lq) lb[gr0] = log2f(d0);
    if (gr1 < lq) lb[gr1] = log2f(d1);
  }
}

// ---------------------------------------------------------------------------
// f32: exact f32 on FMA. 256 threads = 64 rows x 4 parts; a part scores 8 of
// the tile's 32 keys and owns every 4th output channel.
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
fwd_nomax_f32(const float* __restrict__ q, const float* __restrict__ k,
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
  float l = 0.f;

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
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = part * 8 + i;
      const float bb = bs[col];
      float p = ex2(clamp_hi(s[i] + bb));
      if (USE_VALID) p *= (bb > kValidThreshold) ? 1.f : 0.f;
      p = in_range[col] ? p : 0.f;
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

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  const float d = floor_l(l);
  const int gr = q0 + row;
  if (gr < lq) {
    float* orow = o + (size_t(b) * lq + gr) * C + part;
#pragma unroll
    for (int i = 0; i < C4; ++i) orow[4 * i] = acc[i] / d;
    if (lse != nullptr && part == 0) lse[size_t(b) * lq + gr] = log2f(d);
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

template <typename Kernel, typename Elem>
cudaError_t launch(Kernel kernel, std::atomic<uint32_t>& set_on, int rows,
                   int threads, size_t smem, const void* q, const void* k,
                   const void* v, const void* bias, void* o, float* lse,
                   int b, int lq, int lk, float qmul, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem, set_on);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + rows - 1) / rows, b);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const Elem*>(q), static_cast<const Elem*>(k),
      static_cast<const Elem*>(v), static_cast<const float*>(bias),
      static_cast<Elem*>(o), lse, lq, lk, qmul);
  return cudaGetLastError();
}

template <int C, bool UV>
cudaError_t run(bool bf16, const void* q, const void* k, const void* v,
                const void* bias, void* o, float* lse, int b, int lq, int lk,
                float qmul, cudaStream_t stream) {
  if (bf16) {
    // 128 f32 accumulators a thread at C = 256: halve the key tile there.
    // At C = 64 a block takes 128 queries, which halves the K/V reads
    // from L2 (the long attn5/attn6 layers still fill the card).
    constexpr int BK = C >= 256 ? 32 : 64;
    constexpr int WARPS = C == 64 ? 8 : 4;
    using T = Bf16Tile<C, BK, WARPS>;
    static std::atomic<uint32_t> bf16_set_on{0};
    return launch<decltype(&fwd_nomax_bf16<C, BK, WARPS, UV>), __nv_bfloat16>(
        &fwd_nomax_bf16<C, BK, WARPS, UV>, bf16_set_on, T::BQ, 32 * WARPS,
        T::smem, q, k, v, bias, o, lse, b, lq, lk, qmul, stream);
  }
  static std::atomic<uint32_t> f32_set_on{0};
  return launch<decltype(&fwd_nomax_f32<C, UV>), float>(
      &fwd_nomax_f32<C, UV>, f32_set_on, kBQ, 256, F32Tile<C>::smem, q, k, v,
      bias, o, lse, b, lq, lk, qmul, stream);
}

template <int C>
cudaError_t run_c(bool bf16, bool use_valid, const void* q, const void* k,
                  const void* v, const void* bias, void* o, float* lse, int b,
                  int lq, int lk, float qmul, cudaStream_t stream) {
  return use_valid ? run<C, true>(bf16, q, k, v, bias, o, lse, b, lq, lk,
                                  qmul, stream)
                   : run<C, false>(bf16, q, k, v, bias, o, lse, b, lq, lk,
                                   qmul, stream);
}

int dispatch(const void* q, const void* k, const void* v, const void* bias,
             void* o, float* lse, int b, int lq, int lk, int c, int is_bf16,
             int use_valid, float qmul, void* stream) {
  if (b <= 0 || lq <= 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = is_bf16 != 0, uv = use_valid != 0;
  switch (c) {
    case 64: return int(run_c<64>(bf16, uv, q, k, v, bias, o, lse, b, lq, lk, qmul, st));
    case 128: return int(run_c<128>(bf16, uv, q, k, v, bias, o, lse, b, lq, lk, qmul, st));
    case 256: return int(run_c<256>(bf16, uv, q, k, v, bias, o, lse, b, lq, lk, qmul, st));
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v: [B, Lq|Lk, C] contiguous, all bf16 (is_bf16 = 1) or all f32;
// bias: [B, 1, Lk] f32; o: [B, Lq, C] in q's dtype. C in {64, 128, 256}.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_fwd_nomax(const void* q, const void* k, const void* v,
                               const void* bias, void* o, int b, int lq,
                               int lk, int c, int is_bf16, int use_valid,
                               float qmul, void* stream) {
  return dispatch(q, k, v, bias, o, nullptr, b, lq, lk, c, is_bf16,
                  use_valid, qmul, stream);
}

// As `flash_fwd_nomax`, and lse: [B, 1, Lq] f32, log2(max(l, 1e-30)) of
// each query row (the row sum l of the unnormalised p).
extern "C" int flash_fwd_nomax_lse(const void* q, const void* k,
                                   const void* v, const void* bias, void* o,
                                   void* lse, int b, int lq, int lk, int c,
                                   int is_bf16, int use_valid, float qmul,
                                   void* stream) {
  return dispatch(q, k, v, bias, o, static_cast<float*>(lse), b, lq, lk, c,
                  is_bf16, use_valid, qmul, stream);
}
