// No-max attention forward with the mask bias as a 65th channel, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_nomax65_kernel` (tools/softmax_ab.py:
// 157-181, launched at :191 in `nomax65_fwd`), variants D and E of the
// softmax A/B tool. Its inputs carry the bias inside the product: q65 =
// [q * log2e, 1] and k65 = [k, bias], both [B, L, 65] bf16, and v [B, Lk, 64]
// bf16. Per (batch, query row):
//
//   s  = q65 . k65                     f32 accumulation over 65 channels
//   p  = exp2(min(s, 60))              variant D (`clamp` = 1), NaN kept;
//        exp2(s)                       variant E (`clamp` = 0)
//   O  = (p_v . v) / max(l, 1e-30)     p_v = p rounded to bf16, l = sum of the
//                                      f32 p; O in bf16, no lse
//
// What bounds it on an H100: the products (2*B*Lq*Lk*(65 + 64) flops) and the
// B*Lq*Lk exp2, never the bytes. The design is the no-max kernel's
// (flash_fwd_nomax.cu: one block of 8 warps per (batch, 128 queries), mma.sync
// m16n8k16, p kept in registers as P.V's A operand) with two changes for the
// 65-channel rows:
//
//   * a row of q65 or k65 is 130 bytes, so rows are not 16-byte aligned and
//     cp.async's 16-byte copies do not apply. The kernel reads them with
//     2-byte loads (consecutive threads on consecutive elements) into shared
//     rows padded with zeros to 80 channels, five k-steps of 16; the next K
//     tile's loads are issued into registers before this tile's products and
//     stored after them, so they overlap. V's 128-byte rows keep the
//     two-stage cp.async ring;
//   * keys past Lk get p = 0 by a select (the kernel has no bias input).
//
// Entry point: `flash_fwd_nomax65` below (plain C, bound with ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kClamp = 60.0f;  // the tool's clamp
constexpr float kMinL = 1e-30f;
constexpr int kC = 64;           // V's channels
constexpr int kCQK = 65;         // q65 / k65 channels
constexpr int kCP = 80;          // the contraction, zero-padded to 5 x 16
constexpr int kS = kCP + 8;      // q / k shared row stride (elements)
constexpr int kSV = kC + 8;      // v shared row stride
constexpr int kBK = 64;          // keys per tile
constexpr int kWarps = 8;
constexpr int kNT = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // queries per block
// K elements a thread carries from one tile to the next
constexpr int kKReg = (kBK * kCQK + kNT - 1) / kNT;
constexpr size_t kSmem =
    size_t(kBQ * kS + 2 * kBK * kS + 2 * kBK * kSV) * sizeof(__nv_bfloat16);

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

template <bool CLAMP>
__global__ void __launch_bounds__(kNT)
fwd_nomax65(const __nv_bfloat16* __restrict__ q65,
            const __nv_bfloat16* __restrict__ k65,
            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
            int lq, int lk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kBQ * kS;      // [stage][kBK * kS]
  __nv_bfloat16* vs = ks + 2 * kBK * kS;  // [stage][kBK * kSV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kBQ;
  const unsigned short* qb =
      reinterpret_cast<const unsigned short*>(q65) + size_t(b) * lq * kCQK;
  const unsigned short* kb =
      reinterpret_cast<const unsigned short*>(k65) + size_t(b) * lk * kCQK;
  const __nv_bfloat16* vb = v + size_t(b) * lk * kC;
  unsigned short* qsu = reinterpret_cast<unsigned short*>(qs);
  unsigned short* ksu = reinterpret_cast<unsigned short*>(ks);

  // Zero the padding channels 65..79 of Q and of both K stages once; the
  // tile loads write channels 0..64 only.
  for (int idx = tid; idx < (kBQ + 2 * kBK) * (kCP - kCQK); idx += kNT) {
    const int row = idx / (kCP - kCQK), c = kCQK + idx % (kCP - kCQK);
    qsu[row * kS + c] = 0;  // rows past kBQ are the K stages' rows
  }

  unsigned short kreg[kKReg];
  // The K tile at key kt into registers: the tile's rows are one contiguous
  // run of kBK * 65 elements; keys past lk read as 0.
  auto fetch_k = [&](int kt) {
    const unsigned short* src = kb + size_t(kt) * kCQK;
    const int n = (lk - kt < kBK ? lk - kt : kBK) * kCQK;
#pragma unroll
    for (int i = 0; i < kKReg; ++i) {
      const int idx = tid + i * kNT;
      kreg[i] = idx < n ? src[idx] : 0;
    }
  };
  auto store_k = [&](int stage) {
    unsigned short* dst = ksu + stage * kBK * kS;
#pragma unroll
    for (int i = 0; i < kKReg; ++i) {
      const int idx = tid + i * kNT;
      if (idx < kBK * kCQK) dst[(idx / kCQK) * kS + idx % kCQK] = kreg[i];
    }
  };
  auto load_v = [&](int kt, int stage) {
    __nv_bfloat16* dst = vs + stage * kBK * kSV;
    for (int idx = tid; idx < kBK * (kC / 8); idx += kNT) {
      const int row = idx / (kC / 8), c8 = idx % (kC / 8), gk = kt + row;
      const bool in = gk < lk;
      cp_async16(dst + row * kSV + c8 * 8,
                 vb + size_t(in ? gk : 0) * kC + c8 * 8, in);
    }
    cp_async_commit();
  };

  const int ntiles = (lk + kBK - 1) / kBK;
  if (ntiles > 0) {
    load_v(0, 0);
    fetch_k(0);
    store_k(0);
  }
  // Q tile: the block's rows are one contiguous run; rows past lq are 0.
  {
    const int n = (lq - q0 < kBQ ? lq - q0 : kBQ) * kCQK;
    const unsigned short* src = qb + size_t(q0) * kCQK;
    for (int idx = tid; idx < kBQ * kCQK; idx += kNT)
      qsu[(idx / kCQK) * kS + idx % kCQK] = idx < n ? src[idx] : 0;
  }

  float acc[kC / 8][4];
#pragma unroll
  for (int n = 0; n < kC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float l0 = 0.f, l1 = 0.f;

  const __nv_bfloat16* qa = qs + (warp * 16 + (lane & 15)) * kS + (lane >> 4) * 8;
  const int mrow = lane & 7, mhalf = (lane >> 3) & 1, mpair = lane >> 4;

  for (int it = 0; it < ntiles; ++it) {
    const int stage = it & 1, kt = it * kBK;
    const bool more = it + 1 < ntiles;
    if (more) {
      load_v(kt + kBK, stage ^ 1);
      fetch_k(kt + kBK);  // in flight during this tile's products
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this stage's K and V (and, first time, Q) are in
    const __nv_bfloat16* kst = ks + stage * kBK * kS;
    const __nv_bfloat16* vst = vs + stage * kBK * kSV;

    // S = Q65 K65^T over the padded 80 channels.
    float s[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kCP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, qa + kk * 16);
#pragma unroll
      for (int j = 0; j < kBK / 8; j += 2) {
        uint32_t bf[4];
        ldsm_x4(bf, kst + ((j + mpair) * 8 + mrow) * kS + kk * 16 + mhalf * 8);
        mma_bf16(s[j], a, bf[0], bf[1]);
        mma_bf16(s[j + 1], a, bf[2], bf[3]);
      }
    }

    // p = exp2(min(s, 60)) (D) or exp2(s) (E); keys past lk give 0.
    const int nvalid = lk - kt;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(CLAMP ? clamp_hi(s[j][e]) : s[j][e]);
        p = j * 8 + t * 2 + (e & 1) < nvalid ? p : 0.f;
        if (e < 2) l0 += p; else l1 += p;
        s[j][e] = p;
      }
    }

    // O += P V: the score fragments are the A operand (rounded to bf16).
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kC / 8; n += 2) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, vst + (kk * 16 + mhalf * 8 + mrow) * kSV + (n + mpair) * 8);
        mma_bf16(acc[n], a, bf[0], bf[1]);
        mma_bf16(acc[n + 1], a, bf[2], bf[3]);
      }
    }
    // The next tile's K into the other stage: nobody reads it this step.
    if (more) store_k(stage ^ 1);
    __syncthreads();  // the next iteration refills this stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = floor_l(l0), d1 = floor_l(l1);
  const int gr0 = q0 + warp * 16 + g, gr1 = gr0 + 8;
  __nv_bfloat16* ob = o + size_t(b) * lq * kC;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    const int col = n * 8 + t * 2;
    if (gr0 < lq)
      *reinterpret_cast<uint32_t*>(ob + size_t(gr0) * kC + col) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (gr1 < lq)
      *reinterpret_cast<uint32_t*>(ob + size_t(gr1) * kC + col) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
}

// The dynamic shared memory limit is a per-device attribute of each kernel
// instantiation: `set_on` holds one bit per device it was raised on.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<uint32_t>& set_on) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (set_on.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err == cudaSuccess) set_on.fetch_or(bit, std::memory_order_release);
  return err;
}

template <bool CLAMP>
cudaError_t run(const void* q65, const void* k65, const void* v, void* o,
                int b, int lq, int lk, cudaStream_t stream) {
  static std::atomic<uint32_t> set_on{0};
  cudaError_t err = allow_smem(&fwd_nomax65<CLAMP>, set_on);
  if (err != cudaSuccess) return err;
  dim3 grid((lq + kBQ - 1) / kBQ, b);
  fwd_nomax65<CLAMP><<<grid, kNT, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q65),
      static_cast<const __nv_bfloat16*>(k65),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lq, lk);
  return cudaGetLastError();
}

}  // namespace

// q65: [B, Lq, 65], k65: [B, Lk, 65], v: [B, Lk, 64], o: [B, Lq, 64], all
// bf16 and contiguous (q65 and k65 need only 2-byte alignment; v and o 16
// bytes). `clamp` = 1 is variant D, 0 variant E. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int flash_fwd_nomax65(const void* q65, const void* k65,
                                 const void* v, void* o, int b, int lq,
                                 int lk, int clamp, void* stream) {
  if (b <= 0 || lq <= 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return clamp ? int(run<true>(q65, k65, v, o, b, lq, lk, st))
               : int(run<false>(q65, k65, v, o, b, lq, lk, st));
}
