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
// function units (16 a clock an SM: ~0.29 ms); the add, clamp, row sum and
// bf16 pack are ~0.15 ms more of ALU issue. The bytes (q, k, v, o once
// each) are ~16 us. So it is bound by operations, never by memory, and
// every design keeps everything of size Lq x Lk on chip: one thread block
// owns one (batch, query tile) and loops over all key tiles, holding the
// f32 O accumulator and the row sums l in registers; O is written once;
// the score fragments become the A operand of P.V in registers, so p never
// touches shared or device memory. Three bodies:
//
// bf16 (`fwd_nomax_wgmma`; all six attention layers of the model):
// Hopper's warpgroup products, so that both products can run at the
// tensor cores' full rate, fed by TMA and mbarriers, with no block-wide
// barrier in the sweep.
//
//   * Each consumer warpgroup (4 warps) owns 64 queries; a block holds two
//     (128 queries; one at C = 256) and a producer warpgroup. Per step of
//     BK keys (128 at C = 64, 64 above) and consumer warpgroup:
//       S  = (q*qmul) K^T   wgmma m64n128k16 (m64n64k16 at C >= 128), A =
//                           the q tile, B = the K tile, both K-major from
//                           shared memory
//       O += P V            wgmma m64n64k16, A = P packed to bf16 straight
//                           from the S accumulator registers, B = the V
//                           tile read MN-major (the transpose bit), one
//                           product per 64 channels
//     S and O stay f32 in registers (64 + 32 a thread at C = 64, 32 + 64
//     at C = 128, 32 + 128 at C = 256), so the softmax runs on the S
//     registers.
//   * Warp specialisation. One thread of the producer warpgroup streams K
//     and V (3-D maps, box 64 channels x BK keys a region) through a ring
//     of mbarrier-tracked stages (four, three at C = 256: shared memory);
//     each consumer warp releases a stage on an `empty` mbarrier once its
//     products have read it. K and V are read once a block, not once a
//     warp. The producer gives up registers (`setmaxnreg` 24) to the
//     consumers (240), though ptxas still allocates each thread at most
//     65536 / threads (168 with two consumer warpgroups). The q tile comes
//     once by TMA and is scaled in place. Every tile is in the 128-byte
//     swizzle both TMA and the wgmma descriptors name, as 64-channel
//     regions of one 128-byte line a row.
//   * Pipelining. Step j issues S_j and P_{j-1} V_{j-1} together, then
//     runs tile j's softmax (exp2 on the SFUs; the add, clamp, sum and
//     pack on the ALUs) while P_{j-1} V_{j-1} is still in flight. At C =
//     64 the two warpgroups' steps interleave freely; at C = 128 they take
//     turns at the tensor cores by named barriers (ping-pong), which paid
//     only there. The first and last steps are peeled so that no product
//     is issued on a divergent path (ptxas then serialises every wgmma:
//     C7520).
//   * The bias of each key tile comes by plain loads, one key a thread,
//     issued a step ahead into registers and moved to a double buffer of
//     the warpgroup's in shared memory (a TMA map needs 16-byte strides,
//     which a bias row of 4 Lk bytes denies), with -inf past Lk. A
//     warpgroup syncs its own 128 threads once a step.
//   * O leaves through shared memory (the warpgroup's q tile, free after
//     the last S) by a 3-D TMA store, which clips rows past Lq; lse by
//     plain stores from one thread of each quad.
//   * Traps named and avoided. TMA over [B, L, C] uses 3-D maps (C, L, B):
//     a 2-D map over B*L rows would read the next batch's rows at a ragged
//     edge where a 3-D one fills zeros, so keys past Lk have k = v = 0 and
//     bias -inf (p = 0), and rows past Lq read q = 0 and are not stored.
//     The maps reach the kernel as __grid_constant__ parameters, encoded
//     through cudaGetDriverEntryPoint (no -lcuda). Every key slot is read,
//     masked or not: a NaN in a masked slot's k still gives NaN, as in JAX.
//
// bf16 with no key, and every C in the A/B tool's `mma_sync` variant
// (`fwd_nomax_bf16`): the first design, mma.sync m16n8k16, 16 query rows a
// warp (8 warps at C = 64, 4 above); K and V tiles stream through a
// two-stage cp.async ring, and ldmatrix reads them (.trans gives V's B
// operand without a transposing copy).
//
// f32 (`fwd_nomax_f32`): exact f32 (no TF32) on plain FMA, 64x32 tiles.
//
// Any Lq and Lk: keys past Lk get p = 0, rows past Lq are not stored.
// Entry points: `flash_fwd_nomax`, `flash_fwd_nomax_lse` and
// `flash_fwd_nomax_body` below (plain C, bound with ctypes). The lse
// output costs one f32 store per query row.
//
// K6. The same source also replaces the Pallas TPU kernel `_nomax65_kernel`
// (tools/softmax_ab.py:157-181, launched at :191 in `nomax65_fwd`),
// variants D and E of the softmax A/B tool, whose inputs carry the bias
// inside the product: q65 = [q * log2e, 1] and k65 = [k, bias], both
// [B, L, 65] bf16, and v [B, Lk, 64] bf16. Per (batch, query row):
//
//   s  = q65 . k65                     f32 accumulation over 65 channels
//   p  = exp2(min(s, 60))              D (NaN kept); exp2(s) for E
//   O  = (p_v . v) / max(l, 1e-30)     as above; no lse, no use_valid
//
// A q65 or k65 row is 130 bytes: no TMA map (16-byte strides) and no
// cp.async (16-byte alignment) can read it. So K6 is two kernels:
//
//   * `repack65` (entry `flash_repack65`) reads a [N, 65] tensor once, by
//     coalesced 2-byte loads through shared memory, and writes its first
//     64 channels as [N, 64] bf16 (128-byte rows) and its 65th as f32
//     [N]: q64 and qa, k64 and kb. Bound by bytes: ~54 MB at the tool's
//     attn6 shape, ~0.016 ms at the card's 3.35 TB/s;
//   * a mode of the bf16 wgmma body (entry `flash_fwd_nomax65`) on q64,
//     k64 and v with K1's tiles and schedule at C = 64, which takes q as
//     given (no q*qmul pass), stages kb a step ahead where K1 stages the
//     bias, and scores s = fma(qa, kb, q64 . k64) (exact: qa kb is a
//     product of two bf16 values) with the clamp for D and none for E
//     (but at 128, from where exp2 is +inf anyway: `kExp2Inf`).
//     Keys past Lk read k = 0 and kb = 0, whose p = exp2(0) = 1 no
//     sentinel in kb could zero for every qa (qa * -inf is NaN at qa = 0);
//     the last key tile's softmax selects p = 0 there instead, the others
//     need no select. A NaN in an in-range k65 row still gives NaN.

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr float kValidThreshold = -5e29f;  // NEG_INF * 0.5
constexpr float kClamp = 60.0f;            // _NOMAX_CLAMP
// exp2 of this and of anything above it is +inf in f32: K6's variant E
// clamps there, which leaves exp2(s) as it is and gives E the same code
// as D (ptxas schedules an unclamped softmax worse: more moves, slower)
constexpr float kExp2Inf = 128.0f;
constexpr float kMinL = 1e-30f;
constexpr int kBQ = 64;                    // query rows per f32 block

// The scores of the wgmma body: K1/K2's s + bias clamped at 60 (kBias), or
// K6's fma(qa, kb, s) clamped at 60 (kChannel, variant D) or not
// (kChannelNoClamp, variant E).
enum Mode { kBias = 0, kChannel = 1, kChannelNoClamp = 2 };

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
// bf16: warpgroup products (wgmma) fed by TMA through an mbarrier ring.
// See the header for the design.
// ---------------------------------------------------------------------------

// C values whose bf16 forward runs `fwd_nomax_wgmma`; the others (and a
// call with no key) run `fwd_nomax_bf16`.
constexpr bool wgmma_body(int c) { return c == 64 || c == 128 || c == 256; }

constexpr int kTile = 64 * 128;   // 64 rows of one 128-byte line
// The schedule and tile shapes per C, chosen by tools/fwd_ab.py's A/B on
// the card. A warpgroup of its own streams K and V (false: thread 0
// refills each stage after its own step); the consumer warpgroups take
// turns at the tensor cores (ping-pong) where it paid: at C = 128, where
// the products outweigh the exp2. Three consumer warpgroups cap a thread
// at 128 registers (ptxas allocates 65536 / threads whatever `setmaxnreg`
// grants later), where use_valid's body spills; at C = 256 one consumer
// warpgroup a block keeps its 128 O accumulators in registers and makes
// twice the blocks of two. 64 keys a step at C >= 128 keep S and P small
// beside O.
constexpr bool kProducerWarp = true;
constexpr bool kPingPong64 = false;
constexpr bool kPingPong128 = true;
constexpr bool kPingPongK6 = true;  // K6's modes (C = 64): they gain from it
constexpr int kConsumers = 2;     // consumer warpgroups (64 queries each)
constexpr int kConsumers256 = 1;  // consumer warpgroups, C 256
constexpr int kKeys64 = 128;      // keys a step, C 64
constexpr int kKeys128 = 64;      // keys a step, C 128
constexpr int kKeys256 = 64;      // keys a step, C 256
constexpr int kStages64 = 4;      // depth of the K / V ring, C 64
constexpr int kStages128 = 4;     // depth of the K / V ring, C 128
constexpr int kStages256 = 3;     // depth of the K / V ring, C 256

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
// product a k-step, or two m64n128k16 side by side at BK = 256.
template <int BK>
__device__ __forceinline__ void wgmma_scores(float (&d)[BK / 2], uint64_t da,
                                             const unsigned char* b,
                                             int accumulate) {
  if constexpr (BK == 128) {
    wgmma_ss128(d, da, sw128_desc(b), accumulate);
  } else if constexpr (BK == 64) {
    wgmma_ss64(d, da, sw128_desc(b), accumulate);
  } else {
    static_assert(BK == 256, "key tile of 64, 128 or 256");
    wgmma_ss128(*reinterpret_cast<float(*)[64]>(&d[0]), da, sw128_desc(b),
                accumulate);
    wgmma_ss128(*reinterpret_cast<float(*)[64]>(&d[64]), da,
                sw128_desc(b + 128 * 128), accumulate);
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
  static_assert(BK == 64 || BK == 128 || BK == 256, "key tile");
};

// One block: batch row blockIdx.y, queries blockIdx.x * BQ ..; consumer
// warpgroup wg owns queries wg * 64 .. wg * 64 + 63 of them, and with PW
// the last warpgroup streams the tiles; PP: ping-pong. q, k, v, o: 3-D
// maps (C, L, B), box (64, 64 or BK, 1), 128-byte swizzle. MODE kBias
// (K1/K2): `bias` [B, 1, Lk], `lse` null or [B, 1, Lq] written; the K6
// modes: `bias` is kb [B, Lk] and `lse` is qa [B, Lq], read (one
// signature for all, so that K1/K2's instantiations stay as they were).
template <int C, int BK, int NS, int WGS, bool PW, bool PP, bool USE_VALID,
          int MODE>
__global__ void __launch_bounds__(FwdWgTile<C, BK, NS, WGS, PW>::threads, 1)
fwd_nomax_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to,
                const float* __restrict__ bias, float* __restrict__ lse,
                int lq, int lk, float qmul) {
  using T = FwdWgTile<C, BK, NS, WGS, PW>;
  constexpr int H = T::H, NB = (BK + 127) / 128;
  static_assert(MODE == kBias || (C == 64 && !USE_VALID),
                "K6 takes C = 64 and no use_valid");
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

  const int lane = tid & 31, g = lane >> 2, tq4 = lane & 3;
  const int r0 = 16 * (t >> 5) + g;  // accumulator rows r0, r0 + 8
  const int sw = r0 & 7;             // their 128-byte swizzle phase
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

  // K6: qa of this thread's rows r0 and r0 + 8 (0 past lq)
  float qa0 = 0.f, qa1 = 0.f;
  if constexpr (MODE != kBias) {
    const float* qab = lse + size_t(b) * lq;
    if (qw + r0 < lq) qa0 = qab[qw + r0];
    if (qw + r0 + 8 < lq) qa1 = qab[qw + r0 + 8];
  }

  // q * qmul rounded to bf16 in place, as the TPU kernel rounds it (JAX's
  // weak typing): the scaling is elementwise, so the swizzle does not
  // matter. qmul is a bf16 value (the wrapper rounds it so) and the
  // product of two bf16 is exact in f32, so one bf16x2 multiply rounds as
  // f32-then-bf16 does. K6 takes q as given.
  bar_wait(qbar, 0);
  if constexpr (MODE == kBias) {
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
  float l0 = 0.f, l1 = 0.f;  // row sums of rows r0 and r0 + 8 (this part)
  float st[BK / 2];          // S of key tile j, then its p in f32
  uint32_t pa[BK / 4];       // p of key tile j - 1 as bf16 A fragments

  // Tile j's bias (K6: kb) by plain loads into registers, one key a
  // thread, issued a step ahead so that they land meanwhile (a TMA map
  // needs 16-byte strides, which a bias row of 4 Lk bytes denies). Keys
  // past lk get -inf: with their zero-filled K rows, p = exp2(-inf) = 0
  // (K6: 0, and the last tile's softmax zeroes their p).
  float bv[NB];
  auto load_bias = [&](int j) {
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int i = t + 128 * n;
      bv[n] = i < BK && j * BK + i < lk
                  ? biasb[j * BK + i]
                  : (MODE == kBias ? __int_as_float(0xff800000) : 0.f);
    }
  };
  // Waits for tile j's K and V, and moves its bias to shared memory.
  auto wait_tile = [&](int j) {
    float* bt = bsw + (j & 1) * BK;
    bar_wait(&full[j % NS], (j / NS) & 1);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      if (t + 128 * n < BK) bt[t + 128 * n] = bv[n];
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
  // p = exp2(min(s + bias, 60)) [* valid] in f32 (K6: s = fma(qa, kb,
  // s), clamped for D; in the `last` key tile p = 0 past lk), summed into
  // l (two partial sums a row, to halve the chain of dependent adds)
  float l0b = 0.f, l1b = 0.f;
  auto softmax = [&](int j, auto last) {
    fence_acc(st);
    const float* bt = bsw + (j & 1) * BK;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      const float2 b2 = *reinterpret_cast<const float2*>(bt + 8 * jj +
                                                         2 * tq4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float bb = (e & 1) ? b2.y : b2.x;
        float p;
        if constexpr (MODE == kBias) {
          p = ex2(clamp_hi(st[4 * jj + e] + bb));
        } else {
          const float s = fmaf(e < 2 ? qa0 : qa1, bb, st[4 * jj + e]);
          p = ex2(MODE == kChannel ? clamp_hi(s)
                                   : (s > kExp2Inf ? kExp2Inf : s));
          if constexpr (decltype(last)::value)
            p = j * BK + 8 * jj + 2 * tq4 + (e & 1) < lk ? p : 0.f;
        }
        if (USE_VALID) p *= (bb > kValidThreshold) ? 1.f : 0.f;
        float& l = e < 2 ? (jj & 1 ? l0b : l0) : (jj & 1 ? l1b : l1);
        l += p;
        st[4 * jj + e] = p;
      }
    }
  };
  // K6 selects past lk in its last key tile only (a select, not a product
  // on a divergent path); K1/K2's keys past lk have bias -inf
  auto softmax_tile = [&](int j) {
    if constexpr (MODE != kBias) {
      if (j == nk - 1) {
        softmax(j, std::true_type{});
        return;
      }
    }
    softmax(j, std::false_type{});
  };
  // P_j as bf16 A fragments, once the last P V has read the old ones
  auto pack = [&]() {
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      pa[2 * jj] = pack_bf16(st[4 * jj], st[4 * jj + 1]);
      pa[2 * jj + 1] = pack_bf16(st[4 * jj + 2], st[4 * jj + 3]);
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

  // Step j issues S_j and P_{j-1} V_{j-1} in one turn, then runs tile j's
  // softmax while P_{j-1} V_{j-1} is still in flight. The first and last
  // steps are peeled, so that no product is issued on a divergent path
  // (ptxas serialises every wgmma of a kernel that does: C7520).
  load_bias(0);
  wait_tile(0);
  turn();
  issue_s(0);
  hand_over(false);
  wgmma_wait<0>();
  softmax_tile(0);
  pack();
  for (int j = 1; j < nk; ++j) {
    wait_tile(j);
    turn();
    issue_s(j);
    issue_pv(j - 1);
    hand_over(false);
    wgmma_wait<1>();  // S_j (groups complete in order)
    softmax_tile(j);
    wgmma_wait<0>();  // P_{j-1} V_{j-1}
    release(j - 1);
    pack();
  }
  turn();
  issue_pv(nk - 1);
  hand_over(true);
  wgmma_wait<0>();
  release(nk - 1);
  l0 += l0b;
  l1 += l1b;

  // The four threads of a quad hold disjoint columns of the same rows.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = floor_l(l0), d1 = floor_l(l1);

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
  if constexpr (MODE == kBias) {
    if (lse != nullptr && tq4 == 0) {  // lse2 = log2(max(l, 1e-30)), NaN kept
      float* lb = lse + size_t(b) * lq;
      if (qw + r0 < lq) lb[qw + r0] = log2f(d0);
      if (qw + r0 + 8 < lq) lb[qw + r0 + 8] = log2f(d1);
    }
  }
}

// ---------------------------------------------------------------------------
// K6's repack (see the header): rows of 65 bf16 channels, 2-byte aligned,
// into rows of 64 and the 65th channel as f32. Each block stages
// kRepackRows rows (one contiguous run of 130-byte rows) in shared memory
// by coalesced 2-byte loads, then writes 16-byte pieces of the 128-byte
// rows and one f32 a row; blocks stride over the rows.
// ---------------------------------------------------------------------------

constexpr int kRepackRows = 64;
constexpr int kRepackThreads = 256;

__global__ void __launch_bounds__(kRepackThreads)
repack65(const unsigned short* __restrict__ x65, uint4* __restrict__ x64,
         float* __restrict__ xa, long long n) {
  __shared__ unsigned short tile[kRepackRows * 65];
  const int tid = threadIdx.x;
  for (long long r0 = (long long)blockIdx.x * kRepackRows; r0 < n;
       r0 += (long long)gridDim.x * kRepackRows) {
    const int rows = n - r0 < kRepackRows ? int(n - r0) : kRepackRows;
    const unsigned short* src = x65 + r0 * 65;
#pragma unroll 4
    for (int i = tid; i < rows * 65; i += kRepackThreads) tile[i] = src[i];
    __syncthreads();
    for (int i = tid; i < rows * 8; i += kRepackThreads) {
      const unsigned short* h = tile + (i >> 3) * 65 + (i & 7) * 8;
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[e] = uint32_t(h[2 * e]) | (uint32_t(h[2 * e + 1]) << 16);
      x64[r0 * 8 + i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    for (int r = tid; r < rows; r += kRepackThreads)
      xa[r0 + r] = __uint_as_float(uint32_t(tile[r * 65 + 64]) << 16);
    __syncthreads();  // the next run refills the tile
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

template <int C, bool UV, int MODE = kBias>
cudaError_t run_wgmma(const void* q, const void* k, const void* v,
                      const void* bias, void* o, float* lse, int b, int lq,
                      int lk, float qmul, cudaStream_t stream) {
  constexpr int BK = C == 64 ? kKeys64 : C == 128 ? kKeys128 : kKeys256;
  constexpr int NS = C == 64 ? kStages64 : C == 128 ? kStages128 : kStages256;
  constexpr int WGS = C == 256 ? kConsumers256 : kConsumers;
  constexpr bool PP = MODE != kBias ? kPingPongK6
                     : C == 64     ? kPingPong64
                                   : C == 128 && kPingPong128;
  using T = FwdWgTile<C, BK, NS, WGS, kProducerWarp>;
  auto kernel =
      &fwd_nomax_wgmma<C, BK, NS, WGS, kProducerWarp, PP, UV, MODE>;
  static std::atomic<uint32_t> set_on{0};
  cudaError_t err = allow_smem(kernel, T::smem, set_on);
  if (err != cudaSuccess) return err;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mo;
  const bool ok = map_3d(enc, &mq, q, C, lq, b, 64) &&
                  map_3d(enc, &mk, k, C, lk, b, BK) &&
                  map_3d(enc, &mv, v, C, lk, b, BK) &&
                  map_3d(enc, &mo, o, C, lq, b, 64);
  if (!ok) return cudaErrorInvalidValue;
  dim3 grid((lq + T::BQ - 1) / T::BQ, b);
  kernel<<<grid, T::threads, T::smem, stream>>>(
      mq, mk, mv, mo, static_cast<const float*>(bias), lse, lq, lk, qmul);
  return cudaGetLastError();
}

template <int C, bool UV>
cudaError_t run(bool bf16, const void* q, const void* k, const void* v,
                const void* bias, void* o, float* lse, int b, int lq, int lk,
                float qmul, cudaStream_t stream) {
  // No key (a map cannot have length 0): the mma.sync body writes o = 0.
  if constexpr (wgmma_body(C)) {
    if (bf16 && lk > 0)
      return run_wgmma<C, UV>(q, k, v, bias, o, lse, b, lq, lk, qmul, stream);
  }
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

// K6's repack: x65 [b, l, 65] bf16 (2-byte aligned) into x64 [b, l, 64]
// bf16 (16-byte aligned) and xa [b, l] f32. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int flash_repack65(const void* x65, void* x64, void* xa, int b,
                              int l, void* stream) {
  const long long n = (long long)b * l;
  if (n <= 0) return int(cudaSuccess);
  const long long blocks = (n + kRepackRows - 1) / kRepackRows;
  repack65<<<unsigned(blocks < (1 << 20) ? blocks : (1 << 20)),
             kRepackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x65), static_cast<uint4*>(x64),
      static_cast<float*>(xa), n);
  return int(cudaGetLastError());
}

// K6 on the repacked inputs: q64 [b, lq, 64], k64 and v [b, lk, 64], all
// bf16 and 16-byte aligned; qa [b, lq] and kb [b, lk] f32; o [b, lq, 64]
// bf16. `clamp` = 1 is variant D, 0 variant E. With no key o = 0 (a TMA
// map cannot have length 0). Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_fwd_nomax65(const void* q64, const void* qa,
                                 const void* k64, const void* kb,
                                 const void* v, void* o, int b, int lq,
                                 int lk, int clamp, void* stream) {
  if (b <= 0 || lq <= 0) return int(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lk <= 0)
    return int(cudaMemsetAsync(o, 0, size_t(b) * lq * 64 * 2, st));
  float* qa_in = const_cast<float*>(static_cast<const float*>(qa));
  return clamp ? int(run_wgmma<64, false, kChannel>(
                     q64, k64, v, kb, o, qa_in, b, lq, lk, 1.f, st))
               : int(run_wgmma<64, false, kChannelNoClamp>(
                     q64, k64, v, kb, o, qa_in, b, lq, lk, 1.f, st));
}

// Which body the bf16 forward runs at C channels: 2 = wgmma
// (`fwd_nomax_wgmma`), 1 = mma.sync (`fwd_nomax_bf16`), 0 = no kernel for
// that C.
extern "C" int flash_fwd_nomax_body(int c) {
  if (c != 64 && c != 128 && c != 256) return 0;
  return wgmma_body(c) ? 2 : 1;
}
