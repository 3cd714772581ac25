// Flash attention forward on head-major, pre-scaled (base-2) q, k, v.
//
// One source, two instantiations of one kernel (compile-time FIXED_BOUND):
//   true  replaces rap_tpu/ops/pallas_attention.py:188 `_flash_fwd_full_kernel`
//         (launched by `_fwd_full_impl`, :224): p = exp2(s - bound) with a
//         fixed per-call logit bound and no running max.
//   false replaces rap_tpu/ops/pallas_attention.py:91 `_flash_fwd_kernel`
//         (launched by `_fwd_impl`, :140): online max and rescale, a (B, Tk)
//         key mask shared by the H heads of a batch row, key blocks with no
//         valid key skipped, and fully masked rows giving 0 and LSE_EMPTY
//         (:131-138).
// Both write out (BH, Tq, d) bf16 and lse2 (BH, Tq) fp32 = max + log2(l), the
// residual the training slice's backward will read. Both read only the first
// d columns of the ones-augmented v rows (the online kernel's input at :287);
// the row sum l is the fp32 sum of the bf16-rounded p, which is the value the
// TPU kernel's ones column produced through its matmul. Keys are never
// padded: zero-padded keys would leak exp2(-bound) mass into the softmax, so
// the wrapper refuses lengths that are not multiples of the key block.
//
// Bound on the H100 at the main path's shapes (d=64; part: BH=64, T=4096,
// 275 GFLOP; global: BH=32, T=8192, 550 GFLOP; both move < 100 MB): the
// tensor cores bound it (~278 us and ~556 us at 989 TFLOP/s), with exp2 on
// the FP32 pipes next (T^2 per head). This is the simple first design
// (FlashAttention-2 style): a block owns 64 query rows of one head (16 per
// warp, q fragments in registers), walks the keys in blocks of 64 staged in
// shared memory, computes S = Q K^T and O += P V with warp-level mma.sync and
// keeps P in registers between the two products. No TMA, no wgmma, no
// pipelining of the key blocks.
#include "common.cuh"

namespace {

using rtt::bf16;
constexpr int D = 64;          // head width
constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per block step
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows
constexpr int LDS = D + 8;
constexpr float NEG_INF = -1e30f;
constexpr float LSE_EMPTY = 1e30f;

template <bool FIXED_BOUND>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ va, const int* __restrict__ mask,
                 float bound, bf16* __restrict__ out, float* __restrict__ lse,
                 int Tq, int Tk, int heads) {
  __shared__ __align__(16) bf16 sQ[BQ * LDS];
  __shared__ __align__(16) bf16 sK[BK * LDS];
  __shared__ __align__(16) bf16 sV[BK * LDS];
  __shared__ int sMask[BK];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3;
  const bf16* qb = q + ((long)bh * Tq + q0) * D;
  const bf16* kb = k + (long)bh * Tk * D;
  const bf16* vb = va + (long)bh * Tk * (D + 1);
  const int* mrow = mask == nullptr ? nullptr : mask + (long)(bh / heads) * Tk;

  rtt::stage_tile<NTHREADS>(sQ, LDS, qb, D, BQ, D);
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) rtt::load_a(qa[kc], sQ, LDS, warp * 16, kc * 16, lane);

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float mA = NEG_INF, mB = NEG_INF;  // running max (online variant)
  float lA = 0.f, lB = 0.f;          // this thread's part of the row sums

  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // previous block's sK / sV / sMask reads are done
    if (!FIXED_BOUND) {
      int any = 0;
      for (int i = threadIdx.x; i < BK; i += NTHREADS) {
        const int m = mrow == nullptr ? 1 : (mrow[k0 + i] != 0);
        sMask[i] = m;
        any |= m;
      }
      if (!__syncthreads_or(any)) continue;  // no valid key in this block
    }
    rtt::stage_tile<NTHREADS>(sK, LDS, kb + (long)k0 * D, D, BK, D);
    for (int i = threadIdx.x; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      sV[r * LDS + c] = vb[(long)(k0 + r) * (D + 1) + c];
    }
    __syncthreads();

    // ---- S = Q K^T (base-2 logits), 16 rows x 64 keys per warp -----------
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t b0, b1;
        rtt::load_b_nk(b0, b1, sK, LDS, kc * 16, j * 8, lane);
        rtt::mma16816(s[j], qa[kc], b0, b1);
      }
    }

    float subA = bound, subB = bound;
    if (!FIXED_BOUND) {
      float bmA = NEG_INF, bmB = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int c = j * 8 + 2 * t;
        if (!sMask[c]) s[j][0] = s[j][2] = NEG_INF;
        if (!sMask[c + 1]) s[j][1] = s[j][3] = NEG_INF;
        bmA = fmaxf(bmA, fmaxf(s[j][0], s[j][1]));
        bmB = fmaxf(bmB, fmaxf(s[j][2], s[j][3]));
      }
      const float nA = fmaxf(mA, rtt::quad_max(bmA));
      const float nB = fmaxf(mB, rtt::quad_max(bmB));
      const float cA = exp2f(mA - nA), cB = exp2f(mB - nB);
      mA = nA;
      mB = nB;
      subA = nA;
      subB = nB;
      lA *= cA;
      lB *= cB;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][0] *= cA;
        o[j][1] *= cA;
        o[j][2] *= cB;
        o[j][3] *= cB;
      }
    }

    // ---- P = exp2(S - m) in bf16 (kept in registers), O += P V ------------
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      float pr[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* sj = s[2 * kc + h];
        const bf16 p0 = __float2bfloat16(exp2f(sj[0] - subA));
        const bf16 p1 = __float2bfloat16(exp2f(sj[1] - subA));
        const bf16 p2 = __float2bfloat16(exp2f(sj[2] - subB));
        const bf16 p3 = __float2bfloat16(exp2f(sj[3] - subB));
        pa[2 * h] = rtt::pack_raw(p0, p1);
        pa[2 * h + 1] = rtt::pack_raw(p2, p3);
        pr[4 * h + 0] = __bfloat162float(p0);
        pr[4 * h + 1] = __bfloat162float(p1);
        pr[4 * h + 2] = __bfloat162float(p2);
        pr[4 * h + 3] = __bfloat162float(p3);
      }
      lA += pr[0] + pr[1] + pr[4] + pr[5];
      lB += pr[2] + pr[3] + pr[6] + pr[7];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        rtt::load_b_kn(b0, b1, sV, LDS, kc * 16, j * 8, lane);
        rtt::mma16816(o[j], pa, b0, b1);
      }
    }
  }

  // ---- finalize: out = O / l, lse2 = m + log2(l) ---------------------------
  lA = rtt::quad_sum(lA);
  lB = rtt::quad_sum(lB);
  const float refA = FIXED_BOUND ? bound : mA, refB = FIXED_BOUND ? bound : mB;
  const float dA = fmaxf(lA, 1e-30f), dB = fmaxf(lB, 1e-30f);
  const bool emptyA = !FIXED_BOUND && !(lA > 0.f);
  const bool emptyB = !FIXED_BOUND && !(lB > 0.f);
  const long rowA = (long)bh * Tq + q0 + warp * 16 + gg, rowB = rowA + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    const float a0 = emptyA ? 0.f : o[j][0] / dA, a1 = emptyA ? 0.f : o[j][1] / dA;
    const float b0 = emptyB ? 0.f : o[j][2] / dB, b1 = emptyB ? 0.f : o[j][3] / dB;
    *reinterpret_cast<uint32_t*>(out + rowA * D + c) = rtt::pack_f2(a0, a1);
    *reinterpret_cast<uint32_t*>(out + rowB * D + c) = rtt::pack_f2(b0, b1);
  }
  if (t == 0) {
    lse[rowA] = emptyA ? LSE_EMPTY : refA + log2f(dA);
    lse[rowB] = emptyB ? LSE_EMPTY : refB + log2f(dB);
  }
}

template <bool FIXED_BOUND>
int launch(const void* q, const void* k, const void* va, const void* mask,
           float bound, void* out, void* lse, int BH, int Tq, int Tk,
           int heads, void* stream) {
  dim3 grid(Tq / BQ, BH);
  flash_fwd_kernel<FIXED_BOUND><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)va, (const int*)mask,
      bound, (bf16*)out, (float*)lse, Tq, Tk, heads);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rtt_flash_fixed(const void* q, const void* k, const void* va,
                               float bound, void* out, void* lse, int BH,
                               int Tq, int Tk, void* stream) {
  return launch<true>(q, k, va, nullptr, bound, out, lse, BH, Tq, Tk, 1,
                      stream);
}

// mask: (BH / heads, Tk) int32, nonzero = valid key; null = every key valid.
extern "C" int rtt_flash_online(const void* q, const void* k, const void* va,
                                const void* mask, void* out, void* lse,
                                int BH, int Tq, int Tk, int heads,
                                void* stream) {
  return launch<false>(q, k, va, mask, 0.f, out, lse, BH, Tq, Tk, heads,
                       stream);
}
