// The split flash attention backward: dK, dV in one pass, dQ in another.
//
// Replaces the TPU kernels rap_tpu/ops/pallas_attention.py:426
// `_flash_bwd_dkv_kernel` (row 7) and :471 `_flash_bwd_dq_kernel` (row 8),
// launched by `_bwd_split_impl` (:655, at :673 and :703). rap_tpu takes them
// when the fused kernel's fp32 dQ partials slab would exceed 2 GiB
// (`_bwd_impl`, :639-652): masked behind the online forward of a padded
// batch (`_flash_hm_bwd`), unmasked behind the no-padding forward. Both passes
// compute every logit with attention_bwd_common.cuh's `p_ds`.
//
// dKV (`rtt_flash_bwd_dkv`): attention_bwd_dkv.cuh's key block without dQ
// (TMA, wgmma, warp specialisation; its note gives the design): one block per
// 128 keys of one head, walking every query; dV += P^T dO and dK += dS^T Q in
// fp32 registers, written once as bf16 (dK x ln2). No atomics, no slab.
// dQ (`rtt_flash_bwd_dq`): one block per 64 queries of one head, dQ in fp32
// registers over every key block, written once as dQ x ln2 in bf16: no
// zero-fill, no atomics, no post-scale, so rows 7-8 are bitwise repeatable.
// Both skip key blocks with no valid key (the kernels' pl.when(any(mask)),
// :441 and :485): dKV writes zeros there, dQ adds nothing.
//
// Bound on the H100 (d=64; global attention of the 2 x 8 x 4096 multi-view
// batch, BH=16, T=32768; 2 T^2 d per product and head at 989 TFLOP/s): dKV
// computes 4 products (S, dP, dV, dK), 8.80 TFLOP, 8.89 ms; dQ 3 (S, dP,
// dQ), 6.60 TFLOP, 6.67 ms; masked key blocks lower both in proportion. The
// tensor cores bound them, exp2 on the FP32 pipes next; the split recomputes
// S and dP twice, which is its price for needing no dQ slab. The dQ pass is
// still the simple first design: warp-level mma.sync; no TMA, no wgmma, no
// pipelining; it reads va and [dO | -delta] with their 130-byte rows.
// The `_softcap` entry points are both passes' softcap variants (the TPU
// kernels' static `softcap`): dsdz = c(1 - tanh²) per logit in `p_ds`, and
// no ln2 at finalize (:466, :502).
#include "attention_bwd_dkv.cuh"

namespace {

using rtt::bf16;
using rtt::attn_bwd::D;
using rtt::attn_bwd::LDS;
using rtt::attn_bwd::Cap;
using rtt::attn_bwd::out_scale;
using rtt::attn_bwd::ds_q;
using rtt::attn_bwd::s_dp;
using rtt::attn_bwd::zero_tiles;

constexpr int BQ = 64;         // queries per block (16 per warp)
constexpr int BK = 64;         // keys per step
constexpr int NTHREADS = 128;  // 4 warps

template <bool SOFTCAP>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ va, const int* __restrict__ mask,
          const bf16* __restrict__ doa, const float* __restrict__ lse,
          bf16* __restrict__ dq, int Tq, int Tk, int heads, Cap cap) {
  __shared__ __align__(16) bf16 sQ[BQ * LDS];
  __shared__ __align__(16) bf16 sDO[BQ * LDS];
  __shared__ __align__(16) bf16 sK[BK * LDS];
  __shared__ __align__(16) bf16 sV[BK * LDS];
  __shared__ float sOne[BK];
  __shared__ int sValid[BK];

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3;
  const long qrow0 = (long)bh * Tq + q0;
  const bf16* dob = doa + qrow0 * (D + 1);
  const bf16* kb = k + (long)bh * Tk * D;
  const bf16* vb = va + (long)bh * Tk * (D + 1);
  const int* mrow = mask == nullptr ? nullptr : mask + (long)(bh / heads) * Tk;

  rtt::stage_tile<NTHREADS>(sQ, LDS, q + qrow0 * D, D, BQ, D);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    sDO[r * LDS + c] = dob[(long)r * (D + 1) + c];
  }
  __syncthreads();
  const int qr = warp * 16;  // this warp's first query row in the block
  uint32_t qa[D / 16][4], da[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    rtt::load_a(qa[kc], sQ, LDS, qr, kc * 16, lane);
    rtt::load_a(da[kc], sDO, LDS, qr, kc * 16, lane);
  }
  const long rowA = qrow0 + qr + gg, rowB = rowA + 8;
  const float lA = lse[rowA], lB = lse[rowB];
  const float nA = __bfloat162float(doa[rowA * (D + 1) + D]);
  const float nB = __bfloat162float(doa[rowB * (D + 1) + D]);

  float dqacc[D / 8][4];
  zero_tiles<D / 8>(dqacc);
  for (int k0 = 0; k0 < Tk; k0 += BK) {
    __syncthreads();  // the previous step's reads of sK, sV, sOne, sValid are done
    int any = 0;
    for (int i = threadIdx.x; i < BK; i += NTHREADS) {
      const int m = mrow == nullptr ? 1 : (mrow[k0 + i] != 0);
      sValid[i] = m;
      any |= m;
    }
    if (!__syncthreads_or(any)) continue;  // no valid key in this block
    rtt::stage_tile<NTHREADS>(sK, LDS, kb + (long)k0 * D, D, BK, D);
    for (int i = threadIdx.x; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      sV[r * LDS + c] = vb[(long)(k0 + r) * (D + 1) + c];
    }
    for (int i = threadIdx.x; i < BK; i += NTHREADS)
      sOne[i] = __bfloat162float(vb[(long)(k0 + i) * (D + 1) + D]);
    __syncthreads();

    float s[BK / 8][4], dp[BK / 8][4];
    s_dp<BK>(s, dp, qa, da, sK, sV, lane);
    uint32_t dsa[BK / 16][4];
    ds_q<BK, SOFTCAP>(dsa, s, dp, lA, lB, nA, nB, sOne, sValid, cap, lane);
    // ---- dQ += dS K (M = queries, K = keys, N = dims) ----------------------
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        rtt::load_b_kn(b0, b1, sK, LDS, kc * 16, j * 8, lane);
        rtt::mma16816(dqacc[j], dsa[kc], b0, b1);
      }
    }
  }

  // ---- dQ x ln2 (x 1 under softcap), bf16 -------------------------------------
  const float qs = out_scale<SOFTCAP>();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dq + rowA * D + c) =
        rtt::pack_f2(dqacc[j][0] * qs, dqacc[j][1] * qs);
    *reinterpret_cast<uint32_t*>(dq + rowB * D + c) =
        rtt::pack_f2(dqacc[j][2] * qs, dqacc[j][3] * qs);
  }
}

template <bool SOFTCAP>
int launch_dq(const void* q, const void* k, const void* va, const void* mask,
              const void* doa, const void* lse, void* dq, int BH, int Tq, int Tk,
              int heads, Cap cap, void* stream) {
  dim3 grid(Tq / BQ, BH);
  dq_kernel<SOFTCAP><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)va, (const int*)mask,
      (const bf16*)doa, (const float*)lse, (bf16*)dq, Tq, Tk, heads, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// dKV: q, k (BH, T, 64) bf16; v (BH, Tk, 64) bf16 and ones (BH, Tk) fp32, va
// without and with its ones column; mask (BH / heads, Tk) int32, nonzero =
// valid key, or null (masked=False: every key valid); dout (BH, Tq, 64) bf16
// and nd (BH, Tq) fp32, [dO | -delta] split the same way; lse (BH, Tq) fp32.
// Writes dk (x ln2), dv (BH, Tk, 64) bf16. Tq % 64 == 0, Tk % 128 == 0; q, k,
// v, dout, nd and lse 16-byte aligned.
extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* ones, const void* mask, const void* dout,
                                 const void* nd, const void* lse, void* dk, void* dv, int BH,
                                 int Tq, int Tk, int heads, void* stream) {
  return rtt::attn_bwd::launch_dkv<false, false>(q, k, v, ones, mask, dout, nd, lse, nullptr,
                                                 dk, dv, BH, Tq, Tk, heads, Cap{0.f, 0.f},
                                                 stream);
}

// dQ: q, k, mask and lse as above; va (BH, Tk, 65) bf16 with its ones column;
// doa (BH, Tq, 65) bf16 = [dO | -delta].
// dQ writes dq (x ln2) (BH, Tq, 64) bf16; Tq % 64 == 0, Tk % 64 == 0.
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* va,
                                const void* mask, const void* doa,
                                const void* lse, void* dq, int BH, int Tq,
                                int Tk, int heads, void* stream) {
  return launch_dq<false>(q, k, va, mask, doa, lse, dq, BH, Tq, Tk, heads,
                          Cap{0.f, 0.f}, stream);
}

// The softcap variants of both passes: cap = c, cap2 = c log2(e) (q
// pre-scaled by scale/c); dk and dq are not scaled by ln2.
extern "C" int rtt_flash_bwd_dkv_softcap(const void* q, const void* k, const void* v,
                                         const void* ones, const void* mask, const void* dout,
                                         const void* nd, const void* lse, void* dk, void* dv,
                                         int BH, int Tq, int Tk, int heads, float cap,
                                         float cap2, void* stream) {
  return rtt::attn_bwd::launch_dkv<false, true>(q, k, v, ones, mask, dout, nd, lse, nullptr,
                                                dk, dv, BH, Tq, Tk, heads, Cap{cap, cap2},
                                                stream);
}

extern "C" int rtt_flash_bwd_dq_softcap(const void* q, const void* k,
                                        const void* va, const void* mask,
                                        const void* doa, const void* lse,
                                        void* dq, int BH, int Tq, int Tk,
                                        int heads, float cap, float cap2,
                                        void* stream) {
  return launch_dq<true>(q, k, va, mask, doa, lse, dq, BH, Tq, Tk, heads,
                         Cap{cap, cap2}, stream);
}

// Registers and local (stack + spill) bytes of the dKV pass's two
// instantiations, <fused, softcap> = <0, 0> then <0, 1>, into out[0..3].
extern "C" int rtt_flash_bwd_dkv_attributes(int* out) {
  const int err = rtt::attn_bwd::dkv_attributes<false, false>(out, out + 1);
  return err != 0 ? err : rtt::attn_bwd::dkv_attributes<false, true>(out + 2, out + 3);
}
