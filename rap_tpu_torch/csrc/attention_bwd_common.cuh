// Tile math shared by the three attention backward kernels, so that they
// cannot drift apart in arithmetic:
//   attention_bwd_dkv.cuh   the key block of rows 6 and 7:
//                           rap_tpu/ops/pallas_attention.py:506
//                           `_flash_bwd_fused_kernel` (with dQ) and :426
//                           `_flash_bwd_dkv_kernel` (without)
//   attention_bwd_split.cu  :471 `_flash_bwd_dq_kernel` (row 8)
//
// All three recompute, per tile, what `_recompute_p_ds` (:369) computes on
// head-major, pre-scaled (base-2) q: s = q.k in fp32; a masked key's logit is
// NEG_INF (:411-412); p = exp2(s - lse2); ds = p (dO.V^T - delta) in fp32,
// the -delta column of [dO | -delta] (bf16, `_augment_do` :566) entering
// through va's ones column; p and ds rounded to bf16 before their products.
// dV = sum p^T dO, dK = ln2 sum ds^T Q, dQ = ln2 sum ds K: the ln2 of the
// base-2 domain is applied once per output element.
// SOFTCAP (the `softcap` static of all three TPU kernels): q arrives
// pre-scaled by scale/c, the logit is s = c·log2(e)·tanh(q.k) and ds gains
// the per-logit factor dsdz = c·(1 - tanh²), both from one tanhf
// (:402-405); the deferred ln2 is then not applied (:466, :502, :561, :618).
// `Cap` carries c and cap2 = c·log2(e), each rounded to fp32 by the host.
// Rows whose keys are all
// masked carry lse2 = LSE_EMPTY = 1e30 from the forward, so their p is
// exp2(-1e30 - 1e30) = 0 with no inf - inf.
//
// Every logit goes through `p_ds`. The query-major tiles of the dQ pass (a
// warp owns 16 queries on warp-level mma.sync.m16n8k16, common.cuh): S = Q K^T
// and dP = dO V^T put dS in registers as A fragments for dQ += dS K (`s_dp`,
// `ds_q`). The key block (attention_bwd_dkv.cuh) is TMA + wgmma.
#pragma once

#include "common.cuh"

namespace rtt {
namespace attn_bwd {

constexpr int D = 64;     // head width
constexpr int LDS = D + 8;  // shared-memory row stride of a [row][dim] tile
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;

struct Cap {
  float c;     // the logit cap
  float cap2;  // c log2(e)
};

// The scale of dK and dQ at finalize: ln2 of the base-2 domain, or 1 under
// softcap (dsdz is applied per logit there).
template <bool SOFTCAP>
__device__ __forceinline__ float out_scale() {
  return SOFTCAP ? 1.f : LN2;
}

// One logit: (p, ds). `valid` false is a masked key; `nd` is -delta (bf16
// value) and `one` va's ones column of the key.
template <bool SOFTCAP>
__device__ __forceinline__ float2 p_ds(float s, float dpv, float lse, float nd,
                                       float one, bool valid, Cap cap) {
  if (SOFTCAP) {
    const float th = tanhf(s);
    const float p = exp2f((valid ? th * cap.cap2 : NEG_INF) - lse);
    return make_float2(p, p * (dpv + nd * one) * (cap.c * (1.f - th * th)));
  }
  const float p = exp2f((valid ? s : NEG_INF) - lse);
  return make_float2(p, p * (dpv + nd * one));
}

template <int N>
__device__ __forceinline__ void zero_tiles(float (*c)[4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// ---- query-major tiles (a warp owns 16 queries, q and dO in registers) ----

// S = Q K^T and dP = dO V^T against the BK keys staged in sK, sV.
template <int BK>
__device__ __forceinline__ void s_dp(float (*s)[4], float (*dp)[4],
                                     const uint32_t (*qa)[4],
                                     const uint32_t (*da)[4], const bf16* sK,
                                     const bf16* sV, int lane) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t b0, b1;
      load_b_nk(b0, b1, sK, LDS, kc * 16, j * 8, lane);
      mma16816(s[j], qa[kc], b0, b1);
      load_b_nk(b0, b1, sV, LDS, kc * 16, j * 8, lane);
      mma16816(dp[j], da[kc], b0, b1);
    }
  }
}

// dS as bf16 A fragments (M = queries, K = keys). This thread's queries are
// g (lse lA, -delta nA) and g + 8 (lB, nB); sOne and sValid hold va's ones
// column and the mask of the step's keys.
template <int BK, bool SOFTCAP>
__device__ __forceinline__ void ds_q(uint32_t (*dsa)[4], const float (*s)[4],
                                     const float (*dp)[4], float lA, float lB,
                                     float nA, float nB, const float* sOne,
                                     const int* sValid, Cap cap, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int c = j * 8 + 2 * t;  // key within the step
    const float o0 = sOne[c], o1 = sOne[c + 1];
    const bool v0 = sValid[c] != 0, v1 = sValid[c + 1] != 0;
    const float2 a0 = p_ds<SOFTCAP>(s[j][0], dp[j][0], lA, nA, o0, v0, cap);
    const float2 a1 = p_ds<SOFTCAP>(s[j][1], dp[j][1], lA, nA, o1, v1, cap);
    const float2 b0 = p_ds<SOFTCAP>(s[j][2], dp[j][2], lB, nB, o0, v0, cap);
    const float2 b1 = p_ds<SOFTCAP>(s[j][3], dp[j][3], lB, nB, o1, v1, cap);
    const int slot = (j & 1) * 2;
    dsa[j >> 1][slot] = pack_f2(a0.y, a1.y);
    dsa[j >> 1][slot + 1] = pack_f2(b0.y, b1.y);
  }
}

}  // namespace attn_bwd
}  // namespace rtt
