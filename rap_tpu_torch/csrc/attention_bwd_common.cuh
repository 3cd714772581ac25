// Tile math shared by the three attention backward kernels, so that they
// cannot drift apart in arithmetic:
//   attention_bwd_dkv.cuh   the key block of rows 6 and 7:
//                           rap_tpu/ops/pallas_attention.py:506
//                           `_flash_bwd_fused_kernel` (with dQ) and :426
//                           `_flash_bwd_dkv_kernel` (without)
//   attention_bwd_dq.cuh    the dQ pass of row 8 (attention_bwd_split.cu):
//                           :471 `_flash_bwd_dq_kernel`
//
// All three recompute, per tile, what `_recompute_p_ds` (:369) computes on
// head-major, pre-scaled (base-2) q: s = q.k in fp32; a masked key's logit is
// NEG_INF (:411-412); p = exp2(s - lse2); ds = p (dO.V^T - delta) in fp32,
// -delta a per-query fp32 vector holding the bf16 value of `_augment_do`
// (:566) added after the dO.V^T product; p and ds rounded to bf16 before
// their products.
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
// Every logit goes through `p_ds`. Both kernels are TMA + wgmma + warp
// specialisation (hopper.cuh): the key block owns keys and walks queries, the
// dQ pass owns queries and walks keys.
#pragma once

#include "common.cuh"

namespace rtt {
namespace attn_bwd {

constexpr int D = 64;  // head width
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

// One logit: (p, ds). `valid` false is a masked key; `nd` is the query's
// -delta (bf16 value).
template <bool SOFTCAP>
__device__ __forceinline__ float2 p_ds(float s, float dpv, float lse, float nd, bool valid,
                                       Cap cap) {
  if (SOFTCAP) {
    const float th = tanhf(s);
    const float p = exp2f((valid ? th * cap.cap2 : NEG_INF) - lse);
    return make_float2(p, p * (dpv + nd) * (cap.c * (1.f - th * th)));
  }
  const float p = exp2f((valid ? s : NEG_INF) - lse);
  return make_float2(p, p * (dpv + nd));
}

}  // namespace attn_bwd
}  // namespace rtt
