// Flash attention backward on head-major, pre-scaled (base-2) q, k, v.
//
// Replaces the TPU kernel rap_tpu/ops/pallas_attention.py:506
// `_flash_bwd_fused_kernel` (launched by `_bwd_fused_impl`, :588), the
// single-pass backward that `_bwd_impl` (:639) takes while its fp32 dQ
// partials slab stays within 2 GiB: masked=False behind the no-padding
// forward (either variant's lse2), masked=True with a (B, Tk) key mask shared
// by the H heads of a batch row (`_flash_hm_bwd`, :747). The tile math is
// attention_bwd_common.cuh's, shared with the split backward (rows 7-8).
//
// dQ: the TPU kernel writes one fp32 partial per kv block, (BH, nk, T, d),
// and sums them afterwards. With 128-key blocks that slab would be 4 GiB at
// the dense global shape, so here every block adds its dQ tile into one fp32
// (BH, T, d) accumulator (64 MiB) with atomicAdd; the caller scales it by
// ln2 and rounds it to bf16. Sums in no fixed order: not bitwise repeatable.
//
// Bound on the H100 (d=64, 5 products of 2 T^2 d per head; dense global
// BH=32, T=8192: 1.37 TFLOP, ~1.39 ms at 989 TFLOP/s; masked part BH=128,
// T=4096: the same): the tensor cores bound it, exp2 on the FP32 pipes next.
// Simple first design (FlashAttention-2 style): a block owns 128 keys of one
// head (16 per warp) and keeps their dK and dV in registers while it walks
// all queries in blocks of 64 staged in shared memory; dS^T goes through
// shared memory for dQ += dS K. A key block with no valid key writes zeros
// and stops. Warp-level mma.sync; no TMA, no wgmma, no pipelining.
// `rtt_flash_bwd_softcap` is the kernel's softcap variant (the TPU kernel's
// static `softcap`): the per-logit factor c(1 - tanh²) is applied in
// `p_ds`, so the caller scales dq_acc by 1 instead of ln2 (:618).
#include "attention_bwd_common.cuh"

// q, k (BH, T, 64) bf16; va (BH, Tk, 65) bf16 with its ones column; mask
// (BH / heads, Tk) int32, nonzero = valid key, or null (every key valid);
// doa (BH, Tq, 65) bf16 = [dO | -delta]; lse (BH, Tq) fp32 from either
// forward. dq_acc (BH, Tq, 64) fp32 zeroed by the caller (it receives
// sum ds K, not yet times ln2); dk, dv (BH, Tk, 64) bf16.
// Tq % 64 == 0, Tk % 128 == 0.
extern "C" int rtt_flash_bwd(const void* q, const void* k, const void* va,
                             const void* mask, const void* doa, const void* lse,
                             void* dq_acc, void* dk, void* dv, int BH, int Tq,
                             int Tk, int heads, void* stream) {
  return rtt::attn_bwd::launch_dkv<true, false>(q, k, va, mask, doa, lse, dq_acc,
                                                dk, dv, BH, Tq, Tk, heads,
                                                rtt::attn_bwd::Cap{0.f, 0.f}, stream);
}

// The softcap variant: cap = c, cap2 = c log2(e) (q pre-scaled by scale/c);
// dk is not scaled by ln2 and dq_acc receives sum ds K to be used as it is.
extern "C" int rtt_flash_bwd_softcap(const void* q, const void* k, const void* va,
                                     const void* mask, const void* doa,
                                     const void* lse, void* dq_acc, void* dk,
                                     void* dv, int BH, int Tq, int Tk, int heads,
                                     float cap, float cap2, void* stream) {
  return rtt::attn_bwd::launch_dkv<true, true>(q, k, va, mask, doa, lse, dq_acc,
                                               dk, dv, BH, Tq, Tk, heads,
                                               rtt::attn_bwd::Cap{cap, cap2}, stream);
}
