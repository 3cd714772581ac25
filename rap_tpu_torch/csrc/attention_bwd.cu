// Flash attention backward on head-major, pre-scaled (base-2) q, k, v: the
// fused single pass (row 6).
//
// Replaces the TPU kernel rap_tpu/ops/pallas_attention.py:506
// `_flash_bwd_fused_kernel` (launched by `_bwd_fused_impl`, :588), the
// single-pass backward that `_bwd_impl` (:639) takes while its fp32 dQ
// partials slab stays within 2 GiB: masked=False behind the no-padding
// forward (either variant's lse2), masked=True with a (B, Tk) key mask shared
// by the H heads of a batch row (`_flash_hm_bwd`, :747). The kernel is
// attention_bwd_dkv.cuh's key block with FUSED_DQ (TMA, wgmma, warp
// specialisation; its note gives the bound and the design), shared with the
// split backward's dKV pass (row 7).
//
// dQ: the TPU kernel writes one fp32 partial per kv block, (BH, nk, T, d),
// and sums them afterwards. With 128-key blocks that slab would be 4 GiB at
// the dense global shape, so here every block adds its dQ tile into one fp32
// (BH, T, d) accumulator (64 MiB) by a bulk reduce-add; the caller scales it
// by ln2 and rounds it to bf16. Sums in no fixed order: not bitwise
// repeatable. `rtt_flash_bwd_softcap` is the kernel's softcap variant (the
// TPU kernel's static `softcap`): the per-logit factor c(1 - tanh²) is
// applied in `p_ds`, so the caller scales dq_acc by 1 instead of ln2 (:618).
#include "attention_bwd_dkv.cuh"

using rtt::attn_bwd::Cap;
using rtt::attn_bwd::launch_dkv;

// q, k (BH, T, 64) bf16; v (BH, Tk, 64) bf16 and ones (BH, Tk) fp32, va
// without and with its ones column; mask (BH / heads, Tk) int32, nonzero =
// valid key, or null (every key valid); dout (BH, Tq, 64) bf16 and nd
// (BH, Tq) fp32, [dO | -delta] split the same way; lse (BH, Tq) fp32 from
// either forward. dq_acc (BH, Tq, 64) fp32 zeroed by the caller (it
// receives sum ds K, not yet times ln2); dk, dv (BH, Tk, 64) bf16.
// Tq % 64 == 0, Tk % 128 == 0; q, k, v, dout, nd and lse 16-byte aligned.
extern "C" int rtt_flash_bwd(const void* q, const void* k, const void* v, const void* ones,
                             const void* mask, const void* dout, const void* nd,
                             const void* lse, void* dq_acc, void* dk, void* dv, int BH,
                             int Tq, int Tk, int heads, void* stream) {
  return launch_dkv<true, false>(q, k, v, ones, mask, dout, nd, lse, dq_acc, dk, dv, BH, Tq,
                                 Tk, heads, Cap{0.f, 0.f}, stream);
}

// The softcap variant: cap = c, cap2 = c log2(e) (q pre-scaled by scale/c);
// dk is not scaled by ln2 and dq_acc receives sum ds K to be used as it is.
extern "C" int rtt_flash_bwd_softcap(const void* q, const void* k, const void* v,
                                     const void* ones, const void* mask, const void* dout,
                                     const void* nd, const void* lse, void* dq_acc, void* dk,
                                     void* dv, int BH, int Tq, int Tk, int heads, float cap,
                                     float cap2, void* stream) {
  return launch_dkv<true, true>(q, k, v, ones, mask, dout, nd, lse, dq_acc, dk, dv, BH, Tq,
                                Tk, heads, Cap{cap, cap2}, stream);
}

// Registers and local (stack + spill) bytes of the two instantiations,
// <fused, softcap> = <1, 0> then <1, 1>, into out[0..3]. Returns the first
// CUDA error, else 0.
extern "C" int rtt_flash_bwd_attributes(int* out) {
  const int err = rtt::attn_bwd::dkv_attributes<true, false>(out, out + 1);
  return err != 0 ? err : rtt::attn_bwd::dkv_attributes<true, true>(out + 2, out + 3);
}
