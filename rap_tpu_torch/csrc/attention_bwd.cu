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
// split backward's dKV pass (row 7), at head width 64, and
// attention_bwd_dkv128.cuh's `dkv128_kernel` at head width 128 (heads of
// 64 < d <= 128, zero-padded by the caller).
//
// dQ: the TPU kernel writes one fp32 partial per kv block, (BH, nk, T, d),
// and sums them afterwards. With 128-key blocks that slab would be 4 GiB at
// the dense global shape, so here every block adds its dQ tile into one fp32
// (BH, T, D) accumulator (64 MiB at D = 64) by a bulk reduce-add; the caller scales it
// by ln2 and rounds it to bf16. Sums in no fixed order: not bitwise
// repeatable. `rtt_flash_bwd_softcap` is the kernel's softcap variant (the
// TPU kernel's static `softcap`): the per-logit factor c(1 - tanh²) is
// applied in `p_ds`, so the caller scales dq_acc by 1 instead of ln2 (:618).
#include "attention_bwd_dkv.cuh"
#include "attention_bwd_dkv128.cuh"

using rtt::attn_bwd::Cap;

namespace {

// The instantiation at head width D = 64 or 128.
template <bool SOFTCAP>
int launch_fused(const void* q, const void* k, const void* v, const void* mask,
                 const void* dout, const void* nd, const void* lse, void* dq_acc, void* dk,
                 void* dv, int BH, int Tq, int Tk, int heads, int D, Cap cap, void* stream) {
  if (D == 64)
    return rtt::attn_bwd::launch_dkv<true, SOFTCAP>(q, k, v, mask, dout, nd, lse, dq_acc,
                                                    dk, dv, BH, Tq, Tk, heads, cap, stream);
  if (D == 128)
    return rtt::attn_bwd::launch_dkv128<true, SOFTCAP>(q, k, v, mask, dout, nd, lse, dq_acc,
                                                       dk, dv, BH, Tq, Tk, heads, cap, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v (BH, T, D) bf16, D = 64 or 128 (the padded head width); mask
// (BH / heads, Tk) int32, nonzero = valid key, or null (every key valid);
// dout (BH, Tq, D) bf16; nd = -delta (BH, Tq) fp32; lse (BH, Tq) fp32 from
// either forward. dq_acc (BH, Tq, D) fp32 zeroed
// by the caller (it receives sum ds K, not yet times ln2); dk, dv (BH, Tk, D)
// bf16. Tq % 64 == 0, Tk % 128 == 0; q, k, v, dout, nd and lse 16-byte
// aligned.
extern "C" int rtt_flash_bwd(const void* q, const void* k, const void* v, const void* mask,
                             const void* dout, const void* nd, const void* lse, void* dq_acc,
                             void* dk, void* dv, int BH, int Tq, int Tk, int heads, int D,
                             void* stream) {
  return launch_fused<false>(q, k, v, mask, dout, nd, lse, dq_acc, dk, dv, BH, Tq, Tk,
                             heads, D, Cap{0.f, 0.f}, stream);
}

// The softcap variant: cap = c, cap2 = c log2(e) (q pre-scaled by scale/c);
// dk is not scaled by ln2 and dq_acc receives sum ds K to be used as it is.
extern "C" int rtt_flash_bwd_softcap(const void* q, const void* k, const void* v,
                                     const void* mask, const void* dout, const void* nd,
                                     const void* lse, void* dq_acc, void* dk, void* dv, int BH,
                                     int Tq, int Tk, int heads, int D, float cap, float cap2,
                                     void* stream) {
  return launch_fused<true>(q, k, v, mask, dout, nd, lse, dq_acc, dk, dv, BH, Tq, Tk,
                            heads, D, Cap{cap, cap2}, stream);
}

// Registers and local (stack + spill) bytes of the four instantiations,
// <fused, softcap> = <1, 0> then <1, 1> at D = 64, then the same at D = 128,
// into out[0..7]. Returns the first CUDA error, else 0.
extern "C" int rtt_flash_bwd_attributes(int* out) {
  using namespace rtt::attn_bwd;
  int err = dkv_attributes<true, false>(out, out + 1);
  if (!err) err = dkv_attributes<true, true>(out + 2, out + 3);
  if (!err) err = dkv128_attributes<true, false>(out + 4, out + 5);
  if (!err) err = dkv128_attributes<true, true>(out + 6, out + 7);
  return err;
}
