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
// dKV (`rtt_flash_bwd_dkv`): attention_bwd_dkv.cuh's key block without dQ:
// one block per 128 keys of one head, walking every query; dV += P^T dO and
// dK += dS^T Q in fp32 registers, written once as bf16 (dK x ln2).
// dQ (`rtt_flash_bwd_dq`): attention_bwd_dq.cuh, the same design with queries
// and keys swapped: one block per 128 queries of one head, walking the live
// key tiles; dQ in fp32 registers, written once as dQ x ln2 in bf16.
// Both at head width 64; at 128 (heads of 64 < d <= 128, zero-padded by the
// caller) attention_bwd_dkv128.cuh and attention_bwd_dq128.cuh, the same
// passes redesigned for accumulators twice as wide.
// Both passes are TMA, wgmma and warp specialisation (their notes give the
// designs), have no atomics, no zero-fill and no post-scale, so rows 7-8
// are bitwise repeatable. Both skip key blocks with no valid key (the
// kernels' pl.when(any(mask)), :441 and :485): dKV writes zeros there, dQ
// adds nothing. Both read V and dO with D-value rows and -delta as an fp32
// vector, which the caller computes once for both passes (`_neg_delta` in
// ops/flash_attention.py).
//
// Bound on the H100 (d=64; global attention of the 2 x 8 x 4096 multi-view
// batch, BH=16, T=32768; 2 T^2 d per product and head at 989 TFLOP/s): dKV
// computes 4 products (S, dP, dV, dK), 8.80 TFLOP, 8.89 ms; dQ 3 (S, dP,
// dQ), 6.60 TFLOP, 6.67 ms; masked key blocks lower both in proportion. The
// tensor cores bound them, exp2 on the special-function units next; the
// split recomputes S and dP twice, which is its price for needing no dQ
// slab. The `_softcap` entry points are both passes' softcap variants (the
// TPU kernels' static `softcap`): dsdz = c(1 - tanh²) per logit in `p_ds`,
// and no ln2 at finalize (:466, :502).
#include "attention_bwd_dkv.cuh"
#include "attention_bwd_dkv128.cuh"
#include "attention_bwd_dq.cuh"
#include "attention_bwd_dq128.cuh"

using rtt::attn_bwd::Cap;

namespace {

// The dKV pass at head width D = 64 or 128.
template <bool SOFTCAP>
int launch_dkv_at(const void* q, const void* k, const void* v, const void* mask,
                  const void* dout, const void* nd, const void* lse, void* dk, void* dv, int BH,
                  int Tq, int Tk, int heads, int D, Cap cap, void* stream) {
  if (D == 64)
    return rtt::attn_bwd::launch_dkv<false, SOFTCAP>(q, k, v, mask, dout, nd, lse, nullptr, dk,
                                                     dv, BH, Tq, Tk, heads, cap, stream);
  if (D == 128)
    return rtt::attn_bwd::launch_dkv128<false, SOFTCAP>(q, k, v, mask, dout, nd, lse, nullptr,
                                                        dk, dv, BH, Tq, Tk, heads, cap, stream);
  return (int)cudaErrorInvalidValue;
}

// The dQ pass at head width D = 64 or 128.
template <bool SOFTCAP>
int launch_dq_at(const void* q, const void* k, const void* v, const void* mask,
                 const void* dout, const void* nd, const void* lse, void* dq, int BH, int Tq,
                 int Tk, int heads, int D, Cap cap, void* stream) {
  if (D == 64)
    return rtt::attn_bwd::launch_dq<SOFTCAP>(q, k, v, mask, dout, nd, lse, dq, BH, Tq, Tk,
                                             heads, cap, stream);
  if (D == 128)
    return rtt::attn_bwd::launch_dq128<SOFTCAP>(q, k, v, mask, dout, nd, lse, dq, BH, Tq, Tk,
                                                heads, cap, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dKV: q, k, v (BH, T, D) bf16, D = 64 or 128 (the padded head width); mask
// (BH / heads, Tk) int32, nonzero = valid key, or null (masked=False: every
// key valid); dout (BH, Tq, D) bf16; nd = -delta (BH, Tq) fp32; lse (BH, Tq)
// fp32. Writes dk (x ln2), dv (BH, Tk, D) bf16. Tq % 64 == 0, Tk % 128 == 0;
// q, k, v, dout, nd and lse 16-byte aligned.
extern "C" int rtt_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                                 const void* dout, const void* nd, const void* lse, void* dk,
                                 void* dv, int BH, int Tq, int Tk, int heads, int D,
                                 void* stream) {
  return launch_dkv_at<false>(q, k, v, mask, dout, nd, lse, dk, dv, BH, Tq, Tk, heads, D,
                              Cap{0.f, 0.f}, stream);
}

// dQ: q, k, v, mask, dout, nd and lse as above. Writes dq (x ln2) (BH, Tq,
// D) bf16. Tq % 128 == 0, Tk % 128 == 0; q, k, v, dout, nd and lse 16-byte
// aligned.
extern "C" int rtt_flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                                const void* dout, const void* nd, const void* lse, void* dq,
                                int BH, int Tq, int Tk, int heads, int D, void* stream) {
  return launch_dq_at<false>(q, k, v, mask, dout, nd, lse, dq, BH, Tq, Tk, heads, D,
                             Cap{0.f, 0.f}, stream);
}

// The softcap variants of both passes: cap = c, cap2 = c log2(e) (q
// pre-scaled by scale/c); dk and dq are not scaled by ln2.
extern "C" int rtt_flash_bwd_dkv_softcap(const void* q, const void* k, const void* v,
                                         const void* mask, const void* dout, const void* nd,
                                         const void* lse, void* dk, void* dv, int BH, int Tq,
                                         int Tk, int heads, int D, float cap, float cap2,
                                         void* stream) {
  return launch_dkv_at<true>(q, k, v, mask, dout, nd, lse, dk, dv, BH, Tq, Tk, heads, D,
                             Cap{cap, cap2}, stream);
}

extern "C" int rtt_flash_bwd_dq_softcap(const void* q, const void* k, const void* v,
                                        const void* mask, const void* dout, const void* nd,
                                        const void* lse, void* dq, int BH, int Tq, int Tk,
                                        int heads, int D, float cap, float cap2, void* stream) {
  return launch_dq_at<true>(q, k, v, mask, dout, nd, lse, dq, BH, Tq, Tk, heads, D,
                            Cap{cap, cap2}, stream);
}

// Registers and local (stack + spill) bytes of the dKV pass's four
// instantiations, <fused, softcap> = <0, 0> then <0, 1> at D = 64, then the
// same at D = 128, into out[0..7].
extern "C" int rtt_flash_bwd_dkv_attributes(int* out) {
  using namespace rtt::attn_bwd;
  int err = dkv_attributes<false, false>(out, out + 1);
  if (!err) err = dkv_attributes<false, true>(out + 2, out + 3);
  if (!err) err = dkv128_attributes<false, false>(out + 4, out + 5);
  if (!err) err = dkv128_attributes<false, true>(out + 6, out + 7);
  return err;
}

// Registers and local (stack + spill) bytes of the dQ pass's four
// instantiations, <softcap> = <0> then <1> at D = 64, then the same at
// D = 128, into out[0..7].
extern "C" int rtt_flash_bwd_dq_attributes(int* out) {
  using namespace rtt::attn_bwd;
  int err = dq_attributes<false>(out, out + 1);
  if (!err) err = dq_attributes<true>(out + 2, out + 3);
  if (!err) err = dq128_attributes<false>(out + 4, out + 5);
  if (!err) err = dq128_attributes<true>(out + 6, out + 7);
  return err;
}
