// Fused LayerNorm + GEGLU feed-forward + residual.
//
// Replaces the TPU kernel rap_tpu/ops/fused_ff.py:55 `_ff_kernel` (launched
// by `_kernel_call`, :83). Same math and bf16 cast points: h = LN(x)*scale +
// bias -> bf16; proj = h @ wi + bi (fp32 sum, bi rounded to bf16); act =
// hidden * gelu(gate) in fp32 with the exact erf (erff; the TPU kernel used
// the Abramowitz-Stegun polynomial because Mosaic has no erf) -> bf16; y =
// act @ wo + bo (fp32 sum); out = x + bf16(y).
//
// Bound on the H100 at the main path's shape (32768 tokens, D=512, FH=2048):
// 206 GFLOP against ~73 MB that must move, so the tensor cores bound it
// (~208 us at 989 TFLOP/s). Keeping the (tokens, 2*FH) product on chip, as
// the TPU kernel does in VMEM, would need a block's (tokens, D) fp32 output
// in registers across the whole hidden loop; instead three launches on one
// stream, the products on the persistent TMA + wgmma GEMM of gemm_sm90.cuh
// (128 x 128 tiles, 64-deep k slabs, a 3-stage ring, one producer thread,
// two consumer warpgroups, two blocks per SM so that one block's epilogue
// runs under the other's products), with act through device memory once in
// bf16 (128 MiB written and read at 32768 tokens, ~0.08 ms):
//   1. ff_ln_kernel<false>: yln = bf16(LN(x) ws + wb), (T, D);
//   2. GEMM1 yln . wi: a tile's B is the 64 hidden columns wi[:, n0:n0+64]
//      and the matching 64 gate columns wi[:, FH+n0:FH+n0+64], so hidden
//      column c and gate column c sit in one thread's accumulator; the
//      epilogue adds bi, applies GEGLU and writes act (T, FH) in bf16;
//   3. GEMM2 act . wo (K = FH, N = D in 128-column tiles): the epilogue adds
//      bo, rounds to bf16, adds x and writes bf16.
// Takes every shape rap_tpu's `legal` rule admits: T % 128 == 0, D % 128 ==
// 0, FH % 64 == 0 (the wrapper checks; ops/fused_ff.py `ff_shape_error`).
#include "ff_common.cuh"
#include "gemm_sm90.cuh"

namespace {

using rtt::gemm::K_MAJOR;
using rtt::gemm::MN_MAJOR;
using rtt::gemm::Unit;

// GEMM1's epilogue: act = bf16((hidden + bi) * gelu(gate + bi)).
struct FfFwdGeglu {
  bf16* act;
  const bf16* bi;
  int FH;
  __device__ int2 b_cols(int tn) const { return make_int2(tn * 64, FH + tn * 64); }
  __device__ void operator()(const float (&acc)[64], const Unit& u, int row0, int wq,
                             int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const long ra = row0 + 16 * wq + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = u.tn * 64 + 8 * j + 2 * t;
      const float bh0 = __bfloat162float(bi[col]), bh1 = __bfloat162float(bi[col + 1]);
      const float bg0 = __bfloat162float(bi[FH + col]);
      const float bg1 = __bfloat162float(bi[FH + col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float a0 = (acc[4 * j + 2 * h] + bh0) * gelu_exact(acc[4 * (j + 8) + 2 * h] + bg0);
        const float a1 =
            (acc[4 * j + 2 * h + 1] + bh1) * gelu_exact(acc[4 * (j + 8) + 2 * h + 1] + bg1);
        *reinterpret_cast<uint32_t*>(act + (ra + 8 * h) * FH + col) = rtt::pack_f2(a0, a1);
      }
    }
  }
};

// GEMM2's epilogue: out = x + bf16(y + bo) (a type of its own, so profiles
// tell it from out_proj's).
struct FfFwdResidual : rtt::gemm::BiasResidual {};

}  // namespace

// x (T, D) bf16; ln_s, ln_b (D) fp32; wi (D, 2FH), bi (2FH), wo (FH, D), bo
// (D) bf16. Scratch: yln (T, D) and act (T, FH) bf16. out (T, D) bf16.
// x, wi, wo, yln, act 16-byte aligned.
extern "C" int rtt_ff(const void* x, const void* ln_s, const void* ln_b, const void* wi,
                      const void* bi, const void* wo, const void* bo, void* yln, void* act,
                      void* out, int T, int D, int FH, void* stream) {
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_ln<false>(x, ln_s, ln_b, yln, T, D, s);
  if (err) return err;
  CUtensorMap m_yln, m_wi, m_act, m_wo;
  if (!rtt::gemm::tile_map(&m_yln, yln, T, D) || !rtt::gemm::tile_map(&m_wi, wi, D, 2L * FH) ||
      !rtt::gemm::tile_map(&m_act, act, T, FH) || !rtt::gemm::tile_map(&m_wo, wo, FH, D))
    return (int)cudaErrorInvalidValue;
  const rtt::gemm::Sched s1{T / 128, FH / 64, 1, D / 64};
  if ((err = rtt::gemm::launch<K_MAJOR, MN_MAJOR>(m_yln, m_wi, s1,
                                                  FfFwdGeglu{(bf16*)act, (const bf16*)bi, FH}, s)))
    return err;
  const rtt::gemm::Sched s2{T / 128, D / 128, 1, FH / 64};
  return rtt::gemm::launch<K_MAJOR, MN_MAJOR>(
      m_act, m_wo, s2, FfFwdResidual{{(const bf16*)x, (const bf16*)bo, (bf16*)out, D}}, s);
}

// Registers and local bytes of the forward's three kernels (ff_ln_kernel,
// the GEGLU GEMM, the residual GEMM), two ints each.
extern "C" int rtt_ff_attributes(int* out) {
  int err = rtt::gemm::attributes(ff_ln_kernel<false>, out);
  if (!err) err = rtt::gemm::attributes(rtt::gemm::gemm_kernel<K_MAJOR, MN_MAJOR, FfFwdGeglu>,
                                        out + 2);
  if (!err)
    err = rtt::gemm::attributes(rtt::gemm::gemm_kernel<K_MAJOR, MN_MAJOR, FfFwdResidual>,
                                out + 4);
  return err;
}
