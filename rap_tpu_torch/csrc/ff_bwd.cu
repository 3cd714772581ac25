// Backward of the fused LayerNorm + GEGLU feed-forward + residual.
//
// Replaces the TPU kernel rap_tpu/ops/fused_ff.py:121 `_ff_bwd_kernel`
// (launched by `_bwd_kernel_call`, :209). Same math and cast points, with g
// the output cotangent rounded to bf16: recompute yln = bf16(LN(x) ws + wb)
// and proj = yln wi + bi (fp32 sum, fp32 bi); gelu(gate) and its derivative
// with the exact erf (`_gelu_grad_terms`, :114); act = hidden gelu(gate);
// dact = g wo^T (fp32); dwo = bf16(act)^T g; dbo = sum g; dhidden = dact
// gelu(gate), dgate = dact hidden gelu'(gate); dbi = sum dproj (fp32);
// dwi = yln^T bf16(dproj); dyln = bf16(dproj) wi^T (fp32); dws = sum dyln
// xhat, dwb = sum dyln; dx = g + rstd (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat)) with dxhat = dyln ws. Every weight gradient is fp32.
//
// Bound on the H100 at the training shape (32768 tokens, D=512, hidden
// 2048): recompute 137 + dact 69 + dwo 69 + dwi 137 + dyln 137 = 550 GFLOP
// (~0.556 ms at 989 TFLOP/s), so the tensor cores bound it. The (tokens,
// 4096) intermediate does not fit on chip, and the weight gradients sum over
// every token, so this design writes the GEGLU intermediates to device
// memory once, in bf16, and reads them back for the weight gradients:
// act (tokens x 2048, 128 MiB) and dproj (tokens x 4096, 256 MiB), beside
// yln (32 MiB bf16), dact (256 MiB fp32) and dyln (64 MiB fp32). Seven
// launches on one stream (the shared pieces are in bwd_common.cuh); the
// weight gradients are split over 2048-token chunks and meet in fp32
// atomicAdd. Simple first design: mma.sync, no TMA, no wgmma, no pipelining.
#include "bwd_common.cuh"

namespace {

// For 64 tokens x 64 hidden units: recompute the hidden and gate columns of
// proj, apply the GEGLU vjp with dact, write act and dproj in bf16 and add
// the column sums of dproj to dbi. Grid (FH / 64, T / 64).
__global__ void __launch_bounds__(GTHREADS)
geglu_bwd_kernel(const bf16* __restrict__ yln, const bf16* __restrict__ wi,
                 const float* __restrict__ bi, const float* __restrict__ dact,
                 bf16* __restrict__ act, bf16* __restrict__ dproj,
                 float* __restrict__ dbi, int D, int FH) {
  __shared__ __align__(16) bf16 sA[GT * GLD];
  __shared__ __align__(16) bf16 sB[GT * GLD];
  const int u0 = blockIdx.x * GT, m0 = blockIdx.y * GT;
  const long F2 = 2L * FH;
  float hid[8][4], gat[8][4];
  zero_acc(hid);
  zero_acc(gat);
  gemm_tile64<false, false>(hid, yln + (long)m0 * D, D, wi + u0, F2, D, sA, sB);
  gemm_tile64<false, false>(gat, yln + (long)m0 * D, D, wi + FH + u0, F2, D, sA, sB);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3;
  const long rows[2] = {m0 + warp * 16 + gg, m0 + warp * 16 + gg + 8};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int u = u0 + j * 8 + 2 * t;
    float sh[2] = {0.f, 0.f}, sg[2] = {0.f, 0.f};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long row = rows[half];
      float a_out[2], dh_out[2], dg_out[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float hidden = hid[j][2 * half + e] + bi[u + e];
        const float gate = gat[j][2 * half + e] + bi[FH + u + e];
        const float Phi = 0.5f * (1.f + erff(gate * 0.7071067811865476f));
        const float phi = expf(-0.5f * gate * gate) * 0.3989422804014327f;
        const float gelu = gate * Phi, dgelu = Phi + gate * phi;
        const float da = dact[row * FH + u + e];
        a_out[e] = hidden * gelu;
        dh_out[e] = da * gelu;
        dg_out[e] = da * hidden * dgelu;
        sh[e] += dh_out[e];
        sg[e] += dg_out[e];
      }
      *reinterpret_cast<uint32_t*>(act + row * FH + u) = rtt::pack_f2(a_out[0], a_out[1]);
      *reinterpret_cast<uint32_t*>(dproj + row * F2 + u) =
          rtt::pack_f2(dh_out[0], dh_out[1]);
      *reinterpret_cast<uint32_t*>(dproj + row * F2 + FH + u) =
          rtt::pack_f2(dg_out[0], dg_out[1]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float vh = col_sum8(sh[e]), vg = col_sum8(sg[e]);
      if (gg == 0) {
        atomicAdd(dbi + u + e, vh);
        atomicAdd(dbi + FH + u + e, vg);
      }
    }
  }
}

}  // namespace

// x, g (T, D) bf16; ws, wb (D) fp32; wi (D, 2FH) bf16; bi (2FH) fp32;
// wo (FH, D) bf16. Scratch: yln (T, D) bf16, dact (T, FH) fp32, act (T, FH)
// bf16, dproj (T, 2FH) bf16, dyln (T, D) fp32. Outputs: dx (T, D) bf16; dws,
// dwb, dbo (D), dwi (D, 2FH), dbi (2FH), dwo (FH, D) fp32, the last six
// zeroed by the caller. T % 64 == 0, D % 64 == 0, FH % 64 == 0.
extern "C" int rtt_ff_bwd(const void* x, const void* g, const void* ws,
                          const void* wb, const void* wi, const void* bi,
                          const void* wo, void* yln, void* dact, void* act,
                          void* dproj, void* dyln, void* dx, void* dws,
                          void* dwb, void* dwi, void* dbi, void* dwo,
                          void* dbo, int T, int D, int FH, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  ln_affine_rows<<<T / (ROW_THREADS / 32), ROW_THREADS, 0, s>>>(
      (const bf16*)x, (const float*)ws, (const float*)wb, 0, T, 0.f,
      (bf16*)yln, D);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if ((err = launch_gemm_nt_f32((const bf16*)g, (const bf16*)wo, (float*)dact,
                                T, FH, D, s)))
    return err;
  geglu_bwd_kernel<<<dim3(FH / GT, T / GT), GTHREADS, 0, s>>>(
      (const bf16*)yln, (const bf16*)wi, (const float*)bi, (const float*)dact,
      (bf16*)act, (bf16*)dproj, (float*)dbi, D, FH);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_gemm_nt_f32((const bf16*)dproj, (const bf16*)wi,
                                (float*)dyln, T, D, 2 * FH, s)))
    return err;
  ln_bwd_rows<<<T / ROW_BLOCK, ROW_THREADS, 0, s>>>(
      (const bf16*)x, (const float*)dyln, (const float*)ws, 0, T, 0.f,
      (const bf16*)g, (bf16*)dx, (float*)dws, (float*)dwb, (float*)dbo, D);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_wgrad((const bf16*)act, (const bf16*)g, (float*)dwo, FH, D,
                          T, s)))
    return err;
  return launch_wgrad((const bf16*)yln, (const bf16*)dproj, (float*)dwi, D,
                      2 * FH, T, s);
}
