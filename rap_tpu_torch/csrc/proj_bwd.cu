// Backward of the fused AdaLN-modulate + QKV projection + per-head RMS qk-norm.
//
// Replaces the TPU kernel rap_tpu/ops/fused_proj.py:184 `_proj_bwd_kernel`
// (launched by `_bwd_kernel_call`, :333). Same math and cast points:
// recompute h = bf16(LN(x) (1 + scale) + shift) and y = h W (fp32 sum);
// per head of q and k, with r = rsqrt(sum y^2 + 1e-12) and dqg = dq * gain,
// dy = r dqg - y r^3 sum_head(dqg y) (fp32, then bf16), and d(gain) = sum over
// tokens of dq y r; the v section of dy is dva without its ones column. Then
// dW = h^T dy (fp32 sum over all tokens, kept fp32), dh = dy W^T (fp32), and
// the AdaLN + LayerNorm vjp: d(scale) = sum dh xhat and d(shift) = sum dh per
// part, dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) with
// dxhat = dh (1 + scale). dq, dk and dva are read in their head-major layout
// ((G,H,N,dh) part, (S,H,P,N,dh) global) and folded to tokens in the reads,
// as the TPU kernel folds them in its DMA reads.
//
// Bound on the H100 at the training shape (32768 tokens, D=512): three
// products of 2 * 32768 * 512 * 1536 = 155 GFLOP (~0.156 ms at 989 TFLOP/s)
// against ~0.4 GB moved, so the tensor cores bound it. The TPU kernel keeps
// dW resident across its sequential grid; here blocks run in parallel, so
// the function is five launches on one stream (bwd_common.cuh): ln_affine_rows
// writes h (bf16, 32 MiB), proj_dy_kernel writes dy (bf16, 96 MiB) and the
// gain gradients, gemm_nt_f32 writes dh (fp32, 64 MiB), ln_bwd_rows writes dx
// and the per-part AdaLN sums, and wgrad_kernel reduces dW over 2048-token
// chunks with fp32 atomicAdd. Simple first design: mma.sync, no TMA, no
// wgmma, no pipelining.
#include "bwd_common.cuh"

namespace {

constexpr int DH = 64;  // head width: one gemm tile column block is one head

// dy for 64 tokens of part g and one 64-wide head slice `sl` of y (q: sl < H,
// k: H <= sl < 2H, v: sl >= 2H). Grid (N / 64, 3H, G).
__global__ void __launch_bounds__(GTHREADS)
proj_dy_kernel(const bf16* __restrict__ h, const bf16* __restrict__ w,
               const float* __restrict__ gq, const float* __restrict__ gk,
               const bf16* __restrict__ dq, const bf16* __restrict__ dk,
               const bf16* __restrict__ dva, bf16* __restrict__ dy,
               float* __restrict__ dgain, int N, int D, int H, int P_layout) {
  __shared__ __align__(16) bf16 sA[GT * GLD];
  __shared__ __align__(16) bf16 sB[GT * GLD];
  const int n0 = blockIdx.x * GT, sl = blockIdx.y, g = blockIdx.z;
  const int kind = sl / H, head = sl % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3;
  const int s_idx = g / P_layout, p_idx = g % P_layout;
  // head-major row of token n0 of part g in head `head`
  const long hrow = ((long)(s_idx * H + head) * P_layout + p_idx) * N + n0;
  const long tok0 = (long)g * N + n0;
  const long D3 = 3L * D;
  const long col0 = (long)kind * D + head * DH;

  if (kind == 2) {  // v: the cotangent itself (ones column dropped)
    for (int i = threadIdx.x; i < GT * DH; i += GTHREADS) {
      const int r = i / DH, c = i % DH;
      dy[(tok0 + r) * D3 + col0 + c] = dva[(hrow + r) * (DH + 1) + c];
    }
    return;
  }

  float acc[8][4];
  zero_acc(acc);
  gemm_tile64<false, false>(acc, h + tok0 * D, D, w + sl * DH, D3, D, sA, sB);

  const bf16* src = kind == 0 ? dq : dk;
  const float* gain = (kind == 0 ? gq : gk) + head * DH;
  const int rA = warp * 16 + gg, rB = rA + 8;
  float dA[8][2], dB[8][2];
  float ssA = 0.f, ssB = 0.f, sdA = 0.f, sdB = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;
    const __nv_bfloat162 a2 =
        *reinterpret_cast<const __nv_bfloat162*>(src + (hrow + rA) * DH + c);
    const __nv_bfloat162 b2 =
        *reinterpret_cast<const __nv_bfloat162*>(src + (hrow + rB) * DH + c);
    dA[j][0] = __low2float(a2);
    dA[j][1] = __high2float(a2);
    dB[j][0] = __low2float(b2);
    dB[j][1] = __high2float(b2);
    ssA += acc[j][0] * acc[j][0] + acc[j][1] * acc[j][1];
    ssB += acc[j][2] * acc[j][2] + acc[j][3] * acc[j][3];
    sdA += dA[j][0] * gain[c] * acc[j][0] + dA[j][1] * gain[c + 1] * acc[j][1];
    sdB += dB[j][0] * gain[c] * acc[j][2] + dB[j][1] * gain[c + 1] * acc[j][3];
  }
  const float rrA = rsqrtf(rtt::quad_sum(ssA) + 1e-12f);
  const float rrB = rsqrtf(rtt::quad_sum(ssB) + 1e-12f);
  const float cA = rtt::quad_sum(sdA) * rrA * rrA * rrA;
  const float cB = rtt::quad_sum(sdB) * rrB * rrB * rrB;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;
    const float g0 = gain[c], g1 = gain[c + 1];
    *reinterpret_cast<uint32_t*>(dy + (tok0 + rA) * D3 + col0 + c) =
        rtt::pack_f2(rrA * dA[j][0] * g0 - acc[j][0] * cA,
                     rrA * dA[j][1] * g1 - acc[j][1] * cA);
    *reinterpret_cast<uint32_t*>(dy + (tok0 + rB) * D3 + col0 + c) =
        rtt::pack_f2(rrB * dB[j][0] * g0 - acc[j][2] * cB,
                     rrB * dB[j][1] * g1 - acc[j][3] * cB);
    const float v0 = col_sum8(dA[j][0] * acc[j][0] * rrA + dB[j][0] * acc[j][2] * rrB);
    const float v1 = col_sum8(dA[j][1] * acc[j][1] * rrA + dB[j][1] * acc[j][3] * rrB);
    if (gg == 0) {
      atomicAdd(dgain + col0 + c, v0);
      atomicAdd(dgain + col0 + c + 1, v1);
    }
  }
}

}  // namespace

// x (G,N,D) bf16; ada (G,2D) fp32 = (scale | shift); w (D,3D) bf16; gq, gk
// (H*dh) fp32 folded gains; dq, dk head-major bf16, dva head-major (dh+1)
// wide. Scratch: h (G*N, D) bf16, dy (G*N, 3D) bf16, dh (G*N, D) fp32.
// Outputs: dx (G,N,D) bf16; dsc, dsh (G, D), dw (D, 3D), dgain (2D: q | k)
// fp32, all four zeroed by the caller. N % 64 == 0, D % 64 == 0, dh == 64.
extern "C" int rtt_proj_bwd(const void* x, const void* ada, const void* w,
                            const void* gq, const void* gk, const void* dq,
                            const void* dk, const void* dva, void* hbuf,
                            void* dybuf, void* dhid, void* dx, void* dsc,
                            void* dsh, void* dw, void* dgain, int G, int N,
                            int D, int H, int P_layout, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int T = G * N;
  const float* ada_f = (const float*)ada;
  ln_affine_rows<<<T / (ROW_THREADS / 32), ROW_THREADS, 0, s>>>(
      (const bf16*)x, ada_f, ada_f + D, 2 * D, N, 1.f, (bf16*)hbuf, D);
  int err = (int)cudaGetLastError();
  if (err) return err;
  proj_dy_kernel<<<dim3(N / GT, 3 * H, G), GTHREADS, 0, s>>>(
      (const bf16*)hbuf, (const bf16*)w, (const float*)gq, (const float*)gk,
      (const bf16*)dq, (const bf16*)dk, (const bf16*)dva, (bf16*)dybuf,
      (float*)dgain, N, D, H, P_layout);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = launch_gemm_nt_f32((const bf16*)dybuf, (const bf16*)w,
                                (float*)dhid, T, D, 3 * D, s)))
    return err;
  ln_bwd_rows<<<T / ROW_BLOCK, ROW_THREADS, 0, s>>>(
      (const bf16*)x, (const float*)dhid, ada_f, 2 * D, N, 1.f, nullptr,
      (bf16*)dx, (float*)dsc, (float*)dsh, nullptr, D);
  if ((err = (int)cudaGetLastError())) return err;
  return launch_wgrad((const bf16*)hbuf, (const bf16*)dybuf, (float*)dw, D,
                      3 * D, T, s);
}
