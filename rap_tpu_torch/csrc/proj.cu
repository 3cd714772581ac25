// Fused AdaLN-modulate + QKV projection + per-head RMS qk-norm, head-major out.
//
// Replaces the TPU kernel rap_tpu/ops/fused_proj.py:46 `_proj_kernel`
// (launched by `_kernel_call`, :100). Same math and the same bf16 cast
// points: LN without affine (eps 1e-5) in fp32 -> h*(1+scale)+shift -> bf16
// -> h @ W (D, 3D) with fp32 accumulation -> per-head RMS of q and k with the
// folded gains (gq*log2e, gk*sqrt(dh)) -> bf16; v is cast from the fp32 sum
// and gets the ones column. Outputs are written straight into the head-major
// layout the attention kernel reads: (G,H,N,dh) for part attention and
// (S,H,P,N,dh) for global attention (P_layout = 1 resp. P below).
//
// Bound on the H100 at the main path's shape (32768 tokens, D=512): the
// product is 51.5 GFLOP against ~130 MB moved, so the tensor cores bound it
// (~52 us at 989 TFLOP/s). This is the simple first design: one block owns
// 64 tokens of one part, normalises them once into shared memory and walks
// the 3H head slices of W (64 columns each, staged through shared memory in
// 32-row slabs) with warp-level mma.sync; no TMA, no wgmma, no pipelining.
#include "common.cuh"

namespace {

using rtt::bf16;
constexpr int BM = 64;        // tokens per block
constexpr int DH = 64;        // head width
constexpr int NTHREADS = 128; // 4 warps x 16 rows

__global__ void __launch_bounds__(NTHREADS)
proj_kernel(const bf16* __restrict__ x, const float* __restrict__ ada,
            const bf16* __restrict__ w, const float* __restrict__ gq,
            const float* __restrict__ gk, bf16* __restrict__ q,
            bf16* __restrict__ k, bf16* __restrict__ va, int N, int D, int H,
            int P_layout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // BM x (D + 8)
  __shared__ __align__(16) bf16 sB[32 * (8 * 8 + 8)];

  const int lda = D + 8;
  const int g = blockIdx.y;
  const int n0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* scale = ada + (long)g * 2 * D;
  const float* shift = scale + D;

  // ---- stage x, LayerNorm + AdaLN, cast to bf16 (one warp per row) -------
  for (int r = warp; r < BM; r += NTHREADS / 32) {
    const bf16* xr = x + ((long)g * N + n0 + r) * D;
    bf16* ar = sA + r * lda;
    for (int c = lane; c < D; c += 32) ar[c] = xr[c];
    __syncwarp();
    const float2 st = rtt::row_stats(ar, D, lane, 1e-5f);
    for (int c = lane; c < D; c += 32) {
      const float h = (__bfloat162float(ar[c]) - st.x) * st.y;
      ar[c] = __float2bfloat16(h * (1.f + scale[c]) + shift[c]);
    }
  }
  // (gemm_rows16 begins with a block barrier)

  const int gg = lane >> 2, t = lane & 3;
  const int s_idx = g / P_layout, p_idx = g % P_layout;
  const int rowA = warp * 16 + gg, rowB = rowA + 8;
  for (int sl = 0; sl < 3 * H; ++sl) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    rtt::gemm_rows16<8, NTHREADS>(acc, sA, lda, warp * 16, w, 3 * D, D,
                                  sl * DH, sB, lane);
    const int kind = sl / H, h = sl % H;  // 0 = q, 1 = k, 2 = v
    const long hrow = ((long)(s_idx * H + h) * P_layout + p_idx) * N + n0;
    if (kind < 2) {
      float ssA = 0.f, ssB = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ssA += acc[j][0] * acc[j][0] + acc[j][1] * acc[j][1];
        ssB += acc[j][2] * acc[j][2] + acc[j][3] * acc[j][3];
      }
      const float rA = rsqrtf(rtt::quad_sum(ssA) + 1e-12f);
      const float rB = rsqrtf(rtt::quad_sum(ssB) + 1e-12f);
      const float* gain = (kind == 0 ? gq : gk) + h * DH;
      bf16* dst = kind == 0 ? q : k;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j * 8 + 2 * t;
        const float g0 = gain[c], g1 = gain[c + 1];
        *reinterpret_cast<uint32_t*>(dst + (hrow + rowA) * DH + c) =
            rtt::pack_f2(acc[j][0] * rA * g0, acc[j][1] * rA * g1);
        *reinterpret_cast<uint32_t*>(dst + (hrow + rowB) * DH + c) =
            rtt::pack_f2(acc[j][2] * rB * g0, acc[j][3] * rB * g1);
      }
    } else {
      // (dh + 1)-wide rows are only 2-byte aligned: scalar stores
      bf16* pa = va + (hrow + rowA) * (DH + 1);
      bf16* pb = va + (hrow + rowB) * (DH + 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j * 8 + 2 * t;
        pa[c] = __float2bfloat16(acc[j][0]);
        pa[c + 1] = __float2bfloat16(acc[j][1]);
        pb[c] = __float2bfloat16(acc[j][2]);
        pb[c + 1] = __float2bfloat16(acc[j][3]);
      }
      if (t == 0) {
        pa[DH] = __float2bfloat16(1.f);
        pb[DH] = __float2bfloat16(1.f);
      }
    }
  }
}

}  // namespace

extern "C" int rtt_proj(const void* x, const void* ada, const void* w,
                        const void* gq, const void* gk, void* q, void* k,
                        void* va, int G, int N, int D, int H, int P_layout,
                        void* stream) {
  const size_t smem = (size_t)BM * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      proj_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / BM, G);
  proj_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ada, (const bf16*)w, (const float*)gq,
      (const float*)gk, (bf16*)q, (bf16*)k, (bf16*)va, N, D, H, P_layout);
  return (int)cudaGetLastError();
}
