// Attention output projection + residual: head-major rows -> tokens -> @W+b.
//
// Replaces the TPU kernel rap_tpu/ops/fused_proj.py:458 `_out_kernel`
// (launched by `_out_call`, :474). Same math: the H head-major rows of a
// token are joined into one (H*dh) row, y = row @ W_out + b in fp32, then
// out = res + bf16(y) in bf16. The head-major input is (G,H,N,dh) for part
// attention and (S,H,P,N,dh) for global attention (P_layout = 1 resp. P).
//
// Bound on the H100 at the main path's shape (32768 tokens, D=512): 17.2
// GFLOP against ~100 MB moved (a, residual, out), so memory bounds it (~30 us
// at 3.35 TB/s) with tensor-core work close behind (~17 us). This is the
// simple first design: one block gathers 64 tokens of one part into shared
// memory once and walks the output columns 64 at a time with warp-level
// mma.sync, W staged through shared memory in 32-row slabs.
#include "common.cuh"

namespace {

using rtt::bf16;
constexpr int BM = 64;
constexpr int DH = 64;
constexpr int NTHREADS = 128;

__global__ void __launch_bounds__(NTHREADS)
out_kernel(const bf16* __restrict__ a, const bf16* __restrict__ res,
           const bf16* __restrict__ w, const bf16* __restrict__ b,
           bf16* __restrict__ out, int N, int D, int H, int P_layout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);  // BM x (D + 8)
  __shared__ __align__(16) bf16 sB[32 * (8 * 8 + 8)];

  const int lda = D + 8;
  const int g = blockIdx.y;
  const int n0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s_idx = g / P_layout, p_idx = g % P_layout;

  // ---- gather: sA[r][h*dh + c] = a[(s,h,p), n0 + r, c] (16-byte moves) ----
  for (int i = threadIdx.x; i < BM * H * (DH / 8); i += NTHREADS) {
    const int c = (i % (DH / 8)) * 8;
    const int r = (i / (DH / 8)) % BM;
    const int h = i / (BM * (DH / 8));
    const long src = (((long)(s_idx * H + h) * P_layout + p_idx) * N + n0 + r) * DH + c;
    *reinterpret_cast<uint4*>(sA + r * lda + h * DH + c) =
        *reinterpret_cast<const uint4*>(a + src);
  }

  const int gg = lane >> 2, t = lane & 3;
  const long rowA = (long)g * N + n0 + warp * 16 + gg, rowB = rowA + 8;
  for (int nc = 0; nc < D; nc += 64) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    rtt::gemm_rows16<8, NTHREADS>(acc, sA, lda, warp * 16, w, D, D, nc, sB,
                                  lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = nc + j * 8 + 2 * t;
      const float b0 = __bfloat162float(b[c]), b1 = __bfloat162float(b[c + 1]);
      const long oa = rowA * D + c, ob = rowB * D + c;
      const bf16 ya0 = __float2bfloat16(acc[j][0] + b0);
      const bf16 ya1 = __float2bfloat16(acc[j][1] + b1);
      const bf16 yb0 = __float2bfloat16(acc[j][2] + b0);
      const bf16 yb1 = __float2bfloat16(acc[j][3] + b1);
      *reinterpret_cast<uint32_t*>(out + oa) = rtt::pack_f2(
          __bfloat162float(res[oa]) + __bfloat162float(ya0),
          __bfloat162float(res[oa + 1]) + __bfloat162float(ya1));
      *reinterpret_cast<uint32_t*>(out + ob) = rtt::pack_f2(
          __bfloat162float(res[ob]) + __bfloat162float(yb0),
          __bfloat162float(res[ob + 1]) + __bfloat162float(yb1));
    }
  }
}

}  // namespace

extern "C" int rtt_out_proj(const void* a, const void* res, const void* w,
                            const void* b, void* out, int G, int N, int D,
                            int H, int P_layout, void* stream) {
  const size_t smem = (size_t)BM * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      out_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / BM, G);
  out_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)res, (const bf16*)w, (const bf16*)b,
      (bf16*)out, N, D, H, P_layout);
  return (int)cudaGetLastError();
}
