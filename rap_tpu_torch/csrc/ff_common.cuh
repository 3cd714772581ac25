// What the GEGLU feed-forward's forward (ff.cu) and backward (ff_bwd.cu)
// share: the LayerNorm row pass that writes yln = bf16(LN(x) ws + wb), and
// the exact-erf GELU; the QKV projection (proj.cu) runs the same row with
// its AdaLN scale and shift.
#pragma once

#include "common.cuh"

namespace {

using rtt::bf16;

constexpr int LN_THREADS = 256;  // 8 warps, one row each

__device__ __forceinline__ float gelu_exact(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// One row: y = bf16(LN(x) * ws + wb) with fp32 statistics (two passes, eps
// 1e-5), by one warp, 16-byte loads and stores (D % 8 == 0, 16-byte-aligned
// rows). ADA: ws is an AdaLN scale, applied as (1 + ws).
template <bool ADA>
__device__ __forceinline__ void ln_row(const bf16* __restrict__ xr, const float* __restrict__ ws,
                                       const float* __restrict__ wb, bf16* __restrict__ yr,
                                       int D, int lane) {
  float s = 0.f;
  for (int c = 8 * lane; c < D; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) s += __bfloat162float(e[q]);
  }
  const float mu = rtt::warp_sum(s) / D;
  float v2 = 0.f;
  for (int c = 8 * lane; c < D; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float d = __bfloat162float(e[q]) - mu;
      v2 += d * d;
    }
  }
  const float rstd = rsqrtf(rtt::warp_sum(v2) / D + 1e-5f);
  for (int c = 8 * lane; c < D; c += 256) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
    uint4 o;
    uint32_t* op = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int q = 0; q < 8; q += 2) {
      const float h0 = (__bfloat162float(e[q]) - mu) * rstd;
      const float h1 = (__bfloat162float(e[q + 1]) - mu) * rstd;
      const float s0 = ADA ? 1.f + ws[c + q] : ws[c + q];
      const float s1 = ADA ? 1.f + ws[c + q + 1] : ws[c + q + 1];
      op[q / 2] = rtt::pack_f2(h0 * s0 + wb[c + q], h1 * s1 + wb[c + q + 1]);
    }
    *reinterpret_cast<uint4*>(yr + c) = o;
  }
}

// y = bf16(LN(x) * ws + wb), one warp per row (ln_row). BWD only names the
// launch (the backward's recompute is profiled apart). Grid: rows / 8.
template <bool BWD>
__global__ void __launch_bounds__(LN_THREADS)
ff_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ ws,
             const float* __restrict__ wb, bf16* __restrict__ y, int D) {
  const long row = (long)blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  ln_row<false>(x + row * D, ws, wb, y + row * D, D, threadIdx.x & 31);
}

template <bool BWD>
inline int launch_ln(const void* x, const void* ws, const void* wb, void* y, int T, int D,
                     cudaStream_t s) {
  ff_ln_kernel<BWD><<<T / (LN_THREADS / 32), LN_THREADS, 0, s>>>(
      (const bf16*)x, (const float*)ws, (const float*)wb, (bf16*)y, D);
  return (int)cudaGetLastError();
}

}  // namespace
