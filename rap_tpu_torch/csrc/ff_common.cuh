// The row passes of the GEGLU feed-forward (ff.cu, ff_bwd.cu) and of the
// AdaLN + QKV projection (proj.cu, proj_bwd.cu): the LayerNorm row that
// writes yln = bf16(LN(x) ws + wb), or with an AdaLN scale and shift per
// part; the LayerNorm vjp with its per-block column sums; and the exact-erf
// GELU.
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

// hln = bf16(LN(x) * (1 + scale[g]) + shift[g]) for the QKV projection, ada
// (G, 2D) = (scale | shift) in fp32, g = row / N, one warp per row. BWD only
// names the launch (the backward's recompute is profiled apart). Grid: T / 8.
template <bool BWD>
__global__ void __launch_bounds__(LN_THREADS)
adaln_ln_kernel(const bf16* __restrict__ x, const float* __restrict__ ada,
                bf16* __restrict__ hln, int N, int D) {
  const long row = (long)blockIdx.x * (LN_THREADS / 32) + (threadIdx.x >> 5);
  const float* scale = ada + (row / N) * 2 * D;
  ln_row<true>(x + row * D, scale, scale + D, hln + row * D, D, threadIdx.x & 31);
}

constexpr int LNB_ROWS = 64;  // most rows a block of ln_grad_kernel takes

// The LayerNorm vjp of R rows a block (R <= 64), one warp per row (lane: 4
// consecutive columns a step, D % 128 == 0), then the block's column sums,
// each column summed in row order, into part[block]:
// - FF (ADA false): dx = bf16(g + rstd (dxhat - mean(dxhat) - xhat
//   mean(dxhat xhat))), dxhat = dy ws; part rows [sum dy xhat | sum dy |
//   sum g] (3D);
// - AdaLN (ADA true): the same without g, dxhat = dy (1 + scale), scale =
//   ws + (row0 / N) * 2D (ada's scale of the block's part: R divides N, so a
//   block lies in one part); part rows [sum dy xhat | sum dy] (2D).
// Grid: T / R.
template <bool ADA>
__global__ void __launch_bounds__(LN_THREADS)
ln_grad_kernel(const bf16* __restrict__ x, const float* __restrict__ dy,
               const float* __restrict__ ws, const bf16* __restrict__ gr,
               bf16* __restrict__ dx, float* __restrict__ part, int D, int R, int N) {
  __shared__ float sMu[LNB_ROWS], sRstd[LNB_ROWS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row0 = (long)blockIdx.x * R;
  if (ADA) ws += (row0 / N) * 2 * D;
  for (int r = warp; r < R; r += LN_THREADS / 32) {
    const long row = row0 + r;
    const bf16* xr = x + row * D;
    const float* dyr = dy + row * D;
    float s = 0.f;
    for (int c = 4 * lane; c < D; c += 128) {
      const uint2 v = *reinterpret_cast<const uint2*>(xr + c);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) s += __bfloat162float(e[q]);
    }
    const float mu = rtt::warp_sum(s) / D;
    float v2 = 0.f;
    for (int c = 4 * lane; c < D; c += 128) {
      const uint2 v = *reinterpret_cast<const uint2*>(xr + c);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float d = __bfloat162float(e[q]) - mu;
        v2 += d * d;
      }
    }
    const float rstd = rsqrtf(rtt::warp_sum(v2) / D + 1e-5f);
    float m1 = 0.f, m2 = 0.f;
    for (int c = 4 * lane; c < D; c += 128) {
      const uint2 v = *reinterpret_cast<const uint2*>(xr + c);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      const float4 d4 = *reinterpret_cast<const float4*>(dyr + c);
      const float dyv[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xhat = (__bfloat162float(e[q]) - mu) * rstd;
        const float dxhat = dyv[q] * (ADA ? 1.f + ws[c + q] : ws[c + q]);
        m1 += dxhat;
        m2 += dxhat * xhat;
      }
    }
    m1 = rtt::warp_sum(m1) / D;
    m2 = rtt::warp_sum(m2) / D;
    for (int c = 4 * lane; c < D; c += 128) {
      const uint2 v = *reinterpret_cast<const uint2*>(xr + c);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
      const float4 d4 = *reinterpret_cast<const float4*>(dyr + c);
      const float dyv[4] = {d4.x, d4.y, d4.z, d4.w};
      float gv[4] = {0.f, 0.f, 0.f, 0.f};
      if (!ADA) {
        const uint2 g2 = *reinterpret_cast<const uint2*>(gr + row * D + c);
        const bf16* ge = reinterpret_cast<const bf16*>(&g2);
#pragma unroll
        for (int q = 0; q < 4; ++q) gv[q] = __bfloat162float(ge[q]);
      }
      float o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float xhat = (__bfloat162float(e[q]) - mu) * rstd;
        const float dxhat = dyv[q] * (ADA ? 1.f + ws[c + q] : ws[c + q]);
        o[q] = ADA ? rstd * (dxhat - m1 - xhat * m2)
                   : gv[q] + rstd * (dxhat - m1 - xhat * m2);
      }
      uint2 out;
      out.x = rtt::pack_f2(o[0], o[1]);
      out.y = rtt::pack_f2(o[2], o[3]);
      *reinterpret_cast<uint2*>(dx + row * D + c) = out;
    }
    if (lane == 0) {
      sMu[r] = mu;
      sRstd[r] = rstd;
    }
  }
  __syncthreads();
  float* pb = part + (long)blockIdx.x * (ADA ? 2 : 3) * D;
  for (int k = threadIdx.x; k < D; k += LN_THREADS) {
    float s_dx = 0.f, s_d = 0.f, s_g = 0.f;
    for (int r = 0; r < R; ++r) {
      const long o = (row0 + r) * D + k;
      const float xhat = (__bfloat162float(x[o]) - sMu[r]) * sRstd[r];
      const float d = dy[o];
      s_dx += d * xhat;
      s_d += d;
      if (!ADA) s_g += __bfloat162float(gr[o]);
    }
    pb[k] = s_dx;
    pb[D + k] = s_d;
    if (!ADA) pb[2 * D + k] = s_g;
  }
}

}  // namespace
