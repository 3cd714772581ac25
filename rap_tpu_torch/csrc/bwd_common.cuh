// Building blocks of the AdaLN+QKV projection's backward (proj_bwd.cu; the
// GEGLU feed-forward's backward, ff_bwd.cu, moved to gemm_sm90.cuh).
//
// The TPU backward kernels run their token blocks in order and keep the
// weight gradients resident in VMEM across the whole grid. Blocks on the
// card run in parallel and in no order, so each backward is split here into
// a few simple kernels on one stream, all written by hand:
//   * gemm_tile64: one block computes a 64 x 64 fp32 tile of A.B with
//     warp-level mma.sync, both operands staged through shared memory in
//     32-deep slabs (either operand may be stored transposed);
//   * ln_affine_rows: bf16(LN(x) * (c + a) + b), the recompute of the
//     normalised input (AdaLN: c = 1, a = scale, b = shift per part);
//   * ln_bwd_rows: the LayerNorm vjp, dx = rstd (dxhat - mean(dxhat) -
//     xhat mean(dxhat xhat)) [+ residual cotangent], with dxhat = dY (c + a),
//     and the per-part column sums of dY xhat, dY (and of the residual
//     cotangent) reduced with one fp32 atomicAdd per column and block;
//   * wgrad_kernel: dW (M x N, fp32) += A^T B over the token axis, split
//     into 2048-token chunks whose partial tiles meet in fp32 atomicAdd.
// This is the simple first design: no TMA, no wgmma, no pipelining.
#pragma once

#include "common.cuh"

namespace {

using rtt::bf16;

constexpr int GT = 64;             // gemm tile rows and columns
constexpr int GK = 32;             // gemm k slab
constexpr int GLD = GK + 8;        // shared row pitch (80 bytes: conflict-free fragments)
constexpr int GTHREADS = 128;      // 4 warps x 16 rows of the tile
constexpr int WGRAD_CHUNK = 2048;  // most tokens per wgrad block

// Stage a 64 x 32 operand slab into shared memory as [row][k] (k
// contiguous). KMAJOR: element (row, k) lives at src[k * ld + row], else at
// src[row * ld + k]. 16-byte global loads; the transposed case scatters.
template <bool KMAJOR>
__device__ __forceinline__ void stage_slab(bf16* dst, const bf16* src,
                                           long ld) {
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int i = threadIdx.x + it * GTHREADS;
    if (KMAJOR) {
      const int k = i >> 3, r = (i & 7) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(src + (long)k * ld + r);
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) dst[(r + q) * GLD + k] = e[q];
    } else {
      const int r = i >> 2, k = (i & 3) * 8;
      *reinterpret_cast<uint4*>(dst + r * GLD + k) =
          *reinterpret_cast<const uint4*>(src + (long)r * ld + k);
    }
  }
}

// acc[8][4] += A(64 x K) . B(K x 64) for the warp's 16 rows (warp * 16) and
// all 64 columns. A_KM: A(m, k) = A[k * lda + m], else A[m * lda + k].
// B_NK: B(k, n) = B[n * ldb + k], else B[k * ldb + n]. K % 32 == 0; the
// pointers address the tile's first row / column. Every thread of the
// (128-thread) block calls this together.
template <bool A_KM, bool B_NK>
__device__ __forceinline__ void gemm_tile64(float (*acc)[4], const bf16* A,
                                            long lda, const bf16* B, long ldb,
                                            int K, bf16* sA, bf16* sB) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += GK) {
    __syncthreads();
    stage_slab<A_KM>(sA, A_KM ? A + (long)k0 * lda : A + k0, lda);
    stage_slab<!B_NK>(sB, B_NK ? B + k0 : B + (long)k0 * ldb, ldb);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      uint32_t a[4];
      rtt::load_a(a, sA, GLD, warp * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        rtt::load_b_nk(b0, b1, sB, GLD, kk, j * 8, lane);
        rtt::mma16816(acc[j], a, b0, b1);
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void zero_acc(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// Sum over the 8 lanes that share t = lane % 4 (the 8 row groups of an mma
// C fragment): a column sum over a warp's 8 (or 16, summed first) rows.
__device__ __forceinline__ float col_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// C (M x N, fp32, row-major) = A(M x K) . B with B(k, n) = B[n * ldb + k]:
// a token-major activation times a transposed weight (dhid = dy W^T). Grid
// (N / 64, M / 64).
__global__ void __launch_bounds__(GTHREADS)
gemm_nt_f32(const bf16* __restrict__ A, const bf16* __restrict__ B,
            float* __restrict__ C, int N, int K) {
  __shared__ __align__(16) bf16 sA[GT * GLD];
  __shared__ __align__(16) bf16 sB[GT * GLD];
  const int m0 = blockIdx.y * GT, n0 = blockIdx.x * GT;
  float acc[8][4];
  zero_acc(acc);
  gemm_tile64<false, true>(acc, A + (long)m0 * K, K, B + (long)n0 * K, K, K,
                           sA, sB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long rA = m0 + warp * 16 + g, rB = rA + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + j * 8 + 2 * t;
    *reinterpret_cast<float2*>(C + rA * N + c) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(C + rB * N + c) = make_float2(acc[j][2], acc[j][3]);
  }
}

// dW (M x N, fp32, zeroed by the caller) += A^T B, A (K x M) and B (K x N)
// token-major bf16. Grid (N / 64, M / 64, K / kchunk); each block sums one
// chunk of tokens for one tile and adds it with fp32 atomicAdd.
__global__ void __launch_bounds__(GTHREADS)
wgrad_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
             float* __restrict__ dW, int M, int N, int kchunk) {
  __shared__ __align__(16) bf16 sA[GT * GLD];
  __shared__ __align__(16) bf16 sB[GT * GLD];
  const int n0 = blockIdx.x * GT, m0 = blockIdx.y * GT;
  const long k0 = (long)blockIdx.z * kchunk;
  float acc[8][4];
  zero_acc(acc);
  gemm_tile64<true, false>(acc, A + k0 * M + m0, M, B + k0 * N + n0, N,
                           kchunk, sA, sB);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long rA = m0 + warp * 16 + g, rB = rA + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = n0 + j * 8 + 2 * t;
    atomicAdd(dW + rA * N + c, acc[j][0]);
    atomicAdd(dW + rA * N + c + 1, acc[j][1]);
    atomicAdd(dW + rB * N + c, acc[j][2]);
    atomicAdd(dW + rB * N + c + 1, acc[j][3]);
  }
}

constexpr int ROW_THREADS = 256;  // 8 warps
constexpr int ROW_BLOCK = 64;     // rows per ln_bwd_rows block

// LayerNorm statistics of one bf16 row in global memory (fp32, two passes).
__device__ __forceinline__ float2 row_stats_global(const bf16* row, int D,
                                                   int lane) {
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += __bfloat162float(row[c]);
  const float mu = rtt::warp_sum(s) / D;
  float v = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = __bfloat162float(row[c]) - mu;
    v += d * d;
  }
  return make_float2(mu, rsqrtf(rtt::warp_sum(v) / D + 1e-5f));
}

// out = bf16(LN(x) * (c + a) + b), one warp per row. a and b advance by
// part_stride floats per part of rows_per_part rows. Grid: rows / 8.
__global__ void __launch_bounds__(ROW_THREADS)
ln_affine_rows(const bf16* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ b, int part_stride, int rows_per_part,
               float c, bf16* __restrict__ out, int D) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (ROW_THREADS / 32) + warp;
  const int part = (int)(row / rows_per_part);
  const float* ap = a + (long)part * part_stride;
  const float* bp = b + (long)part * part_stride;
  const bf16* xr = x + row * D;
  const float2 st = row_stats_global(xr, D, lane);
  for (int k = lane; k < D; k += 32) {
    const float h = (__bfloat162float(xr[k]) - st.x) * st.y;
    out[row * D + k] = __float2bfloat16(h * (c + ap[k]) + bp[k]);
  }
}

// LayerNorm vjp of 64 rows of one part per block (see the file comment).
// dY fp32 (rows, D); res (bf16 residual cotangent) may be null, then
// sum_res is not written. Sums are (parts, D) fp32, zeroed by the caller.
// Grid: rows / 64; rows_per_part % 64 == 0; D <= 1024.
__global__ void __launch_bounds__(ROW_THREADS)
ln_bwd_rows(const bf16* __restrict__ x, const float* __restrict__ dY,
            const float* __restrict__ a, int part_stride, int rows_per_part,
            float c, const bf16* __restrict__ res, bf16* __restrict__ dx,
            float* __restrict__ sum_dy_xhat, float* __restrict__ sum_dy,
            float* __restrict__ sum_res, int D) {
  __shared__ float sMu[ROW_BLOCK], sRstd[ROW_BLOCK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row0 = (long)blockIdx.x * ROW_BLOCK;
  const int part = (int)(row0 / rows_per_part);
  const float* ap = a + (long)part * part_stride;

  for (int r = warp; r < ROW_BLOCK; r += ROW_THREADS / 32) {
    const long row = row0 + r;
    const bf16* xr = x + row * D;
    const float* dyr = dY + row * D;
    const float2 st = row_stats_global(xr, D, lane);
    float m1 = 0.f, m2 = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float xhat = (__bfloat162float(xr[k]) - st.x) * st.y;
      const float dxhat = dyr[k] * (c + ap[k]);
      m1 += dxhat;
      m2 += dxhat * xhat;
    }
    m1 = rtt::warp_sum(m1) / D;
    m2 = rtt::warp_sum(m2) / D;
    for (int k = lane; k < D; k += 32) {
      const float xhat = (__bfloat162float(xr[k]) - st.x) * st.y;
      const float dxhat = dyr[k] * (c + ap[k]);
      float v = st.y * (dxhat - m1 - xhat * m2);
      if (res != nullptr) v += __bfloat162float(res[row * D + k]);
      dx[row * D + k] = __float2bfloat16(v);
    }
    if (lane == 0) {
      sMu[r] = st.x;
      sRstd[r] = st.y;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < D; k += ROW_THREADS) {
    float s_dx = 0.f, s_d = 0.f, s_r = 0.f;
    for (int r = 0; r < ROW_BLOCK; ++r) {
      const long row = row0 + r;
      const float xhat = (__bfloat162float(x[row * D + k]) - sMu[r]) * sRstd[r];
      const float dy = dY[row * D + k];
      s_dx += dy * xhat;
      s_d += dy;
      if (res != nullptr) s_r += __bfloat162float(res[row * D + k]);
    }
    atomicAdd(sum_dy_xhat + (long)part * D + k, s_dx);
    atomicAdd(sum_dy + (long)part * D + k, s_d);
    if (res != nullptr) atomicAdd(sum_res + k, s_r);
  }
}

// Launch helpers; each returns cudaGetLastError().
inline int launch_gemm_nt_f32(const bf16* A, const bf16* B, float* C, int M,
                              int N, int K, cudaStream_t s) {
  gemm_nt_f32<<<dim3(N / GT, M / GT), GTHREADS, 0, s>>>(A, B, C, N, K);
  return (int)cudaGetLastError();
}

// K % 32 == 0; the chunk is the largest power-of-two divisor of K up to
// WGRAD_CHUNK (at least 32).
inline int launch_wgrad(const bf16* A, const bf16* B, float* dW, int M, int N,
                        int K, cudaStream_t s) {
  int kchunk = WGRAD_CHUNK;
  while (K % kchunk != 0) kchunk /= 2;
  wgrad_kernel<<<dim3(N / GT, M / GT, K / kchunk), GTHREADS, 0, s>>>(
      A, B, dW, M, N, kchunk);
  return (int)cudaGetLastError();
}

}  // namespace
