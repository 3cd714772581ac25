// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every product in these kernels is a bf16 x bf16 -> fp32 warp-level
// `mma.sync.m16n8k16` (the simple first design; `wgmma` + TMA come later).
// Fragment layouts follow the PTX ISA for m16n8k16 with .row.col operands;
// with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major):  a0 = A[g][2t..2t+1]    a1 = A[g+8][2t..2t+1]
//                          a2 = A[g][2t+8..2t+9]  a3 = A[g+8][2t+8..2t+9]
//   B (16x8, k x n):       b0 = B[2t..2t+1][g]    b1 = B[2t+8..2t+9][g]
//   C (16x8, fp32):        c0,c1 = C[g][2t..2t+1] c2,c3 = C[g+8][2t..2t+1]
// No file of the port includes a PyTorch header: each source exposes a plain
// C launcher that returns cudaGetLastError() after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_f2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) = low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [row0, row0+16) x cols [k0, k0+16) of a row-major tile.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int ld,
                                       int row0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p0 = s + (row0 + g) * ld + k0 + 2 * t;
  const bf16* p1 = p0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(p0);
  a[1] = *reinterpret_cast<const uint32_t*>(p1);
  a[2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
}

// B fragment from a tile stored [k][n] (n contiguous).
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1,
                                          const bf16* s, int ld, int k0,
                                          int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (k0 + 2 * t) * ld + n0 + g;
  b0 = pack_raw(p[0], p[ld]);
  b1 = pack_raw(p[8 * ld], p[9 * ld]);
}

// B fragment from a tile stored [n][k] (k contiguous), e.g. K rows for Q.K^T.
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* s, int ld, int k0,
                                          int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// Copy a rows x cols tile (cols % 8 == 0, 16-byte aligned rows) of a
// row-major global matrix into shared memory, 16 bytes per thread and step.
template <int NTHREADS>
__device__ __forceinline__ void stage_tile(bf16* dst, int ldd, const bf16* src,
                                           long lds, int rows, int cols) {
  const int vpr = cols / 8;
  for (int i = threadIdx.x; i < rows * vpr; i += NTHREADS) {
    const int r = i / vpr, c = (i % vpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + (long)r * lds + c);
  }
}

// acc[NT][4] += A[r0..r0+16, 0..K) @ W[0..K, n0..n0+8*NT).
// A lives in shared memory (row-major, lda); W is row-major in global memory
// (ldw) and is staged through sB in BK-row slabs by the whole block, so every
// warp of the block must call this together.
template <int NT, int NTHREADS>
__device__ __forceinline__ void gemm_rows16(float (*acc)[4], const bf16* sA,
                                            int lda, int r0, const bf16* W,
                                            int ldw, int K, int n0, bf16* sB,
                                            int lane) {
  constexpr int BK = 32;
  constexpr int LDB = NT * 8 + 8;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();
    stage_tile<NTHREADS>(sB, LDB, W + (long)k0 * ldw + n0, ldw, BK, NT * 8);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4];
      load_a(a, sA, lda, r0, k0 + kk, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1;
        load_b_kn(b0, b1, sB, LDB, kk, j * 8, lane);
        mma16816(acc[j], a, b0, b1);
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the four lanes of one mma row group (lanes 4g..4g+3).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// LayerNorm statistics of one row held in shared memory as bf16 (fp32 math,
// two passes, as the JAX kernels' _ln): returns (mean, rstd) to every lane.
__device__ __forceinline__ float2 row_stats(const bf16* row, int D, int lane,
                                            float eps) {
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += __bfloat162float(row[c]);
  const float mu = warp_sum(s) / D;
  float v = 0.f;
  for (int c = lane; c < D; c += 32) {
    const float d = __bfloat162float(row[c]) - mu;
    v += d * d;
  }
  const float var = warp_sum(v) / D;
  return make_float2(mu, rsqrtf(var + eps));
}

}  // namespace rtt
