// Shared device helpers for the port's hand-written Hopper kernels.
//
// The proj backward (proj_bwd.cu, the one kernel of the simple first design
// left) computes its products as bf16 x bf16 -> fp32 warp-level
// `mma.sync.m16n8k16` (bwd_common.cuh); the TMA + `wgmma` kernels take their
// pieces from hopper.cuh and gemm_sm90.cuh.
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

// B fragment from a tile stored [n][k] (k contiguous), e.g. K rows for Q.K^T.
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* s, int ld, int k0,
                                          int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (n0 + g) * ld + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
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
