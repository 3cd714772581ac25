// Shared device helpers for the port's hand-written Hopper kernels: the
// bf16 type, packing two floats into a bf16 pair, and sums over a warp, a
// quad (the 4 lanes of an accumulator row) and the 8 lanes of an
// accumulator column. Every kernel computes its products with TMA + `wgmma`
// (hopper.cuh, gemm_sm90.cuh); none uses `mma.sync`.
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

// Sum over the 8 lanes that share t = lane % 4 (the 8 row groups of a wgmma
// accumulator's 8 columns): a column sum over a warp's rows.
__device__ __forceinline__ float col_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

}  // namespace rtt
