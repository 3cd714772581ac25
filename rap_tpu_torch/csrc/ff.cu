// Fused LayerNorm + GEGLU feed-forward + residual, one kernel.
//
// Replaces the TPU kernel rap_tpu/ops/fused_ff.py:55 `_ff_kernel` (launched
// by `_kernel_call`, :83). Same math and bf16 cast points: h = LN(x)*scale +
// bias -> bf16; proj = h @ wi + bi (fp32 sum); act = hidden * gelu(gate) in
// fp32 with the exact erf (erff; the TPU kernel used the Abramowitz-Stegun
// polynomial because Mosaic has no erf) -> bf16; y = act @ wo + bo (fp32
// sum); out = x + bf16(y).
//
// Bound on the H100 at the main path's shape (32768 tokens, D=512, FH=2048):
// 206 GFLOP against ~73 MB moved, so the tensor cores bound it (~208 us at
// 989 TFLOP/s). The (tokens, 2*FH) intermediate never reaches device memory:
// a block owns 32 tokens and streams the hidden dimension in chunks of 64
// units. Per chunk it computes the 64 hidden and 64 gate columns (K = D, wi
// staged through shared memory in 64-row slabs), applies GEGLU into a bf16
// tile in shared memory, and accumulates that tile @ wo[chunk] (staged whole)
// into the (32, D) fp32 output held in registers across the loop. This is the
// simple first design: warp-level mma.sync, no TMA, no wgmma, no pipelining.
#include "common.cuh"

namespace {

using rtt::bf16;
constexpr int BM = 32;         // tokens per block
constexpr int CH = 64;         // hidden units per chunk
constexpr int NTHREADS = 256;  // 8 warps: 2 row groups x 4 column groups
constexpr int LDW1 = 2 * CH + 8;
constexpr int LDP = 2 * CH + 4;
constexpr int LDACT = CH + 8;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
ff_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_s,
          const float* __restrict__ ln_b, const bf16* __restrict__ wi,
          const bf16* __restrict__ bi, const bf16* __restrict__ wo,
          const bf16* __restrict__ bo, bf16* __restrict__ out, int FH) {
  constexpr int LDH = D + 8;
  constexpr int NT2 = D / 4 / 8;  // output n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sH = reinterpret_cast<bf16*>(smem_raw);          // BM x LDH
  bf16* sW1 = sH + BM * LDH;                             // 64 x LDW1
  float* sP = reinterpret_cast<float*>(sW1 + 64 * LDW1); // BM x LDP
  bf16* sAct = reinterpret_cast<bf16*>(sP + BM * LDP);   // BM x LDACT
  bf16* sWo = sAct + BM * LDACT;                         // CH x LDH

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 1, cg = warp >> 1;
  const int gg = lane >> 2, t = lane & 3;
  const long tok0 = (long)blockIdx.x * BM;

  // ---- LayerNorm(scale, bias) -> bf16 h (one warp per row) ---------------
  for (int r = warp; r < BM; r += NTHREADS / 32) {
    const bf16* xr = x + (tok0 + r) * D;
    bf16* hr = sH + r * LDH;
    for (int c = lane; c < D; c += 32) hr[c] = xr[c];
    __syncwarp();
    const float2 st = rtt::row_stats(hr, D, lane, 1e-5f);
    for (int c = lane; c < D; c += 32) {
      const float h = (__bfloat162float(hr[c]) - st.x) * st.y;
      hr[c] = __float2bfloat16(h * ln_s[c] + ln_b[c]);
    }
  }

  float y[NT2][4];
#pragma unroll
  for (int j = 0; j < NT2; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;

  for (int c0 = 0; c0 < FH; c0 += CH) {
    // ---- proj chunk: [hidden c0..c0+64 | gate FH+c0..] = h @ wi[:, cols] --
    float p[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
    for (int k0 = 0; k0 < D; k0 += 64) {
      __syncthreads();
      for (int i = threadIdx.x; i < 64 * (2 * CH / 8); i += NTHREADS) {
        const int r = i / (2 * CH / 8), c = (i % (2 * CH / 8)) * 8;
        const int col = c < CH ? c0 + c : FH + c0 + (c - CH);
        *reinterpret_cast<uint4*>(sW1 + r * LDW1 + c) =
            *reinterpret_cast<const uint4*>(wi + (long)(k0 + r) * 2 * FH + col);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16) {
        uint32_t a[4];
        rtt::load_a(a, sH, LDH, rg * 16, k0 + kk, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b0, b1;
          rtt::load_b_kn(b0, b1, sW1, LDW1, kk, cg * 32 + j * 8, lane);
          rtt::mma16816(p[j], a, b0, b1);
        }
      }
    }
    // ---- + bi, GEGLU -> bf16 act; stage wo[c0..c0+64, :] ----------------
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cg * 32 + j * 8 + 2 * t;
      const int col = c < CH ? c0 + c : FH + c0 + (c - CH);
      const float b0 = __bfloat162float(bi[col]);
      const float b1 = __bfloat162float(bi[col + 1]);
      float* pa = sP + (rg * 16 + gg) * LDP + c;
      float* pb = pa + 8 * LDP;
      pa[0] = p[j][0] + b0;
      pa[1] = p[j][1] + b1;
      pb[0] = p[j][2] + b0;
      pb[1] = p[j][3] + b1;
    }
    rtt::stage_tile<NTHREADS>(sWo, LDH, wo + (long)c0 * D, D, CH, D);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * CH; i += NTHREADS) {
      const int r = i / CH, u = i % CH;
      const float hid = sP[r * LDP + u], gate = sP[r * LDP + CH + u];
      const float gelu = 0.5f * gate * (1.f + erff(gate * 0.7071067811865476f));
      sAct[r * LDACT + u] = __float2bfloat16(hid * gelu);
    }
    __syncthreads();
    // ---- y += act @ wo[chunk] -------------------------------------------
#pragma unroll
    for (int kk = 0; kk < CH; kk += 16) {
      uint32_t a[4];
      rtt::load_a(a, sAct, LDACT, rg * 16, kk, lane);
#pragma unroll
      for (int j = 0; j < NT2; ++j) {
        uint32_t b0, b1;
        rtt::load_b_kn(b0, b1, sWo, LDH, kk, cg * (D / 4) + j * 8, lane);
        rtt::mma16816(y[j], a, b0, b1);
      }
    }
  }

  // ---- out = x + bf16(y + bo) ---------------------------------------------
  const long rowA = tok0 + rg * 16 + gg, rowB = rowA + 8;
#pragma unroll
  for (int j = 0; j < NT2; ++j) {
    const int c = cg * (D / 4) + j * 8 + 2 * t;
    const float b0 = __bfloat162float(bo[c]), b1 = __bfloat162float(bo[c + 1]);
    const long oa = rowA * D + c, ob = rowB * D + c;
    const float ya0 = __bfloat162float(__float2bfloat16(y[j][0] + b0));
    const float ya1 = __bfloat162float(__float2bfloat16(y[j][1] + b1));
    const float yb0 = __bfloat162float(__float2bfloat16(y[j][2] + b0));
    const float yb1 = __bfloat162float(__float2bfloat16(y[j][3] + b1));
    *reinterpret_cast<uint32_t*>(out + oa) = rtt::pack_f2(
        __bfloat162float(x[oa]) + ya0, __bfloat162float(x[oa + 1]) + ya1);
    *reinterpret_cast<uint32_t*>(out + ob) = rtt::pack_f2(
        __bfloat162float(x[ob]) + yb0, __bfloat162float(x[ob + 1]) + yb1);
  }
}

template <int D>
size_t ff_smem() {
  return (size_t)BM * (D + 8) * 2 + 64 * LDW1 * 2 + BM * LDP * 4 +
         BM * LDACT * 2 + CH * (D + 8) * 2;
}

}  // namespace

// Only D = 512 (every shipped configuration) is instantiated; the wrapper
// refuses other widths.
extern "C" int rtt_ff(const void* x, const void* ln_s, const void* ln_b,
                      const void* wi, const void* bi, const void* wo,
                      const void* bo, void* out, int T, int D, int FH,
                      void* stream) {
  if (D != 512) return (int)cudaErrorInvalidValue;
  const size_t smem = ff_smem<512>();
  cudaError_t err = cudaFuncSetAttribute(
      ff_kernel<512>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ff_kernel<512><<<T / BM, NTHREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, (const float*)ln_s, (const float*)ln_b,
      (const bf16*)wi, (const bf16*)bi, (const bf16*)wo, (const bf16*)bo,
      (bf16*)out, FH);
  return (int)cudaGetLastError();
}
