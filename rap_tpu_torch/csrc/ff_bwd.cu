// Backward of the fused LayerNorm + GEGLU feed-forward + residual.
//
// Replaces the TPU kernel rap_tpu/ops/fused_ff.py:121 `_ff_bwd_kernel`
// (launched by `_bwd_kernel_call`, :209). Same math and cast points, with g
// the output cotangent rounded to bf16: recompute yln = bf16(LN(x) ws + wb)
// and proj = yln wi + bi (fp32 sum, fp32 bi); gelu(gate) and its derivative
// with the exact erf (`_gelu_grad_terms`, :114); act = hidden gelu(gate);
// dact = g wo^T (fp32); dwo = bf16(act)^T g; dbo = sum g; dhidden = dact
// gelu(gate), dgate = dact hidden gelu'(gate); dbi = sum dproj (fp32);
// dwi = yln^T bf16(dproj); dyln = bf16(dproj) wi^T (fp32); dws = sum dyln
// xhat, dwb = sum dyln; dx = g + rstd (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat)) with dxhat = dyln ws. Every weight gradient is fp32.
//
// Bound on the H100 at the training shape (32768 tokens, D=512, hidden
// 2048): recompute 137 + dact 69 + dwo 69 + dwi 137 + dyln 137 = 550 GFLOP
// (~0.556 ms at 989 TFLOP/s), so the tensor cores bound it. The TPU kernel
// keeps the weight gradients in VMEM across a sequential grid of token
// blocks; blocks on the card run in parallel, so the five products run as
// four TMA + wgmma kernels on one stream, with act and dproj through device
// memory once in bf16 and dyln in fp32:
//   1. ff_ln_kernel<true>: yln (T, D) bf16;
//   2. ff_bwd_geglu_kernel: products 1 and 2 over one 128-token tile and 64
//      hidden units (K = D for both, as the TPU kernel's token block):
//      proj's hidden and gate columns (yln . wi, B MN-major) and dact (g .
//      wo^T, B K-major) in registers; the epilogue runs the GEGLU vjp,
//      writes act and dproj in bf16 into swizzled shared-memory tiles that
//      TMA stores (dact never leaves the chip), and the column sums of
//      dproj over each 64 tokens (dbi's partials);
//   3. GEMM dyln = bf16(dproj) . wi^T (K = 2FH), written fp32;
//   4. ln_grad_kernel<false> (ff_common.cuh): the LayerNorm vjp per row
//      (dx), and the column sums of dyln xhat, dyln and g over each 64
//      tokens;
//   5. GEMMs dwo = act^T g and dwi = yln^T dproj (A and B MN-major, K = T),
//      split over token ranges where the tiles alone would leave SMs idle
//      (the wrapper picks the splits), each split's fp32 partial written to
//      scratch (gemm_sm90.cuh `weight_grad`).
// The GEMMs' epilogues store fp32 (gemm_sm90.cuh `F32Out<10>`).
// Every sum over tokens is added in an order fixed by the shape
// (colsum_kernel, splitsum_kernel; no atomics), so the gradients are bitwise
// repeatable. Takes every shape rap_tpu's `legal` rule admits: T % 128 == 0,
// D % 128 == 0, FH % 64 == 0 (FH % 128 == 64 leaves dwo's last tile half
// outside the matrix: TMA reads zeros there and the epilogue stores nothing).
#include "ff_common.cuh"
#include "gemm_sm90.cuh"

namespace {

using rtt::gemm::BOX_BYTES;
using rtt::gemm::K_MAJOR;
using rtt::gemm::MN_MAJOR;

// ---- products 1 and 2 with the GEGLU vjp -----------------------------------------

constexpr int GB_THREADS = 384;  // a producer warpgroup + 2 consumer warpgroups
constexpr int GB_STAGES = 3;
// a stage: yln rows 0-63, 64-127; wi hidden, gate; g rows 0-63, 64-127; wo
constexpr uint32_t GB_STAGE_BYTES = 7 * BOX_BYTES;
// each consumer's act, dproj-hidden and dproj-gate tiles (64 x 64 bf16 in
// the 128-byte swizzle), written by its threads and stored by TMA
constexpr size_t GB_OUT = 2 * 3 * (size_t)BOX_BYTES;
constexpr size_t GB_RED = 2 * 4 * 128 * sizeof(float);  // consumer x warp x 128 columns
constexpr size_t GB_SMEM =
    1024 + GB_STAGES * (size_t)GB_STAGE_BYTES + GB_OUT + GB_RED + 2 * GB_STAGES * 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 40 + 2 x 232 = 3 x 168 (the launch bound)
constexpr int LAUNCH_REGS = 168;

// Byte offset of the bf16 pair at (row r, column c even) of a 64 x 64 tile in
// TMA's 128-byte swizzle: 16-byte chunk c / 8 of row r sits at chunk
// (c / 8) ^ (r % 8). A warp's pairs of one accumulator column block land in
// 32 different banks.
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return r * 128 + ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2;
}

// A unit is 128 tokens (m tile) x 64 hidden units (tn): grid-stride over
// (T / 128) x (FH / 64) units, the hidden index fastest.
__global__ void __launch_bounds__(GB_THREADS, 1)
ff_bwd_geglu_kernel(const __grid_constant__ CUtensorMap map_yln,
                    const __grid_constant__ CUtensorMap map_wi,
                    const __grid_constant__ CUtensorMap map_g,
                    const __grid_constant__ CUtensorMap map_wo,
                    const __grid_constant__ CUtensorMap map_act,
                    const __grid_constant__ CUtensorMap map_dproj, const float* __restrict__ bi,
                    float* __restrict__ dbi_part, int T, int D, int FH) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (rtt::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* out_tiles = smem + GB_STAGES * (size_t)GB_STAGE_BYTES;
  float* red = reinterpret_cast<float*>(out_tiles + GB_OUT);
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tiles + GB_OUT + GB_RED);
  uint64_t* empty = full + GB_STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles_n = FH / 64, units = (T / 128) * tiles_n, nslab = D / 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GB_STAGES; ++s) {
      rtt::mbar_init(&full[s], 1);
      rtt::mbar_init(&empty[s], 8);
    }
    rtt::mbar_fence_init();
    rtt::fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer ------------------------------------------------------------------
    rtt::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0, it = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int m0 = (u / tiles_n) * 128, n0 = (u % tiles_n) * 64;
        for (int ks = 0; ks < nslab; ++ks, ++it) {
          if (it >= GB_STAGES) rtt::mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * (size_t)GB_STAGE_BYTES;
          uint64_t* bar = &full[stage];
          const int k0 = ks * 64;
          rtt::mbar_expect_tx(bar, GB_STAGE_BYTES);
          rtt::tma_load_2d(st, &map_yln, bar, k0, m0);
          rtt::tma_load_2d(st + BOX_BYTES, &map_yln, bar, k0, m0 + 64);
          rtt::tma_load_2d(st + 2 * BOX_BYTES, &map_wi, bar, n0, k0);
          rtt::tma_load_2d(st + 3 * BOX_BYTES, &map_wi, bar, FH + n0, k0);
          rtt::tma_load_2d(st + 4 * BOX_BYTES, &map_g, bar, k0, m0);
          rtt::tma_load_2d(st + 5 * BOX_BYTES, &map_g, bar, k0, m0 + 64);
          rtt::tma_load_2d(st + 6 * BOX_BYTES, &map_wo, bar, k0, n0);
          if (++stage == GB_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 tokens each ----------------------------------------------------
  rtt::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = warp / 4 - 1, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int i = threadIdx.x - 128 * (c + 1);  // thread in the warpgroup
  float* red_w = red + (c * 4 + wq) * 128;  // this warp's column sums
  float* red_c = red + c * 4 * 128;
  uint8_t* o_act = out_tiles + c * 3 * BOX_BYTES;  // then dproj hidden, dproj gate
  float pacc[64], dacc[32];                        // [hidden | gate] and dact
#pragma unroll
  for (int e = 0; e < 64; ++e) pacc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) dacc[e] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int m0 = (u / tiles_n) * 128, n0 = (u % tiles_n) * 64;
    int prev = -1;
    for (int ks = 0; ks < nslab; ++ks) {
      rtt::mbar_wait(&full[stage], phase);
      const uint32_t base = rtt::smem_u32(smem + stage * (size_t)GB_STAGE_BYTES);
      const uint64_t d_yln = rtt::sw128_desc(base + c * BOX_BYTES);
      const uint64_t d_wi = rtt::sw128_desc(base + 2 * BOX_BYTES, BOX_BYTES);
      const uint64_t d_g = rtt::sw128_desc(base + (4 + c) * BOX_BYTES);
      const uint64_t d_wo = rtt::sw128_desc(base + 6 * BOX_BYTES);
      rtt::fence_regs(pacc);
      rtt::fence_regs(dacc);
      rtt::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        rtt::wgmma_m64n128k16_ss<0, 1>(pacc, d_yln + 2 * kk, d_wi + 128 * kk, ks > 0 || kk > 0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        rtt::wgmma_m64n64k16_ss<0, 0>(dacc, d_g + 2 * kk, d_wo + 2 * kk, ks > 0 || kk > 0);
      rtt::wgmma_commit();
      rtt::wgmma_wait<1>();
      rtt::fence_regs(pacc);
      rtt::fence_regs(dacc);
      if (prev >= 0 && lane == 0) rtt::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == GB_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    rtt::wgmma_wait<0>();
    rtt::fence_regs(pacc);
    rtt::fence_regs(dacc);
    if (prev >= 0 && lane == 0) rtt::mbar_arrive(&empty[prev]);

    // ---- GEGLU vjp: act, dproj (bf16) and dproj's column sums ----------------------
    if (i == 0) rtt::bulk_wait_read<0>();  // the last unit's tiles have left
    rtt::bar_sync(1 + c, 128);             // ... and red was read
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = 8 * j + 2 * t, col = n0 + cl;
      float sh[2] = {0.f, 0.f}, sg[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float av[2], dh[2], dg[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float hidden = pacc[4 * j + 2 * h + e] + bi[col + e];
          const float gate = pacc[4 * (j + 8) + 2 * h + e] + bi[FH + col + e];
          const float Phi = 0.5f * (1.f + erff(gate * 0.7071067811865476f));
          const float phi = __expf(-0.5f * gate * gate) * 0.3989422804014327f;
          const float gelu = gate * Phi, dgelu = Phi + gate * phi;
          const float da = dacc[4 * j + 2 * h + e];
          av[e] = hidden * gelu;
          dh[e] = da * gelu;
          dg[e] = da * hidden * dgelu;
          sh[e] += dh[e];
          sg[e] += dg[e];
        }
        const uint32_t off = sw128_offset(16 * wq + g + 8 * h, cl);
        *reinterpret_cast<uint32_t*>(o_act + off) = rtt::pack_f2(av[0], av[1]);
        *reinterpret_cast<uint32_t*>(o_act + BOX_BYTES + off) = rtt::pack_f2(dh[0], dh[1]);
        *reinterpret_cast<uint32_t*>(o_act + 2 * BOX_BYTES + off) = rtt::pack_f2(dg[0], dg[1]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float vh = rtt::col_sum8(sh[e]), vg = rtt::col_sum8(sg[e]);
        if (g == 0) {
          red_w[cl + e] = vh;
          red_w[64 + cl + e] = vg;
        }
      }
    }
    rtt::fence_proxy_async();  // the tiles' writes, visible to TMA
    rtt::bar_sync(1 + c, 128);
    if (i == 0) {
      const int row0 = m0 + 64 * c;
      rtt::tma_store_2d(&map_act, o_act, n0, row0);
      rtt::tma_store_2d(&map_dproj, o_act + BOX_BYTES, n0, row0);
      rtt::tma_store_2d(&map_dproj, o_act + 2 * BOX_BYTES, FH + n0, row0);
      rtt::bulk_commit();
    }
    {  // the warpgroup's 64 tokens: its four warps' sums, in order
      const float v = red_c[i] + red_c[128 + i] + red_c[256 + i] + red_c[384 + i];
      const int colg = i < 64 ? n0 + i : FH + n0 + (i - 64);
      dbi_part[(long)(m0 / 64 + c) * 2 * FH + colg] = v;
    }
  }
  if (i == 0) rtt::bulk_wait<0>();  // shared memory stays until the stores are done
}

}  // namespace

// x, g (T, D) bf16; ws, wb (D) fp32; wi (D, 2FH) bf16; bi (2FH) fp32; wo (FH,
// D) bf16. Scratch: yln (T, D) bf16, act (T, FH) bf16, dproj (T, 2FH) bf16,
// dyln (T, D) fp32, dbi_part (T / 64, 2FH) fp32, ln_part (T / 64, 3D) fp32,
// wpart (max over dwo, dwi of splits x M x N where splits > 1) fp32.
// Outputs: dx (T, D) bf16; dwi (D, 2FH), dbi (2FH), dwo (FH, D) and sums
// (3, D) = [dws | dwb | dbo], fp32. splits_wo, splits_wi: token splits of
// dwo's and dwi's products (1 <= splits <= T / 64). x, g, wi, wo and the
// bf16 scratch 16-byte aligned.
extern "C" int rtt_ff_bwd(const void* x, const void* g, const void* ws, const void* wb,
                          const void* wi, const void* bi, const void* wo, void* yln, void* act,
                          void* dproj, void* dyln, void* dbi_part, void* ln_part, void* wpart,
                          void* dx, void* dwi, void* dbi, void* dwo, void* sums, int T, int D,
                          int FH, int splits_wo, int splits_wi, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (T == 0) {  // no tokens: every gradient is 0
    cudaMemsetAsync(dwi, 0, sizeof(float) * D * 2L * FH, s);
    cudaMemsetAsync(dbi, 0, sizeof(float) * 2L * FH, s);
    cudaMemsetAsync(dwo, 0, sizeof(float) * FH * (long)D, s);
    cudaMemsetAsync(sums, 0, sizeof(float) * 3L * D, s);
    return (int)cudaGetLastError();
  }
  int err = launch_ln<true>(x, ws, wb, yln, T, D, s);
  if (err) return err;

  CUtensorMap m_yln, m_wi, m_g, m_wo, m_act, m_dproj;
  if (!rtt::gemm::tile_map(&m_yln, yln, T, D) || !rtt::gemm::tile_map(&m_wi, wi, D, 2L * FH) ||
      !rtt::gemm::tile_map(&m_g, g, T, D) || !rtt::gemm::tile_map(&m_wo, wo, FH, D) ||
      !rtt::gemm::tile_map(&m_act, act, T, FH) ||
      !rtt::gemm::tile_map(&m_dproj, dproj, T, 2L * FH))
    return (int)cudaErrorInvalidValue;
  static int regs = 0;  // read once: setmaxnreg.inc would wait forever on another count
  if (regs == 0) {
    int attr[2];
    if ((err = rtt::gemm::attributes(ff_bwd_geglu_kernel, attr))) return err;
    regs = attr[0];
  }
  if (regs != LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  if ((err = (int)cudaFuncSetAttribute(ff_bwd_geglu_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)GB_SMEM)))
    return err;
  const int units = (T / 128) * (FH / 64), sms = rtt::gemm::num_sms();
  const int grid = units < sms ? units : sms;
  ff_bwd_geglu_kernel<<<grid, GB_THREADS, GB_SMEM, s>>>(m_yln, m_wi, m_g, m_wo, m_act, m_dproj,
                                                       (const float*)bi, (float*)dbi_part, T, D,
                                                       FH);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = rtt::gemm::launch_colsum((const float*)dbi_part, (float*)dbi, T / 64, 2 * FH, s)))
    return err;

  const rtt::gemm::Sched sd{T / 128, D / 128, 1, 2 * FH / 64};
  if ((err = rtt::gemm::launch<K_MAJOR, K_MAJOR>(m_dproj, m_wi, sd,
                                                 rtt::gemm::F32Out<10>{(float*)dyln, 0, T, D},
                                                 s)))
    return err;
  ln_grad_kernel<false><<<T / LNB_ROWS, LN_THREADS, 0, s>>>(
      (const bf16*)x, (const float*)dyln, (const float*)ws, (const bf16*)g, (bf16*)dx,
      (float*)ln_part, D, LNB_ROWS, T);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = rtt::gemm::launch_colsum((const float*)ln_part, (float*)sums, T / 64, 3 * D, s)))
    return err;

  if ((err = rtt::gemm::weight_grad<10>(act, g, (float*)dwo, (float*)wpart, T, FH, D,
                                        splits_wo, s)))
    return err;
  return rtt::gemm::weight_grad<10>(yln, dproj, (float*)dwi, (float*)wpart, T, D, 2 * FH,
                                    splits_wi, s);
}

// Registers and local bytes of the backward's kernels, two ints each, in the
// order ff_ln_kernel<true>, ff_bwd_geglu_kernel, the dyln GEMM,
// ln_grad_kernel<false>, the weight-gradient GEMM, colsum_kernel,
// splitsum_kernel.
extern "C" int rtt_ff_bwd_attributes(int* out) {
  int err = rtt::gemm::attributes(ff_ln_kernel<true>, out);
  if (!err) err = rtt::gemm::attributes(ff_bwd_geglu_kernel, out + 2);
  if (!err)
    err = rtt::gemm::attributes(
        rtt::gemm::gemm_kernel<K_MAJOR, K_MAJOR, rtt::gemm::F32Out<10>>, out + 4);
  if (!err) err = rtt::gemm::attributes(ln_grad_kernel<false>, out + 6);
  if (!err)
    err = rtt::gemm::attributes(
        rtt::gemm::gemm_kernel<MN_MAJOR, MN_MAJOR, rtt::gemm::F32Out<10>>, out + 8);
  if (!err) err = rtt::gemm::attributes(rtt::gemm::colsum_kernel, out + 10);
  if (!err) err = rtt::gemm::attributes(rtt::gemm::splitsum_kernel, out + 12);
  return err;
}
