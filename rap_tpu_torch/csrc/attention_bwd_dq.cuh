// The dQ pass of the split flash attention backward (rows 8 and 8s), for
// Hopper: `dq_kernel<SOFTCAP>`. Replaces rap_tpu/ops/pallas_attention.py:471
// `_flash_bwd_dq_kernel`, launched by `_bwd_split_impl` at :703: dQ = ln2 ·
// sum over keys of dS K (x 1 under softcap), in fp32, written once as bf16.
// Every logit goes through attention_bwd_common.cuh's `p_ds`, the arithmetic
// of `_recompute_p_ds` (:369) that the key block (attention_bwd_dkv.cuh)
// shares. No atomics, no zero-fill: rows 7-8 are bitwise repeatable.
//
// Bound on the H100 (d = 64, per logit 2·2·64 bf16 operations per product,
// 989 TFLOP/s): 3 products (S, dP, dQ). Masked multi-view global BH=16,
// T=32768: 4.68 ms over the keys the mask leaves; exp2 (one per logit, a
// 256th of the bf16 rate) needs two thirds of that, and under softcap exp2
// plus tanh need 6.24 ms, which then bounds the kernel. The bytes (each
// operand read once) are far below.
//
// Design: the key block's (attention_bwd_dkv.cuh) with queries and keys
// swapped (TMA, mbarriers, wgmma, warp specialisation), and
// csrc/attention.cu's live-tile list.
// A block owns 128 queries of one head and sweeps every live key tile of
// 128 keys in two steps of 64. Three warpgroups:
// - prologue, all 12 warps: the batch row's key mask becomes per-key bits
//   (4 words a tile) and a compacted list of the live tiles in shared
//   memory, while the block's Q and dO tiles (TMA, 128-byte swizzle) are in
//   flight. A block with no live tile writes zeros (dq is not zero-filled
//   by the caller) and stops; queries are never skipped.
// - a producer warpgroup (registers lowered to 40 by setmaxnreg) whose one
//   elected thread streams each live tile's K and V (TMA) through a ring of
//   DQ_STAGES stages, each with a full barrier (transaction bytes) and an
//   empty barrier (the 8 consumer warps);
// - two consumer warpgroups of 64 queries (registers raised to 232), each
//   keeping its dQ (64 x 64 fp32) in registers across the sweep, and its dO
//   rows as wgmma A fragments (read once from the swizzled tile). Per step of
//   64 keys: S = Q K^T (A and B K-major from shared memory) and dP = dO V^T
//   (A from registers, B K-major) by wgmma.m64n64k16; p and ds per logit by
//   `p_ds` with the key's valid bit; dS rounded to bf16
//   straight into register A fragments (the accumulator of 8 columns maps
//   onto half an A fragment register-locally); dQ += dS K by wgmma with B
//   MN-major (the transpose bit) from the same K tile. A tile is four commit
//   groups: S and dP of both steps into two register sets, then each step's
//   dQ; the first step's p and ds run while the second step's S and dP are in
//   flight, the second's while the first's dQ is, and the tile ends with
//   every group complete, so between a product and its wait the code is
//   straight-line and ptxas injects no wait. A step whose 64 keys are all
//   valid (every step without a mask, most with one) skips the per-key
//   select of a masked logit.
// Registers a consumer thread: S and dP of two steps 128, dQ 32, two dS sets
// 32, dO 16. That is why Q stays in shared memory and a step is 64 keys.
//
// Tried on the card (NVIDIA H100 80GB HBM3, 700 W; scripts/time_attention_bwd.py,
// row 8 at the masked multi-view global shape, kernel alone): one step at a
// time with the next step's S and dP queued behind the dQ product, Q and dO
// both in registers, 9.6 ms; the consumers taking turns to issue (named
// barriers) 9.9; a ring of 5 stages 9.7 (6 do not fit); the next tile's
// S and dP issued before this tile's p and ds (accumulators read after a wait
// that crosses the loop's back edge) 11.0: ptxas serialises every wgmma
// (C7514). The four groups a tile: 8.8; with the select-free valid steps:
// 8.05. Without `p_ds` (dS = S + dP, a diagnostic) 5.65: p and ds are what
// the tensor cores still wait for.
//
// Inputs with 16-byte row strides for TMA: V (BH, Tk, 64) bf16, dO (BH, Tq,
// 64) bf16, and -delta (BH, Tq) fp32 holding the bf16 values (`_neg_delta`
// in ops/flash_attention.py). Tq % 128 == 0, Tk % 128 == 0; q, k, V, dO,
// lse2 and -delta 16-byte aligned.
//
// ptxas (sm_90a), both instantiations: 168 registers (the launch bound for
// 384 threads; setmaxnreg moves them to 40 / 232), no stack, no spills;
// dynamic shared memory 164 992 bytes plus 20 a key tile. `launch_dq`
// refuses to launch a build with another register count, since
// setmaxnreg.inc would then wait forever.
#pragma once

#include <type_traits>

#include "attention_bwd_common.cuh"
#include "hopper.cuh"

namespace rtt {
namespace attn_bwd {

constexpr int DQ_BQ = 128;      // queries per block, 64 per consumer warpgroup
constexpr int DQ_BK = 128;      // keys per tile (one ring stage)
constexpr int DQ_STEP = 64;     // keys per step: two steps a tile
constexpr int DQ_STAGES = 4;    // K / V ring depth
constexpr int DQ_THREADS = 384;  // producer + 2 consumer warpgroups
constexpr int DQ_PRODUCER_REGS = 40;
constexpr int DQ_CONSUMER_REGS = 232;  // 40 + 2 x 232 = 3 x 168 (launch bound)
constexpr int DQ_LAUNCH_REGS = 168;
constexpr uint32_t DQ_TILE = 128 * D * 2;  // 128 rows x 64 bf16: 16 KB
// shared memory, from a 1024-byte aligned base
constexpr size_t DQ_OFF_Q = 0;
constexpr size_t DQ_OFF_DO = DQ_TILE;
constexpr size_t DQ_OFF_K = 2 * (size_t)DQ_TILE;                       // STAGES tiles
constexpr size_t DQ_OFF_V = DQ_OFF_K + DQ_STAGES * (size_t)DQ_TILE;    // STAGES tiles
constexpr size_t DQ_OFF_BAR = DQ_OFF_V + DQ_STAGES * (size_t)DQ_TILE;
constexpr size_t DQ_SMEM_BARS = 128;  // q barrier, full[], empty[], live count
constexpr size_t DQ_SMEM_FIXED = 1024 + DQ_OFF_BAR + DQ_SMEM_BARS;  // + alignment slack
constexpr size_t DQ_SMEM_PER_TILE = 20;  // per-key bits (16 bytes) and a list entry

// q, k (BH, T, 64), v (BH, Tk, 64), dout (BH, Tq, 64) bf16 as TMA maps; nd =
// -delta (BH, Tq) fp32; mask (BH / heads, Tk) int32 or null; lse (BH, Tq)
// fp32. Writes dq (x ln2, x 1 under SOFTCAP) (BH, Tq, 64) bf16.
template <bool SOFTCAP>
__global__ void __launch_bounds__(DQ_THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
          const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
          const int* __restrict__ mask, const float* __restrict__ nd,
          const float* __restrict__ lse, bf16* __restrict__ dq, int Tq, int Tk, int heads,
          Cap cap) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + DQ_OFF_BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + DQ_STAGES;
  int* sCount = reinterpret_cast<int*>(empty + DQ_STAGES);
  uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + DQ_OFF_BAR + DQ_SMEM_BARS);
  const int ntiles = Tk / DQ_BK;
  int* sList = reinterpret_cast<int*>(sBits + 4 * ntiles);
  const int bh = blockIdx.y;
  const int qrow0 = bh * Tq + blockIdx.x * DQ_BQ;  // the block's first row of q, dO, dq
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
    fence_proxy_async();
    mbar_expect_tx(qbar, 2 * DQ_TILE);
    tma_load_2d(smem + DQ_OFF_Q, &map_q, qbar, 0, qrow0);
    tma_load_2d(smem + DQ_OFF_DO, &map_do, qbar, 0, qrow0);
  }
  // per-key bits (word w of a tile holds keys 32w..32w+31; every key valid
  // without a mask), then the live tiles compacted in order
  const int* mrow = mask == nullptr ? nullptr : mask + (long)(bh / heads) * Tk;
#pragma unroll 4
  for (int tile = warp; tile < ntiles; tile += DQ_THREADS / 32) {
    uint4 b = make_uint4(~0u, ~0u, ~0u, ~0u);
    if (mrow != nullptr) {
      const int* m = mrow + tile * DQ_BK + lane;
      b.x = __ballot_sync(0xffffffffu, m[0] != 0);
      b.y = __ballot_sync(0xffffffffu, m[32] != 0);
      b.z = __ballot_sync(0xffffffffu, m[64] != 0);
      b.w = __ballot_sync(0xffffffffu, m[96] != 0);
    }
    if (lane == 0) *reinterpret_cast<uint4*>(sBits + 4 * tile) = b;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int tile = t0 + lane;
      bool live = false;
      if (tile < ntiles) {
        const uint4 b = *reinterpret_cast<const uint4*>(sBits + 4 * tile);
        live = (b.x | b.y | b.z | b.w) != 0;
      }
      const uint32_t ballot = __ballot_sync(0xffffffffu, live);
      if (live) sList[n + __popc(ballot & ((1u << lane) - 1u))] = tile;
      n += __popc(ballot);
    }
    if (lane == 0) *sCount = n;
  }
  __syncthreads();
  const int n_live = *sCount;

  if (n_live == 0) {  // no valid key for this batch row: dq is exactly 0
    uint4* z = reinterpret_cast<uint4*>(dq + (long)qrow0 * D);
    for (int i = threadIdx.x; i < DQ_BQ * D / 8; i += DQ_THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
    if (threadIdx.x == 0) mbar_wait(qbar, 0);  // no TMA write outlives the block
    return;
  }

  if (warp < 4) {
    // ---- producer: K and V of each live tile --------------------------------------
    setmaxnreg_dec<DQ_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_live; ++i) {
        if (i >= DQ_STAGES) mbar_wait(&empty[stage], phase ^ 1);
        const int row = bh * Tk + sList[i] * DQ_BK;
        mbar_expect_tx(&full[stage], 2 * DQ_TILE);
        tma_load_2d(smem + DQ_OFF_K + stage * DQ_TILE, &map_k, &full[stage], 0, row);
        tma_load_2d(smem + DQ_OFF_V + stage * DQ_TILE, &map_v, &full[stage], 0, row);
        if (++stage == DQ_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: 64 queries each ------------------------------------------------------
  setmaxnreg_inc<DQ_CONSUMER_REGS>();
  const int c = warp / 4 - 1;  // consumer warpgroup: queries 64c..64c+63 of the block
  const int g = lane >> 2, t = lane & 3;
  const int r = 64 * c + 16 * (warp & 3) + g;  // this thread's query rows: r, r + 8
  const long rowA = (long)qrow0 + r, rowB = rowA + 8;
  const float lA = lse[rowA], lB = lse[rowB];
  const float nA = nd[rowA], nB = nd[rowB];

  // dO rows r, r + 8 as A fragments (k-step kk: dims 16kk + 2t, +1 in
  // registers 0 (row r), 1 (row r + 8); dims + 8 in 2, 3), read from the
  // 128-byte swizzle TMA wrote: the 16-byte chunk j of row r sits at
  // j ^ (r & 7), and r & 7 == g. Q stays in shared memory.
  uint32_t da[16];
  mbar_wait(qbar, 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = r * 128 + (((2 * kk + h) ^ g) << 4) + 4 * t;
      da[4 * kk + 2 * h] = *reinterpret_cast<const uint32_t*>(smem + DQ_OFF_DO + off);
      da[4 * kk + 2 * h + 1] = *reinterpret_cast<const uint32_t*>(smem + DQ_OFF_DO + off + 1024);
    }
  }
  const uint64_t desc_q = sw128_desc(smem_u32(smem + DQ_OFF_Q) + 64 * c * 128);

  // S and dP of the two steps of a tile in two register sets (A: the first 64
  // keys, B: the last 64) and their dS fragments, dQ across the sweep
  float sA[32], dpA[32], sB[32], dpB[32], dqacc[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) sA[e] = dpA[e] = sB[e] = dpB[e] = dqacc[e] = 0.f;
  uint32_t dsA[16], dsB[16];  // dS: 4 k-steps of 16 keys x 4 A-fragment registers

  // descriptor of the K or V rows of step half h (64 keys, 8 KB) in stage stg;
  // a k-step of 16 dims (32 bytes) is 2 in the address field, one of 16 keys
  // (2048 bytes) 128 (no carry: shared addresses < 2^18)
  auto step_desc = [&](size_t off, int stg, int h) {
    return sw128_desc(smem_u32(smem + off + stg * DQ_TILE + h * (DQ_STEP * 128)));
  };
  // S = Q K^T (A and B K-major from shared memory) and dP = dO V^T (A from
  // registers) of one step (64 queries x 64 keys), one commit group
  auto issue_s_dp = [&](float (&s)[32], float (&dp)[32], int stg, int h) {
    const uint64_t desc_k = step_desc(DQ_OFF_K, stg, h), desc_v = step_desc(DQ_OFF_V, stg, h);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss<0, 0>(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_rs<0>(dp, da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3],
                            desc_v + 2 * kk, kk > 0);
    wgmma_commit();
  };
  // p, ds per logit of one step and dS as bf16 A fragments: accumulator tile
  // j holds keys 8j + 2t, +1 of rows r (0, 1) and r + 8 (2, 3); A fragment
  // k-step j/2 takes tile j in registers 2(j&1), 2(j&1)+1
  auto ds_frags_of = [&](auto all_valid, uint32_t (&dsa)[16], float (&s)[32], float (&dp)[32],
                         uint32_t w0, uint32_t w1) {
    constexpr bool ALL_VALID = decltype(all_valid)::value;
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < DQ_STEP / 8; ++j) {
      const uint32_t bits = ALL_VALID ? 3u : (j < 4 ? w0 : w1) >> (8 * (j & 3) + 2 * t);
      const bool v0 = (bits & 1u) != 0, v1 = (bits & 2u) != 0;
      const float2 a0 = p_ds<SOFTCAP>(s[4 * j], dp[4 * j], lA, nA, v0, cap);
      const float2 a1 = p_ds<SOFTCAP>(s[4 * j + 1], dp[4 * j + 1], lA, nA, v1, cap);
      const float2 b0 = p_ds<SOFTCAP>(s[4 * j + 2], dp[4 * j + 2], lB, nB, v0, cap);
      const float2 b1 = p_ds<SOFTCAP>(s[4 * j + 3], dp[4 * j + 3], lB, nB, v1, cap);
      const int e = 4 * (j >> 1) + 2 * (j & 1);
      dsa[e] = pack_f2(a0.y, a1.y);
      dsa[e + 1] = pack_f2(b0.y, b1.y);
    }
  };
  // a step whose 64 keys are all valid (every step without a mask) skips the
  // per-key select
  auto ds_frags = [&](uint32_t (&dsa)[16], float (&s)[32], float (&dp)[32], uint32_t w0,
                      uint32_t w1) {
    if ((w0 & w1) == ~0u)
      ds_frags_of(std::true_type(), dsa, s, dp, w0, w1);
    else
      ds_frags_of(std::false_type(), dsa, s, dp, w0, w1);
  };
  // dQ += dS K (queries x dims; K-dim = the step's 64 keys), one commit group
  auto issue_dq = [&](uint32_t (&dsa)[16], int stg, int h) {
    const uint64_t desc_k = step_desc(DQ_OFF_K, stg, h);
    fence_regs(dqacc);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < DQ_STEP / 16; ++kc)
      wgmma_m64n64k16_rs<1>(dqacc, dsa[4 * kc], dsa[4 * kc + 1], dsa[4 * kc + 2],
                            dsa[4 * kc + 3], desc_k + 128 * kc, 1);
    wgmma_commit();
  };

  // Per tile, four commit groups: S, dP of the first 64 keys (A), of the last
  // 64 (B), dQ of A, dQ of B. A's p and ds run while B's S and dP are in
  // flight, B's while A's dQ is; the tile ends with every group complete, so
  // the code between a product and its wait is straight-line.
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_live; ++i) {
    const uint4 b = *reinterpret_cast<const uint4*>(sBits + 4 * sList[i]);
    mbar_wait(&full[stage], phase);
    issue_s_dp(sA, dpA, stage, 0);
    issue_s_dp(sB, dpB, stage, 1);
    wgmma_wait<1>();  // A's S and dP
    ds_frags(dsA, sA, dpA, b.x, b.y);
    issue_dq(dsA, stage, 0);
    wgmma_wait<1>();  // B's S and dP
    ds_frags(dsB, sB, dpB, b.z, b.w);
    issue_dq(dsB, stage, 1);
    wgmma_wait<0>();  // both dQ products: the tile is read
    fence_regs(dqacc);
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == DQ_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // ---- dQ (x ln2, x 1 under softcap), bf16 ------------------------------------------------
  const float qs = out_scale<SOFTCAP>();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(dq + rowA * D + col) =
        pack_f2(dqacc[4 * j] * qs, dqacc[4 * j + 1] * qs);
    *reinterpret_cast<uint32_t*>(dq + rowB * D + col) =
        pack_f2(dqacc[4 * j + 2] * qs, dqacc[4 * j + 3] * qs);
  }
}

// cudaFuncGetAttributes of one instantiation: (registers, local bytes).
template <bool SOFTCAP>
inline int dq_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, dq_kernel<SOFTCAP>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Tq % 128 == 0, Tk % 128 == 0 (the wrapper checks). Returns
// cudaErrorInvalidValue if a tensor map is refused, cudaErrorInvalidConfiguration
// if the kernel was not compiled to the launch bound's register count (its
// setmaxnreg.inc would wait forever), else cudaGetLastError() after the launch.
template <bool SOFTCAP>
inline int launch_dq(const void* q, const void* k, const void* v, const void* mask,
                     const void* dout, const void* nd, const void* lse, void* dq, int BH,
                     int Tq, int Tk, int heads, Cap cap, void* stream) {
  static int regs = 0;  // per instantiation, read once
  if (regs == 0) {
    int local_bytes = 0;
    const int err = dq_attributes<SOFTCAP>(&regs, &local_bytes);
    if (err != 0) return err;
  }
  if (regs != DQ_LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!bf16_rows64_map(&map_q, q, (uint64_t)BH * Tq, DQ_BQ) ||
      !bf16_rows64_map(&map_k, k, (uint64_t)BH * Tk, DQ_BK) ||
      !bf16_rows64_map(&map_v, v, (uint64_t)BH * Tk, DQ_BK) ||
      !bf16_rows64_map(&map_do, dout, (uint64_t)BH * Tq, DQ_BQ))
    return (int)cudaErrorInvalidValue;
  const size_t smem = DQ_SMEM_FIXED + (size_t)(Tk / DQ_BK) * DQ_SMEM_PER_TILE;
  auto kernel = dq_kernel<SOFTCAP>;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != 0) return err;
  kernel<<<dim3(Tq / DQ_BQ, BH), DQ_THREADS, smem, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, map_do, (const int*)mask, (const float*)nd, (const float*)lse,
      (bf16*)dq, Tq, Tk, heads, cap);
  return (int)cudaGetLastError();
}

}  // namespace attn_bwd
}  // namespace rtt
