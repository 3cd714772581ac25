// The dQ pass of the split flash attention backward at head width 128 (rows
// 8 and 8s, heads of 64 < d <= 128 zero-padded to 128): `dq128_kernel<SOFTCAP>`,
// the 128-wide counterpart of attention_bwd_dq.cuh's `dq_kernel`, replacing
// the same TPU kernel, rap_tpu/ops/pallas_attention.py:471
// `_flash_bwd_dq_kernel`: dQ = ln2 · sum over keys of dS K (x 1 under
// softcap), in fp32, written once as bf16. Every logit goes through
// attention_bwd_common.cuh's `p_ds`. No atomics, no zero-fill: bitwise
// repeatable.
//
// Bound on the H100: 3 products (S, dP, dQ) of 2·d bf16 operations per logit
// at 989 TFLOP/s, and one exp2 per logit on the special-function units.
//
// Design: the 64-wide pass's (a block owns 128 queries of one head, 64 per
// consumer warpgroup, and walks the live key tiles of 128 keys in two steps of
// 64; the same live-tile prologue, producer warpgroup and ring), with what 128
// columns change:
// - a K or V tile is 32 KB (two 64-column boxes), so the ring has 2 stages
//   (Q 32 KB + dO 32 KB + 2 x (K + V) 128 KB);
// - dQ is 64 x 128 fp32, 64 registers a thread (two 64-column halves), so a
//   step is serial: S = Q K^T and dP = dO V^T (A and B K-major from shared
//   memory, 8 k-steps over two boxes) into registers zeroed right before
//   them; wait; p and ds; dQ += dS K (A from registers, B MN-major, one
//   product per half); wait. At most dQ 64 + S 32 + dP 32 + dS 16 registers.
//   Q and dO stay in shared memory.
// A step whose 64 keys are all valid skips the per-key select.
//
// Inputs: q, k, V, dO (BH, T, 128) bf16 (zero-padded past d); -delta (BH, Tq)
// fp32. Tq % 128 == 0, Tk % 128 == 0; q, k, V, dO, lse2 and -delta 16-byte
// aligned.
//
// ptxas (sm_90a), both instantiations: 168 registers (the launch bound for
// 384 threads; setmaxnreg moves them to 40 / 232) and no local memory;
// `launch_dq128` refuses to launch a build with another register count.
#pragma once

#include <type_traits>

#include "attention_bwd_common.cuh"
#include "hopper.cuh"

namespace rtt {
namespace attn_bwd {

constexpr int Q8_STAGES = 2;                     // K / V ring depth
constexpr uint32_t Q8_BOX = 128 * 64 * 2;        // 128 rows x 64 bf16: 16 KB
constexpr uint32_t Q8_TILE = 2 * Q8_BOX;         // 128 rows x 128 bf16: 32 KB
// shared memory, from a 1024-byte aligned base
constexpr size_t Q8_OFF_Q = 0;
constexpr size_t Q8_OFF_DO = Q8_TILE;
constexpr size_t Q8_OFF_K = 2 * (size_t)Q8_TILE;                      // STAGES tiles
constexpr size_t Q8_OFF_V = Q8_OFF_K + Q8_STAGES * (size_t)Q8_TILE;   // STAGES tiles
constexpr size_t Q8_OFF_BAR = Q8_OFF_V + Q8_STAGES * (size_t)Q8_TILE;
constexpr size_t Q8_SMEM_FIXED = 1024 + Q8_OFF_BAR + DQ_SMEM_BARS;  // + alignment slack

// q, k, v, dout (BH, T, 128) bf16 as TMA maps; nd = -delta (BH, Tq) fp32;
// mask (BH / heads, Tk) int32 or null; lse (BH, Tq) fp32.
// Writes dq (x ln2, x 1 under SOFTCAP) (BH, Tq, 128) bf16.
template <bool SOFTCAP>
__global__ void __launch_bounds__(DQ_THREADS, 1)
dq128_kernel(const __grid_constant__ CUtensorMap map_q,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_v,
             const __grid_constant__ CUtensorMap map_do, const int* __restrict__ mask,
             const float* __restrict__ nd, const float* __restrict__ lse,
             bf16* __restrict__ dq, int Tq, int Tk, int heads, Cap cap) {
  constexpr int W = 128;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + Q8_OFF_BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + Q8_STAGES;
  int* sCount = reinterpret_cast<int*>(empty + Q8_STAGES);
  uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + Q8_OFF_BAR + DQ_SMEM_BARS);
  const int ntiles = Tk / DQ_BK;
  int* sList = reinterpret_cast<int*>(sBits + 4 * ntiles);
  const int bh = blockIdx.y;
  const int qrow0 = bh * Tq + blockIdx.x * DQ_BQ;  // the block's first row of q, dO, dq
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < Q8_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
    fence_proxy_async();
    mbar_expect_tx(qbar, 2 * Q8_TILE);
    for (int b = 0; b < 2; ++b) {
      tma_load_2d(smem + Q8_OFF_Q + b * Q8_BOX, &map_q, qbar, 64 * b, qrow0);
      tma_load_2d(smem + Q8_OFF_DO + b * Q8_BOX, &map_do, qbar, 64 * b, qrow0);
    }
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
    uint4* z = reinterpret_cast<uint4*>(dq + (long)qrow0 * W);
    for (int i = threadIdx.x; i < DQ_BQ * W / 8; i += DQ_THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
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
        if (i >= Q8_STAGES) mbar_wait(&empty[stage], phase ^ 1);
        const int row = bh * Tk + sList[i] * DQ_BK;
        mbar_expect_tx(&full[stage], 2 * Q8_TILE);
        for (int b = 0; b < 2; ++b) {
          tma_load_2d(smem + Q8_OFF_K + stage * Q8_TILE + b * Q8_BOX, &map_k, &full[stage],
                      64 * b, row);
          tma_load_2d(smem + Q8_OFF_V + stage * Q8_TILE + b * Q8_BOX, &map_v, &full[stage],
                      64 * b, row);
        }
        if (++stage == Q8_STAGES) {
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
  // this consumer's 64 rows of box b of Q and dO: Q8_BOX b on, 64c rows in; a
  // k-step of 16 columns (32 bytes) is 2 in the descriptor's address field, one
  // of 16 rows (2048 bytes) 128 (no carry: shared addresses < 2^18)
  const uint32_t q_addr = smem_u32(smem + Q8_OFF_Q) + 64 * c * 128;
  const uint32_t do_addr = smem_u32(smem + Q8_OFF_DO) + 64 * c * 128;

  float dq0[32], dq1[32];  // dQ columns 0-63 and 64-127
#pragma unroll
  for (int e = 0; e < 32; ++e) dq0[e] = dq1[e] = 0.f;

  // p, ds per logit of one step and dS as bf16 A fragments: accumulator tile
  // j holds keys 8j + 2t, +1 of rows r (0, 1) and r + 8 (2, 3); A fragment
  // k-step j/2 takes tile j in registers 2(j&1), 2(j&1)+1
  auto ds_frags_of = [&](auto all_valid, uint32_t (&dsa)[16], float (&s)[32], float (&dp)[32],
                         uint32_t w0, uint32_t w1) {
    constexpr bool ALL_VALID = decltype(all_valid)::value;
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

  mbar_wait(qbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_live; ++i) {
    const uint4 bits = *reinterpret_cast<const uint4*>(sBits + 4 * sList[i]);
    mbar_wait(&full[stage], phase);
    const uint32_t k_addr = smem_u32(smem + Q8_OFF_K + stage * Q8_TILE);
    const uint32_t v_addr = smem_u32(smem + Q8_OFF_V + stage * Q8_TILE);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // keys 64h..64h+63 of the tile
      // ---- S = Q K^T, dP = dO V^T (64 queries x 64 keys, K-dim 128) ---------------
      float s[32], dp[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = dp[e] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const uint64_t dqd = sw128_desc(q_addr + b * Q8_BOX);
        const uint64_t dkd = sw128_desc(k_addr + b * Q8_BOX + h * 64 * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0, 0>(s, dqd + 2 * kk, dkd + 2 * kk, 1);
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const uint64_t dod = sw128_desc(do_addr + b * Q8_BOX);
        const uint64_t dvd = sw128_desc(v_addr + b * Q8_BOX + h * 64 * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss<0, 0>(dp, dod + 2 * kk, dvd + 2 * kk, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // ---- p, ds; a step whose 64 keys are all valid skips the per-key select ----------
      uint32_t dsa[16];
      const uint32_t w0 = h ? bits.z : bits.x, w1 = h ? bits.w : bits.y;
      if ((w0 & w1) == ~0u)
        ds_frags_of(std::true_type(), dsa, s, dp, w0, w1);
      else
        ds_frags_of(std::false_type(), dsa, s, dp, w0, w1);

      // ---- dQ += dS K (queries x dims; K-dim = the step's 64 keys), per half -------
      fence_regs(dq0);
      fence_regs(dq1);
      fence_regs(dsa);
      wgmma_fence();
      const uint64_t dk0 = sw128_desc(k_addr + h * 64 * 128);
      const uint64_t dk1 = sw128_desc(k_addr + Q8_BOX + h * 64 * 128);
#pragma unroll
      for (int kc = 0; kc < DQ_STEP / 16; ++kc) {
        wgmma_m64n64k16_rs<1>(dq0, dsa[4 * kc], dsa[4 * kc + 1], dsa[4 * kc + 2],
                              dsa[4 * kc + 3], dk0 + 128 * kc, 1);
        wgmma_m64n64k16_rs<1>(dq1, dsa[4 * kc], dsa[4 * kc + 1], dsa[4 * kc + 2],
                              dsa[4 * kc + 3], dk1 + 128 * kc, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq0);
      fence_regs(dq1);
    }
    if (lane == 0) mbar_arrive(&empty[stage]);  // the tile is read
    if (++stage == Q8_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  // ---- dQ (x ln2, x 1 under softcap), bf16 ------------------------------------------------
  const float qs = out_scale<SOFTCAP>();
  auto store = [&](const float (&acc)[32], int col0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dq + rowA * W + col) =
          pack_f2(acc[4 * j] * qs, acc[4 * j + 1] * qs);
      *reinterpret_cast<uint32_t*>(dq + rowB * W + col) =
          pack_f2(acc[4 * j + 2] * qs, acc[4 * j + 3] * qs);
    }
  };
  store(dq0, 0);
  store(dq1, 64);
}

// cudaFuncGetAttributes of one instantiation: (registers, local bytes).
template <bool SOFTCAP>
inline int dq128_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, dq128_kernel<SOFTCAP>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Tq % 128 == 0, Tk % 128 == 0 (the wrapper checks); q, k, v, dout (BH, T,
// 128). Returns as launch_dq does.
template <bool SOFTCAP>
inline int launch_dq128(const void* q, const void* k, const void* v, const void* mask,
                        const void* dout, const void* nd, const void* lse, void* dq, int BH,
                        int Tq, int Tk, int heads, Cap cap, void* stream) {
  static int regs = 0;  // per instantiation, read once
  if (regs == 0) {
    int local_bytes = 0;
    const int err = dq128_attributes<SOFTCAP>(&regs, &local_bytes);
    if (err != 0) return err;
  }
  if (regs != DQ_LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_q, map_k, map_v, map_do;
  if (!bf16_box64_map(&map_q, q, (uint64_t)BH * Tq, 128, DQ_BQ) ||
      !bf16_box64_map(&map_k, k, (uint64_t)BH * Tk, 128, DQ_BK) ||
      !bf16_box64_map(&map_v, v, (uint64_t)BH * Tk, 128, DQ_BK) ||
      !bf16_box64_map(&map_do, dout, (uint64_t)BH * Tq, 128, DQ_BQ))
    return (int)cudaErrorInvalidValue;
  const size_t smem = Q8_SMEM_FIXED + (size_t)(Tk / DQ_BK) * DQ_SMEM_PER_TILE;
  auto kernel = dq128_kernel<SOFTCAP>;
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
