// The key block of the flash attention backward (rows 6 and 7), for Hopper:
// `dkv_kernel<FUSED_DQ, SOFTCAP>`.
//
//   FUSED_DQ true  (attention_bwd.cu) replaces rap_tpu/ops/pallas_attention.py:506
//         `_flash_bwd_fused_kernel`: dK, dV and this block's share of dQ,
//         added into one fp32 (BH, Tq, 64) accumulator across key blocks.
//   FUSED_DQ false (attention_bwd_split.cu) replaces :426
//         `_flash_bwd_dkv_kernel`: dK and dV only, no atomics, bitwise
//         repeatable.
// Both recompute p and ds through attention_bwd_common.cuh's `p_ds`, the
// arithmetic of `_recompute_p_ds` (:369) that the dQ pass (row 8) shares.
//
// Bound on the H100 (d = 64, per logit 2·2·64 bf16 operations per product,
// 989 TFLOP/s): 5 products with dQ, 4 without. Dense global BH=32, T=8192:
// 1.37 TFLOP, 1.39 ms; masked multi-view global BH=16, T=32768 without dQ:
// 6.24 ms over the keys the mask leaves. The tensor cores bound it; exp2
// (one per logit, 1/256 of the bf16 rate) needs a fifth of that time, and
// the bytes (each operand read once) are far below.
//
// Design (TMA, mbarriers, wgmma, warp specialisation, as csrc/attention.cu).
// A block owns 128 keys of one head and sweeps every query in steps of 64.
// Three warpgroups:
// - a producer warpgroup (registers lowered to 40 by setmaxnreg) whose one
//   elected thread loads the block's K and V once (TMA, 128-byte swizzle) and
//   then streams each step's Q and dO tiles (TMA) with their lse2 and -delta
//   (bulk copies of 256 bytes) through a ring of STAGES stages, each with a
//   full barrier (transaction bytes) and an empty barrier (8 consumer warps);
// - two consumer warpgroups (registers raised to 232), each owning 64 of the
//   keys and keeping their dK and dV (64 x 64 fp32 each) in registers across
//   the whole sweep. Per step: S^T = K Q^T and dP^T = V dO^T by wgmma
//   (m64n64k16, A and B K-major from shared memory); p and ds per logit in
//   registers; P^T and dS^T rounded to bf16 straight into register A
//   fragments (the accumulator of 8 columns maps onto half an A fragment
//   register-locally); dV += P^T dO and dK += dS^T Q by wgmma with A from
//   registers and B MN-major (the transpose bit) from the same Q and dO tiles.
//   The next step's S^T and dP^T are issued right behind this step's
//   products, so the tensor cores never wait for a consumer's wgmma.wait.
// - Row 6's dQ: each consumer stores its dS^T (bf16, 64 keys x 64 queries)
//   into a 128-byte-swizzled tile and multiplies dQ_c = dS_c K_c (A and B
//   MN-major from shared memory) over its own 64 keys, in the same commit
//   group as dV and dK. (Split by query rows instead, each consumer would own
//   32 of the step's 64 queries, below wgmma's M of 64.) Each consumer adds
//   its dQ_c into dq_acc[bh, q0:q0+64, :] by itself: the fp32 tile goes to
//   one of KV_DQ_BUFS shared buffers in the 128-byte swizzle of an fp32
//   tensor map (stores without bank conflicts), at the next step's barrier
//   together with that step's dS^T (one proxy fence, one barrier, no wgmma in
//   flight), and one thread adds it with two TMA tile reduce-adds. Sums in no
//   fixed order: not bitwise repeatable.
//   Tried on the card (NVIDIA H100 80GB HBM3, 700 W; scripts/time_attention_bwd.py,
//   dense global shape): combining the two partials in shared memory first
//   (one reduce per step, half the traffic) couples the consumers and was
//   0.6 ms slower than a reduce per consumer; vector atomics from registers
//   (red.global.add.v2.f32) 1.8 ms slower; linear fp32 buffers (8-way bank
//   conflicts) and no pipelining together 0.6 ms slower.
//   The dQ path still costs ~1.2 ms of the kernel's ~3.25 ms there (the
//   dK/dV pass alone takes ~2.05): its stores and the reduce's reads share
//   the SM's shared-memory bandwidth with the wgmma operand reads, which
//   m64n64k16 from shared memory nearly fills (inferred, not measured).
//
// Mask: a (BH / heads, Tk) int32 key mask; each consumer thread keeps the
// valid bits of its two keys in registers. A block whose 128 keys are all
// masked writes zero dK, dV and returns before loading anything (the TPU
// kernels' pl.when(any(mask)), :441, :485); queries are never skipped (a
// padded query's p is not zero in general).
//
// Inputs with 16-byte row strides for TMA: V (BH, Tk, 64) bf16, dO (BH, Tq,
// 64) bf16, and -delta (BH, Tq) fp32 holding the bf16 values
// (`_neg_delta` in ops/flash_attention.py). Tq % 64 == 0, Tk % 128 == 0; q,
// k, V, dO, lse2 and -delta 16-byte aligned.
//
// ptxas (sm_90a), all four instantiations: 168 registers (the launch bound
// for 384 threads; setmaxnreg moves them to 40 / 232), no stack, no spills;
// dynamic shared memory 194 KB. `launch_dkv` refuses to launch a build with
// another register count, since setmaxnreg.inc would then wait forever.
// ptxas reports one injected warpgroup.wait per instantiation, where the
// loop is entered (once per block).
#pragma once

#include "attention_bwd_common.cuh"
#include "hopper.cuh"

namespace rtt {
namespace attn_bwd {

constexpr int KV_BQ = 64;           // queries per step
constexpr int KV_BK = 128;          // keys per block, 64 per consumer warpgroup
constexpr int KV_STAGES = 3;        // Q / dO ring depth
constexpr int KV_THREADS = 384;     // producer + 2 consumer warpgroups
constexpr int KV_PRODUCER_REGS = 40;
constexpr int KV_CONSUMER_REGS = 232;  // 40 + 2 x 232 = 3 x 168 (launch bound)
constexpr int KV_LAUNCH_REGS = 168;
constexpr uint32_t KV_KTILE = KV_BK * D * 2;  // 128 x 64 bf16: 16 KB
constexpr uint32_t KV_QTILE = KV_BQ * D * 2;  // 64 x 64 bf16: 8 KB
constexpr uint32_t KV_VEC = KV_BQ * 4;        // 64 fp32: 256 bytes
constexpr uint32_t KV_DQ = KV_BQ * D * 4;     // a 64 x 64 fp32 dQ tile: 16 KB
constexpr int KV_DQ_BUFS = 3;                 // dQ tiles per consumer in flight to the reduce
// shared memory, from a 1024-byte aligned base
constexpr size_t KV_OFF_K = 0;
constexpr size_t KV_OFF_V = KV_KTILE;
constexpr size_t KV_OFF_Q = 2 * (size_t)KV_KTILE;                  // STAGES tiles
constexpr size_t KV_OFF_DO = KV_OFF_Q + KV_STAGES * KV_QTILE;      // STAGES tiles
constexpr size_t KV_OFF_DS = KV_OFF_DO + KV_STAGES * KV_QTILE;     // dS^T, 128 x 64 bf16
constexpr size_t KV_OFF_DQ = KV_OFF_DS + KV_KTILE;                 // 2 x DQ_BUFS dQ tiles
constexpr size_t KV_OFF_VEC = KV_OFF_DQ + 2 * KV_DQ_BUFS * (size_t)KV_DQ;  // STAGES x (lse2, -delta)
constexpr size_t KV_OFF_BAR = KV_OFF_VEC + KV_STAGES * 2 * KV_VEC;
constexpr size_t KV_SMEM = 1024 + KV_OFF_BAR + 8 * (1 + 2 * KV_STAGES);
constexpr int KV_BAR_WG = 1;  // named barrier (0 is __syncthreads) + consumer: its 128 threads

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// A consumer's dQ tile (64 queries x 64 dims, fp32 accumulator of this thread:
// rows rA, rA + 8) into `buf` as two 64 x 32 boxes in the 128-byte swizzle of
// an fp32 tensor map (chunk k of row r at k ^ (r & 7); r & 7 == g).
__device__ __forceinline__ void store_dq(const float (&dq)[32], uint8_t* buf, int rA, int g,
                                         int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    uint8_t* p = buf + (j >> 2) * (KV_DQ / 2) + (((2 * (j & 3) + (t >> 1)) ^ g) << 4) +
                 8 * (t & 1);
    *reinterpret_cast<float2*>(p + rA * 128) = make_float2(dq[4 * j], dq[4 * j + 1]);
    *reinterpret_cast<float2*>(p + (rA + 8) * 128) = make_float2(dq[4 * j + 2], dq[4 * j + 3]);
  }
}

// After the warpgroup barrier that follows store_dq: the consumer's first
// thread adds buffer `buf` into dq_acc rows [row, row + 64) by two tile
// reduces, then waits until the reduce KV_DQ_BUFS - 1 before it has read its
// buffer, the next one to be stored; every thread moves on to that buffer.
__device__ __forceinline__ void reduce_dq(const CUtensorMap& map_dq, uint8_t* sDQ,
                                          int& buf, int row, int c) {
  if (threadIdx.x == 128 * (c + 1)) {
    tma_reduce_add_2d(&map_dq, sDQ + buf * KV_DQ, 0, row);
    tma_reduce_add_2d(&map_dq, sDQ + buf * KV_DQ + KV_DQ / 2, 32, row);
    bulk_commit();
    bulk_wait_read<KV_DQ_BUFS - 1>();
  }
  if (++buf == KV_DQ_BUFS) buf = 0;
}

// q, k (BH, T, 64), v (BH, Tk, 64), dout (BH, Tq, 64) bf16 as TMA maps; nd =
// -delta (BH, Tq) fp32; mask (BH / heads, Tk) int32 or null; lse (BH, Tq)
// fp32. dk (x ln2, x 1 under SOFTCAP), dv (BH, Tk, 64) bf16.
// FUSED_DQ: map_dq over dq_acc (BH, Tq, 64) fp32, zeroed by the caller, which
// receives sum ds K (unused without).
template <bool FUSED_DQ, bool SOFTCAP>
__global__ void __launch_bounds__(KV_THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
           const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
           const __grid_constant__ CUtensorMap map_dq, const int* __restrict__ mask,
           const float* __restrict__ nd, const float* __restrict__ lse, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int Tq, int Tk, int heads, Cap cap) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int bh = blockIdx.y, k0 = blockIdx.x * KV_BK;
  const int krow0 = bh * Tk + k0;
  const int* mrow = mask == nullptr ? nullptr : mask + (long)(bh / heads) * Tk + k0;

  // A key block with no valid key writes zeros and stops.
  const int live = threadIdx.x < KV_BK && (mrow == nullptr || mrow[threadIdx.x] != 0);
  if (!__syncthreads_or(live)) {
    uint4* zk = reinterpret_cast<uint4*>(dk + (long)krow0 * D);
    uint4* zv = reinterpret_cast<uint4*>(dv + (long)krow0 * D);
    for (int i = threadIdx.x; i < KV_BK * D / 8; i += KV_THREADS)
      zk[i] = zv[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + KV_OFF_BAR);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + KV_STAGES;
  float* sVec = reinterpret_cast<float*>(smem + KV_OFF_VEC);  // per stage: lse2[64], nd[64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nsteps = Tq / KV_BQ;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
    fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: K and V once, then the Q / dO ring --------------------------
    setmaxnreg_dec<KV_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * KV_KTILE);
      tma_load_2d(smem + KV_OFF_K, &map_k, kvbar, 0, krow0);
      tma_load_2d(smem + KV_OFF_V, &map_v, kvbar, 0, krow0);
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < nsteps; ++i) {
        if (i >= KV_STAGES) mbar_wait(&empty[stage], phase ^ 1);
        const int row = bh * Tq + i * KV_BQ;
        mbar_expect_tx(&full[stage], 2 * KV_QTILE + 2 * KV_VEC);
        tma_load_2d(smem + KV_OFF_Q + stage * KV_QTILE, &map_q, &full[stage], 0, row);
        tma_load_2d(smem + KV_OFF_DO + stage * KV_QTILE, &map_do, &full[stage], 0, row);
        bulk_load(sVec + stage * 2 * KV_BQ, lse + row, KV_VEC, &full[stage]);
        bulk_load(sVec + stage * 2 * KV_BQ + KV_BQ, nd + row, KV_VEC, &full[stage]);
        if (++stage == KV_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: 64 keys each -------------------------------------------------------
  setmaxnreg_inc<KV_CONSUMER_REGS>();
  const int c = warp / 4 - 1;  // consumer warpgroup: keys 64c..64c+63 of the block
  const int wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kA = 64 * c + 16 * wq + g, kB = kA + 8;  // this thread's keys in the block
  const int rA = 16 * wq + g;  // this thread's dQ rows (queries of the step): rA, rA + 8
  const bool validA = mrow == nullptr || mrow[kA] != 0;
  const bool validB = mrow == nullptr || mrow[kB] != 0;
  const uint32_t k_addr = smem_u32(smem + KV_OFF_K) + 64 * c * 128;  // this consumer's rows
  const uint32_t v_addr = smem_u32(smem + KV_OFF_V) + 64 * c * 128;
  const uint32_t ds_addr = smem_u32(smem + KV_OFF_DS) + 64 * c * 128;
  // descriptors of this consumer's tiles; a k-step of 16 rows (2048 bytes) is
  // 128 in the descriptor's address field (no carry: shared addresses < 2^18)
  const uint64_t desc_k = sw128_desc(k_addr), desc_v = sw128_desc(v_addr);
  const uint64_t desc_ds = sw128_desc(ds_addr);
  uint8_t* sDQ = smem + KV_OFF_DQ + KV_DQ_BUFS * c * KV_DQ;  // this consumer's dQ buffers
  int dq_buf = 0;

  float dkacc[32], dvacc[32], st[32], dpt[32], dq[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dkacc[e] = dvacc[e] = st[e] = dpt[e] = dq[e] = 0.f;
  uint32_t pa[16], dsa[16];  // P^T, dS^T: 4 k-steps of 16 queries x 4 A-fragment registers

  // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries) of the step in stage
  // `stg`, one commit group
  auto issue_s_dp = [&](int stg) {
    const uint64_t desc_q = sw128_desc(smem_u32(smem + KV_OFF_Q + stg * KV_QTILE));
    const uint64_t desc_do = sw128_desc(smem_u32(smem + KV_OFF_DO + stg * KV_QTILE));
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss<0, 0>(st, desc_k + 2 * kk, desc_q + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64k16_ss<0, 0>(dpt, desc_v + 2 * kk, desc_do + 2 * kk, kk > 0);
    wgmma_commit();
  };

  mbar_wait(kvbar, 0);
  mbar_wait(&full[0], 0);
  issue_s_dp(0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < nsteps; ++i) {
    const uint64_t desc_q = sw128_desc(smem_u32(smem + KV_OFF_Q + stage * KV_QTILE));
    const uint64_t desc_do = sw128_desc(smem_u32(smem + KV_OFF_DO + stage * KV_QTILE));
    const float* sLse = sVec + stage * 2 * KV_BQ;
    const float* sND = sLse + KV_BQ;
    wgmma_wait<0>();  // this step's S^T and dP^T
    fence_regs(st);
    fence_regs(dpt);

    // ---- p, ds per logit; P^T and dS^T as bf16 A fragments --------------------------
    // accumulator tile j holds queries 8j + 2t, +1 of keys kA (0, 1) and kB (2, 3);
    // A fragment k-step j/2 takes tile j in registers 2(j&1), 2(j&1)+1
#pragma unroll
    for (int j = 0; j < KV_BQ / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(sLse + 8 * j + 2 * t);
      const float2 n = *reinterpret_cast<const float2*>(sND + 8 * j + 2 * t);
      const float2 a0 = p_ds<SOFTCAP>(st[4 * j], dpt[4 * j], l.x, n.x, validA, cap);
      const float2 a1 = p_ds<SOFTCAP>(st[4 * j + 1], dpt[4 * j + 1], l.y, n.y, validA, cap);
      const float2 b0 = p_ds<SOFTCAP>(st[4 * j + 2], dpt[4 * j + 2], l.x, n.x, validB, cap);
      const float2 b1 = p_ds<SOFTCAP>(st[4 * j + 3], dpt[4 * j + 3], l.y, n.y, validB, cap);
      const int r = 4 * (j >> 1) + 2 * (j & 1);
      pa[r] = pack_f2(a0.x, a1.x);
      pa[r + 1] = pack_f2(b0.x, b1.x);
      dsa[r] = pack_f2(a0.y, a1.y);
      dsa[r + 1] = pack_f2(b0.y, b1.y);
    }
    if constexpr (FUSED_DQ) {
      // dS^T rows kA, kB (keys) x queries, in TMA's 128-byte swizzle: the 16-byte
      // chunk j of row r sits at chunk j ^ (r & 7); kA & 7 == kB & 7 == g. The
      // previous step's dQ product has read the tile (its wgmma_wait).
      const uint32_t base = smem_u32(smem + KV_OFF_DS);
#pragma unroll
      for (int j = 0; j < KV_BQ / 8; ++j) {
        const int r = 4 * (j >> 1) + 2 * (j & 1);
        const uint32_t col = ((j ^ g) << 4) + 4 * t;
        st_shared_u32(base + kA * 128 + col, dsa[r]);
        st_shared_u32(base + kB * 128 + col, dsa[r + 1]);
      }
      // the previous step's dQ, stored here where no wgmma reads shared memory, so
      // one proxy fence and one barrier serve both tiles
      if (i > 0) store_dq(dq, sDQ + dq_buf * KV_DQ, rA, g, t);
      fence_proxy_async();  // the generic stores, visible to wgmma and the reduce
      bar_sync(KV_BAR_WG + c, 128);
      if (i > 0) reduce_dq(map_dq, sDQ, dq_buf, bh * Tq + (i - 1) * KV_BQ, c);
    }

    // ---- dV += P^T dO, dK += dS^T Q (keys x dims); dQ_c = dS_c K_c (queries x dims)
    fence_regs(dvacc);
    fence_regs(dkacc);
    fence_regs(pa);
    fence_regs(dsa);
    if constexpr (FUSED_DQ) fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < KV_BQ / 16; ++kc)  // 16 queries (rows of dO, Q) per k-step
      wgmma_m64n64k16_rs(dvacc, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                         desc_do + 128 * kc, 1);
#pragma unroll
    for (int kc = 0; kc < KV_BQ / 16; ++kc)
      wgmma_m64n64k16_rs(dkacc, dsa[4 * kc], dsa[4 * kc + 1], dsa[4 * kc + 2], dsa[4 * kc + 3],
                         desc_q + 128 * kc, 1);
    if constexpr (FUSED_DQ) {
#pragma unroll
      for (int kc = 0; kc < 64 / 16; ++kc)  // 16 keys (rows of dS^T, K) per k-step
        wgmma_m64n64k16_ss<1, 1>(dq, desc_ds + 128 * kc, desc_k + 128 * kc, kc > 0);
    }
    wgmma_commit();

    // ---- the next step's S^T and dP^T queue behind this step's products. After the
    // last step they read a stage no load overwrites any more and are not used: the
    // same instructions on every path keep ptxas from waiting on in-flight
    // accumulators (its injected warpgroup.wait) where the paths meet.
    const int this_stage = stage;
    if (++stage == KV_STAGES) {
      stage = 0;
      phase ^= 1;
    }
    if (i + 1 < nsteps) mbar_wait(&full[stage], phase);
    issue_s_dp(stage);
    wgmma_wait<1>();  // this step's products
    fence_regs(dvacc);
    fence_regs(dkacc);
    if constexpr (FUSED_DQ) fence_regs(dq);
    if (lane == 0) mbar_arrive(&empty[this_stage]);  // its Q, dO, lse2, -delta are read
  }
  wgmma_wait<0>();  // the unused products after the last step
  if constexpr (FUSED_DQ) {  // the last step's dQ
    store_dq(dq, sDQ + dq_buf * KV_DQ, rA, g, t);
    fence_proxy_async();
    bar_sync(KV_BAR_WG + c, 128);
    reduce_dq(map_dq, sDQ, dq_buf, bh * Tq + (nsteps - 1) * KV_BQ, c);
    if (threadIdx.x == 128 * (c + 1)) bulk_wait<0>();  // shared memory outlives the reduces
  }

  // ---- dK (x ln2, x 1 under softcap) and dV, bf16 ---------------------------------------
  const float ks = out_scale<SOFTCAP>();
  const long rowA = (long)krow0 + kA, rowB = (long)krow0 + kB;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + rowA * D + col) =
        pack_f2(dkacc[4 * j] * ks, dkacc[4 * j + 1] * ks);
    *reinterpret_cast<uint32_t*>(dk + rowB * D + col) =
        pack_f2(dkacc[4 * j + 2] * ks, dkacc[4 * j + 3] * ks);
    *reinterpret_cast<uint32_t*>(dv + rowA * D + col) = pack_f2(dvacc[4 * j], dvacc[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(dv + rowB * D + col) = pack_f2(dvacc[4 * j + 2], dvacc[4 * j + 3]);
  }
}

// cudaFuncGetAttributes of one instantiation: (registers, local bytes).
template <bool FUSED_DQ, bool SOFTCAP>
inline int dkv_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, dkv_kernel<FUSED_DQ, SOFTCAP>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Tq % 64 == 0, Tk % 128 == 0 (the wrapper checks). Returns
// cudaErrorInvalidValue if a tensor map is refused, cudaErrorInvalidConfiguration
// if the kernel was not compiled to the launch bound's register count (its
// setmaxnreg.inc would wait forever), else cudaGetLastError() after the launch.
template <bool FUSED_DQ, bool SOFTCAP>
inline int launch_dkv(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const void* nd, const void* lse, void* dq_acc, void* dk,
                      void* dv, int BH, int Tq, int Tk, int heads, Cap cap, void* stream) {
  static int regs = 0;  // per instantiation, read once
  if (regs == 0) {
    int local_bytes = 0;
    const int err = dkv_attributes<FUSED_DQ, SOFTCAP>(&regs, &local_bytes);
    if (err != 0) return err;
  }
  if (regs != KV_LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_q, map_k, map_v, map_do, map_dq = {};
  if (!bf16_rows64_map(&map_q, q, (uint64_t)BH * Tq, KV_BQ) ||
      !bf16_rows64_map(&map_k, k, (uint64_t)BH * Tk, KV_BK) ||
      !bf16_rows64_map(&map_v, v, (uint64_t)BH * Tk, KV_BK) ||
      !bf16_rows64_map(&map_do, dout, (uint64_t)BH * Tq, KV_BQ) ||
      (FUSED_DQ && !f32_box32_map(&map_dq, dq_acc, (uint64_t)BH * Tq, D, KV_BQ)))
    return (int)cudaErrorInvalidValue;
  auto kernel = dkv_kernel<FUSED_DQ, SOFTCAP>;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)KV_SMEM);
  if (err != 0) return err;
  kernel<<<dim3(Tk / KV_BK, BH), KV_THREADS, KV_SMEM, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, map_do, map_dq, (const int*)mask, (const float*)nd,
      (const float*)lse, (bf16*)dk, (bf16*)dv, Tq, Tk, heads, cap);
  return (int)cudaGetLastError();
}

}  // namespace attn_bwd
}  // namespace rtt
