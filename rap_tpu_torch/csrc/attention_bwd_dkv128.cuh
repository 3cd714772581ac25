// The key block of the flash attention backward at head width 128 (rows 6
// and 7, heads of 64 < d <= 128 zero-padded to 128): `dkv128_kernel<FUSED_DQ,
// SOFTCAP>`, the 128-wide counterpart of attention_bwd_dkv.cuh's 64-wide
// `dkv_kernel`, replacing the same TPU kernels:
//   FUSED_DQ true  (attention_bwd.cu) rap_tpu/ops/pallas_attention.py:506
//         `_flash_bwd_fused_kernel`: dK, dV and the block's dQ, added into
//         one fp32 (BH, Tq, 128) accumulator across key blocks.
//   FUSED_DQ false (attention_bwd_split.cu) :426 `_flash_bwd_dkv_kernel`:
//         dK and dV only, no atomics, bitwise repeatable.
// Every logit goes through attention_bwd_common.cuh's `p_ds`.
//
// Bound on the H100 (per logit 2·2·d bf16 operations per product at 989
// TFLOP/s; 5 products with dQ, 4 without): the tensor cores, as at 64 wide.
//
// Why a design of its own: the 64-wide kernel keeps dK, dV, S^T, dP^T and the
// fused dQ tile (32 fp32 registers each), P^T and dS^T (16 each) live at once,
// and queues the next step's S^T, dP^T behind this step's products: 192
// registers. At 128 wide dK and dV alone take 64 each, so that schedule would
// need 256 of the 232 a consumer gets. Here
// - S^T and dP^T are zeroed right before their first product and dead after
//   their last read, so a consumer thread holds dK and dV (2 x 64 fp32) plus
//   either S^T and dP^T (2 x 32) or the products' operands;
// - a step is serial within a consumer: S^T, dP^T; wait; p, ds; the products;
//   wait. The two consumer warpgroups overlap each other's phases;
// - row 6's dQ is one product per consumer over all 128 keys of the block:
//   both consumers store their dS^T (bf16, 64 keys x 64 queries) into one
//   128-key tile, meet at a named barrier of 256 threads, and consumer c
//   multiplies dQ[:, 64c:64c+64] = dS (64 queries x 128 keys) K[:, 64c:64c+64]
//   (A and B MN-major from shared memory), so a block adds one 64 x 128 fp32
//   tile a step into dq_acc (as the 64-wide kernel does at its width) with
//   two TMA tile reduce-adds per consumer. Sums in no fixed order: not bitwise
//   repeatable. The product runs as two m64n32 halves (16 registers each),
//   each stored into its 32-column box of the consumer's fp32 buffer: with
//   one 64-column accumulator ptxas found no room for a seventh 32-register
//   block beside dK, dV, S^T and dP^T, spilled one (128 bytes, every fused
//   instantiation) and serialised every wgmma (SASS read on the card). The
//   dS^T tile is double-buffered: a step's stores go to the buffer whose last
//   reader (two steps back) both consumers waited for before the previous
//   step's barrier. Row 6 also stores P^T into a tile of its own and reads
//   both P^T and dS^T from shared memory (K-major A) in its dV and dK
//   products, so it holds no A fragments; each pair goes to shared memory as
//   p_ds makes it.
// - the ring holds 2 stages of Q and dO (16 KB each a stage).
// Shared memory: K and V 32 KB each, 2 x (Q + dO) 64 KB, 2 dS^T tiles 32 KB,
// a P^T tile 16 KB, one 16 KB fp32 dQ buffer a consumer, lse2 and -delta 1 KB:
// 209 KB + 1 KB of alignment slack.
//
// The rest is the 64-wide kernel's: a block owns 128 keys of one head, 64 per
// consumer warpgroup, and sweeps every query in steps of 64; a producer
// warpgroup streams Q, dO (TMA, 128-byte swizzle, two 64-column boxes a row)
// with lse2 and -delta (bulk copies); each consumer keeps its keys' dK and dV
// in fp32 registers for the sweep; P^T and dS^T are rounded to bf16 straight
// into wgmma A fragments; a key block with no valid key writes zero dK, dV
// and returns before loading anything.
//
// Inputs: q, k, V, dO (BH, T, 128) bf16 (zero-padded past d); -delta (BH, Tq)
// fp32; Tq % 64 == 0, Tk % 128 == 0; q, k, V, dO, lse2 and -delta 16-byte
// aligned.
//
// ptxas (sm_90a), all four instantiations: 168 registers (the launch bound
// for 384 threads; setmaxnreg moves them to 40 / 232) and no local memory;
// `launch_dkv128` refuses to launch a build with another register count.
#pragma once

#include "attention_bwd_common.cuh"
#include "hopper.cuh"

namespace rtt {
namespace attn_bwd {

constexpr int W128 = 128;             // head width of this kernel
constexpr int K8_BQ = 64;             // queries per step
constexpr int K8_BK = 128;            // keys per block, 64 per consumer warpgroup
constexpr int K8_STAGES = 2;          // Q / dO ring depth
constexpr uint32_t K8_KBOX = K8_BK * 64 * 2;   // 128 keys x 64 columns bf16: 16 KB
constexpr uint32_t K8_QBOX = K8_BQ * 64 * 2;   // 64 queries x 64 columns bf16: 8 KB
constexpr uint32_t K8_KTILE = 2 * K8_KBOX;     // K or V of the block: 32 KB
constexpr uint32_t K8_QTILE = 2 * K8_QBOX;     // Q or dO of a step: 16 KB
constexpr uint32_t K8_DS = K8_BK * K8_BQ * 2;  // dS^T, 128 keys x 64 queries bf16: 16 KB
constexpr uint32_t K8_DQ = K8_BQ * 64 * 4;     // a consumer's 64 x 64 fp32 dQ tile: 16 KB
// shared memory, from a 1024-byte aligned base
constexpr size_t K8_OFF_K = 0;
constexpr size_t K8_OFF_V = K8_KTILE;
constexpr size_t K8_OFF_Q = 2 * (size_t)K8_KTILE;                  // STAGES tiles
constexpr size_t K8_OFF_DO = K8_OFF_Q + K8_STAGES * K8_QTILE;      // STAGES tiles
constexpr size_t K8_OFF_DS = K8_OFF_DO + K8_STAGES * K8_QTILE;     // 2 dS^T tiles
constexpr size_t K8_OFF_PT = K8_OFF_DS + 2 * (size_t)K8_DS;        // P^T, 128 keys x 64 queries
constexpr size_t K8_OFF_DQ = K8_OFF_PT + (size_t)K8_DS;             // 2 dQ tiles
constexpr size_t K8_OFF_VEC = K8_OFF_DQ + 2 * (size_t)K8_DQ;       // STAGES x (lse2, -delta)
constexpr size_t K8_OFF_BAR = K8_OFF_VEC + K8_STAGES * 2 * KV_VEC;
constexpr size_t K8_SMEM = 1024 + K8_OFF_BAR + 8 * (1 + 2 * K8_STAGES);
constexpr int K8_BAR_BOTH = 3;  // named barrier of both consumers (1, 2: each one's)
constexpr int K8_PRODUCER_REGS = 40;
constexpr int K8_CONSUMER_REGS = 232;  // 40 + 2 x 232 = 3 x 168 (the launch bound)

// Half a consumer's dQ tile (64 queries x 32 dims, fp32 accumulator of this
// thread: rows rA, rA + 8) into `box`, one 64 x 32 box in the 128-byte swizzle
// of an fp32 tensor map (store_dq's layout for one of its two boxes).
__device__ __forceinline__ void store_dq_half(const float (&dq)[16], uint8_t* box, int rA, int g,
                                              int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint8_t* p = box + (((2 * j + (t >> 1)) ^ g) << 4) + 8 * (t & 1);
    *reinterpret_cast<float2*>(p + rA * 128) = make_float2(dq[4 * j], dq[4 * j + 1]);
    *reinterpret_cast<float2*>(p + (rA + 8) * 128) = make_float2(dq[4 * j + 2], dq[4 * j + 3]);
  }
}

template <bool FUSED_DQ, bool SOFTCAP>
__global__ void __launch_bounds__(KV_THREADS, 1)
dkv128_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_do,
              const __grid_constant__ CUtensorMap map_dq,
              const int* __restrict__ mask, const float* __restrict__ nd,
              const float* __restrict__ lse, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int Tq, int Tk, int heads, Cap cap) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int bh = blockIdx.y, k0 = blockIdx.x * K8_BK;
  const int krow0 = bh * Tk + k0;
  const int* mrow = mask == nullptr ? nullptr : mask + (long)(bh / heads) * Tk + k0;

  // A key block with no valid key writes zeros and stops.
  const int live = threadIdx.x < K8_BK && (mrow == nullptr || mrow[threadIdx.x] != 0);
  if (!__syncthreads_or(live)) {
    uint4* zk = reinterpret_cast<uint4*>(dk + (long)krow0 * W128);
    uint4* zv = reinterpret_cast<uint4*>(dv + (long)krow0 * W128);
    for (int i = threadIdx.x; i < K8_BK * W128 / 8; i += KV_THREADS)
      zk[i] = zv[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + K8_OFF_BAR);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + K8_STAGES;
  float* sVec = reinterpret_cast<float*>(smem + K8_OFF_VEC);  // per stage: lse2[64], nd[64]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nsteps = Tq / K8_BQ;
  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < K8_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
    fence_proxy_async();
  }
  __syncthreads();

  if (warp < 4) {
    // ---- producer: K and V once, then the Q / dO ring --------------------------
    setmaxnreg_dec<K8_PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kvbar, 2 * K8_KTILE);
      for (int b = 0; b < 2; ++b) {
        tma_load_2d(smem + K8_OFF_K + b * K8_KBOX, &map_k, kvbar, 64 * b, krow0);
        tma_load_2d(smem + K8_OFF_V + b * K8_KBOX, &map_v, kvbar, 64 * b, krow0);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < nsteps; ++i) {
        if (i >= K8_STAGES) mbar_wait(&empty[stage], phase ^ 1);
        const int row = bh * Tq + i * K8_BQ;
        mbar_expect_tx(&full[stage], 2 * K8_QTILE + 2 * KV_VEC);
        for (int b = 0; b < 2; ++b) {
          tma_load_2d(smem + K8_OFF_Q + stage * K8_QTILE + b * K8_QBOX, &map_q, &full[stage],
                      64 * b, row);
          tma_load_2d(smem + K8_OFF_DO + stage * K8_QTILE + b * K8_QBOX, &map_do,
                      &full[stage], 64 * b, row);
        }
        bulk_load(sVec + stage * 2 * K8_BQ, lse + row, KV_VEC, &full[stage]);
        bulk_load(sVec + stage * 2 * K8_BQ + K8_BQ, nd + row, KV_VEC, &full[stage]);
        if (++stage == K8_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: 64 keys each -------------------------------------------------------
  setmaxnreg_inc<K8_CONSUMER_REGS>();
  const int c = warp / 4 - 1;  // consumer warpgroup: keys 64c..64c+63 of the block
  const int wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int kA = 64 * c + 16 * wq + g, kB = kA + 8;  // this thread's keys in the block
  const int rA = 16 * wq + g;  // this thread's dQ rows (queries of the step): rA, rA + 8
  const bool validA = mrow == nullptr || mrow[kA] != 0;
  const bool validB = mrow == nullptr || mrow[kB] != 0;
  // this consumer's 64 rows of box b of K and V are KBOX b on, 64c rows in; a
  // k-step of 16 columns (32 bytes) is 2 in the descriptor's address field, one
  // of 16 rows (2048 bytes) 128 (no carry: shared addresses < 2^18)
  const uint32_t k_addr = smem_u32(smem + K8_OFF_K), v_addr = smem_u32(smem + K8_OFF_V);
  uint8_t* sDQ = smem + K8_OFF_DQ + c * K8_DQ;  // this consumer's dQ buffer

  float dk0[32], dk1[32], dv0[32], dv1[32];  // dK, dV: columns 0-63 and 64-127
#pragma unroll
  for (int e = 0; e < 32; ++e) dk0[e] = dk1[e] = dv0[e] = dv1[e] = 0.f;

  mbar_wait(kvbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int i = 0; i < nsteps; ++i) {
    const uint32_t q_addr = smem_u32(smem + K8_OFF_Q + stage * K8_QTILE);
    const uint32_t do_addr = smem_u32(smem + K8_OFF_DO + stage * K8_QTILE);
    const float* sLse = sVec + stage * 2 * K8_BQ;
    const float* sND = sLse + K8_BQ;
    mbar_wait(&full[stage], phase);

    // ---- S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries, K-dim 128) ------------
    float st[32], dpt[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const uint64_t dkb = sw128_desc(k_addr + b * K8_KBOX + 64 * c * 128);
      const uint64_t dqb = sw128_desc(q_addr + b * K8_QBOX);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0, 0>(st, dkb + 2 * kk, dqb + 2 * kk, 1);
    }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const uint64_t dvb = sw128_desc(v_addr + b * K8_KBOX + 64 * c * 128);
      const uint64_t dob = sw128_desc(do_addr + b * K8_QBOX);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n64k16_ss<0, 0>(dpt, dvb + 2 * kk, dob + 2 * kk, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // ---- p, ds per logit; P^T and dS^T as bf16 A fragments, or with dQ straight
    // to their shared tiles. Accumulator tile j holds queries 8j + 2t, +1 of keys
    // kA (0, 1) and kB (2, 3); A fragment k-step j/2 takes tile j in registers
    // 2(j&1), 2(j&1)+1. A tile's rows kA, kB (keys) x queries are in TMA's
    // 128-byte swizzle (the 16-byte chunk j of row r at chunk j ^ (r & 7);
    // kA & 7 == kB & 7 == g; row kB is 1024 bytes after row kA). A row starts
    // at a multiple of 128 bytes, so chunk j ^ g of row kA, at 4t bytes in,
    // is x ^ (j << 4) with x = row + (g << 4) + 4t: one register a tile
    // instead of eight swizzled offsets
    const uint32_t ds_addr = smem_u32(smem + K8_OFF_DS + (i & 1) * K8_DS);
    const uint32_t pt_addr = smem_u32(smem + K8_OFF_PT);
    const uint32_t ds_x = ds_addr + kA * 128 + (g << 4) + 4 * t;
    const uint32_t pt_x = pt_addr + kA * 128 + (g << 4) + 4 * t;
    uint32_t pa[16], dsa[16];
#pragma unroll
    for (int j = 0; j < K8_BQ / 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(sLse + 8 * j + 2 * t);
      const float2 n = *reinterpret_cast<const float2*>(sND + 8 * j + 2 * t);
      const float2 a0 = p_ds<SOFTCAP>(st[4 * j], dpt[4 * j], l.x, n.x, validA, cap);
      const float2 a1 = p_ds<SOFTCAP>(st[4 * j + 1], dpt[4 * j + 1], l.y, n.y, validA, cap);
      const float2 b0 = p_ds<SOFTCAP>(st[4 * j + 2], dpt[4 * j + 2], l.x, n.x, validB, cap);
      const float2 b1 = p_ds<SOFTCAP>(st[4 * j + 3], dpt[4 * j + 3], l.y, n.y, validB, cap);
      const int r = 4 * (j >> 1) + 2 * (j & 1);
      if constexpr (FUSED_DQ) {
        st_shared_u32(pt_x ^ (j << 4), pack_f2(a0.x, a1.x));
        st_shared_u32((pt_x ^ (j << 4)) + 1024, pack_f2(b0.x, b1.x));
        st_shared_u32(ds_x ^ (j << 4), pack_f2(a0.y, a1.y));
        st_shared_u32((ds_x ^ (j << 4)) + 1024, pack_f2(b0.y, b1.y));
      } else {
        pa[r] = pack_f2(a0.x, a1.x);
        pa[r + 1] = pack_f2(b0.x, b1.x);
        dsa[r] = pack_f2(a0.y, a1.y);
        dsa[r + 1] = pack_f2(b0.y, b1.y);
      }
    }
    if constexpr (FUSED_DQ) {
      fence_proxy_async();  // the generic stores, visible to wgmma
      bar_sync(K8_BAR_BOTH, 256);  // both consumers' keys are in the tile
    }

    // ---- dV += P^T dO, dK += dS^T Q (keys x dims, two 64-column halves) -----------
    fence_regs(dk0);
    fence_regs(dk1);
    fence_regs(dv0);
    fence_regs(dv1);
    if constexpr (!FUSED_DQ) {
      fence_regs(pa);
      fence_regs(dsa);
    }
    wgmma_fence();
    const uint64_t do0 = sw128_desc(do_addr), do1 = sw128_desc(do_addr + K8_QBOX);
    const uint64_t q0 = sw128_desc(q_addr), q1 = sw128_desc(q_addr + K8_QBOX);
    if constexpr (FUSED_DQ) {
      // P^T and dS^T from the tiles just stored (this consumer's 64 key rows,
      // K-major: a k-step of 16 queries is 32 bytes)
      const uint64_t desc_pt = sw128_desc(pt_addr + 64 * c * 128);
      const uint64_t desc_dst = sw128_desc(ds_addr + 64 * c * 128);
#pragma unroll
      for (int kc = 0; kc < K8_BQ / 16; ++kc) {  // 16 queries (rows of dO, Q) per k-step
        wgmma_m64n64k16_ss<0, 1>(dv0, desc_pt + 2 * kc, do0 + 128 * kc, 1);
        wgmma_m64n64k16_ss<0, 1>(dv1, desc_pt + 2 * kc, do1 + 128 * kc, 1);
      }
#pragma unroll
      for (int kc = 0; kc < K8_BQ / 16; ++kc) {
        wgmma_m64n64k16_ss<0, 1>(dk0, desc_dst + 2 * kc, q0 + 128 * kc, 1);
        wgmma_m64n64k16_ss<0, 1>(dk1, desc_dst + 2 * kc, q1 + 128 * kc, 1);
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < K8_BQ / 16; ++kc) {  // 16 queries (rows of dO, Q) per k-step
        wgmma_m64n64k16_rs(dv0, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                           do0 + 128 * kc, 1);
        wgmma_m64n64k16_rs(dv1, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                           do1 + 128 * kc, 1);
      }
#pragma unroll
      for (int kc = 0; kc < K8_BQ / 16; ++kc) {
        wgmma_m64n64k16_rs(dk0, dsa[4 * kc], dsa[4 * kc + 1], dsa[4 * kc + 2],
                           dsa[4 * kc + 3], q0 + 128 * kc, 1);
        wgmma_m64n64k16_rs(dk1, dsa[4 * kc], dsa[4 * kc + 1], dsa[4 * kc + 2],
                           dsa[4 * kc + 3], q1 + 128 * kc, 1);
      }
    }
    wgmma_commit();
    if constexpr (FUSED_DQ) {
      // dQ[:, 64c:64c+64] = dS K[:, 64c:64c+64] (queries x dims, K-dim the 128
      // keys), by 32-column halves (m64n32k16, K's box c MN-major from 64 bytes
      // in for the second), each half into its 32-column box of the dQ
      // buffer (the previous step's reduce has read it: its issuing thread
      // waited before this step's 256-thread barrier)
      const uint64_t desc_ds = sw128_desc(ds_addr);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t desc_kh = sw128_desc(k_addr + c * K8_KBOX + 64 * h);
        float dq[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) dq[e] = 0.f;
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < K8_BK / 16; ++kc)  // 16 keys (rows of dS^T, K) per k-step
          wgmma_m64n32k16_ss<1, 1>(dq, desc_ds + 128 * kc, desc_kh + 128 * kc, kc > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        store_dq_half(dq, sDQ + h * (K8_DQ / 2), rA, g, t);
      }
    }
    wgmma_wait<0>();
    fence_regs(dk0);
    fence_regs(dk1);
    fence_regs(dv0);
    fence_regs(dv1);
    if (lane == 0) mbar_arrive(&empty[stage]);  // its Q, dO, lse2, -delta are read

    if constexpr (FUSED_DQ) {  // one thread adds the dQ tile into dq_acc by two tile reduces
      fence_proxy_async();
      bar_sync(KV_BAR_WG + c, 128);
      if (threadIdx.x == 128 * (c + 1)) {
        const int row = bh * Tq + i * K8_BQ;
        tma_reduce_add_2d(&map_dq, sDQ, 64 * c, row);
        tma_reduce_add_2d(&map_dq, sDQ + K8_DQ / 2, 64 * c + 32, row);
        bulk_commit();
        bulk_wait_read<0>();
      }
    }
    if (++stage == K8_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if constexpr (FUSED_DQ) {
    if (threadIdx.x == 128 * (c + 1)) bulk_wait<0>();  // shared memory outlives the reduces
  }

  // ---- dK (x ln2, x 1 under softcap) and dV, bf16 ---------------------------------------
  const float ks = out_scale<SOFTCAP>();
  const long rowA = (long)krow0 + kA, rowB = (long)krow0 + kB;
  auto store = [&](const float (&kacc)[32], const float (&vacc)[32], int col0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + rowA * W128 + col) =
          pack_f2(kacc[4 * j] * ks, kacc[4 * j + 1] * ks);
      *reinterpret_cast<uint32_t*>(dk + rowB * W128 + col) =
          pack_f2(kacc[4 * j + 2] * ks, kacc[4 * j + 3] * ks);
      *reinterpret_cast<uint32_t*>(dv + rowA * W128 + col) = pack_f2(vacc[4 * j], vacc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(dv + rowB * W128 + col) =
          pack_f2(vacc[4 * j + 2], vacc[4 * j + 3]);
    }
  };
  store(dk0, dv0, 0);
  store(dk1, dv1, 64);
}

// cudaFuncGetAttributes of one instantiation: (registers, local bytes).
template <bool FUSED_DQ, bool SOFTCAP>
inline int dkv128_attributes(int* regs, int* local_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, dkv128_kernel<FUSED_DQ, SOFTCAP>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

// Tq % 64 == 0, Tk % 128 == 0 (the wrapper checks); q, k, v, dout (BH, T,
// 128); dq_acc (BH, Tq, 128) fp32, zeroed by the caller (FUSED_DQ). Returns
// as launch_dkv does.
template <bool FUSED_DQ, bool SOFTCAP>
inline int launch_dkv128(const void* q, const void* k, const void* v, const void* mask,
                         const void* dout, const void* nd, const void* lse, void* dq_acc,
                         void* dk, void* dv, int BH, int Tq, int Tk, int heads, Cap cap,
                         void* stream) {
  static int regs = 0;  // per instantiation, read once
  if (regs == 0) {
    int local_bytes = 0;
    const int err = dkv128_attributes<FUSED_DQ, SOFTCAP>(&regs, &local_bytes);
    if (err != 0) return err;
  }
  if (regs != KV_LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap map_q, map_k, map_v, map_do, map_dq = {};
  if (!bf16_box64_map(&map_q, q, (uint64_t)BH * Tq, W128, K8_BQ) ||
      !bf16_box64_map(&map_k, k, (uint64_t)BH * Tk, W128, K8_BK) ||
      !bf16_box64_map(&map_v, v, (uint64_t)BH * Tk, W128, K8_BK) ||
      !bf16_box64_map(&map_do, dout, (uint64_t)BH * Tq, W128, K8_BQ) ||
      (FUSED_DQ && !f32_box32_map(&map_dq, dq_acc, (uint64_t)BH * Tq, W128, K8_BQ)))
    return (int)cudaErrorInvalidValue;
  auto kernel = dkv128_kernel<FUSED_DQ, SOFTCAP>;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K8_SMEM);
  if (err != 0) return err;
  kernel<<<dim3(Tk / K8_BK, BH), KV_THREADS, K8_SMEM, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, map_do, map_dq, (const int*)mask, (const float*)nd,
      (const float*)lse, (bf16*)dk, (bf16*)dv, Tq, Tk, heads, cap);
  return (int)cudaGetLastError();
}

}  // namespace attn_bwd
}  // namespace rtt
