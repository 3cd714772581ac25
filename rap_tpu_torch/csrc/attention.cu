// Flash attention forward on head-major, pre-scaled (base-2) q, k, v.
//
// One source, four instantiations of one kernel (compile-time FIXED_BOUND
// and SOFTCAP):
//   FIXED_BOUND true  replaces rap_tpu/ops/pallas_attention.py:188
//         `_flash_fwd_full_kernel` (launched by `_fwd_full_impl`, :224):
//         p = exp2(s - bound) with a fixed per-call logit bound and no running
//         max; out = O / max(l, 1e-30), lse2 = bound + log2(l).
//   FIXED_BOUND false replaces rap_tpu/ops/pallas_attention.py:91
//         `_flash_fwd_kernel` (launched by `_fwd_impl`, :140): online max and
//         rescale, a (B, Tk) int32 key mask shared by the H heads of a batch
//         row, key tiles with no valid key skipped (never loaded, never
//         multiplied), and fully masked rows giving 0 and LSE_EMPTY
//         (:131-138).
//   SOFTCAP (the TPU kernels' static `softcap`, :113-114 and :202-203): q
//         arrives pre-scaled by scale/c, and the base-2 logit is
//         s2 = cap2·tanhf(q·k) with cap2 = c·log2(e) in fp32 from the host; a
//         masked key's logit is NEG_INF after the tanh.
// Each variant is instantiated at two head widths D, 64 and 128: the
// wrapper zero-pads a head of 8 <= d < 64 to 64 and one of 64 < d < 128 to
// 128 (d % 8 == 0), which is exact (flash_attention.py `kernel_width`).
// Both write out (BH, Tq, D) bf16 and lse2 (BH, Tq) fp32, the residual the
// backward kernels read. The row sum l is the fp32 sum of the bf16-rounded p,
// the value the TPU kernel's P·[V | 1] product gives, and is produced by the
// tensor cores here too (below). v arrives as (BH, Tk, D) with 16-byte-aligned
// rows, the caller's own tensor at D = 64, the layout rap_tpu's online path
// feeds its kernel (:288). Keys are never padded: the wrapper refuses Tq, Tk
// that are not multiples of 128.
//
// Bound on the H100 (d = 64): per logit 2·2·64 bf16 tensor-core operations
// and one exp2 on the special-function units (16 per clock per SM, a 256th
// of the bf16 rate), which tie: 0.556 ms each at BH=32, T=8192 (550 GFLOP,
// 2.1 G exp2); the bytes (< 100 MB) are far below. Under softcap the tanh
// doubles the special-function time, which then bounds the kernel. So the
// design keeps the tensor cores fed without stalls on memory, and keeps
// every other per-logit instruction off the special-function pipe.
//
// Design (Hopper: TMA, mbarriers, wgmma, warp specialisation). A block owns
// 128 query rows of one head and has three warpgroups:
// - a producer warpgroup (registers lowered to 40 by setmaxnreg) whose one
//   elected thread loads Q once and the K and V tiles of 128 keys into a ring
//   of STAGES shared-memory stages by TMA (128-byte swizzle; a tile is D / 64
//   boxes of 128 rows x 64 columns), each stage with a full barrier
//   (transaction bytes) and an empty barrier (8 consumer warps), so the loads
//   of the next tiles overlap the products;
// - two consumer warpgroups of 64 query rows (registers raised to 232): for
//   each tile, S = Q K^T by 4 wgmma.m64n128k16 a box from shared memory, then
//   the softcap, mask and running max in registers (the accumulator puts rows
//   g and g+8 of a warp on one quad; the max is a tree, then a quad shuffle),
//   P = exp2(S - m) rounded to bf16 by cvt.rn.bf16x2 into register A
//   fragments, and O += P V with P from registers and V from shared memory
//   (MN-major): by 8 wgmma.m64n72k16 on B = [V's last box | ones], after 8
//   wgmma.m64n64k16 on V's first box at D = 128. Columns 64-71 of that B
//   are a 2 KB block of bf16 ones one descriptor offset from V, so the
//   tensor cores also produce l = sum of the bf16-rounded p in fp32, as the
//   TPU kernel's P·[V | 1] does, and the online rescale of O rescales l with
//   it.
//   The P V product of tile i is issued in one commit group with the Q K^T
//   product of tile i+1; the stage of tile i is released when that group
//   completes.
// - For the masked variant all 12 warps first reduce the batch row's mask to
//   per-key bits (4 words per tile) and a compacted list of live tiles in
//   shared memory, while the Q load is in flight; producer and consumers then
//   walk the same list, and consumers read each live tile's bits from shared
//   memory.
// At D = 128 a tile of K or V is 32 KB, so the ring has 2 stages (3 would
// take 232 576 bytes with Q, the ones and the alignment slack, past the
// 232 448 a block may have): Q 32 KB + 2 x (K + V) 128 KB + 2 KB of ones.
// Registers per consumer thread there: S 64, O and l 32 + 36, P 32.
//
// ptxas (sm_90a), all eight instantiations must have 168 registers (the
// launch bound for 384 threads; setmaxnreg moves them to 40 / 232, and
// setmaxnreg.inc would wait forever for registers a smaller count never
// frees: the launcher refuses another count, rtt_flash_fwd_attributes reads
// it) and no local memory. Dynamic shared memory: 117 888 bytes at D = 64,
// 167 040 at D = 128, plus 20 bytes per key tile with a mask.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using rtt::bf16;
constexpr int BQ = 128;                  // query rows per block (64 per consumer)
constexpr int BK = 128;                  // keys per tile
constexpr int NTHREADS = 384;            // producer + 2 consumer warpgroups
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;       // 40 + 2 x 232 = 3 x 168 (launch bound)
constexpr int LAUNCH_REGS = 168;
constexpr uint32_t BOX_BYTES = BK * 64 * 2;  // one 128 x 64 bf16 box: 16 KB
constexpr size_t SMEM_BARS = 128;        // q, full[], empty[] barriers, live count

// The shared-memory layout at head width D: Q, the K and V rings, 16 rows of
// bf16 ones, the barriers, 1 KB of alignment slack (per-key mask bits after).
template <int D>
struct Fwd {
  static constexpr int NB = D / 64;                    // boxes of a row
  static constexpr int STAGES = D == 64 ? 3 : 2;       // K/V ring depth
  static constexpr uint32_t TILE_BYTES = NB * BOX_BYTES;  // 128 rows of Q, K or V
  static constexpr size_t ONES_OFF = (1 + 2 * STAGES) * (size_t)TILE_BYTES;
  static constexpr size_t SMEM_TILES = ONES_OFF + 2048;
  static constexpr size_t SMEM_FIXED = 1024 + SMEM_TILES + SMEM_BARS;
};

constexpr float NEG_INF = -1e30f;
constexpr float LSE_EMPTY = 1e30f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P = exp2(S - m) rounded to bf16 (cvt.rn.bf16x2), as wgmma A fragments:
// k-step j/2 holds keys 0-7 (rows g, g+8) in registers 0, 1, keys 8-15 in 2, 3
__device__ __forceinline__ void exp_tile(uint32_t (&p)[32], const float (&s)[64], float mA,
                                         float mB) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    p[4 * (j >> 1) + 2 * (j & 1)] = rtt::pack_f2(ex2(s[4 * j] - mA), ex2(s[4 * j + 1] - mA));
    p[4 * (j >> 1) + 2 * (j & 1) + 1] =
        rtt::pack_f2(ex2(s[4 * j + 2] - mB), ex2(s[4 * j + 3] - mB));
  }
}

template <bool FIXED_BOUND, bool SOFTCAP, int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const int* __restrict__ mask,
                 float bound, float cap2, bf16* __restrict__ out,
                 float* __restrict__ lse, int Tq, int Tk, int heads) {
  using L = Fwd<D>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (rtt::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sK = sQ + L::TILE_BYTES;            // STAGES tiles
  uint8_t* sV = sK + STAGES * L::TILE_BYTES;   // STAGES tiles
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::SMEM_TILES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  int* sCount = reinterpret_cast<int*>(empty + STAGES);
  uint32_t* sBits = reinterpret_cast<uint32_t*>(smem + L::SMEM_TILES + SMEM_BARS);
  const int ntiles = Tk / BK;
  int* sList = reinterpret_cast<int*>(sBits + 4 * ntiles);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool masked = !FIXED_BOUND && mask != nullptr;

  if (threadIdx.x == 0) {
    rtt::mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      rtt::mbar_init(&full[s], 1);
      rtt::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    rtt::mbar_fence_init();
    rtt::fence_proxy_async();
    rtt::mbar_expect_tx(qbar, L::TILE_BYTES);
#pragma unroll
    for (int b = 0; b < L::NB; ++b)
      rtt::tma_load_2d(sQ + b * BOX_BYTES, &map_q, qbar, 64 * b, bh * Tq + q0);
  }
  if (masked) {
    // per-key bits: word w of a tile holds keys 32w..32w+31
    const int* mrow = mask + (long)(bh / heads) * Tk;
#pragma unroll 4
    for (int tile = warp; tile < ntiles; tile += NTHREADS / 32) {
      const int* m = mrow + tile * BK + lane;
      const uint32_t w0 = __ballot_sync(0xffffffffu, m[0] != 0);
      const uint32_t w1 = __ballot_sync(0xffffffffu, m[32] != 0);
      const uint32_t w2 = __ballot_sync(0xffffffffu, m[64] != 0);
      const uint32_t w3 = __ballot_sync(0xffffffffu, m[96] != 0);
      if (lane == 0) *reinterpret_cast<uint4*>(sBits + 4 * tile) = make_uint4(w0, w1, w2, w3);
    }
    __syncthreads();
    if (warp == 0) {  // compact the live tiles, in order
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
  }
  {  // bf16 ones, read by the last P V product of a k-step as B's columns 64-71
    uint32_t* ones = reinterpret_cast<uint32_t*>(smem + L::ONES_OFF);
    for (int i = threadIdx.x; i < 512; i += NTHREADS) ones[i] = 0x3F803F80u;
    rtt::fence_proxy_async();
  }
  __syncthreads();
  const int n_live = masked ? *sCount : ntiles;

  if (warp < 4) {
    // ---- producer: one thread keeps the K/V ring full --------------------------
    rtt::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int i = 0; i < n_live; ++i) {
        if (i >= STAGES) rtt::mbar_wait(&empty[stage], phase ^ 1);
        const int row = bh * Tk + (masked ? sList[i] : i) * BK;
        rtt::mbar_expect_tx(&full[stage], 2 * L::TILE_BYTES);
#pragma unroll
        for (int b = 0; b < L::NB; ++b) {
          rtt::tma_load_2d(sK + stage * L::TILE_BYTES + b * BOX_BYTES, &map_k, &full[stage],
                           64 * b, row);
          rtt::tma_load_2d(sV + stage * L::TILE_BYTES + b * BOX_BYTES, &map_v, &full[stage],
                           64 * b, row);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: 64 query rows each ---------------------------------------------
  rtt::setmaxnreg_inc<CONSUMER_REGS>();
  const int c = warp / 4 - 1;  // consumer warpgroup
  const int wq = warp & 3;     // warp within it: rows 16wq..16wq+15
  const int g = lane >> 2, t = lane & 3;
  // this consumer's 64 rows of Q's first box (the next box is BOX_BYTES on)
  const uint32_t q_addr = rtt::smem_u32(sQ + c * 64 * 128);
  const uint32_t ones_addr = rtt::smem_u32(smem + L::ONES_OFF);

  // o[0..31]: O's last 64 columns; o[32..35]: columns 64-71 of the last
  // product, the row sums l; o_lo: O's columns 0-63 at D = 128
  float o[36], o_lo[D == 128 ? 32 : 1], s[64];
  uint32_t pa[32];  // P of the last tile: 8 k-steps x 4 A-fragment registers
#pragma unroll
  for (int i = 0; i < 36; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (D == 128 ? 32 : 1); ++i) o_lo[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = 0u;
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  float mA = NEG_INF, mB = NEG_INF;  // running max (online variant), rows g, g+8

  // O += P V of the tile in stage st, and l += P 1: each k-step's B is 16
  // keys of V's box (MN-major); the last box's has the ones block one
  // leading byte offset away
  auto issue_pv = [&](int st) {
    const uint32_t v_addr = rtt::smem_u32(sV + st * L::TILE_BYTES);
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t a = v_addr + 2048 * kc + (L::NB - 1) * BOX_BYTES;  // 16 keys, 128 bytes
      if constexpr (D == 128)
        rtt::wgmma_m64n64k16_rs<1>(o_lo, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2],
                                   pa[4 * kc + 3], rtt::sw128_desc(a - BOX_BYTES), 1);
      rtt::wgmma_m64n72k16_rs(o, pa[4 * kc], pa[4 * kc + 1], pa[4 * kc + 2], pa[4 * kc + 3],
                              rtt::sw128_desc(a, ones_addr - a), 1);
    }
  };

  rtt::mbar_wait(qbar, 0);
  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_live; ++i) {
    rtt::mbar_wait(&full[stage], phase);
    // ---- S = Q K^T of this tile, then O += P V of the previous one -------------
    const uint32_t k_addr = rtt::smem_u32(sK + stage * L::TILE_BYTES);
    rtt::fence_regs(o);
    rtt::fence_regs(o_lo);
    rtt::fence_regs(pa);
    rtt::wgmma_fence();
#pragma unroll
    for (int b = 0; b < L::NB; ++b) {
      const uint64_t desc_q = rtt::sw128_desc(q_addr + b * BOX_BYTES);
      const uint64_t desc_k = rtt::sw128_desc(k_addr + b * BOX_BYTES);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        rtt::wgmma_m64n128k16_ss(s, desc_q + 2 * kk, desc_k + 2 * kk, b > 0 || kk > 0);
    }
    if (i > 0) issue_pv(prev);
    rtt::wgmma_commit();
    rtt::wgmma_wait<0>();
    rtt::fence_regs(s);
    rtt::fence_regs(o);
    rtt::fence_regs(o_lo);
    if (i > 0 && lane == 0) rtt::mbar_arrive(&empty[prev]);  // V of the previous tile

    if (SOFTCAP) {  // s2 = c log2(e) tanh(z'), before the mask
#pragma unroll
      for (int e = 0; e < 64; ++e) s[e] = tanhf(s[e]) * cap2;
    }
    if (!FIXED_BOUND) {
      if (masked) {
        const uint4 b = *reinterpret_cast<const uint4*>(sBits + 4 * sList[i]);
        const uint32_t words[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const uint32_t bits = words[j >> 2] >> (8 * (j & 3) + 2 * t);
          if (!(bits & 1u)) s[4 * j] = s[4 * j + 2] = NEG_INF;
          if (!(bits & 2u)) s[4 * j + 1] = s[4 * j + 3] = NEG_INF;
        }
      }
      // the row maxima by a tree (short dependency chains), then the quad
      float xA[BK / 8], xB[BK / 8];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        xA[j] = fmaxf(s[4 * j], s[4 * j + 1]);
        xB[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) xA[j] = fmaxf(xA[j], xA[j + 8]), xB[j] = fmaxf(xB[j], xB[j + 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j) xA[j] = fmaxf(xA[j], xA[j + 4]), xB[j] = fmaxf(xB[j], xB[j + 4]);
#pragma unroll
      for (int j = 0; j < 2; ++j) xA[j] = fmaxf(xA[j], xA[j + 2]), xB[j] = fmaxf(xB[j], xB[j + 2]);
      const float tA = rtt::quad_max(fmaxf(xA[0], xA[1]));
      const float tB = rtt::quad_max(fmaxf(xB[0], xB[1]));
      const float nA = fmaxf(mA, tA), nB = fmaxf(mB, tB);
      const float cA = ex2(mA - nA), cB = ex2(mB - nB);
      mA = nA;
      mB = nB;
#pragma unroll
      for (int j = 0; j < 9; ++j) {  // rescale O and l to the new maxima
        o[4 * j] *= cA;
        o[4 * j + 1] *= cA;
        o[4 * j + 2] *= cB;
        o[4 * j + 3] *= cB;
      }
      if constexpr (D == 128) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o_lo[4 * j] *= cA;
          o_lo[4 * j + 1] *= cA;
          o_lo[4 * j + 2] *= cB;
          o_lo[4 * j + 3] *= cB;
        }
      }
      exp_tile(pa, s, mA, mB);
    } else {
      exp_tile(pa, s, bound, bound);
    }
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (n_live > 0) {  // O += P V of the last tile
    rtt::fence_regs(o);
    rtt::fence_regs(o_lo);
    rtt::fence_regs(pa);
    rtt::wgmma_fence();
    issue_pv(prev);
    rtt::wgmma_commit();
    rtt::wgmma_wait<0>();
    rtt::fence_regs(o);
    rtt::fence_regs(o_lo);
  }

  // ---- finalize: out = O / l, lse2 = m + log2(l) -----------------------------------
  const float lA = o[32], lB = o[34];  // every column of the ones block holds l
  const float refA = FIXED_BOUND ? bound : mA, refB = FIXED_BOUND ? bound : mB;
  const float dA = fmaxf(lA, 1e-30f), dB = fmaxf(lB, 1e-30f);
  const bool emptyA = !FIXED_BOUND && !(lA > 0.f);
  const bool emptyB = !FIXED_BOUND && !(lB > 0.f);
  const long rowA = (long)bh * Tq + q0 + 64 * c + 16 * wq + g, rowB = rowA + 8;
  // one 64-column block of O: columns col0..col0+63
  auto store = [&](const auto& acc, int col0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + j * 8 + 2 * t;
      const float a0 = emptyA ? 0.f : acc[4 * j] / dA, a1 = emptyA ? 0.f : acc[4 * j + 1] / dA;
      const float b0 = emptyB ? 0.f : acc[4 * j + 2] / dB, b1 = emptyB ? 0.f : acc[4 * j + 3] / dB;
      *reinterpret_cast<uint32_t*>(out + rowA * D + col) = rtt::pack_f2(a0, a1);
      *reinterpret_cast<uint32_t*>(out + rowB * D + col) = rtt::pack_f2(b0, b1);
    }
  };
  if constexpr (D == 128) store(o_lo, 0);
  store(o, D - 64);
  if (t == 0) {
    lse[rowA] = emptyA ? LSE_EMPTY : refA + log2f(dA);
    lse[rowB] = emptyB ? LSE_EMPTY : refB + log2f(dB);
  }
}

template <bool FIXED_BOUND, bool SOFTCAP, int D>
int launch_at(const void* q, const void* k, const void* v, const void* mask, float bound,
              float cap2, void* out, void* lse, int BH, int Tq, int Tk, int heads,
              void* stream) {
  CUtensorMap map_q, map_k, map_v;
  if (!rtt::bf16_box64_map(&map_q, q, (uint64_t)BH * Tq, D, BQ) ||
      !rtt::bf16_box64_map(&map_k, k, (uint64_t)BH * Tk, D, BK) ||
      !rtt::bf16_box64_map(&map_v, v, (uint64_t)BH * Tk, D, BK))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_kernel<FIXED_BOUND, SOFTCAP, D>;
  static int regs = 0;  // read once: setmaxnreg.inc would wait forever on another count
  if (regs == 0) {
    cudaFuncAttributes a;
    const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    if (err != cudaSuccess) return (int)err;
    regs = a.numRegs;
  }
  if (regs != LAUNCH_REGS) return (int)cudaErrorInvalidConfiguration;
  const bool masked = !FIXED_BOUND && mask != nullptr;
  // per-key bits (16 bytes) and a list entry (4 bytes) per key tile
  const size_t smem = Fwd<D>::SMEM_FIXED + (masked ? (size_t)(Tk / BK) * 20 : 0);
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(Tq / BQ, BH), NTHREADS, smem, (cudaStream_t)stream>>>(
      map_q, map_k, map_v, (const int*)mask, bound, cap2, (bf16*)out, (float*)lse, Tq, Tk,
      heads);
  return (int)cudaGetLastError();
}

// The instantiation at head width D = 64 or 128.
template <bool FIXED_BOUND, bool SOFTCAP>
int launch(const void* q, const void* k, const void* v, const void* mask, float bound,
           float cap2, void* out, void* lse, int BH, int Tq, int Tk, int heads, int D,
           void* stream) {
  if (D == 64)
    return launch_at<FIXED_BOUND, SOFTCAP, 64>(q, k, v, mask, bound, cap2, out, lse, BH, Tq,
                                               Tk, heads, stream);
  if (D == 128)
    return launch_at<FIXED_BOUND, SOFTCAP, 128>(q, k, v, mask, bound, cap2, out, lse, BH, Tq,
                                                Tk, heads, stream);
  return (int)cudaErrorInvalidValue;
}

template <bool FIXED_BOUND, bool SOFTCAP, int D>
int attributes_at(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, flash_fwd_kernel<FIXED_BOUND, SOFTCAP, D>);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return (int)err;
}

}  // namespace

// q, k, v: (BH, T, D) bf16, contiguous, D = 64 or 128 (the padded head
// width); every pointer 16-byte aligned.
extern "C" int rtt_flash_fixed(const void* q, const void* k, const void* v, float bound,
                               void* out, void* lse, int BH, int Tq, int Tk, int D,
                               void* stream) {
  return launch<true, false>(q, k, v, nullptr, bound, 0.f, out, lse, BH, Tq, Tk, 1, D, stream);
}

// mask: (BH / heads, Tk) int32, nonzero = valid key; null = every key valid.
extern "C" int rtt_flash_online(const void* q, const void* k, const void* v,
                                const void* mask, void* out, void* lse, int BH, int Tq,
                                int Tk, int heads, int D, void* stream) {
  return launch<false, false>(q, k, v, mask, 0.f, 0.f, out, lse, BH, Tq, Tk, heads, D, stream);
}

// The softcap variants: cap2 = c log2(e) in fp32; the fixed one's bound is
// cap2 too (the caller passes it).
extern "C" int rtt_flash_fixed_softcap(const void* q, const void* k, const void* v,
                                       float bound, float cap2, void* out, void* lse,
                                       int BH, int Tq, int Tk, int D, void* stream) {
  return launch<true, true>(q, k, v, nullptr, bound, cap2, out, lse, BH, Tq, Tk, 1, D, stream);
}

extern "C" int rtt_flash_online_softcap(const void* q, const void* k, const void* v,
                                        const void* mask, float cap2, void* out, void* lse,
                                        int BH, int Tq, int Tk, int heads, int D,
                                        void* stream) {
  return launch<false, true>(q, k, v, mask, 0.f, cap2, out, lse, BH, Tq, Tk, heads, D, stream);
}

// Registers and local bytes of the eight instantiations, two ints each, in
// the order (FIXED_BOUND, SOFTCAP) = (true, false), (false, false), (true,
// true), (false, true), each at D = 64 then 128.
extern "C" int rtt_flash_fwd_attributes(int* out) {
  int err = attributes_at<true, false, 64>(out);
  if (!err) err = attributes_at<true, false, 128>(out + 2);
  if (!err) err = attributes_at<false, false, 64>(out + 4);
  if (!err) err = attributes_at<false, false, 128>(out + 6);
  if (!err) err = attributes_at<true, true, 64>(out + 8);
  if (!err) err = attributes_at<true, true, 128>(out + 10);
  if (!err) err = attributes_at<false, true, 64>(out + 12);
  if (!err) err = attributes_at<false, true, 128>(out + 14);
  return err;
}
