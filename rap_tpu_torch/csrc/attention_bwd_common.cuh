// Tile math shared by the three attention backward kernels, so that they
// cannot drift apart in arithmetic:
//   attention_bwd.cu        rap_tpu/ops/pallas_attention.py:506
//                           `_flash_bwd_fused_kernel` (one pass, dQ by atomics)
//   attention_bwd_split.cu  :426 `_flash_bwd_dkv_kernel` and
//                           :471 `_flash_bwd_dq_kernel` (the split backward)
//
// All three recompute, per tile, what `_recompute_p_ds` (:369) computes on
// head-major, pre-scaled (base-2) q: s = q.k in fp32; a masked key's logit is
// NEG_INF (:411-412); p = exp2(s - lse2); ds = p (dO.V^T - delta) in fp32,
// the -delta column of [dO | -delta] (bf16, `_augment_do` :566) entering
// through va's ones column; p and ds rounded to bf16 before their products.
// dV = sum p^T dO, dK = ln2 sum ds^T Q, dQ = ln2 sum ds K: the ln2 of the
// base-2 domain is applied once per output element.
// SOFTCAP (the `softcap` static of all three TPU kernels): q arrives
// pre-scaled by scale/c, the logit is s = c·log2(e)·tanh(q.k) and ds gains
// the per-logit factor dsdz = c·(1 - tanh²), both from one tanhf
// (:402-405); the deferred ln2 is then not applied (:466, :502, :561, :618).
// `Cap` carries c and cap2 = c·log2(e), each rounded to fp32 by the host.
// Rows whose keys are all
// masked carry lse2 = LSE_EMPTY = 1e30 from the forward, so their p is
// exp2(-1e30 - 1e30) = 0 with no inf - inf.
//
// Two tile layouts, both on warp-level mma.sync.m16n8k16 (common.cuh):
//   key-major (dK, dV): a warp owns 16 keys; S^T = K Q^T and dP^T = V dO^T
//     put P^T and dS^T in registers as A fragments for dV += P^T dO and
//     dK += dS^T Q (`st_dpt`, `pt_dst`, `accumulate_dkv`);
//   query-major (dQ): a warp owns 16 queries; S = Q K^T and dP = dO V^T put
//     dS in registers as A fragments for dQ += dS K (`s_dp`, `ds_q`).
// Both call `p_ds` for every logit. `dkv_kernel` is the block of rows 6 and
// 7: it owns 128 keys of one head and walks every query; the template flag
// adds row 6's dQ, summed across key blocks by fp32 atomicAdd.
#pragma once

#include "common.cuh"

namespace rtt {
namespace attn_bwd {

constexpr int D = 64;     // head width
constexpr int LDS = D + 8;  // shared-memory row stride of a [row][dim] tile
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF = -1e30f;

struct Cap {
  float c;     // the logit cap
  float cap2;  // c log2(e)
};

// The scale of dK and dQ at finalize: ln2 of the base-2 domain, or 1 under
// softcap (dsdz is applied per logit there).
template <bool SOFTCAP>
__device__ __forceinline__ float out_scale() {
  return SOFTCAP ? 1.f : LN2;
}

// One logit: (p, ds). `valid` false is a masked key; `nd` is -delta (bf16
// value) and `one` va's ones column of the key.
template <bool SOFTCAP>
__device__ __forceinline__ float2 p_ds(float s, float dpv, float lse, float nd,
                                       float one, bool valid, Cap cap) {
  if (SOFTCAP) {
    const float th = tanhf(s);
    const float p = exp2f((valid ? th * cap.cap2 : NEG_INF) - lse);
    return make_float2(p, p * (dpv + nd * one) * (cap.c * (1.f - th * th)));
  }
  const float p = exp2f((valid ? s : NEG_INF) - lse);
  return make_float2(p, p * (dpv + nd * one));
}

template <int N>
__device__ __forceinline__ void zero_tiles(float (*c)[4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// ---- key-major tiles (a warp owns the 16 keys [kr, kr + 16)) --------------

// S^T = K Q^T and dP^T = V dO^T against the BQ queries staged in sQ, sDO.
template <int BQ>
__device__ __forceinline__ void st_dpt(float (*st)[4], float (*dpt)[4],
                                       const bf16* sK, const bf16* sV,
                                       const bf16* sQ, const bf16* sDO, int kr,
                                       int lane) {
  zero_tiles<BQ / 8>(st);
  zero_tiles<BQ / 8>(dpt);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t ka[4], vfa[4];
    load_a(ka, sK, LDS, kr, kc * 16, lane);
    load_a(vfa, sV, LDS, kr, kc * 16, lane);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      uint32_t b0, b1;
      load_b_nk(b0, b1, sQ, LDS, kc * 16, j * 8, lane);
      mma16816(st[j], ka, b0, b1);
      load_b_nk(b0, b1, sDO, LDS, kc * 16, j * 8, lane);
      mma16816(dpt[j], vfa, b0, b1);
    }
  }
}

// P^T and dS^T as bf16 A fragments (M = keys, K = queries). This thread's
// keys are kr + g (oneA, validA) and kr + g + 8 (oneB, validB); sLse and sND
// hold lse2 and -delta of the step's queries.
template <int BQ, bool SOFTCAP>
__device__ __forceinline__ void pt_dst(uint32_t (*pa)[4], uint32_t (*dsa)[4],
                                       const float (*st)[4],
                                       const float (*dpt)[4],
                                       const float* sLse, const float* sND,
                                       float oneA, float oneB, bool validA,
                                       bool validB, Cap cap, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const int c = j * 8 + 2 * t;  // query within the step
    const float l0 = sLse[c], l1 = sLse[c + 1];
    const float n0 = sND[c], n1 = sND[c + 1];
    const float2 a0 = p_ds<SOFTCAP>(st[j][0], dpt[j][0], l0, n0, oneA, validA, cap);
    const float2 a1 = p_ds<SOFTCAP>(st[j][1], dpt[j][1], l1, n1, oneA, validA, cap);
    const float2 b0 = p_ds<SOFTCAP>(st[j][2], dpt[j][2], l0, n0, oneB, validB, cap);
    const float2 b1 = p_ds<SOFTCAP>(st[j][3], dpt[j][3], l1, n1, oneB, validB, cap);
    const int slot = (j & 1) * 2;  // C tile j -> A registers of k-step j/2
    pa[j >> 1][slot] = pack_f2(a0.x, a1.x);
    pa[j >> 1][slot + 1] = pack_f2(b0.x, b1.x);
    dsa[j >> 1][slot] = pack_f2(a0.y, a1.y);
    dsa[j >> 1][slot + 1] = pack_f2(b0.y, b1.y);
  }
}

// dV += P^T dO and dK += dS^T Q (M = keys, K = queries, N = dims).
template <int BQ>
__device__ __forceinline__ void accumulate_dkv(float (*dvacc)[4],
                                               float (*dkacc)[4],
                                               const uint32_t (*pa)[4],
                                               const uint32_t (*dsa)[4],
                                               const bf16* sQ, const bf16* sDO,
                                               int lane) {
#pragma unroll
  for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint32_t b0, b1;
      load_b_kn(b0, b1, sDO, LDS, kc * 16, j * 8, lane);
      mma16816(dvacc[j], pa[kc], b0, b1);
      load_b_kn(b0, b1, sQ, LDS, kc * 16, j * 8, lane);
      mma16816(dkacc[j], dsa[kc], b0, b1);
    }
  }
}

// ---- query-major tiles (a warp owns 16 queries, q and dO in registers) ----

// S = Q K^T and dP = dO V^T against the BK keys staged in sK, sV.
template <int BK>
__device__ __forceinline__ void s_dp(float (*s)[4], float (*dp)[4],
                                     const uint32_t (*qa)[4],
                                     const uint32_t (*da)[4], const bf16* sK,
                                     const bf16* sV, int lane) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t b0, b1;
      load_b_nk(b0, b1, sK, LDS, kc * 16, j * 8, lane);
      mma16816(s[j], qa[kc], b0, b1);
      load_b_nk(b0, b1, sV, LDS, kc * 16, j * 8, lane);
      mma16816(dp[j], da[kc], b0, b1);
    }
  }
}

// dS as bf16 A fragments (M = queries, K = keys). This thread's queries are
// g (lse lA, -delta nA) and g + 8 (lB, nB); sOne and sValid hold va's ones
// column and the mask of the step's keys.
template <int BK, bool SOFTCAP>
__device__ __forceinline__ void ds_q(uint32_t (*dsa)[4], const float (*s)[4],
                                     const float (*dp)[4], float lA, float lB,
                                     float nA, float nB, const float* sOne,
                                     const int* sValid, Cap cap, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const int c = j * 8 + 2 * t;  // key within the step
    const float o0 = sOne[c], o1 = sOne[c + 1];
    const bool v0 = sValid[c] != 0, v1 = sValid[c + 1] != 0;
    const float2 a0 = p_ds<SOFTCAP>(s[j][0], dp[j][0], lA, nA, o0, v0, cap);
    const float2 a1 = p_ds<SOFTCAP>(s[j][1], dp[j][1], lA, nA, o1, v1, cap);
    const float2 b0 = p_ds<SOFTCAP>(s[j][2], dp[j][2], lB, nB, o0, v0, cap);
    const float2 b1 = p_ds<SOFTCAP>(s[j][3], dp[j][3], lB, nB, o1, v1, cap);
    const int slot = (j & 1) * 2;
    dsa[j >> 1][slot] = pack_f2(a0.y, a1.y);
    dsa[j >> 1][slot + 1] = pack_f2(b0.y, b1.y);
  }
}

// ---- the key block of rows 6 and 7 ------------------------------------------

constexpr int KV_BQ = 64;         // queries per step
constexpr int KV_BK = 128;        // keys per block
constexpr int KV_THREADS = 256;   // 8 warps x 16 keys
constexpr int LDDS = KV_BQ + 8;   // dS^T [key][query] stride (row 6 only)

template <bool FUSED_DQ>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * KV_BK * LDS + 2 * KV_BQ * LDS +
                  (FUSED_DQ ? KV_BK * LDDS : 0)) * sizeof(bf16) +
         (size_t)(2 * KV_BQ + KV_BK) * sizeof(float) +
         (size_t)KV_BK * sizeof(int);
}

// q, k (BH, T, 64) bf16; va (BH, Tk, 65) bf16 = [V | 1]; mask (BH / heads,
// Tk) int32 or null (every key valid); doa (BH, Tq, 65) bf16 = [dO | -delta];
// lse (BH, Tq) fp32. dk (x ln2, or x 1 under SOFTCAP) and dv (BH, Tk, 64)
// bf16. FUSED_DQ: dq_acc (BH, Tq, 64) fp32, zeroed by the caller, receives
// sum ds K by atomicAdd.
template <bool FUSED_DQ, bool SOFTCAP>
__global__ void __launch_bounds__(KV_THREADS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ va, const int* __restrict__ mask,
           const bf16* __restrict__ doa, const float* __restrict__ lse,
           float* __restrict__ dq_acc, bf16* __restrict__ dk,
           bf16* __restrict__ dv, int Tq, int Tk, int heads, Cap cap) {
  constexpr int BQ = KV_BQ, BK = KV_BK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [key][dim]
  bf16* sV = sK + BK * LDS;                        // [key][dim]
  bf16* sQ = sV + BK * LDS;                        // [query][dim]
  bf16* sDO = sQ + BQ * LDS;                       // [query][dim]
  bf16* sDS = sDO + BQ * LDS;                      // dS^T [key][query], row 6
  float* sLse = reinterpret_cast<float*>(sDS + (FUSED_DQ ? BK * LDDS : 0));
  float* sND = sLse + BQ;                          // -delta per query
  float* sOne = sND + BQ;                          // va's ones column per key
  int* sValid = reinterpret_cast<int*>(sOne + BK);

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3;
  const long krow0 = (long)bh * Tk + k0;

  // A key block with no valid key writes zeros and stops: the kernels'
  // pl.when(any(mask)) (:441, :485), a real skip here.
  const int* mrow = mask == nullptr ? nullptr : mask + (long)(bh / heads) * Tk + k0;
  int any = 0;
  for (int i = threadIdx.x; i < BK; i += KV_THREADS) {
    const int m = mrow == nullptr ? 1 : (mrow[i] != 0);
    sValid[i] = m;
    any |= m;
  }
  if (!__syncthreads_or(any)) {
    uint32_t* zk = reinterpret_cast<uint32_t*>(dk + krow0 * D);
    uint32_t* zv = reinterpret_cast<uint32_t*>(dv + krow0 * D);
    for (int i = threadIdx.x; i < BK * D / 2; i += KV_THREADS) zk[i] = zv[i] = 0u;
    return;
  }

  const bf16* qb = q + (long)bh * Tq * D;
  const bf16* dob = doa + (long)bh * Tq * (D + 1);
  const float* lb = lse + (long)bh * Tq;
  const bf16* vb = va + krow0 * (D + 1);
  stage_tile<KV_THREADS>(sK, LDS, k + krow0 * D, D, BK, D);
  for (int i = threadIdx.x; i < BK * D; i += KV_THREADS) {
    const int r = i / D, c = i % D;
    sV[r * LDS + c] = vb[(long)r * (D + 1) + c];
  }
  for (int i = threadIdx.x; i < BK; i += KV_THREADS)
    sOne[i] = __bfloat162float(vb[(long)i * (D + 1) + D]);
  __syncthreads();

  const int kr = warp * 16;  // this warp's first key row in the block
  const float oneA = sOne[kr + gg], oneB = sOne[kr + gg + 8];
  const bool validA = sValid[kr + gg] != 0, validB = sValid[kr + gg + 8] != 0;
  float dkacc[D / 8][4], dvacc[D / 8][4];
  zero_tiles<D / 8>(dkacc);
  zero_tiles<D / 8>(dvacc);

  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the previous step's reads of sQ, sDO (sDS) are done
    stage_tile<KV_THREADS>(sQ, LDS, qb + (long)q0 * D, D, BQ, D);
    for (int i = threadIdx.x; i < BQ * D; i += KV_THREADS) {
      const int r = i / D, c = i % D;
      sDO[r * LDS + c] = dob[(long)(q0 + r) * (D + 1) + c];
    }
    for (int i = threadIdx.x; i < BQ; i += KV_THREADS) {
      sLse[i] = lb[q0 + i];
      sND[i] = __bfloat162float(dob[(long)(q0 + i) * (D + 1) + D]);
    }
    __syncthreads();

    float st[BQ / 8][4], dpt[BQ / 8][4];
    st_dpt<BQ>(st, dpt, sK, sV, sQ, sDO, kr, lane);
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    pt_dst<BQ, SOFTCAP>(pa, dsa, st, dpt, sLse, sND, oneA, oneB, validA, validB, cap,
                        lane);
    accumulate_dkv<BQ>(dvacc, dkacc, pa, dsa, sQ, sDO, lane);

    if constexpr (FUSED_DQ) {
      // ---- dQ(64 queries x 64 dims) += dS K: 16 x 32 per warp, K = 128 keys
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int c = j * 8 + 2 * t, slot = (j & 1) * 2;
        *reinterpret_cast<uint32_t*>(sDS + (kr + gg) * LDDS + c) = dsa[j >> 1][slot];
        *reinterpret_cast<uint32_t*>(sDS + (kr + gg + 8) * LDDS + c) =
            dsa[j >> 1][slot + 1];
      }
      __syncthreads();  // dS^T of every warp is in shared memory
      const int qr = (warp & 3) * 16, dc = (warp >> 2) * 32;
      float dqp[4][4];
      zero_tiles<4>(dqp);
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        uint32_t a[4];
        load_a_km(a, sDS, LDDS, qr, kc * 16, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t b0, b1;
          load_b_kn(b0, b1, sK, LDS, kc * 16, dc + j * 8, lane);
          mma16816(dqp[j], a, b0, b1);
        }
      }
      float* dqb = dq_acc + (long)bh * Tq * D;
      const long rowA = q0 + qr + gg, rowB = rowA + 8;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = dc + j * 8 + 2 * t;
        atomicAdd(dqb + rowA * D + c, dqp[j][0]);
        atomicAdd(dqb + rowA * D + c + 1, dqp[j][1]);
        atomicAdd(dqb + rowB * D + c, dqp[j][2]);
        atomicAdd(dqb + rowB * D + c + 1, dqp[j][3]);
      }
    }
  }

  // ---- dK (x ln2, x 1 under softcap) and dV, bf16 ---------------------------
  const float ks = out_scale<SOFTCAP>();
  const long rowA = krow0 + kr + gg, rowB = rowA + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + rowA * D + c) =
        pack_f2(dkacc[j][0] * ks, dkacc[j][1] * ks);
    *reinterpret_cast<uint32_t*>(dk + rowB * D + c) =
        pack_f2(dkacc[j][2] * ks, dkacc[j][3] * ks);
    *reinterpret_cast<uint32_t*>(dv + rowA * D + c) = pack_f2(dvacc[j][0], dvacc[j][1]);
    *reinterpret_cast<uint32_t*>(dv + rowB * D + c) = pack_f2(dvacc[j][2], dvacc[j][3]);
  }
}

// Tq % 64 == 0, Tk % 128 == 0. Returns cudaGetLastError() after the launch.
template <bool FUSED_DQ, bool SOFTCAP>
inline int launch_dkv(const void* q, const void* k, const void* va, const void* mask,
               const void* doa, const void* lse, void* dq_acc, void* dk, void* dv,
               int BH, int Tq, int Tk, int heads, Cap cap, void* stream) {
  constexpr size_t smem = dkv_smem_bytes<FUSED_DQ>();
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<FUSED_DQ, SOFTCAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Tk / KV_BK, BH);
  dkv_kernel<FUSED_DQ, SOFTCAP><<<grid, KV_THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)va, (const int*)mask,
      (const bf16*)doa, (const float*)lse, (float*)dq_acc, (bf16*)dk, (bf16*)dv,
      Tq, Tk, heads, cap);
  return (int)cudaGetLastError();
}

}  // namespace attn_bwd
}  // namespace rtt
