// Flash attention backward on head-major, pre-scaled (base-2) q, k, v.
//
// Replaces the TPU kernel rap_tpu/ops/pallas_attention.py:506
// `_flash_bwd_fused_kernel` (launched by `_bwd_fused_impl`, :588), the
// single-pass backward of the no-padding path (masked=False). It serves
// both forward variants: lse2 comes from the fixed-bound or the online
// kernel. Same math and cast points as `_recompute_p_ds` (:369): per tile,
// p = exp2(q.k - lse2) in fp32; dp - delta = [dO | -delta] . [V | ones]^T
// with fp32 sums, the -delta column in bf16 (`_augment_do`, :566); ds =
// p (dp - delta) in fp32; p and ds rounded to bf16 before the products.
// dV = sum p^T dO, dK = ln2 sum ds^T Q, dQ = ln2 sum ds K, the ln2 applied
// once per output element (dK here, dQ by the caller).
//
// dQ: the TPU kernel writes one fp32 partial per kv block, (BH, nk, T, d),
// and sums them afterwards. With 128-key blocks that slab would be 4 GiB at
// the global shape, so here every block adds its dQ tile into one fp32
// (BH, T, d) accumulator (64 MiB) with atomicAdd; the caller scales it by
// ln2 and rounds it to bf16.
//
// Bound on the H100 at the training shapes (d=64; global BH=32, T=8192:
// 5 products of 2 T^2 d per head = 1.37 TFLOP, ~1.39 ms at 989 TFLOP/s;
// part BH=64, T=4096: 0.69 TFLOP): the tensor cores bound it, exp2 on the
// FP32 pipes next. Simple first design (FlashAttention-2 style): a block owns
// 128 keys of one head (16 per warp) and keeps their dK and dV in registers
// while it walks all queries in blocks of 64 staged in shared memory;
// S^T = K Q^T and dP^T = V dO^T give P^T and dS^T in registers, which feed
// dV += P^T dO and dK += dS^T Q directly; dS^T goes through shared memory for
// dQ += dS K. Warp-level mma.sync; no TMA, no wgmma, no pipelining.
#include "common.cuh"

namespace {

using rtt::bf16;
constexpr int D = 64;          // head width
constexpr int BQ = 64;         // queries per step
constexpr int BK = 128;        // keys per block
constexpr int NTHREADS = 256;  // 8 warps x 16 keys
constexpr int LDS = D + 8;
constexpr int LDDS = BQ + 8;
constexpr float LN2 = 0.6931471805599453f;

constexpr size_t SMEM_BYTES =
    (size_t)(2 * BK * LDS + 2 * BQ * LDS + BK * LDDS) * sizeof(bf16) +
    (size_t)(2 * BQ + BK) * sizeof(float);

__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ va, const bf16* __restrict__ doa,
                 const float* __restrict__ lse, float* __restrict__ dq_acc,
                 bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [key][dim]
  bf16* sV = sK + BK * LDS;                        // [key][dim]
  bf16* sQ = sV + BK * LDS;                        // [query][dim]
  bf16* sDO = sQ + BQ * LDS;                       // [query][dim]
  bf16* sDS = sDO + BQ * LDS;                      // dS^T [key][query]
  float* sLse = reinterpret_cast<float*>(sDS + BK * LDDS);
  float* sND = sLse + BQ;                          // -delta per query
  float* sOne = sND + BQ;                          // va's ones column per key

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gg = lane >> 2, t = lane & 3;
  const bf16* qb = q + (long)bh * Tq * D;
  const bf16* dob = doa + (long)bh * Tq * (D + 1);
  const float* lb = lse + (long)bh * Tq;
  const bf16* vb = va + ((long)bh * Tk + k0) * (D + 1);
  float* dqb = dq_acc + (long)bh * Tq * D;

  rtt::stage_tile<NTHREADS>(sK, LDS, k + ((long)bh * Tk + k0) * D, D, BK, D);
  for (int i = threadIdx.x; i < BK * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    sV[r * LDS + c] = vb[(long)r * (D + 1) + c];
  }
  for (int i = threadIdx.x; i < BK; i += NTHREADS)
    sOne[i] = __bfloat162float(vb[(long)i * (D + 1) + D]);

  const int kr = warp * 16;  // this warp's first key row in the block
  float dkacc[D / 8][4], dvacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dkacc[j][0] = dkacc[j][1] = dkacc[j][2] = dkacc[j][3] = 0.f;
    dvacc[j][0] = dvacc[j][1] = dvacc[j][2] = dvacc[j][3] = 0.f;
  }
  // dQ tile of this warp in the dS K product: query rows qr.., dims dc..
  const int qr = (warp & 3) * 16, dc = (warp >> 2) * 32;

  for (int q0 = 0; q0 < Tq; q0 += BQ) {
    __syncthreads();  // the previous step's reads of sQ, sDO, sDS are done
    rtt::stage_tile<NTHREADS>(sQ, LDS, qb + (long)q0 * D, D, BQ, D);
    for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      sDO[r * LDS + c] = dob[(long)(q0 + r) * (D + 1) + c];
    }
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      sLse[i] = lb[q0 + i];
      sND[i] = __bfloat162float(dob[(long)(q0 + i) * (D + 1) + D]);
    }
    __syncthreads();

    // ---- S^T = K Q^T and dP^T = V dO^T: 16 keys x 64 queries per warp ----
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t ka[4], vfa[4];
      rtt::load_a(ka, sK, LDS, kr, kc * 16, lane);
      rtt::load_a(vfa, sV, LDS, kr, kc * 16, lane);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        uint32_t b0, b1;
        rtt::load_b_nk(b0, b1, sQ, LDS, kc * 16, j * 8, lane);
        rtt::mma16816(st[j], ka, b0, b1);
        rtt::load_b_nk(b0, b1, sDO, LDS, kc * 16, j * 8, lane);
        rtt::mma16816(dpt[j], vfa, b0, b1);
      }
    }

    // ---- P^T, dS^T: bf16 A fragments (M = keys, K = queries) ---------------
    const float oneA = sOne[kr + gg], oneB = sOne[kr + gg + 8];
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int c = j * 8 + 2 * t;  // query within the step
      const float l0 = sLse[c], l1 = sLse[c + 1];
      const float n0 = sND[c], n1 = sND[c + 1];
      const float p00 = exp2f(st[j][0] - l0), p01 = exp2f(st[j][1] - l1);
      const float p10 = exp2f(st[j][2] - l0), p11 = exp2f(st[j][3] - l1);
      const float s00 = p00 * (dpt[j][0] + n0 * oneA);
      const float s01 = p01 * (dpt[j][1] + n1 * oneA);
      const float s10 = p10 * (dpt[j][2] + n0 * oneB);
      const float s11 = p11 * (dpt[j][3] + n1 * oneB);
      const int slot = (j & 1) * 2;  // C tile j -> A registers of k-step j/2
      pa[j >> 1][slot] = rtt::pack_f2(p00, p01);
      pa[j >> 1][slot + 1] = rtt::pack_f2(p10, p11);
      dsa[j >> 1][slot] = rtt::pack_f2(s00, s01);
      dsa[j >> 1][slot + 1] = rtt::pack_f2(s10, s11);
      *reinterpret_cast<uint32_t*>(sDS + (kr + gg) * LDDS + c) = dsa[j >> 1][slot];
      *reinterpret_cast<uint32_t*>(sDS + (kr + gg + 8) * LDDS + c) =
          dsa[j >> 1][slot + 1];
    }

    // ---- dV += P^T dO, dK += dS^T Q (M = keys, K = queries, N = dims) -------
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        rtt::load_b_kn(b0, b1, sDO, LDS, kc * 16, j * 8, lane);
        rtt::mma16816(dvacc[j], pa[kc], b0, b1);
        rtt::load_b_kn(b0, b1, sQ, LDS, kc * 16, j * 8, lane);
        rtt::mma16816(dkacc[j], dsa[kc], b0, b1);
      }
    }
    __syncthreads();  // dS^T of every warp is in shared memory

    // ---- dQ(64 queries x 64 dims) += dS K: 16 x 32 per warp, K = 128 keys ---
    float dqp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) dqp[j][0] = dqp[j][1] = dqp[j][2] = dqp[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t a[4];
      rtt::load_a_km(a, sDS, LDDS, qr, kc * 16, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b0, b1;
        rtt::load_b_kn(b0, b1, sK, LDS, kc * 16, dc + j * 8, lane);
        rtt::mma16816(dqp[j], a, b0, b1);
      }
    }
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

  // ---- dK (x ln2) and dV, bf16 ---------------------------------------------
  const long rowA = (long)bh * Tk + k0 + kr + gg, rowB = rowA + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(dk + rowA * D + c) =
        rtt::pack_f2(dkacc[j][0] * LN2, dkacc[j][1] * LN2);
    *reinterpret_cast<uint32_t*>(dk + rowB * D + c) =
        rtt::pack_f2(dkacc[j][2] * LN2, dkacc[j][3] * LN2);
    *reinterpret_cast<uint32_t*>(dv + rowA * D + c) =
        rtt::pack_f2(dvacc[j][0], dvacc[j][1]);
    *reinterpret_cast<uint32_t*>(dv + rowB * D + c) =
        rtt::pack_f2(dvacc[j][2], dvacc[j][3]);
  }
}

}  // namespace

// q, k (BH, T, 64) bf16; va (BH, Tk, 65) bf16 with its ones column; doa
// (BH, Tq, 65) bf16 = [dO | -delta]; lse (BH, Tq) fp32 from either forward.
// dq_acc (BH, Tq, 64) fp32 zeroed by the caller (it receives sum ds K, not
// yet times ln2); dk, dv (BH, Tk, 64) bf16. Tq % 64 == 0, Tk % 128 == 0.
extern "C" int rtt_flash_bwd(const void* q, const void* k, const void* va,
                             const void* doa, const void* lse, void* dq_acc,
                             void* dk, void* dv, int BH, int Tq, int Tk,
                             void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Tk / BK, BH);
  flash_bwd_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)va, (const bf16*)doa,
      (const float*)lse, (float*)dq_acc, (bf16*)dk, (bf16*)dv, Tq, Tk);
  return (int)cudaGetLastError();
}
