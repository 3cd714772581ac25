// Backward of the fused AdaLN-modulate + QKV projection + per-head RMS qk-norm.
//
// Replaces the TPU kernel rap_tpu/ops/fused_proj.py:184 `_proj_bwd_kernel`
// (launched by `_bwd_kernel_call`, :333). Same math and cast points:
// recompute h = bf16(LN(x) (1 + scale) + shift) and y = h W (fp32 sum, q and
// k columns only); per head of q and k, with r = rsqrt(sum y^2 + 1e-12) and
// dqg = dq * gain, dy = r dqg - y r^3 sum_head(dqg y) (fp32, then bf16), and
// d(gain) = sum over tokens of dq y r; the v section of dy is dv. Then dW =
// h^T dy (fp32 sum over all tokens, kept fp32), dh = dy W^T (fp32), and the
// AdaLN + LayerNorm vjp: d(scale) = sum dh xhat and d(shift) = sum dh per
// part, dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat)) with dxhat
// = dh (1 + scale). dq, dk and dv are read in
// their head-major layout ((G,H,N,dh) part, (S,H,P,N,dh) global): for token
// t = b*L + l of attention sequence b (L = N resp. P*N tokens) and head h,
// row (b*H + h)*L + l, as the TPU kernel folds them in its DMA reads.
//
// Bound on the H100 at the training shape (32768 tokens, D=512, H=8): the
// q, k recompute (2 T D 2D), dh (2 T 3D D) and dW (2 D T 3D) are 137 GFLOP
// (~0.139 ms at 989 TFLOP/s) against ~0.2 GB that must move, so the tensor
// cores bound it. The TPU kernel keeps dW resident across its sequential
// grid; blocks on the card run in parallel, so the function is a chain of
// launches on one stream, the products on the persistent TMA + wgmma GEMM of
// gemm_sm90.cuh (128 x 128 tiles, 64-deep k slabs):
//   1. adaln_ln_kernel<true> (ff_common.cuh): h (T, D) bf16, the forward's
//      row pass;
//   2. GEMM h . W[:, :2D] (K = D) with the qk-norm vjp in its epilogue
//      (ProjBwdEpi): a tile's 128 columns are two head slots (dh <= 64, B's
//      halves start at two heads' first columns, `b_cols`) or one head over
//      both halves (64 < dh < 128), as in proj.cu; a head's sums of y^2 and
//      dqg y are quad sums. It writes dy's q and k columns (T, 3D) bf16, and
//      per 64 tokens the column sums of dq y r (gain partials), summed
//      across the warpgroup's 4 warps through shared memory;
//   3. dv_copy_kernel: dy's v columns, dv head-major -> token-major, 16
//      bytes a load and a store;
//   4. GEMM dh = dy . W^T (K = 3D, W stored (D, 3D) is B K-major), fp32;
//   5. ln_grad_kernel<true> (ff_common.cuh): dx, and per block of R rows
//      (R the largest power of two <= 64 dividing N, so a block lies in one
//      part) the column sums of dh xhat and dh;
//   6. GEMM dW = h^T dy (A and B MN-major, K = T), split over token ranges
//      where the tiles alone would leave SMs idle (the wrapper picks the
//      splits: fused_ff.wgrad_splits), each split's fp32 partial in scratch;
//   7. the fixed-order reductions of gemm_sm90.cuh: colsum_kernel for
//      d(gain) and, one segment per part, d(scale | shift); splitsum_kernel
//      for dW.
// No atomics: every gradient is bitwise repeatable. The qk-norm epilogue
// needs more than the 96 registers two GEMM blocks an SM leave a thread, so
// its GEMM runs one block an SM (BLOCKS_PER_SM, as proj.cu's ProjEpi).
// Takes every shape the forward takes (ops/fused_proj.py
// `proj_shape_error`): D % 128 == 0, dh % 8 == 0, dh < 128, D = H*dh, G % P
// == 0, L % 128 == 0. Then H is even at dh <= 64 (an odd H would make dh a
// multiple of 128), so q's and k's 2H heads fill H tiles of two.
#include "ff_common.cuh"
#include "gemm_sm90.cuh"

namespace {

using rtt::gemm::K_MAJOR;
using rtt::gemm::MN_MAJOR;
using rtt::gemm::Unit;

__device__ __forceinline__ float2 unpack(uint32_t v) {  // a bf16 pair
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return make_float2(__low2float(b), __high2float(b));
}

// The recompute GEMM's epilogue. Heads are numbered [q heads | k heads], 2H
// in all; tile column tn holds heads 2tn and 2tn + 1 (dh <= 64) or head tn
// (dh > 64). The head's columns of W start at head * dh, as its columns of
// dy and of the gain gradients (q | k).
struct ProjBwdEpi {
  const bf16* dq;
  const bf16* dk;
  const float* gq;
  const float* gk;
  bf16* dy;     // (T, 3D)
  float* gpart; // (T / 64, 2D): each 64 tokens' column sums of dq y r
  int H, dh, L, D;
  static constexpr int SCRATCH = 128 * sizeof(float);  // a warp's 128 column sums
  static constexpr int BLOCKS_PER_SM = 1;              // see the head comment

  __device__ bool wide() const { return dh > 64; }
  __device__ int head(int tn, int s) const { return wide() ? tn : 2 * tn + s; }
  __device__ int col0(int s) const { return wide() ? 64 * s : 0; }  // slot's first column
  __device__ int2 b_cols(int tn) const {
    if (wide()) return make_int2(tn * dh, tn * dh + 64);
    return make_int2(2 * tn * dh, (2 * tn + 1) * dh);
  }
  // head hi's cotangent (dq or dk) row hrow + (its head-major offset), and
  // its gains
  __device__ const bf16* cot(int hi, long hrow) const {
    const int kind = hi / H, hh = hi - kind * H;
    return (kind ? dk : dq) + (hrow + (long)hh * L) * dh;
  }
  __device__ const float* gain(int hi) const {
    const int kind = hi / H, hh = hi - kind * H;
    return (kind ? gk : gq) + hh * dh;
  }

  __device__ void operator()(const float (&acc)[64], const Unit& u, int row0, int wq, int lane,
                             uint8_t* scratch) const {
    const int g = lane >> 2, t = lane & 3;
    const int m = row0 + 16 * wq;  // the warp's first token: rows m + g, m + g + 8
    const int b = m / L;
    const long l = m - (long)b * L;
    const long hrow0 = (long)b * H * L + l + g;  // head 0's row of token m + g
    // the cotangent pairs (bf16x2) of slot s, row m + g + 8h, column block j,
    // all loaded first: one memory latency, and none behind a store to dy
    uint32_t cv[2][2][8];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bf16* src = cot(head(u.tn, s), hrow0 + 8 * h) + col0(s) + 2 * t;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          cv[s][h][j] =
              col0(s) + 8 * j < dh ? *reinterpret_cast<const uint32_t*>(src + 8 * j) : 0u;
      }
    }
    // r[s][h], cf[s][h]: rsqrt(sum y^2) and r^3 sum(dqg y) of the slot's head
    // on row m + g + 8h
    float r[2][2], cf[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ss[2], sd[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float* gn = gain(head(u.tn, s)) + col0(s) + 2 * t;
        float v = 0.f, w = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (col0(s) + 8 * j < dh) {
            const float a0 = acc[4 * (8 * s + j) + 2 * h], a1 = acc[4 * (8 * s + j) + 2 * h + 1];
            const float2 d = unpack(cv[s][h][j]);
            const float2 gv = __ldg(reinterpret_cast<const float2*>(gn + 8 * j));
            v += a0 * a0 + a1 * a1;
            w += d.x * gv.x * a0 + d.y * gv.y * a1;
          }
        }
        ss[s] = rtt::quad_sum(v);
        sd[s] = rtt::quad_sum(w);
      }
      if (wide()) {
        ss[0] = ss[1] = ss[0] + ss[1];
        sd[0] = sd[1] = sd[0] + sd[1];
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        r[s][h] = rsqrtf(ss[s] + 1e-12f);
        cf[s][h] = sd[s] * r[s][h] * r[s][h] * r[s][h];
      }
    }

    // dy = r dqg - y cf in bf16, and the column sums of dq y r over the
    // warp's 16 rows into its scratch (column 64s + c of the tile)
    float* red = reinterpret_cast<float*>(scratch);
    float* red_wg = red - wq * 128;  // the warpgroup's 4 warps' scratch, in order
    const int c = (row0 >> 6) & 1;   // the consumer warpgroup
    rtt::bar_sync(1 + c, 128);       // the last unit's sums were read
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int hi = head(u.tn, s);
      const float* gn = gain(hi) + col0(s) + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (col0(s) + 8 * j >= dh) continue;
        const float2 gv = __ldg(reinterpret_cast<const float2*>(gn + 8 * j));
        float e0 = 0.f, e1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 d = unpack(cv[s][h][j]);
          const float d0 = d.x, d1 = d.y;
          const float y0 = acc[4 * (8 * s + j) + 2 * h], y1 = acc[4 * (8 * s + j) + 2 * h + 1];
          *reinterpret_cast<uint32_t*>(dy + (long)(m + g + 8 * h) * 3 * D + hi * dh + col0(s) +
                                       8 * j + 2 * t) =
              rtt::pack_f2(r[s][h] * d0 * gv.x - y0 * cf[s][h],
                           r[s][h] * d1 * gv.y - y1 * cf[s][h]);
          e0 += d0 * y0 * r[s][h];
          e1 += d1 * y1 * r[s][h];
        }
        e0 = rtt::col_sum8(e0);
        e1 = rtt::col_sum8(e1);
        if (g == 0) {
          red[64 * s + 8 * j + 2 * t] = e0;
          red[64 * s + 8 * j + 2 * t + 1] = e1;
        }
      }
    }
    rtt::bar_sync(1 + c, 128);
    {  // the warpgroup's 64 tokens: its four warps' sums, in order
      const int i = 32 * wq + lane, s = i >> 6, cc = i & 63;
      if (col0(s) + cc < dh) {
        const float v = red_wg[i] + red_wg[128 + i] + red_wg[256 + i] + red_wg[384 + i];
        gpart[(long)(row0 >> 6) * 2 * D + head(u.tn, s) * dh + col0(s) + cc] = v;
      }
    }
  }
};

// dy[t, 2D + h*dh + c] = dv[(b*H + h)*L + l, c], c < dh, for token t =
// b*L + l: one thread a run of 8 values, read and written 16 bytes at a time.
__global__ void __launch_bounds__(256)
dv_copy_kernel(const bf16* __restrict__ dv, bf16* __restrict__ dy, long rows, int H, int dh,
               int L, int D) {
  const int per = dh / 8;
  for (long i = (long)blockIdx.x * 256 + threadIdx.x; i < rows * per;
       i += (long)gridDim.x * 256) {
    const long r = i / per;
    const int c = (int)(i - r * per) * 8;
    const long bh = r / L, l = r - bh * L, b = bh / H;
    const int hh = (int)(bh - b * H);
    *reinterpret_cast<uint4*>(dy + (b * L + l) * 3 * D + 2 * D + hh * dh + c) =
        *reinterpret_cast<const uint4*>(dv + r * dh + c);
  }
}

}  // namespace

// x (G,N,D) bf16; ada (G,2D) fp32 = (scale | shift); w (D,3D) bf16; gq, gk
// (H*dh) fp32 folded gains; dq, dk, dv head-major bf16, with L = N *
// P_layout tokens a sequence (P_layout = 1 for part attention, P for
// global). Scratch: hln (T, D) bf16, dy (T, 3D) bf16, dhid
// (T, D) fp32, gpart (T / 64, 2D), lnpart (T / R, 2D), wpart (splits, D, 3D)
// fp32 (unused for one split). Outputs: dx (G,N,D) bf16; dada (G, 2D) =
// (d scale | d shift), dw (D, 3D), dgain (2D: q | k), fp32. R: rows of an LN
// vjp block, a power of two <= 64 that divides N; splits: token splits of
// dW's product (1 <= splits <= T / 64). x, w, dq, dk, dv, hln, dy 16-byte
// aligned.
extern "C" int rtt_proj_bwd(const void* x, const void* ada, const void* w, const void* gq,
                            const void* gk, const void* dq, const void* dk, const void* dv,
                            void* hln, void* dy, void* dhid, void* gpart, void* lnpart,
                            void* wpart, void* dx, void* dada, void* dw, void* dgain, int G,
                            int N, int D, int H, int P_layout, int R, int splits,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int T = G * N, dh = D / H, L = N * P_layout;
  if (T == 0) {  // no tokens: every gradient is 0
    cudaMemsetAsync(dada, 0, sizeof(float) * G * 2L * D, s);
    cudaMemsetAsync(dw, 0, sizeof(float) * D * 3L * D, s);
    cudaMemsetAsync(dgain, 0, sizeof(float) * 2L * D, s);
    return (int)cudaGetLastError();
  }
  adaln_ln_kernel<true><<<T / (LN_THREADS / 32), LN_THREADS, 0, s>>>(
      (const bf16*)x, (const float*)ada, (bf16*)hln, N, D);
  int err = (int)cudaGetLastError();
  if (err) return err;

  CUtensorMap m_h, m_w, m_dy;
  if (!rtt::gemm::tile_map(&m_h, hln, T, D) || !rtt::gemm::tile_map(&m_w, w, D, 3L * D) ||
      !rtt::gemm::tile_map(&m_dy, dy, T, 3L * D))
    return (int)cudaErrorInvalidValue;
  const rtt::gemm::Sched sq{T / 128, dh > 64 ? 2 * H : H, 1, D / 64};
  const ProjBwdEpi epi{(const bf16*)dq, (const bf16*)dk, (const float*)gq, (const float*)gk,
                       (bf16*)dy, (float*)gpart, H, dh, L, D};
  if ((err = rtt::gemm::launch<K_MAJOR, MN_MAJOR>(m_h, m_w, sq, epi, s))) return err;
  if ((err = rtt::gemm::launch_colsum((const float*)gpart, (float*)dgain, T / 64, 2 * D, s)))
    return err;

  const long rows = (long)T * H, units = rows * (dh / 8);
  const long blocks = (units + 255) / 256;
  dv_copy_kernel<<<(int)(blocks < 65536 ? blocks : 65536), 256, 0, s>>>(
      (const bf16*)dv, (bf16*)dy, rows, H, dh, L, D);
  if ((err = (int)cudaGetLastError())) return err;

  const rtt::gemm::Sched sd{T / 128, D / 128, 1, 3 * D / 64};
  if ((err = rtt::gemm::launch<K_MAJOR, K_MAJOR>(m_dy, m_w, sd,
                                                 rtt::gemm::F32Out<9>{(float*)dhid, 0, T, D},
                                                 s)))
    return err;
  ln_grad_kernel<true><<<T / R, LN_THREADS, 0, s>>>((const bf16*)x, (const float*)dhid,
                                                    (const float*)ada, nullptr, (bf16*)dx,
                                                    (float*)lnpart, D, R, N);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = rtt::gemm::launch_colsum((const float*)lnpart, (float*)dada, N / R, 2 * D, s, G)))
    return err;
  return rtt::gemm::weight_grad<9>(hln, dy, (float*)dw, (float*)wpart, T, D, 3 * D, splits, s);
}

// Registers and local bytes of the backward's kernels, two ints each, in the
// order adaln_ln_kernel<true>, the recompute GEMM, dv_copy_kernel, the dh
// GEMM, ln_grad_kernel<true>, the dW GEMM.
extern "C" int rtt_proj_bwd_attributes(int* out) {
  int err = rtt::gemm::attributes(adaln_ln_kernel<true>, out);
  if (!err)
    err = rtt::gemm::attributes(rtt::gemm::gemm_kernel<K_MAJOR, MN_MAJOR, ProjBwdEpi>, out + 2);
  if (!err) err = rtt::gemm::attributes(dv_copy_kernel, out + 4);
  if (!err)
    err = rtt::gemm::attributes(rtt::gemm::gemm_kernel<K_MAJOR, K_MAJOR, rtt::gemm::F32Out<9>>,
                                out + 6);
  if (!err) err = rtt::gemm::attributes(ln_grad_kernel<true>, out + 8);
  if (!err)
    err = rtt::gemm::attributes(
        rtt::gemm::gemm_kernel<MN_MAJOR, MN_MAJOR, rtt::gemm::F32Out<9>>, out + 10);
  return err;
}
