// The masked Kabsch fit of every part in one launch, with no host sync. It
// replaces rap_tpu's kabsch_masked (rap_tpu/core/procrustes.py:19), which has
// no Pallas kernel (XLA lowers its SVD), where the port took cuSOLVER's SVD:
// that checks its convergence on the host, so every fit drained the card.
// Bound by bytes (each point is read a few times for ~30 flops) and, at a few
// thousand points a part, by the latency of one block's passes. One block a
// part of (B, N, 3), fp32 all through:
//
//   1. the weighted centroids (w = mask * weights), one pass;
//   2. the 3x3 cross-covariance of the centred points, a second pass (two
//      passes keep clouds far from the origin exact to fp32);
//   3. the degenerate rule (n_eff < 2.5 or sum H^2 < 1e-24: R = I; an empty
//      part t = 0), else the SVD by cyclic one-sided Jacobi in one thread's
//      registers: the steps of core/procrustes.py's _jacobi_svd3 (fixed
//      sweeps, columns sorted by norm, U's third column u1 x u2, the rank-1
//      axis), then the det fix R = V diag(1, 1, det(V U^T)) U^T;
//   4. R and t written; with x_1 given, a third pass writes the forced ODE
//      state x_next = where(mask, R c + t, tgt) * keep + x_1 * t_next.
//
// The target is tgt, or tgt - vel * tscale where vel is given (the sampler's
// end-point estimate x_0_hat = x_t - v t, formed on the fly). The products
// and sums that mirror the plain PyTorch path round where it rounds
// (__fmul_rn / __fadd_rn keep nvcc from fusing them). Every sum runs in a
// fixed order (per-thread strides, a warp tree, the warps in order): the
// kernel is bitwise repeatable.
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SWEEPS = 6;  // core/procrustes.py _JACOBI_SWEEPS

struct Args {
  const float* src;      // (B, N, 3)
  const float* tgt;      // (B, N, 3)
  const float* vel;      // (B, N, 3) or null
  const uint8_t* mask;   // (B, N) bool
  const float* weights;  // (B, N) or null
  const float* x1;       // (B, N, 3) or null
  float* out;            // (B, N, 3), written where x1 is given
  float* R;              // (B, 3, 3)
  float* t;              // (B, 3)
  float tscale, keep, t_next;
  int N;
};

// The sums of K per-thread values over the block, every thread gets them.
// ``red`` holds K * WARPS floats.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float s = rtt::warp_sum(v[k]);
    if (lane == 0) red[k * WARPS + warp] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[k * WARPS + w];
    v[k] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])), __fmul_rn(a[2], b[2]));
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  c[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  c[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

// Columns i and j of (A, V) and their norms swapped where column j is the
// longer (a compare-and-swap of a stable sort by descending norm).
__device__ __forceinline__ void order_pair(float (&a)[3][3], float (&v)[3][3], float (&n)[3],
                                           int i, int j) {
  const bool swap = n[j] > n[i];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float ai = a[i][r], vi = v[i][r];
    a[i][r] = swap ? a[j][r] : ai;
    a[j][r] = swap ? ai : a[j][r];
    v[i][r] = swap ? v[j][r] : vi;
    v[j][r] = swap ? vi : v[j][r];
  }
  const float ni = n[i];
  n[i] = swap ? n[j] : ni;
  n[j] = swap ? ni : n[j];
}

// R (row-major) of the Kabsch fit from the cross-covariance H (row-major),
// by one thread: _jacobi_svd3, then R = V diag(1, 1, det(V U^T)) U^T.
__device__ void kabsch_rotation(const float* H, float* R) {
  float a[3][3], v[3][3];  // a[i], v[i]: column i of H V and of V
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      a[i][r] = H[r * 3 + i];
      v[i][r] = r == i ? 1.f : 0.f;
    }
#pragma unroll
  for (int sweep = 0; sweep < SWEEPS; ++sweep)
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      const float alpha = dot3(a[p], a[p]), beta = dot3(a[q], a[q]);
      const float gamma = dot3(a[p], a[q]);
      const bool off = gamma != 0.f;
      const float zeta = __fdiv_rn(beta - alpha, 2.f * (off ? gamma : 1.f));
      const float root = __fsqrt_rn(__fadd_rn(1.f, __fmul_rn(zeta, zeta)));
      float tn = __fdiv_rn(zeta >= 0.f ? 1.f : -1.f, __fadd_rn(fabsf(zeta), root));
      tn = off ? tn : 0.f;
      const float c = rsqrtf(__fadd_rn(1.f, __fmul_rn(tn, tn)));
      const float s = __fmul_rn(c, tn);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float ap = a[p][r], aq = a[q][r], vp = v[p][r], vq = v[q][r];
        a[p][r] = __fsub_rn(__fmul_rn(c, ap), __fmul_rn(s, aq));
        a[q][r] = __fadd_rn(__fmul_rn(s, ap), __fmul_rn(c, aq));
        v[p][r] = __fsub_rn(__fmul_rn(c, vp), __fmul_rn(s, vq));
        v[q][r] = __fadd_rn(__fmul_rn(s, vp), __fmul_rn(c, vq));
      }
    }
  float n[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = __fsqrt_rn(dot3(a[i], a[i]));
  order_pair(a, v, n, 0, 1);
  order_pair(a, v, n, 1, 2);
  order_pair(a, v, n, 0, 1);
  float u[3][3];  // u[i]: column i of U
  const float s1 = n[0], s2 = n[1];
#pragma unroll
  for (int r = 0; r < 3; ++r) u[0][r] = __fdiv_rn(a[0][r], fmaxf(s1, 1e-30f));
  // rank 1: a unit vector orthogonal to u1, from the axis least along it
  const float m0 = fabsf(u[0][0]), m1 = fabsf(u[0][1]), m2 = fabsf(u[0][2]);
  const int ax = m1 < m0 ? (m2 < m1 ? 2 : 1) : (m2 < m0 ? 2 : 0);
  const float e[3] = {ax == 0 ? 1.f : 0.f, ax == 1 ? 1.f : 0.f, ax == 2 ? 1.f : 0.f};
  float alt[3];
  cross3(u[0], e, alt);
  const float alt_n = fmaxf(__fsqrt_rn(dot3(alt, alt)), 1e-30f);
  const bool full = s2 > __fmul_rn(1e-12f, s1);
#pragma unroll
  for (int r = 0; r < 3; ++r)
    u[1][r] = full ? __fdiv_rn(a[1][r], fmaxf(s2, 1e-30f)) : __fdiv_rn(alt[r], alt_n);
  cross3(u[0], u[1], u[2]);
  // d = det(V U^T): M_rc = sum_k V_rk U_ck = sum_k v[k][r] u[k][c]
  float M[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      M[r][c] = __fadd_rn(__fadd_rn(__fmul_rn(v[0][r], u[0][c]), __fmul_rn(v[1][r], u[1][c])),
                          __fmul_rn(v[2][r], u[2][c]));
  const float d =
      __fmul_rn(M[0][0], __fsub_rn(__fmul_rn(M[1][1], M[2][2]), __fmul_rn(M[1][2], M[2][1]))) -
      __fmul_rn(M[0][1], __fsub_rn(__fmul_rn(M[1][0], M[2][2]), __fmul_rn(M[1][2], M[2][0]))) +
      __fmul_rn(M[0][2], __fsub_rn(__fmul_rn(M[1][0], M[2][1]), __fmul_rn(M[1][1], M[2][0])));
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      R[r * 3 + c] = __fadd_rn(__fadd_rn(__fmul_rn(v[0][r], u[0][c]), __fmul_rn(v[1][r], u[1][c])),
                               __fmul_rn(__fmul_rn(v[2][r], d), u[2][c]));
}

__device__ __forceinline__ void load_target(const Args& a, long i, float* y) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float g = a.tgt[3 * i + k];
    y[k] = a.vel ? __fsub_rn(g, __fmul_rn(a.vel[3 * i + k], a.tscale)) : g;
  }
}

__device__ __forceinline__ float weight(const Args& a, long i) {
  const float m = a.mask[i] ? 1.f : 0.f;
  return a.weights ? __fmul_rn(m, a.weights[i]) : m;
}

__global__ void __launch_bounds__(THREADS) kabsch_kernel(Args a) {
  __shared__ float red[9 * WARPS];
  __shared__ float pose[12];  // R (row-major), t
  const long base = (long)blockIdx.x * a.N;

  // pass 1: sum w, sum w src, sum w tgt
  float m[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = threadIdx.x; n < a.N; n += THREADS) {
    const long i = base + n;
    const float w = weight(a, i);
    float y[3];
    load_target(a, i, y);
    m[0] += w;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      m[1 + k] += __fmul_rn(a.src[3 * i + k], w);
      m[4 + k] += __fmul_rn(y[k], w);
    }
  }
  block_sum(m, red);
  const float n_eff = m[0], wsum = fmaxf(m[0], 1e-12f);
  float sm[3], tm[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    sm[k] = __fdiv_rn(m[1 + k], wsum);
    tm[k] = __fdiv_rn(m[4 + k], wsum);
  }

  // pass 2: H = sum ((src - sm) w) (tgt - tm)^T
  float h[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = threadIdx.x; n < a.N; n += THREADS) {
    const long i = base + n;
    const float w = weight(a, i);
    float y[3], x[3];
    load_target(a, i, y);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x[k] = __fmul_rn(__fsub_rn(a.src[3 * i + k], sm[k]), w);
      y[k] = __fsub_rn(y[k], tm[k]);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) h[r * 3 + c] += __fmul_rn(x[r], y[c]);
  }
  block_sum(h, red);

  if (threadIdx.x == 0) {
    float hh = 0.f;
#pragma unroll
    for (int k = 0; k < 9; ++k) hh += h[k] * h[k];
    float R[9];
    if (n_eff < 2.5f || hh < 1e-24f) {
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = k % 4 == 0 ? 1.f : 0.f;
    } else {
      kabsch_rotation(h, R);
    }
    float* Rg = a.R + 9 * (long)blockIdx.x;
    float* tg = a.t + 3 * (long)blockIdx.x;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float rs = __fadd_rn(
          __fadd_rn(__fmul_rn(R[3 * r], sm[0]), __fmul_rn(R[3 * r + 1], sm[1])),
          __fmul_rn(R[3 * r + 2], sm[2]));
      const float tr = n_eff < 1e-9f ? 0.f : __fsub_rn(tm[r], rs);
      tg[r] = pose[9 + r] = tr;
#pragma unroll
      for (int c = 0; c < 3; ++c) Rg[3 * r + c] = pose[3 * r + c] = R[3 * r + c];
    }
  }
  if (!a.x1) return;
  __syncthreads();

  // pass 3: the forced state where(mask, R c + t, tgt) * keep + x_1 * t_next
  float R[9], tr[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) tr[k] = pose[9 + k];
  for (int n = threadIdx.x; n < a.N; n += THREADS) {
    const long i = base + n;
    float y[3];
    load_target(a, i, y);
    const bool in = a.mask[i];
    const float c0 = a.src[3 * i], c1 = a.src[3 * i + 1], c2 = a.src[3 * i + 2];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float rigid = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(c0, R[3 * r]), __fmul_rn(c1, R[3 * r + 1])),
                    __fmul_rn(c2, R[3 * r + 2])),
          tr[r]);
      const float x0 = in ? rigid : y[r];
      a.out[3 * i + r] = __fadd_rn(__fmul_rn(x0, a.keep), __fmul_rn(a.x1[3 * i + r], a.t_next));
    }
  }
}

}  // namespace

// One fit a part of B parts of N points; vel, weights, x1 and out may be
// null (x1 and out together). keep = 1 - t_next, taken from the caller so
// it rounds as the plain path's scalar does.
extern "C" int rtt_kabsch(const void* src, const void* tgt, const void* vel, const void* mask,
                          const void* weights, const void* x1, void* out, void* R, void* t,
                          float tscale, float keep, float t_next, int B, int N, void* stream) {
  if (B == 0) return 0;
  const Args a{(const float*)src, (const float*)tgt, (const float*)vel, (const uint8_t*)mask,
               (const float*)weights, (const float*)x1, (float*)out, (float*)R, (float*)t,
               tscale, keep, t_next, N};
  kabsch_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Registers and local bytes of kabsch_kernel (two ints).
extern "C" int rtt_kabsch_attributes(int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kabsch_kernel);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  return (int)err;
}
