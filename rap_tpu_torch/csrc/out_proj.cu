// Attention output projection + residual: head-major rows -> tokens -> @W+b.
//
// Replaces the TPU kernel rap_tpu/ops/fused_proj.py:458 `_out_kernel`
// (launched by `_out_call`, :474). Same math: the H head-major rows of a
// token are joined into one (H*dh) row, y = row @ W_out + b in fp32, then
// out = res + bf16(y) in bf16. The head-major input is (G,H,N,dh) for part
// attention and (S,H,P,N,dh) for global attention: for token t = b*L + l of
// attention sequence b (L = N resp. P*N tokens) and head h, row (b*H + h)*L
// + l of a (rows, dh) matrix.
//
// Bound on the H100 at the main path's shape (32768 tokens, D=512): 17.2
// GFLOP against ~100 MB that must move (a, residual, out), so memory bounds
// it (~30 us at 3.35 TB/s) with tensor-core work close behind (~17 us). One
// GEMM on the persistent TMA + wgmma GEMM of gemm_sm90.cuh (128 x 128 tiles,
// 64-deep k slabs, two blocks per SM so one block's epilogue runs under the
// other's products) with the FF's residual epilogue (`BiasResidual`: out =
// res + bf16(acc + b)). At dh = 64 a k slab is one head, and A's box for
// tile rows m.. and slab h is 64 contiguous rows of the head-major input
// (`a_box`; L % 128 == 0 keeps a tile inside one sequence), so the relayout
// costs no pass of its own: a is read once, by TMA. Other head widths first
// gather tokens(a) into a (T, D) bf16 scratch (tokens_kernel, 16-byte
// copies: 2 x 32 MB more traffic at the main path's size), then run the
// plain K-major GEMM.
// Takes every shape rap_tpu's fused guard admits: D % 128 == 0, L % 128 ==
// 0, dh % 8 == 0, dh < 128, D = H*dh (the wrapper checks; ops/fused_proj.py
// `out_shape_error`).
#include "gemm_sm90.cuh"

namespace {

using rtt::bf16;
using rtt::gemm::K_MAJOR;
using rtt::gemm::MN_MAJOR;

// dh = 64: A is the head-major input viewed as (rows, 64).
struct OutHeadMajor : rtt::gemm::BiasResidual {
  int H, L;  // heads, tokens of one attention sequence
  __device__ int2 a_box(int m, int k0) const {
    const int b = m / L;
    return make_int2((b * H + k0 / 64) * L + (m - b * L), 0);
  }
};

// Other head widths: A is the gathered (T, D) tokens.
struct OutTokens : rtt::gemm::BiasResidual {};

// xt[t, h*dh + c .. +7] = a[(b*H + h)*L + l, c .. +7], t = b*L + l; one
// 16-byte chunk a thread and step.
__global__ void __launch_bounds__(256)
tokens_kernel(const uint4* __restrict__ a, uint4* __restrict__ xt, long chunks, int H, int dh,
              int L) {
  const int cpr = H * dh / 8, cph = dh / 8;  // chunks of a token row, of a head row
  for (long i = (long)blockIdx.x * 256 + threadIdx.x; i < chunks; i += (long)gridDim.x * 256) {
    const long t = i / cpr;
    const int r = (int)(i - t * cpr), h = r / cph;
    const long b = t / L;
    xt[i] = a[((b * H + h) * L + (t - b * L)) * cph + (r - h * cph)];
  }
}

}  // namespace

// a head-major (rows, dh) bf16, res (G*N, D) bf16, w (D, D) bf16, b (D) bf16;
// scratch xt (G*N, D) bf16 where dh != 64 (else unused); out (G*N, D) bf16.
// L = N * P_layout tokens a sequence (P_layout = 1 for part attention, P for
// global). a, res, w, xt 16-byte aligned.
extern "C" int rtt_out_proj(const void* a, const void* res, const void* w, const void* b,
                            void* xt, void* out, int G, int N, int D, int H, int P_layout,
                            void* stream) {
  const int T = G * N, dh = D / H, L = N * P_layout;
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const rtt::gemm::BiasResidual epi{(const bf16*)res, (const bf16*)b, (bf16*)out, D};
  const rtt::gemm::Sched sched{T / 128, D / 128, 1, D / 64};
  CUtensorMap m_a, m_w;
  if (!rtt::gemm::tile_map(&m_w, w, D, D)) return (int)cudaErrorInvalidValue;
  if (dh == 64) {
    if (!rtt::gemm::tile_map(&m_a, a, (uint64_t)T * H, 64)) return (int)cudaErrorInvalidValue;
    return rtt::gemm::launch<K_MAJOR, MN_MAJOR>(m_a, m_w, sched, OutHeadMajor{epi, H, L}, s);
  }
  const long chunks = (long)T * D / 8;
  const long blocks = (chunks + 255) / 256;
  tokens_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      (const uint4*)a, (uint4*)xt, chunks, H, dh, L);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (!rtt::gemm::tile_map(&m_a, xt, T, D)) return (int)cudaErrorInvalidValue;
  return rtt::gemm::launch<K_MAJOR, MN_MAJOR>(m_a, m_w, sched, OutTokens{epi}, s);
}

// Registers and local bytes of the head-major GEMM, tokens_kernel and the
// tokens GEMM, two ints each.
extern "C" int rtt_out_proj_attributes(int* out) {
  int err = rtt::gemm::attributes(rtt::gemm::gemm_kernel<K_MAJOR, MN_MAJOR, OutHeadMajor>, out);
  if (!err) err = rtt::gemm::attributes(tokens_kernel, out + 2);
  if (!err)
    err = rtt::gemm::attributes(rtt::gemm::gemm_kernel<K_MAJOR, MN_MAJOR, OutTokens>, out + 4);
  return err;
}
