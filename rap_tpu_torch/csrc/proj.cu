// Fused AdaLN-modulate + QKV projection + per-head RMS qk-norm, head-major out.
//
// Replaces the TPU kernel rap_tpu/ops/fused_proj.py:46 `_proj_kernel`
// (launched by `_kernel_call`, :100). Same math and the same bf16 cast
// points: LN without affine (eps 1e-5) in fp32 -> h*(1+scale)+shift -> bf16
// -> h @ W (D, 3D) with fp32 accumulation -> per-head RMS of q and k with the
// folded gains (gq*log2e, gk*sqrt(dh)) -> bf16; v is cast from the fp32 sum
// (ops/fused_proj.py says how its layout differs from the TPU kernel's).
// Outputs are written straight into the head-major
// layout the attention kernel reads: (G,H,N,dh) for part attention and
// (S,H,P,N,dh) for global attention. Both are, for token t = b*L + l of
// attention sequence b (L = N resp. P*N tokens) and head h, row (b*H + h)*L
// + l of a (rows, dh) matrix.
//
// Bound on the H100 at the main path's shape (32768 tokens, D=512, H=8):
// the product is 51.5 GFLOP against ~100 MB that must move (x in; q, k and
// v out), so the tensor cores bound it (~52 us at 989 TFLOP/s). Two
// launches on one stream:
//   1. adaln_ln_kernel<false>: hln = bf16(LN(x)(1 + scale[g]) + shift[g]),
//      (T, D), g = t / N (ff_common.cuh);
//   2. hln . W on the persistent TMA + wgmma GEMM of gemm_sm90.cuh (128 x 128
//      tiles, 64-deep k slabs). A tile's 128 columns are two head slots
//      (dh <= 64: B's halves start at two heads' first columns, `b_cols`) or
//      one head over both halves (64 < dh < 128); a slot's columns past its
//      head are computed and dropped, so at dh = 64 nothing is wasted. The
//      epilogue takes each head's sum of squares over a quad of threads
//      (a row's columns of one half lie in the quad's 4 threads) and stores
//      q and k from the accumulator's layout, 4 bytes a store; v goes
//      through 2 KB of shared memory a warp, 8 rows at a time, and out as
//      16-byte stores of one contiguous block (a tile's 128 rows of one head
//      are contiguous in both layouts, L % 128 == 0). Stored as q and k are,
//      v made the GEMM 1.4x (part) and 1.7x (global layout) slower at the
//      serving shape on an H100. The GEMM runs one block an SM with a 6-slab
//      ring, which the producer fills with the next tile's slabs while the
//      consumers run the epilogue: every epilogue tried with two blocks an
//      SM (96 registers a thread) spilled 72-104 bytes, as the qk-norm
//      epilogue of proj_bwd.cu does.
// Takes every shape rap_tpu's fused guard admits: D % 128 == 0, L % 128 ==
// 0, dh % 8 == 0, dh < 128, D = H*dh (the wrapper checks; ops/fused_proj.py
// `proj_shape_error`). Then H is even: an odd H would make dh = D/H a
// multiple of 128. So 3H heads fill 3H/2 tiles of two (dh <= 64).
#include "ff_common.cuh"
#include "gemm_sm90.cuh"

namespace {

using rtt::gemm::K_MAJOR;
using rtt::gemm::MN_MAJOR;
using rtt::gemm::Unit;

constexpr int MAX_DH = 120;  // dh % 8 == 0 and dh < 128

// The GEMM's epilogue. Heads are numbered [q heads | k heads | v heads],
// 3H in all; tile column tn holds heads 2tn and 2tn + 1 (dh <= 64, H even)
// or head tn (dh > 64).
struct ProjEpi {
  bf16* q;
  bf16* k;
  bf16* v;
  const float* gq;
  const float* gk;
  int H, dh, L;  // heads, head width, tokens of one attention sequence
  static constexpr int SCRATCH = 16 * (MAX_DH + 8);  // 8 v rows of dh + 8
  static constexpr int BLOCKS_PER_SM = 1;             // see the head comment

  __device__ bool wide() const { return dh > 64; }
  __device__ int head(int tn, int s) const { return wide() ? tn : 2 * tn + s; }
  __device__ int col0(int s) const { return wide() ? 64 * s : 0; }  // slot's first column
  __device__ int2 b_cols(int tn) const {
    if (wide()) return make_int2(tn * dh, tn * dh + 64);
    return make_int2(2 * tn * dh, (2 * tn + 1) * dh);
  }

  __device__ void operator()(const float (&acc)[64], const Unit& u, int row0, int wq, int lane,
                             uint8_t* scratch) const {
    const int g = lane >> 2, t = lane & 3;
    const int m = row0 + 16 * wq;  // the warp's first token: rows m + g, m + g + 8
    const int b = m / L;
    const long l = m - (long)b * L;
    // r[s][h]: rsqrt of the head's sum of squares on row m + g + 8h
    float r[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float ss[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (col0(s) + 8 * j < dh) {
            const float a0 = acc[4 * (8 * s + j) + 2 * h], a1 = acc[4 * (8 * s + j) + 2 * h + 1];
            sq += a0 * a0 + a1 * a1;
          }
        }
        ss[s] = rtt::quad_sum(sq);
      }
      if (wide()) ss[0] = ss[1] = ss[0] + ss[1];
      r[0][h] = rsqrtf(ss[0] + 1e-12f);
      r[1][h] = rsqrtf(ss[1] + 1e-12f);
    }

    // q and k straight from the accumulators (the gains through the
    // read-only path); v 8 rows at a time through the warp's scratch (rows
    // of dh + 8 values, so the 8 rows of a store fall in distinct banks),
    // then out as 16-byte stores: the 8 rows are contiguous in the output
    bf16* sv = reinterpret_cast<bf16*>(scratch);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int hi = head(u.tn, s);
        const int kind = hi / H, hh = hi - kind * H;
        if (kind < 2) {
          const float* gain = (kind ? gk : gq) + hh * dh + col0(s) + 2 * t;
          bf16* dst = (kind ? k : q) + ((long)(b * H + hh) * L + l + g + 8 * h) * dh + col0(s) +
                      2 * t;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (col0(s) + 8 * j < dh) {
              const float2 gv = __ldg(reinterpret_cast<const float2*>(gain + 8 * j));
              *reinterpret_cast<uint32_t*>(dst + 8 * j) =
                  rtt::pack_f2(acc[4 * (8 * s + j) + 2 * h] * r[s][h] * gv.x,
                               acc[4 * (8 * s + j) + 2 * h + 1] * r[s][h] * gv.y);
            }
          }
          continue;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = col0(s) + 8 * j + 2 * t;
          if (c < dh)
            *reinterpret_cast<uint32_t*>(sv + g * (dh + 8) + c) =
                rtt::pack_f2(acc[4 * (8 * s + j) + 2 * h], acc[4 * (8 * s + j) + 2 * h + 1]);
        }
        if (wide() && s == 0) continue;  // the head's columns 64.. come with s = 1
        __syncwarp();
        const long row = (long)(b * H + hh) * L + l + 8 * h;  // the block's first row
        uint4* out = reinterpret_cast<uint4*>(v + row * dh);
        for (int i = lane; i < dh; i += 32) {  // 8 rows of dh / 8 16-byte chunks
          const int rr = i / (dh / 8), cc = i - rr * (dh / 8);
          out[i] = *reinterpret_cast<const uint4*>(sv + rr * (dh + 8) + 8 * cc);
        }
        __syncwarp();
      }
    }
  }
};

}  // namespace

// x (G, N, D) bf16, ada (G, 2D) fp32, w (D, 3D) bf16, gq, gk (H, dh) fp32;
// scratch hln (G*N, D) bf16; out q, k, v (rows, dh) bf16, head-major with
// L = N * P_layout tokens a sequence (P_layout = 1 for part attention, P for
// global). x, w, hln, v 16-byte aligned.
extern "C" int rtt_proj(const void* x, const void* ada, const void* w, const void* gq,
                        const void* gk, void* hln, void* q, void* k, void* v, int G, int N,
                        int D, int H, int P_layout, void* stream) {
  const int T = G * N, dh = D / H;
  if (T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  adaln_ln_kernel<false><<<T / (LN_THREADS / 32), LN_THREADS, 0, s>>>(
      (const bf16*)x, (const float*)ada, (bf16*)hln, N, D);
  int err = (int)cudaGetLastError();
  if (err) return err;
  CUtensorMap m_h, m_w;
  if (!rtt::gemm::tile_map(&m_h, hln, T, D) || !rtt::gemm::tile_map(&m_w, w, D, 3L * D))
    return (int)cudaErrorInvalidValue;
  const rtt::gemm::Sched sched{T / 128, dh > 64 ? 3 * H : 3 * H / 2, 1, D / 64};
  const ProjEpi epi{(bf16*)q, (bf16*)k, (bf16*)v, (const float*)gq, (const float*)gk,
                    H, dh, N * P_layout};
  return rtt::gemm::launch<K_MAJOR, MN_MAJOR>(m_h, m_w, sched, epi, s);
}

// Registers and local bytes of adaln_ln_kernel<false> and the GEMM, two ints each.
extern "C" int rtt_proj_attributes(int* out) {
  int err = rtt::gemm::attributes(adaln_ln_kernel<false>, out);
  if (!err)
    err = rtt::gemm::attributes(rtt::gemm::gemm_kernel<K_MAJOR, MN_MAJOR, ProjEpi>, out + 2);
  return err;
}
