// A persistent TMA + wgmma GEMM for Hopper (sm_90a), and the fixed-order
// reductions that go with it.
//
// C tile (128 x 128, fp32) = sum over k of A (128 x K) B (K x 128), bf16
// operands, for products whose epilogue is the caller's:
// - A and B are row-major bf16 matrices in device memory, read through 2-D
//   tensor maps in boxes of 64 x 64 (128-byte rows, 8 KB) with the 128-byte
//   swizzle (`tile_map`). Either operand is K-major (k contiguous: A = X,
//   B = W^T with W stored (N, K)) or MN-major (m or n contiguous: A = X^T
//   with X stored (K, M), B = W stored (K, N)); the transpose bits of
//   `wgmma_m64n128k16_ss` take both.
// - A stage of the shared-memory ring holds four boxes: A's rows 0-63 and
//   64-127 and B's column halves 0-63 and 64-127 of one 64-deep k slab. The
//   epilogue names where B's two halves start (`b_cols`), so a tile's 128
//   columns may come from two places (the GEGLU's hidden and gate columns,
//   or two heads of the QKV projection at any head width).
// - Two optional hooks of the epilogue, defaulted where it lacks them, so
//   a functor without them compiles to the plain GEMM: `a_box(m, k0)`, the
//   (row, k) at which A's box of product rows m..m+63 and k slab k0 is read
//   (default (m, k0): out_proj reads the head-major attention output, a
//   relayout of the product's rows), `SCRATCH`, bytes of shared memory
//   each consumer warp gets for its epilogue, passed as its last argument
//   (default none: the QKV projection stages v's rows there), and
//   `BLOCKS_PER_SM` (default 2): 1 for an epilogue that needs more than the
//   96 registers a thread has with two blocks of 9 warps on an SM, which
//   then gets a ring of ONE_BLOCK_STAGES slabs.
// - One producer thread (warp 8) keeps STAGES slabs in flight by TMA, each
//   stage with a full barrier (transaction bytes) and an empty barrier (the
//   8 consumer warps). Two consumer warpgroups (warps 0-7) own 64 rows
//   each: per slab 4 wgmma.m64n128k16, one commit group kept in flight, the
//   slab before released when its group completes.
// - The grid is persistent: two blocks on each SM (3 stages of 32 KB; ptxas
//   then holds a thread to 96 registers), or one (`BLOCKS_PER_SM`), walk
//   units u = blockIdx.x, + gridDim.x, ..., where a unit is one output tile
//   and one range of k slabs (`Sched`: a split-K product gives each split a
//   contiguous range and the epilogue writes the split's fp32 partial).
//   While one block runs an epilogue, the other's products keep the SM's
//   tensor cores busy, and each producer runs into its next unit's slabs.
// The accumulator of a consumer puts, in warp w of its warpgroup,
// acc[4j + 0..1] at row 16w + g, columns 8j + 2t..2t+1 and acc[4j + 2..3] at
// row 16w + g + 8 (g = lane / 4, t = lane % 4; j = 0..15, columns 0-63 are
// B's first half, 64-127 its second).
//
// The reductions (colsum_kernel, splitsum_kernel) add partials in an order
// fixed by the shape alone, so every sum built from them is bitwise
// repeatable (no atomics). Two epilogues serve several products: the FF's
// residual (BiasResidual) and a plain fp32 store (F32Out, with the split-K
// weight gradient `weight_grad`).
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace rtt {
namespace gemm {
namespace {  // internal linkage: each source that includes this has its own copy

constexpr int TILE = 128;                        // output tile rows and columns
constexpr int BOX = 64;                          // TMA box: 64 x 64 bf16
constexpr uint32_t BOX_BYTES = BOX * BOX * 2;    // 8 KB
constexpr int NTHREADS = 288;                    // 2 consumer warpgroups + a producer warp
constexpr int BLOCKS_PER_SM = 2;
constexpr int STAGES = 3;
constexpr int ONE_BLOCK_STAGES = 6;
constexpr uint32_t STAGE_BYTES = 4 * BOX_BYTES;  // A rows 0-63, 64-127; B halves

enum { K_MAJOR = 0, MN_MAJOR = 1 };

// Descriptor advance of one k16 step, in 16-byte units: 32 bytes along a
// K-major operand's swizzled rows, 16 rows of 128 bytes down an MN-major one.
template <int MAJOR>
__device__ __forceinline__ uint64_t k16_step() {
  return MAJOR == MN_MAJOR ? 128 : 2;
}

// The box of one 64-wide half of an operand: `mn` is its first row (A) or
// column (B) of the product, k0 its first k. A K-major operand's matrix is
// (mn, k) in device memory, an MN-major one's (k, mn).
template <int MAJOR>
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int mn, int k0) {
  if (MAJOR == MN_MAJOR)
    tma_load_2d(dst, map, bar, mn, k0);
  else
    tma_load_2d(dst, map, bar, k0, mn);
}

struct Unit {
  int tm, tn, split, kb, ke;  // tile row, tile column, split, k slabs [kb, ke)
};

// Units ordered split-major, then tile row, then tile column: the blocks in
// flight at once share A's rows and one split's k range.
struct Sched {
  int tiles_m, tiles_n, splits, nslab;  // nslab: k slabs of the whole K
  __host__ __device__ int units() const { return tiles_m * tiles_n * splits; }
  __device__ Unit unit(int u) const {
    const int per = tiles_m * tiles_n;
    Unit w;
    w.split = u / per;
    const int r = u - w.split * per;
    w.tm = r / tiles_n;
    w.tn = r - w.tm * tiles_n;
    w.kb = (int)((long)w.split * nslab / splits);
    w.ke = (int)((long)(w.split + 1) * nslab / splits);
    return w;
  }
};

// The optional hooks (see the head comment).
template <class E, class = void>
struct EpiScratch {
  static constexpr int bytes = 0;
};
template <class E>
struct EpiScratch<E, std::void_t<decltype(E::SCRATCH)>> {
  static constexpr int bytes = E::SCRATCH;
};
template <class E, class = void>
struct EpiBlocks {
  static constexpr int value = BLOCKS_PER_SM;
};
template <class E>
struct EpiBlocks<E, std::void_t<decltype(E::BLOCKS_PER_SM)>> {
  static constexpr int value = E::BLOCKS_PER_SM;
};
template <class E, class = void>
struct HasABox : std::false_type {};
template <class E>
struct HasABox<E, std::void_t<decltype(&E::a_box)>> : std::true_type {};

// gemm_kernel<..., Epi>'s blocks on an SM, its ring's stages and its dynamic
// shared memory: the ring, its barriers and the consumer warps' epilogue
// scratch (16-byte aligned after the barriers).
template <class Epi>
struct Layout {
  static constexpr int blocks = EpiBlocks<Epi>::value;
  static constexpr int stages = blocks == 1 ? ONE_BLOCK_STAGES : STAGES;
  static constexpr size_t scratch_at = stages * (size_t)STAGE_BYTES + 2 * stages * 8;
  static constexpr size_t smem = 1024 + scratch_at + 8 * (size_t)EpiScratch<Epi>::bytes;
};

// Epi: `int2 b_cols(int tn)`, the first columns of B's two halves for tile
// column tn, and `operator()(acc, unit, row0, wq, lane[, scratch])`, the
// epilogue of one consumer's 64 rows starting at row0 (wq: warp in the
// warpgroup; scratch: the warp's EpiScratch bytes).
template <int A_MAJOR, int B_MAJOR, class Epi>
__global__ void __launch_bounds__(NTHREADS, Layout<Epi>::blocks)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            const Sched sched, const Epi epi) {
  constexpr int STAGES = Layout<Epi>::stages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * (size_t)STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int units = sched.units();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    mbar_fence_init();
    fence_proxy_async();
  }
  __syncthreads();

  if (warp == 8) {
    // ---- producer: one thread keeps the ring full --------------------------
    if (lane == 0) {
      int stage = 0, it = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = sched.unit(u);
        const int m0 = w.tm * TILE;
        const int2 nb = epi.b_cols(w.tn);
        for (int ks = w.kb; ks < w.ke; ++ks, ++it) {
          if (it >= STAGES) mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* st = smem + stage * (size_t)STAGE_BYTES;
          const int k0 = ks * BOX;
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          if constexpr (HasABox<Epi>::value) {
            const int2 a0 = epi.a_box(m0, k0), a1 = epi.a_box(m0 + BOX, k0);
            load_box<A_MAJOR>(st, &map_a, &full[stage], a0.x, a0.y);
            load_box<A_MAJOR>(st + BOX_BYTES, &map_a, &full[stage], a1.x, a1.y);
          } else {
            load_box<A_MAJOR>(st, &map_a, &full[stage], m0, k0);
            load_box<A_MAJOR>(st + BOX_BYTES, &map_a, &full[stage], m0 + BOX, k0);
          }
          load_box<B_MAJOR>(st + 2 * BOX_BYTES, &map_b, &full[stage], nb.x, k0);
          load_box<B_MAJOR>(st + 3 * BOX_BYTES, &map_b, &full[stage], nb.y, k0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: 64 rows each -----------------------------------------------
  const int c = warp / 4, wq = warp & 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const Unit w = sched.unit(u);
    int prev = -1;
    for (int ks = w.kb; ks < w.ke; ++ks) {
      mbar_wait(&full[stage], phase);
      const uint32_t base = smem_u32(smem + stage * (size_t)STAGE_BYTES);
      const uint64_t da = sw128_desc(base + c * BOX_BYTES);
      // an MN-major B's second half is one leading byte offset further (a
      // K-major B's 128 rows are contiguous: no leading offset)
      const uint64_t db = sw128_desc(base + 2 * BOX_BYTES, B_MAJOR == MN_MAJOR ? BOX_BYTES : 16);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BOX / 16; ++kk)
        wgmma_m64n128k16_ss<A_MAJOR, B_MAJOR>(acc, da + k16_step<A_MAJOR>() * kk,
                                              db + k16_step<B_MAJOR>() * kk,
                                              ks > w.kb || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
    if constexpr (EpiScratch<Epi>::bytes > 0)
      epi(acc, w, w.tm * TILE + c * BOX, wq, lane,
          smem + Layout<Epi>::scratch_at + warp * EpiScratch<Epi>::bytes);
    else
      epi(acc, w, w.tm * TILE + c * BOX, wq, lane);
  }
}

// out = x + bf16(acc + bo), all bf16, out and x (T, D) row-major, D % 128
// == 0: the epilogue of the FF's second product (ff.cu) and of out_proj.
struct BiasResidual {
  const bf16* x;
  const bf16* bo;
  bf16* out;
  int D;
  __device__ int2 b_cols(int tn) const { return make_int2(tn * 128, tn * 128 + 64); }
  __device__ void operator()(const float (&acc)[64], const Unit& u, int row0, int wq,
                             int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const long ra = row0 + 16 * wq + g;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = u.tn * 128 + 8 * j + 2 * t;
      const float b0 = __bfloat162float(bo[col]), b1 = __bfloat162float(bo[col + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long o = (ra + 8 * h) * D + col;
        const uint32_t xv = *reinterpret_cast<const uint32_t*>(x + o);
        const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(&xv);
        const float y0 = __bfloat162float(__float2bfloat16(acc[4 * j + 2 * h] + b0));
        const float y1 = __bfloat162float(__float2bfloat16(acc[4 * j + 2 * h + 1] + b1));
        *reinterpret_cast<uint32_t*>(out + o) =
            pack_f2(__bfloat162float(x2.x) + y0, __bfloat162float(x2.y) + y1);
      }
    }
  }
};

// The tile stored in fp32, for products whose sums leave as they are:
// out + split * split_stride is (M, N) row-major, N % 128 == 0; rows past M
// are not stored (a last tile row half outside the matrix: TMA read zeros
// there). ROW only names the launch (each row's products are profiled apart).
template <int ROW>
struct F32Out {
  float* out;
  long split_stride;
  int M, N;
  __device__ int2 b_cols(int tn) const { return make_int2(tn * 128, tn * 128 + 64); }
  __device__ void operator()(const float (&acc)[64], const Unit& u, int row0, int wq,
                             int lane) const {
    const int ra = row0 + 16 * wq + (lane >> 2);
    float* o = out + u.split * split_stride;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = u.tn * 128 + 8 * j + 2 * (lane & 3);
      if (ra < M)
        *reinterpret_cast<float2*>(o + (long)ra * N + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
      if (ra + 8 < M)
        *reinterpret_cast<float2*>(o + (long)(ra + 8) * N + col) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
};

// out[c] = sum of part[r * C + c] over r = 0..R-1 (C % 32 == 0), for each
// segment y = blockIdx.y of R rows (part and out advance by R * C and C):
// thread (ty, tx) of a block of 32 columns sums rows ty, ty + 8, ... in
// order, then the 8 row sums are added in order. Grid: (C / 32, segments)
// blocks of 256.
__global__ void __launch_bounds__(256)
colsum_kernel(const float* __restrict__ part, float* __restrict__ out, int R, int C) {
  __shared__ float red[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  part += (long)blockIdx.y * R * C;
  out += (long)blockIdx.y * C;
  float s = 0.f;
  for (int r = ty; r < R; r += 8) s += part[(long)r * C + c];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0) {
    float v = red[0][tx];
#pragma unroll
    for (int i = 1; i < 8; ++i) v += red[i][tx];
    out[c] = v;
  }
}

// out[i] = sum of part[s * n + i] over s = 0..splits-1 in order, n = 4 * n4.
__global__ void __launch_bounds__(256)
splitsum_kernel(const float4* __restrict__ part, float4* __restrict__ out, long n4,
                int splits) {
  for (long i = (long)blockIdx.x * 256 + threadIdx.x; i < n4; i += (long)gridDim.x * 256) {
    float4 v = part[i];
    for (int s = 1; s < splits; ++s) {
      const float4 w = part[(long)s * n4 + i];
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    out[i] = v;
  }
}

// ---- host -------------------------------------------------------------------------

// A tensor map over a row-major (rows, cols) bf16 matrix, boxes of 64 x 64 in
// the 128-byte swizzle; boxes past the edge read zeros. cols % 8 == 0 and a
// 16-byte-aligned base. Returns false if cuTensorMapEncodeTiled refuses it.
inline bool tile_map(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {BOX, BOX};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int num_sms() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// One persistent launch of gemm_kernel on stream s; returns cudaGetLastError().
template <int A_MAJOR, int B_MAJOR, class Epi>
inline int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const Sched& sched,
                  const Epi& epi, cudaStream_t s) {
  auto kernel = gemm_kernel<A_MAJOR, B_MAJOR, Epi>;
  constexpr size_t smem = Layout<Epi>::smem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  static int per_sm = 0;  // blocks resident on one SM, read once per instantiation
  if (err == cudaSuccess && per_sm == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NTHREADS, smem);
  if (err != cudaSuccess) return (int)err;
  const int units = sched.units(), slots = (per_sm > 0 ? per_sm : 1) * num_sms();
  const int grid = units < slots ? units : slots;
  kernel<<<grid, NTHREADS, smem, s>>>(map_a, map_b, sched, epi);
  return (int)cudaGetLastError();
}

// out (segments, C) = the column sums of each segment of R rows of part.
inline int launch_colsum(const float* part, float* out, int R, int C, cudaStream_t s,
                         int segments = 1) {
  colsum_kernel<<<dim3(C / 32, segments), 256, 0, s>>>(part, out, R, C);
  return (int)cudaGetLastError();
}

inline int launch_splitsum(const float* part, float* out, long n, int splits, cudaStream_t s) {
  const long n4 = n / 4;
  const long blocks = (n4 + 255) / 256;
  splitsum_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out), n4, splits);
  return (int)cudaGetLastError();
}

// dW (M, N) = A^T B over T tokens in `splits` token ranges, A (T, M) and B (T,
// N) row-major bf16 (both MN-major operands, T % 64 == 0); the splits'
// partials go to wpart and are then summed in order into dW (one split
// writes dW directly). ROW names the launch (F32Out).
template <int ROW>
int weight_grad(const void* a, const void* b, float* dW, float* wpart, int T, int M, int N,
                int splits, cudaStream_t s) {
  CUtensorMap ma, mb;
  if (!tile_map(&ma, a, T, M) || !tile_map(&mb, b, T, N)) return (int)cudaErrorInvalidValue;
  const Sched sched{(M + 127) / 128, N / 128, splits, T / 64};
  float* dst = splits > 1 ? wpart : dW;
  const long n = (long)M * N;
  int err = launch<MN_MAJOR, MN_MAJOR>(ma, mb, sched, F32Out<ROW>{dst, n, M, N}, s);
  if (err || splits == 1) return err;
  return launch_splitsum(wpart, dW, n, splits, s);
}

// Registers and local (stack + spill) bytes of a kernel: out[0], out[1].
template <class K>
inline int attributes(K kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  return (int)err;
}

}  // namespace
}  // namespace gemm
}  // namespace rtt
