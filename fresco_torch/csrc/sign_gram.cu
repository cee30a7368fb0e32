// Spatial feature-optimization gradient: out = sign(v v^T - C) v, f32 out.
// bf16 operands on sm_90a wgmma tensor cores, or f32 operands on the CUDA
// cores; f32 accumulation either way.
//
// Replaces: fresco_tpu/ops/gram_kernel.py:_sign_gram_kernel (Pallas TPU),
// called by guidance._gram_l1_grad in every Adam iteration of the
// feature optimization with v [B, hw, c] bf16 (row-normalized decoder
// features) and the dense reference gram C [B, hw, hw] bf16.  The main
// path's shapes (B = 16): hw / c = 64 / 1280, 256 / 1280, 1024 / 1280 and
// 4096 / 640, 240 calls each in a keyframe batch.
//
// Two kernels, not one.  The TPU kernel fuses build -> sign -> apply per
// (bm x bn) tile and keeps a bm x c f32 accumulator in VMEM.  At c = 1280
// and bm = 64 that accumulator alone is 327 KB, more than the 227 KB of
// shared memory a Hopper block can hold.  Splitting c across warpgroups
// or blocks rebuilds G once per split: at c = 640 with two splits that
// alone is 1.5 times the minimum flops (1.04 ms at the bf16 peak at
// [16, 4096, 640]), worse than the round trip it saves.  So:
//   1. the sign kernel (here, bf16): G = v v^T tile by tile, an NT GEMM
//      with K = c, and S = sign(G - C) written as bf16 [B, hw, hw]
//      (-1, 0, +1 are exact in bf16);
//   2. the apply: out = S v, which is bmm.cu's kernel as it stands
//      (S the K-major A, v the MN-major B, K = hw, a_period = B); no
//      transposed copy of v, no widening of S.
// The cost: S makes one round trip through device memory in bf16, 537 MB
// written and read at [16, 4096, 640], 0.32 ms at 3.35 TB/s, which
// overlaps with the products.
//
// What bounds the sign kernel on the H100: it sits on the ridge.  At
// [16, 4096, 640] it does 2 B hw^2 c = 344 GFLOP (0.348 ms at 989
// TFLOP/s) and moves C in and S out, 1.07 GB plus v (0.35 ms at 3.35
// TB/s), so products and the C / S stream must overlap.  What it runs
// into first is neither: it is the operand stream from L2, since every
// block reads both of its row panels of v (K = c is short, 10-20
// k-tiles).  With 128 x 128 tiles that stream is 5.4 GB and alone takes
// ~0.85 ms; 128 x 256 tiles cut it to 4.0 GB (~0.75 ms alone).
//
// Design (bmm.cu's wgmma core; no TMA, no clusters):
//   * Block tile BM x BN x BK = 128 x 256 x 64, 256 threads: two
//     warpgroups of 64 rows, one wgmma.mma_async m64n256k16 a warpgroup a
//     k16 step, both operands from shared memory by descriptor.  A and B
//     are both rows of v (K-major): B is filled by A's loader and read by
//     a descriptor like A's (SBO 1024, the k16 step 32 bytes inside the
//     atom, transposed-B flag 0).
//   * Both tiles in the 128-byte-swizzled layout: one tile row is one
//     128-byte row of a 1024-byte atom, chunk k of row r at chunk k ^ (r %
//     8); eight threads copy one whole 128-byte line of v, and their
//     16-byte writes land in 8 bank groups.
//   * Persistent: one block a SM walks output tiles i, i + gridDim.x, ...,
//     and a ring of STAGES = 3 slots of 48 KB, filled by 16-byte cp.async
//     AHEAD = 2 k-tiles ahead, runs on across the block's tiles, so the
//     next tile's first k-tiles load while this one's last are multiplied
//     and its epilogue runs.  Each k-tile's products are waited for
//     (INFLIGHT = 0) before the barrier that hands its slot back; the
//     refill is issued after the wgmma, while the tensor cores work.
//   * Each output tile's C (128 x 256 bf16) is prefetched by cp.async into
//     a slot of its own with the tile's first k-tile, so its load hides
//     behind the products.  The slot's rows are 528 bytes, so a warp
//     reading it in the accumulator layout (8 rows, 4 column pairs)
//     touches 32 different banks.  Each thread turns its C pairs into S
//     pairs in place (sign(G - C), C widened to f32); then the block
//     writes the tile out as 16-byte rows of S.
//   * Measured (PERF.md, sign-gram findings): 128 x 128 tiles with two blocks a SM (2
//     stages each), or with one block and 5 stages, were 5-15 % slower at
//     hw >= 1024 and up to 30 % faster at hw = 64 and 256, where 128 x 256
//     leaves most SMs idle; the largest shape decides.
//   * S is not mirrored: C is a bf16 rounding of a product that need not
//     be bit-symmetric, and where C_ij and C_ji differ by an ulp a
//     mirrored S flips signs far from any tie.
//
// Edges: any hw (c % 8 == 0, v 16-byte aligned).  Rows of v past hw are
// zero-filled by cp.async; with hw % 8 == 0 and C, S 16-byte aligned the C
// tile comes by cp.async (zero fill past the edge) and S goes out in
// 16-byte stores, otherwise both element by element; stores are masked.
//
// float32 operands (gram_dtype="float32", the strict-parity setting; the
// TPU kernel takes both dtypes) run both products with f32 FMA on the
// CUDA cores: bf16 or TF32 tensor-core inputs would round v before G is
// formed.  The sign kernel writes int8 S [B, hw, ldS] (ldS = hw rounded up
// to 16, padding 0) and the apply reads it with a transposed, zero-padded
// copy of v the wrapper makes.  64 x 64 tiles, 256 threads, a 4 x 4
// register tile each.
#include "mma_util.cuh"
#include "wgmma_util.cuh"

namespace {

using fresco::cp_async16;
using fresco::cp_async_commit;
using fresco::cp_async_wait;
using fresco::fence_proxy_async;
using fresco::wgmma_commit;
using fresco::wgmma_desc_sw128;
using fresco::wgmma_fence;
using fresco::wgmma_reg_fence;
using fresco::wgmma_ss;
using fresco::wgmma_wait;

// ---------------------------------------------------------------- bf16: the sign kernel
constexpr int BM = 128, BN = 256, BK = 64;
constexpr int THREADS = 2 * BM;  // a warpgroup per 64 rows
constexpr int STAGES = 3, INFLIGHT = 0, BLOCKS_PER_SM = 1;
constexpr int AHEAD = STAGES - 1 - INFLIGHT;  // tiles in the ring ahead of the one multiplied
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BN * BK * 2, STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int CPITCH = BN + 8;  // bf16 a row of the C / S tile
constexpr int RING_BYTES = STAGES * STAGE_BYTES, C_BYTES = BM * CPITCH * 2;
constexpr int SMEM_BYTES = RING_BYTES + C_BYTES + 1024;  // + 1 KB to align the atoms
constexpr int NACC = BN / 2;  // float32 accumulators a thread
static_assert(AHEAD >= 1 && BM % 64 == 0 && BK == 64, "a warpgroup per 64 rows; 128-byte rows");
static_assert(BLOCKS_PER_SM * (SMEM_BYTES + 1024) <= 233472, "the blocks a SM must fit its 228 KB");

struct SignParams {
  const __nv_bfloat16* v;  // [B, hw, ch]
  const __nv_bfloat16* c;  // [B, hw, hw]
  __nv_bfloat16* s;        // [B, hw, hw]
  int batch, hw, ch;
};

// ROWS rows of v from `rows` (of which `n_rows` lie inside the matrix),
// columns k0..k0+63, into a swizzled tile
template <int ROWS>
__device__ __forceinline__ void load_rows(unsigned char* tile, const __nv_bfloat16* rows, int n_rows, int k0,
                                          int ch) {
  static_assert(ROWS * 8 % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < ROWS * 8 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / 8, kc = i % 8;  // a tile row is one 128-byte swizzle row
    const int gk = k0 + kc * 8;
    const bool in = r < n_rows && gk < ch;
    cp_async16<false>(tile + r * 128 + ((kc ^ (r & 7)) << 4), in ? rows + (long long)r * ch + gk : rows, in);
  }
}

// the block's C tile into its slot, row pitch CPITCH
template <bool VEC>
__device__ __forceinline__ void load_c(__nv_bfloat16* cs, const __nv_bfloat16* C, const SignParams& p, int m0,
                                       int n0) {
#pragma unroll
  for (int j = 0; j < BM * BN / 8 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
    const int gm = m0 + r, gn = n0 + cc;
    __nv_bfloat16* dst = cs + r * CPITCH + cc;
    if constexpr (VEC) {
      const bool in = gm < p.hw && gn < p.hw;
      cp_async16<false>(dst, in ? C + (long long)gm * p.hw + gn : C, in);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gm < p.hw && gn + e < p.hw) ? C[(long long)gm * p.hw + gn + e] : __float2bfloat16_rn(0.f);
    }
  }
}

__device__ __forceinline__ float sign_of(float d) { return static_cast<float>((d > 0.f) - (d < 0.f)); }

// the origin of output tile `tile`: column tiles of a row panel first, then
// the row panels of a batch element, then the batch
__device__ __forceinline__ void tile_origin(const SignParams& p, int tile, int& batch, int& m0, int& n0) {
  const int tiles_n = (p.hw + BN - 1) / BN, tiles_m = (p.hw + BM - 1) / BM;
  n0 = (tile % tiles_n) * BN;
  m0 = ((tile / tiles_n) % tiles_m) * BM;
  batch = tile / tiles_n / tiles_m;
}

// Persistent: block i takes output tiles i, i + gridDim.x, ...  The ring
// runs on across the block's tiles, so the next tile's first k-tiles load
// while this one's last are multiplied and its epilogue runs.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) sign_kernel(SignParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) % 1024) % 1024);
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem + RING_BYTES);
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tiles = ((p.hw + BN - 1) / BN) * ((p.hw + BM - 1) / BM) * p.batch;
  const int nk = (p.ch + BK - 1) / BK;
  const int steps = (tiles > static_cast<int>(blockIdx.x) ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0) * nk;

  // the loader's position: tile lt, k-tile lk; the rows of v its A and B
  // tiles start at, found once a tile
  int lt = blockIdx.x, lk = 0, a_rows = 0, b_rows = 0;
  const __nv_bfloat16 *la = p.v, *lb = p.v;
  auto load_step = [&](int slot) {
    if (lk == 0) {
      int b, m0, n0;
      tile_origin(p, lt, b, m0, n0);
      la = p.v + ((long long)b * p.hw + m0) * p.ch;
      lb = p.v + ((long long)b * p.hw + n0) * p.ch;
      a_rows = p.hw - m0;
      b_rows = p.hw - n0;
    }
    load_rows<BM>(smem + slot * STAGE_BYTES, la, a_rows, lk * BK, p.ch);
    load_rows<BN>(smem + slot * STAGE_BYTES + A_BYTES, lb, b_rows, lk * BK, p.ch);
    if (++lk == nk) lk = 0, lt += gridDim.x;
  };
  auto load_c_of = [&](int tile) {
    int b, m0, n0;
    tile_origin(p, tile, b, m0, n0);
    load_c<VEC>(cs, p.c + (long long)b * p.hw * p.hw, p, m0, n0);
  };

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  if (steps > 0) load_c_of(blockIdx.x);  // with the first k-tile's group
#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }
  int tile = blockIdx.x, kt = 0;  // the tile and k-tile being multiplied
  for (int q = 0; q < steps; ++q) {
    cp_async_wait<AHEAD - 1>();  // this thread's part of step q has landed
    fence_proxy_async();         // ... and the tensor cores may read it
    __syncthreads();             // every thread's; step q - 1 - INFLIGHT is retired by both warpgroups
    const uint32_t a_addr = smem_addr + (q % STAGES) * STAGE_BYTES + wg * 64 * 128;
    const uint32_t b_addr = smem_addr + (q % STAGES) * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_ss<0>(acc, wgmma_desc_sw128(a_addr + ks * 32, 16, 1024), wgmma_desc_sw128(b_addr + ks * 32, 16, 1024), 1);
    wgmma_commit();
    // the refill goes out while the tensor cores work on step q
    if (q + AHEAD < steps) load_step((q + AHEAD) % STAGES);
    cp_async_commit();  // an empty group keeps the count in step (the next C tile joins this group)
    wgmma_wait<INFLIGHT>();
    if (++kt < nk) continue;

    // the tile's epilogue
    kt = 0;
    wgmma_wait<0>();
    wgmma_reg_fence(acc);
    // the C tile came with the group of the tile's first step, complete by
    // step AHEAD of the tile; a tile of no more steps waits for it here
    if (nk <= AHEAD) cp_async_wait<0>();
    __syncthreads();
    // S = sign(G - C) in place of C, in the accumulator layout
    const int g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        auto* cp = reinterpret_cast<__nv_bfloat162*>(cs + (r0 + 8 * h) * CPITCH + 8 * j + 2 * t);
        const float2 cf = __bfloat1622float2(*cp);
        *cp = __floats2bfloat162_rn(sign_of(acc[4 * j + 2 * h] - cf.x), sign_of(acc[4 * j + 2 * h + 1] - cf.y));
        acc[4 * j + 2 * h] = acc[4 * j + 2 * h + 1] = 0.f;
      }
    }
    __syncthreads();
    // ... and out as 16-byte rows
    int b, m0, n0;
    tile_origin(p, tile, b, m0, n0);
    __nv_bfloat16* S = p.s + (long long)b * p.hw * p.hw;
#pragma unroll
    for (int j = 0; j < BM * BN / 8 / THREADS; ++j) {
      const int i = threadIdx.x + j * THREADS;
      const int r = i / (BN / 8), cc = (i % (BN / 8)) * 8;
      const int gm = m0 + r, gn = n0 + cc;
      if (gm >= p.hw || gn >= p.hw) continue;
      __nv_bfloat16* dst = S + (long long)gm * p.hw + gn;
      if constexpr (VEC) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(cs + r * CPITCH + cc);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (gn + e < p.hw) dst[e] = cs[r * CPITCH + cc + e];
      }
    }
    __syncthreads();  // the C slot is free
    tile += gridDim.x;
    if (tile < tiles) load_c_of(tile);
  }
  cp_async_wait<0>();
}

template <bool VEC>
int launch_sign(const SignParams& p, cudaStream_t st) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  auto kern = sign_kernel<VEC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles = (long long)((p.hw + BN - 1) / BN) * ((p.hw + BM - 1) / BM) * p.batch;
  const int grid = static_cast<int>(tiles < (long long)n_sm * BLOCKS_PER_SM ? tiles : (long long)n_sm * BLOCKS_PER_SM);
  kern<<<grid, THREADS, SMEM_BYTES, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- float32: CUDA cores
constexpr int NTHREADS = 256;

enum Epilogue { kSign = 0, kApply = 1 };

struct GemmParams {
  const void* a;  // [batch, M, lda] f32, or int8 when A_INT8
  const void* b;  // [batch, N, ldb] f32
  int M, N, K;
  long long lda, a_bs, ldb, b_bs;
  // kSign: C [batch, M, ldc] f32 in, S [batch, M, ldsv] int8 out
  const void* c;
  long long ldc, c_bs;
  int8_t* s;
  long long ldsv, s_bs;
  int n_store;  // kSign: columns written (ldS >= N); padding gets 0
  // kApply: out [batch, M, ldo] f32
  float* out;
  long long ldo, o_bs;
};

constexpr int FT = 64, FK = 16;

template <bool A_INT8, int EPI>
__global__ void __launch_bounds__(NTHREADS) nt_gemm_f32_kernel(GemmParams p) {
  __shared__ float As[FK][FT + 1];  // k-major, so a k step reads one row
  __shared__ float Bs[FK][FT + 1];
  const int batch = blockIdx.z;
  const int m0 = blockIdx.y * FT, n0 = blockIdx.x * FT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* B = static_cast<const float*>(p.b) + batch * p.b_bs;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < p.K; k0 += FK) {
    __syncthreads();
    for (int i = threadIdx.x; i < FT * FK; i += NTHREADS) {
      const int r = i / FK, k = i % FK;
      float a = 0.f, b = 0.f;
      if (k0 + k < p.K) {
        const long long off = (long long)(m0 + r) * p.lda + k0 + k;
        if (m0 + r < p.M) {
          if constexpr (A_INT8)
            a = static_cast<float>(static_cast<const int8_t*>(p.a)[batch * p.a_bs + off]);
          else
            a = static_cast<const float*>(p.a)[batch * p.a_bs + off];
        }
        if (n0 + r < p.N) b = B[(long long)(n0 + r) * p.ldb + k0 + k];
      }
      As[k][r] = a;
      Bs[k][r] = b;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if constexpr (EPI == kSign) {
        if (col >= p.n_store) continue;
        int8_t sv = 0;
        if (col < p.N) {
          const float d = acc[i][j] -
              static_cast<const float*>(p.c)[batch * p.c_bs + (long long)row * p.ldc + col];
          sv = static_cast<int8_t>((d > 0.f) - (d < 0.f));
        }
        p.s[batch * p.s_bs + (long long)row * p.ldsv + col] = sv;
      } else {
        if (col >= p.N) continue;
        p.out[batch * p.o_bs + (long long)row * p.ldo + col] = acc[i][j];
      }
    }
  }
}

template <bool A_INT8, int EPI>
int launch_f32(const GemmParams& p, int n_cols, int B, void* stream) {
  dim3 grid((n_cols + FT - 1) / FT, (p.M + FT - 1) / FT, B);
  nt_gemm_f32_kernel<A_INT8, EPI><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S = sign(v v^T - C).  bf16 (f32 == 0): S bf16 [B, hw, hw], lds == hw.
// float32 (f32 != 0): S int8 [B, hw, lds], columns [hw, lds) zeroed.
// v [B, hw, ch] (ch % 8 == 0) and C [B, hw, hw] contiguous.  Returns a
// cudaError_t.
extern "C" int fresco_sign_gram_sign(const void* v, const void* c, void* s, int B, int hw, int ch, int lds,
                                     int f32, void* stream) {
  if (B == 0 || hw == 0) return 0;
  if (!f32) {
    if (lds != hw || ch % 8 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    SignParams p;
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.c = static_cast<const __nv_bfloat16*>(c);
    p.s = static_cast<__nv_bfloat16*>(s);
    p.batch = B; p.hw = hw; p.ch = ch;
    const bool vec = hw % 8 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(s) % 16 == 0;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return vec ? launch_sign<true>(p, st) : launch_sign<false>(p, st);
  }
  GemmParams p = {};
  p.a = v;
  p.b = v;
  p.M = hw; p.N = hw; p.K = ch;
  p.lda = ch; p.a_bs = (long long)hw * ch;
  p.ldb = ch; p.b_bs = (long long)hw * ch;
  p.c = c;
  p.ldc = hw; p.c_bs = (long long)hw * hw;
  p.s = static_cast<int8_t*>(s);
  p.ldsv = lds; p.s_bs = (long long)hw * lds;
  p.n_store = lds;
  return launch_f32<false, kSign>(p, lds, B, stream);
}

// float32 only: out [B, hw, ch] = S [B, hw, lds] (int8) x vt^T, vt [B, ch,
// lds] f32 zero-padded past hw.  (The bf16 apply is fresco_bmm.)
extern "C" int fresco_sign_gram_apply_f32(const void* s, const void* vt, void* out, int B, int hw, int ch, int lds,
                                          void* stream) {
  GemmParams p = {};
  p.a = s;
  p.b = vt;
  p.M = hw; p.N = ch; p.K = lds;
  p.lda = lds; p.a_bs = (long long)hw * lds;
  p.ldb = lds; p.b_bs = (long long)ch * lds;
  p.out = static_cast<float*>(out);
  p.ldo = ch; p.o_bs = (long long)hw * ch;
  if (B == 0 || hw == 0) return 0;
  return launch_f32<true, kApply>(p, ch, B, stream);
}
