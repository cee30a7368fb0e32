// Batched bf16 GEMM with float32 accumulation and output:
//   out[b] = a[b % a_period] @ x[b],  a [*, M, K] bf16, x [B, K, N] bf16,
//   out [B, M, N] f32 (all row-major, contiguous).
//
// Replaces: scripts/bench_gemm.py:_mm_kernel (Pallas TPU, `pallas_bmm`),
// the microbench of the feature optimization's dense-warp product
// [8, 4096, 4096] x [8, 4096, 1280].  `a_period` lets one `a` serve
// several batches of `x` (the guidance layout fij,kfjc->kfic).
//
// What bounds it on the H100: operations.  The flat row is 2·8·4096²·1280
// = 344 GFLOP against 168 MB of operands and output, 0.347 ms at the bf16
// tensor peak (989 TFLOP/s) and 0.050 ms of memory; the gram-build row
// [16,1024,320]x[16,320,4096] is the one near the memory line (its 268 MB
// float32 output alone is 0.080 ms of a 0.096 ms bound).  Only wgmma
// reaches the tensor cores' full rate on Hopper; the mma.sync kernel this
// replaced ran the flat row at a quarter of it.  What this kernel runs into
// first is the operand stream from L2 into shared memory, which it issues
// from the same warps that issue the products: with either left out the
// flat row takes about 0.45-0.55 ms, with both about 0.69.
//
// Design (no TMA, no clusters, no persistent scheduler):
//   * Block tile BM x BN x BK = 128 x 128 x 64, 256 threads: two
//     warpgroups, each owning 64 rows and all 128 columns, so a k16 step is
//     one wgmma.mma_async m64n128k16 a warpgroup (64 float32 accumulators a
//     thread).  Both operands come from shared memory by descriptor
//     (`wgmma_ss`): A [M][K] is the K-major operand, X [K][N] the MN-major B
//     (transposed-B flag).  No ldmatrix, no A registers.
//   * Both tiles lie in the 128-byte-swizzled layout (descriptor layout
//     type 1): a row of the A tile is one 128-byte row of a 1024-byte atom
//     of 8 rows, the X tile is cut into atoms of 8 K-rows x 64 columns, and
//     the 16-byte chunk c of atom row r sits at chunk c ^ r.  Eight
//     consecutive threads copy one whole 128-byte row of global memory, so
//     a warp reads whole lines, and their 16-byte writes land in 8
//     different bank groups.  The no-swizzle core-matrix layout has no such
//     fill: 8 threads filling one core matrix read 16 bytes of each of 8
//     rows (half lines; the operand stream then ran at 2.2 TB/s and the flat
//     row took 1.76 ms), and whole-line reads into it collide 8 ways in the
//     banks.  A: SBO 1024 (8 rows), the k16 step 32 bytes inside the atom;
//     X: SBO 1024 (8 K-rows), LBO 8192 (the next 64 columns).
//   * A ring of STAGES = 6 tiles (32 KB each, 192 KB, one block a SM)
//     filled by 16-byte cp.async, four tiles ahead of the one multiplied;
//     one wgmma group stays in flight (wgmma_wait<1> after issuing tile k),
//     and the refill of tile k-2's slot waits for the block barrier of tile
//     k, by which both warpgroups have retired it.  fence.proxy.async then
//     the barrier hand a landed tile to the tensor cores.  128 x 256 tiles
//     (m64n256k16, 4 stages) and 192 x 256 tiles (three warpgroups) were
//     slower on three of the four microbench rows (PERF.md).
//   * Epilogue through the freed ring: each warpgroup writes its 64 x BN
//     float32 tile to shared memory (row pitch BN + 8 floats: the float2
//     writes of the accumulator layout are conflict-free), then every thread
//     stores 16-byte float4s to consecutive addresses of an output row.
//   * Block order: blockIdx.x walks the column tiles of one 128-row panel
//     first, so the blocks that read one A panel run side by side, and a
//     wave of 132 blocks covers ~13 panels of one batch, whose X (10 MB at
//     the flat row) stays in L2 with them.
//
// Edges: any M, N, K.  With K and N multiples of 8 and 16-byte aligned
// operands a 16-byte chunk is wholly inside or outside the matrix, so the
// cp.async zero fill covers the ragged M, N and K tiles.  Otherwise the
// same kernel loads element by element with bounds checks (ordinary
// shared-memory stores, fenced for the async proxy like the copies).
// Stores are masked; float4 only where N is a multiple of 4 and the output
// 16-byte aligned.
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

constexpr int BM = 128, BK = 64, NTHREADS = 256;
constexpr int BN = 128, STAGES = 6;
constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * BN * 2, STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int OPITCH = BN + 8;  // floats a row of the staged output tile
constexpr int RING_BYTES = STAGES * STAGE_BYTES, OUT_BYTES = BM * OPITCH * 4;
constexpr int SMEM_BYTES = RING_BYTES > OUT_BYTES ? RING_BYTES : OUT_BYTES;
constexpr int NKC = BK / 8, NNC = BN / 8;  // 16-byte chunks along a row of the A / X tile
constexpr int A_CHUNKS = BM * NKC, X_CHUNKS = BK * NNC;
constexpr int A_PER = (A_CHUNKS + NTHREADS - 1) / NTHREADS, X_PER = (X_CHUNKS + NTHREADS - 1) / NTHREADS;
constexpr int NACC = BN / 2;  // float32 accumulators a thread
static_assert(STAGES >= 3 && BM == 64 * (NTHREADS / 128) && BK == 64, "a warpgroup per 64 rows; 128-byte A rows");

struct Params {
  const __nv_bfloat16* a;
  const __nv_bfloat16* x;
  float* out;
  int M, N, K, a_period;
  bool vec_out;  // N % 4 == 0 and out 16-byte aligned
};

// One BM x BK tile of A and one BK x BN tile of X (from column k0 / row k0)
// into a ring slot, chunk i of each at byte 16 i of its part.
template <bool VEC>
__device__ __forceinline__ void load_tiles(unsigned char* slot, const Params& p, const __nv_bfloat16* A,
                                           const __nv_bfloat16* X, int m0, int n0, int k0) {
#pragma unroll
  for (int j = 0; j < A_PER; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    if (A_CHUNKS % NTHREADS != 0 && i >= A_CHUNKS) break;
    const int r = i / NKC, kc = i % NKC;  // a row of the tile is one 128-byte swizzle row
    const int gm = m0 + r, gk = k0 + kc * 8;
    auto* dst = reinterpret_cast<__nv_bfloat16*>(slot + r * 128 + ((kc ^ (r & 7)) << 4));
    if constexpr (VEC) {
      const bool in = gm < p.M && gk < p.K;
      cp_async16<false>(dst, in ? A + (long long)gm * p.K + gk : A, in);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gm < p.M && gk + e < p.K) ? A[(long long)gm * p.K + gk + e] : __float2bfloat16_rn(0.f);
    }
  }
#pragma unroll
  for (int j = 0; j < X_PER; ++j) {
    const int i = threadIdx.x + j * NTHREADS;
    if (X_CHUNKS % NTHREADS != 0 && i >= X_CHUNKS) break;
    const int k = i / NNC, nc = i % NNC;  // atom (k / 8, nc / 8): 8 rows of 64 columns
    const int gk = k0 + k, gn = n0 + nc * 8;
    auto* dst = reinterpret_cast<__nv_bfloat16*>(slot + A_BYTES + ((nc >> 3) * (BK / 8) + (k >> 3)) * 1024 +
                                                 (k & 7) * 128 + (((nc & 7) ^ (k & 7)) << 4));
    if constexpr (VEC) {
      const bool in = gk < p.K && gn < p.N;
      cp_async16<false>(dst, in ? X + (long long)gk * p.N + gn : X, in);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gk < p.K && gn + e < p.N) ? X[(long long)gk * p.N + gn + e] : __float2bfloat16_rn(0.f);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS, 1) bmm_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzle atoms need 1024-byte alignment; the launch adds 1 KB to round up
  unsigned char* smem = smem_raw + ((1024 - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) % 1024) % 1024);
  const int batch = blockIdx.z;
  const __nv_bfloat16* A = p.a + (long long)(batch % p.a_period) * p.M * p.K;
  const __nv_bfloat16* X = p.x + (long long)batch * p.K * p.N;
  float* O = p.out + (long long)batch * p.M * p.N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  const int nk = (p.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 2; ++s) {
    if (s < nk) load_tiles<VEC>(smem + s * STAGE_BYTES, p, A, X, m0, n0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 3>();  // this thread's part of tile kt has landed
    fence_proxy_async();          // ... and the tensor cores may read it
    __syncthreads();              // every thread's; tile kt-2 is retired by both warpgroups
    const int pf = kt + STAGES - 2;
    if (pf < nk) load_tiles<VEC>(smem + (pf % STAGES) * STAGE_BYTES, p, A, X, m0, n0, pf * BK);
    cp_async_commit();  // an empty group keeps the count in step
    const uint32_t a_addr = smem_addr + (kt % STAGES) * STAGE_BYTES + wg * 64 * 128;
    const uint32_t b_addr = smem_addr + (kt % STAGES) * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_ss<1>(acc, wgmma_desc_sw128(a_addr + ks * 32, 16, 1024),
                  wgmma_desc_sw128(b_addr + ks * 2 * 1024, (BK / 8) * 1024, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // tile kt-1's products are done
  }
  wgmma_wait<0>();
  wgmma_reg_fence(acc);
  cp_async_wait<0>();
  __syncthreads();  // both warpgroups are done with the ring

  // the warpgroup's 64 x BN tile into shared memory, in the accumulator layout
  float* stage = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
  const int r0 = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = 8 * j + 2 * t;
    *reinterpret_cast<float2*>(stage + r0 * OPITCH + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(stage + (r0 + 8) * OPITCH + c) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();
  // ... and out as float4s along each row
#pragma unroll 4
  for (int q = threadIdx.x; q < BM * BN / 4; q += NTHREADS) {
    const int row = q / (BN / 4), col = (q % (BN / 4)) * 4;
    const int gm = m0 + row, gn = n0 + col;
    if (gm >= p.M || gn >= p.N) continue;
    const float4 v = *reinterpret_cast<const float4*>(stage + row * OPITCH + col);
    float* dst = O + (long long)gm * p.N + gn;
    if (p.vec_out && gn + 3 < p.N) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      dst[0] = v.x;
      if (gn + 1 < p.N) dst[1] = v.y;
      if (gn + 2 < p.N) dst[2] = v.z;
      if (gn + 3 < p.N) dst[3] = v.w;
    }
  }
}

template <bool VEC>
int launch(const Params& p, int B, cudaStream_t st) {
  auto kern = bmm_kernel<VEC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES + 1024);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, B);
  kern<<<grid, NTHREADS, SMEM_BYTES + 1024, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [B, M, N] f32 = a[b % a_period] [M, K] x x[b] [K, N], bf16 inputs.
// Returns a cudaError_t.
extern "C" int fresco_bmm(const void* a, const void* x, void* out, int B, int M, int N, int K,
                          int a_period, void* stream) {
  if (B == 0 || M == 0 || N == 0) return 0;
  Params p;
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.out = static_cast<float*>(out);
  p.M = M; p.N = N; p.K = K; p.a_period = a_period;
  p.vec_out = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const bool vec = (K % 8 == 0) && (N % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(a) % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(p, B, st) : launch<false>(p, B, st);
}
