// Batched bf16 GEMM with float32 accumulation and output:
//   out[b] = a[b % a_period] @ x[b],  a [*, M, K] bf16, x [B, K, N] bf16,
//   out [B, M, N] f32 (all row-major, contiguous).
//
// Replaces: scripts/bench_gemm.py:_mm_kernel (Pallas TPU, `pallas_bmm`),
// the microbench of the feature optimization's dense-warp product
// [8, 4096, 4096] x [8, 4096, 1280].  `a_period` lets one `a` serve
// several batches of `x` (the guidance layout fij,kfjc->kfic).
//
// Design: block tiles of 128 x 128 x 32, 8 warps in a 2 x 4 grid, each
// warp a 64 x 32 tile of mma.sync m16n8k16 bf16 on the tensor cores.
// A tiles are read from shared memory with ldmatrix, X tiles (K-major in
// memory: consecutive k of one n are N apart) with ldmatrix.trans, which
// hands each lane the (k, k+1) pair of its column that the mma's "col" B
// operand wants.  Global -> shared copies are 16-byte cp.async with zero
// fill in a ring of 4 tiles: 3 tiles stream in while one is multiplied,
// one barrier per tile.
// Shared-memory pitches of BK+8 and BN+8 elements keep every ldmatrix row
// phase conflict-free.
//
// Edges: unlike the Pallas kernel (every tile must divide), any M, N, K
// works.  With K and N multiples of 8 a 16-byte chunk is wholly inside or
// outside the matrix, so the zero fill covers the ragged M, N and K tiles.
// Otherwise (rows not 16-byte aligned) the same kernel loads element by
// element with bounds checks.  Stores are masked.  wgmma and TMA are left
// for later work.
#include "mma_util.cuh"

namespace {

using fresco::mma_bf16_16816;

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 4, NTHREADS = 256;
constexpr int APITCH = BK + 8;  // 80 bytes per A row in shared memory
constexpr int BPITCH = BN + 8;
constexpr int A_ELEMS = BM * APITCH, B_ELEMS = BK * BPITCH;
constexpr int SMEM_BYTES = STAGES * (A_ELEMS + B_ELEMS) * 2;
constexpr int MI = BM / 2 / 16;  // m16 tiles per warp
constexpr int NJ = BN / 4 / 8;   // n8 tiles per warp

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = in ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

struct Params {
  const __nv_bfloat16* a;
  const __nv_bfloat16* x;
  float* out;
  int M, N, K, a_period;
};

// One BM x BK tile of A and one BK x BN tile of X into shared memory.
template <bool VEC>
__device__ __forceinline__ void load_tiles(__nv_bfloat16* As, __nv_bfloat16* Bs, const Params& p,
                                           const __nv_bfloat16* A, const __nv_bfloat16* X, int m0,
                                           int n0, int k0) {
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < BM * (BK / 8); i += NTHREADS) {
    const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
    const int gm = m0 + r, gk = k0 + c;
    __nv_bfloat16* dst = As + r * APITCH + c;
    if constexpr (VEC) {
      const bool in = gm < p.M && gk < p.K;
      cp_async16(dst, in ? A + (long long)gm * p.K + gk : A, in);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gm < p.M && gk + e < p.K) ? A[(long long)gm * p.K + gk + e] : zero;
    }
  }
  for (int i = threadIdx.x; i < BK * (BN / 8); i += NTHREADS) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int gk = k0 + r, gn = n0 + c;
    __nv_bfloat16* dst = Bs + r * BPITCH + c;
    if constexpr (VEC) {
      const bool in = gk < p.K && gn < p.N;
      cp_async16(dst, in ? X + (long long)gk * p.N + gn : X, in);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gk < p.K && gn + e < p.N) ? X[(long long)gk * p.N + gn + e] : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS) bmm_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_ELEMS;
  const int batch = blockIdx.z;
  const __nv_bfloat16* A = p.a + (long long)(batch % p.a_period) * p.M * p.K;
  const __nv_bfloat16* X = p.x + (long long)batch * p.K * p.N;
  float* O = p.out + (long long)batch * p.M * p.N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * (MI * 16), wn = (warp % 4) * (NJ * 8);

  float acc[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int nk = (p.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tiles<VEC>(As + s * A_ELEMS, Bs + s * B_ELEMS, p, A, X, m0, n0, s * BK);
    if constexpr (VEC) cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if constexpr (VEC) cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();  // ... for every thread, and tile kt-1 is no longer read
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      const int ps = pf % STAGES;
      load_tiles<VEC>(As + ps * A_ELEMS, Bs + ps * B_ELEMS, p, A, X, m0, n0, pf * BK);
    }
    if constexpr (VEC) cp_async_commit();  // an empty group keeps the count in step
    const __nv_bfloat16* as = As + (kt % STAGES) * A_ELEMS;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * B_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldmatrix_x4(a[i], as + (wm + i * 16 + (lane % 16)) * APITCH + kk + (lane / 16) * 8);
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (kk + (lane % 16)) * BPITCH + wn + jj * 16 + (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          mma_bf16_16816(acc[i][2 * jj], a[i], r[0], r[1]);
          mma_bf16_16816(acc[i][2 * jj + 1], a[i], r[2], r[3]);
        }
      }
    }
  }
  if constexpr (VEC) cp_async_wait<0>();

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (row < p.M && col < p.N) O[(long long)row * p.N + col] = acc[i][j][e];
      }
}

template <bool VEC>
int launch(const Params& p, int B, cudaStream_t st) {
  auto kern = bmm_kernel<VEC>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, B);
  kern<<<grid, NTHREADS, SMEM_BYTES, st>>>(p);
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
  const bool vec = (K % 8 == 0) && (N % 8 == 0) &&
                   (reinterpret_cast<uintptr_t>(a) % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(p, B, st) : launch<false>(p, B, st);
}
