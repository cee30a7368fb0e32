// Spatial feature-optimization gradient: out = sign(v v^T - C) v, f32 out.
// bf16 operands on sm_90a mma.sync tensor cores, or f32 operands on the
// CUDA cores; f32 accumulation either way.
//
// Replaces: fresco_tpu/ops/gram_kernel.py:_sign_gram_kernel (Pallas TPU),
// called by guidance._gram_l1_grad in every Adam iteration of the
// feature optimization with v [B, hw, c] bf16 (row-normalized decoder
// features) and the dense reference gram C [B, hw, hw] bf16.
//
// The TPU kernel fuses build -> sign -> apply per (bm x bn) tile and keeps
// a bm x c f32 accumulator in VMEM.  At c = 1280 and bm = 64 that
// accumulator alone is 327 KB, more than the 227 KB of shared memory a
// Hopper block can hold (and far more than its registers).  Design
// choice: two kernels, both the same block-tiled "NT" product
// out[m][n] = sum_k A[m][k] * B[n][k] with different loaders/epilogues:
//   1. sign kernel: G = v v^T tile by tile (K = c), epilogue writes
//      S = sign(G - C) as int8 [B, hw, ldS] (ldS = hw rounded up to 16,
//      padding written as 0);
//   2. apply kernel: out = S v^T^T, i.e. A = S (int8 -> bf16 on load,
//      exact for -1/0/1), B = v^T [B, c, ldS] (a transposed, zero-padded
//      copy the wrapper makes), K = ldS.
// Cost of the choice: S makes one round trip through device memory, one
// byte per entry (268 MB written and read back at hw = 4096, B = 16), on
// top of reading C (2 bytes per entry).  The alternative (split c across
// blocks, rebuild G per split) would multiply the G products by c / split
// (10x at c = 1280 with 128-column splits); the extra bytes cost far less
// than that on a card with 3.35 TB/s.
//
// What bounds it on the H100: 4 hw^2 c flops per batch element (two
// products) against ~3 hw^2 bytes of C and S traffic: ~850 flops per byte
// at c = 640, so the tensor cores bound it.  Tiles are 128 x 128 x 32 with
// 8 warps (warp tile 64 x 32) to reuse each loaded fragment 4 times; loads
// are synchronous 16-byte copies (cp.async / TMA pipelining and wgmma are
// left for later work).  Any hw is handled: rows and columns past the
// edge are zero-filled on load and masked on store.
//
// float32 operands (gram_dtype="float32", the strict-parity setting; the
// TPU kernel takes both dtypes) run the same two products with f32 FMA on
// the CUDA cores: bf16 or TF32 tensor-core inputs would round v before G
// is formed.  64 x 64 tiles, 256 threads, a 4 x 4 register tile each.
#include "mma_util.cuh"

namespace {

using fresco::ld_pair;
using fresco::mma_bf16_16816;

constexpr int TM = 128, TN = 128, TK = 32;
constexpr int LDS = TK + 8;  // shared-memory row pitch (bf16), 80 bytes
constexpr int NTHREADS = 256;

enum Epilogue { kSign = 0, kApply = 1 };

struct GemmParams {
  const void* a;  // [batch, M, lda] operand dtype, or int8 when A_INT8
  const void* b;  // [batch, N, ldb] operand dtype
  int M, N, K;
  long long lda, a_bs, ldb, b_bs;
  // kSign: C [batch, M, ldc] operand dtype in, S [batch, M, ldsv] int8 out
  const void* c;
  long long ldc, c_bs;
  int8_t* s;
  long long ldsv, s_bs;
  int n_store;  // kSign: columns written (ldS >= N); padding gets 0
  // kApply: out [batch, M, ldo] f32
  float* out;
  long long ldo, o_bs;
};

// A tile [TM x TK] -> shared bf16; int8 sources are widened on load.
template <bool A_INT8>
__device__ __forceinline__ void load_a(__nv_bfloat16* As, const GemmParams& p, int batch,
                                       int m0, int k0) {
  if constexpr (A_INT8) {
    // 2 chunks of 16 bytes per row, one chunk per thread
    const int8_t* A = static_cast<const int8_t*>(p.a) + batch * p.a_bs;
    const int r = threadIdx.x / 2, c = (threadIdx.x % 2) * 16;
    int4 raw = make_int4(0, 0, 0, 0);
    if (m0 + r < p.M && k0 + c < p.K)
      raw = *reinterpret_cast<const int4*>(A + (long long)(m0 + r) * p.lda + k0 + c);
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&raw);
    __nv_bfloat16 w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = __float2bfloat16_rn(static_cast<float>(bytes[i]));
    uint4* dst = reinterpret_cast<uint4*>(As + r * LDS + c);
    dst[0] = *reinterpret_cast<const uint4*>(&w[0]);
    dst[1] = *reinterpret_cast<const uint4*>(&w[8]);
  } else {
    const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(p.a) + batch * p.a_bs;
    for (int i = threadIdx.x; i < TM * (TK / 8); i += NTHREADS) {
      const int r = i / (TK / 8), c = (i % (TK / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < p.M && k0 + c < p.K)
        val = *reinterpret_cast<const uint4*>(A + (long long)(m0 + r) * p.lda + k0 + c);
      *reinterpret_cast<uint4*>(As + r * LDS + c) = val;
    }
  }
}

__device__ __forceinline__ void load_b(__nv_bfloat16* Bs, const GemmParams& p, int batch,
                                       int n0, int k0) {
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(p.b) + batch * p.b_bs;
  for (int i = threadIdx.x; i < TN * (TK / 8); i += NTHREADS) {
    const int r = i / (TK / 8), c = (i % (TK / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n0 + r < p.N && k0 + c < p.K)
      val = *reinterpret_cast<const uint4*>(B + (long long)(n0 + r) * p.ldb + k0 + c);
    *reinterpret_cast<uint4*>(Bs + r * LDS + c) = val;
  }
}

template <bool A_INT8, int EPI>
__global__ void __launch_bounds__(NTHREADS) nt_gemm_kernel(GemmParams p) {
  __shared__ __align__(16) __nv_bfloat16 As[TM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[TN * LDS];
  const int batch = blockIdx.z;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += TK) {
    __syncthreads();
    load_a<A_INT8>(As, p, batch, m0, k0);
    load_b(Bs, p, batch, n0, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* ap = As + (wm + i * 16 + g) * LDS + kk + 2 * t;
        a[i][0] = ld_pair(ap);
        a[i][1] = ld_pair(ap + 8 * LDS);
        a[i][2] = ld_pair(ap + 8);
        a[i][3] = ld_pair(ap + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* bp = Bs + (wn + j * 8 + g) * LDS + kk + 2 * t;
        const uint32_t b0 = ld_pair(bp), b1 = ld_pair(bp + 8);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma_bf16_16816(acc[i][j], a[i], b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (row >= p.M) continue;
        if constexpr (EPI == kSign) {
          if (col >= p.n_store) continue;
          int8_t sv = 0;
          if (col < p.N) {
            const float d = acc[i][j][e] - __bfloat162float(static_cast<const __nv_bfloat16*>(
                p.c)[batch * p.c_bs + (long long)row * p.ldc + col]);
            sv = static_cast<int8_t>((d > 0.f) - (d < 0.f));
          }
          p.s[batch * p.s_bs + (long long)row * p.ldsv + col] = sv;
        } else {
          if (col >= p.N) continue;
          p.out[batch * p.o_bs + (long long)row * p.ldo + col] = acc[i][j][e];
        }
      }
    }
  }
}

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
int launch(const GemmParams& p, int n_cols, int B, bool f32, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (f32) {
    dim3 grid((n_cols + FT - 1) / FT, (p.M + FT - 1) / FT, B);
    nt_gemm_f32_kernel<A_INT8, EPI><<<grid, NTHREADS, 0, st>>>(p);
  } else {
    dim3 grid((n_cols + TN - 1) / TN, (p.M + TM - 1) / TM, B);
    nt_gemm_kernel<A_INT8, EPI><<<grid, NTHREADS, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S = sign(v v^T - C) as int8 [B, hw, lds]; columns [hw, lds) are zeroed.
// v and C are bf16, or f32 when f32 != 0.
extern "C" int fresco_sign_gram_sign(const void* v, const void* c, void* s, int B, int hw,
                                     int ch, int lds, int f32, void* stream) {
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
  if (B == 0 || hw == 0) return 0;
  return launch<false, kSign>(p, lds, B, f32 != 0, stream);
}

// out [B, hw, ch] f32 = S [B, hw, lds] (int8) x vt^T, vt [B, ch, lds] bf16
// (f32 when f32 != 0) zero-padded past hw.
extern "C" int fresco_sign_gram_apply(const void* s, const void* vt, void* out, int B, int hw,
                                      int ch, int lds, int f32, void* stream) {
  GemmParams p = {};
  p.a = s;
  p.b = vt;
  p.M = hw; p.N = ch; p.K = lds;
  p.lda = lds; p.a_bs = (long long)hw * lds;
  p.ldb = lds; p.b_bs = (long long)ch * lds;
  p.out = static_cast<float*>(out);
  p.ldo = ch; p.o_bs = (long long)hw * ch;
  if (B == 0 || hw == 0) return 0;
  return launch<true, kApply>(p, ch, B, f32 != 0, stream);
}
