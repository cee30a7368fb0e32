// Masked flash attention, forward only, bf16 in / bf16 out, f32 softmax
// statistics and accumulators.  sm_90a, mma.sync tensor cores.
//
// Replaces: fresco_tpu/attention/flash.py:_flash_kernel (Pallas TPU), the
// kernel behind every UNet / ControlNet self-attention, the cross-frame
// and spatial-guided FRESCO attentions and the VAE mid-block attention.
//
// Semantics kept from the TPU kernel:
//   * one bool mask per key [B, Sk], shared by every query and head;
//   * key tiles with no valid key are skipped (no loads, no products);
//   * key tiles with only valid keys skip the mask pass;
//   * a query row with no valid key at all writes exact zeros (l == 0);
//   * online softmax with m, l and the output accumulator in f32.
// Ragged Sq / Sk are masked at the edges (keys past Sk count as invalid,
// rows past Sq are not stored), so no caller pads.
//
// What bounds it on the H100: at the main path's small head dims
// (d = 40, 80) the kernel does little work per byte of K/V, so the
// softmax's per-logit arithmetic and the shared-memory traffic of the
// fragment loads bound it, not the tensor cores; at d = 160 and d = 512
// the two products dominate.  Design: 64 query rows per block (16 per
// warp, one m16 slab), 64-key tiles, head dim zero-padded only to the next
// instantiated width (40 -> 48, not to 128), logits and probabilities
// kept in registers in the mma accumulator layout so P feeds the second
// product without a trip through shared memory.  The d = 512 case would
// need a 16 x 512 f32 accumulator per warp (256 registers a thread), so
// the output columns are split across blocks (grid z, 128 columns each)
// and each block recomputes the logits for its slice: 4x the QK^T work on
// that one shape, which is a small part of the path (VAE mid-block only).
// Shared memory is sized per width (150 KB at d = 512, above the 48 KB
// default, so the launch raises the dynamic limit).  Loads are plain
// synchronous 16-byte copies; cp.async / TMA pipelining and wgmma are
// left for later work.
#include "mma_util.cuh"

#include <math_constants.h>

namespace {

using fresco::ld_pair;
using fresco::mma_bf16_16816;
using fresco::pack_f32;
using fresco::pack_raw;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int NTHREADS = 128;

struct FlashParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* mask;  // [B, Sk] bool, or null (all keys valid)
  __nv_bfloat16* o;
  int H, Sq, Sk, D;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long mask_sb;
  float scale_log2;  // softmax scale * log2(e)
};

// rows [row0, row0+ROWS) x cols [col0, col0+COLS) of a row-major bf16
// matrix into shared memory (leading dim sld); out-of-range rows/cols
// (row >= nrows, col >= ncols) are zero.  ncols % 8 == 0.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* s, int sld, const __nv_bfloat16* g,
                                          long long gld, int row0, int nrows, int col0,
                                          int ncols) {
  constexpr int CPR = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && col0 + c < ncols)
      val = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * gld + col0 + c);
    *reinterpret_cast<uint4*>(s + r * sld + c) = val;
  }
}

template <int DQK, int DVC>
constexpr int smem_bytes() {
  return (BM * (DQK + 8) + BN * (DQK + 8) + BN * (DVC + 8)) * 2 + BN * 4;
}

template <int DQK, int DVC>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(FlashParams p) {
  constexpr int LQ = DQK + 8;
  constexpr int LV = DVC + 8;
  constexpr int NT = BN / 8;   // n8 tiles of logits per warp
  constexpr int NO = DVC / 8;  // n8 tiles of output per warp
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BM * LQ;
  __nv_bfloat16* Vs = Ks + BN * LQ;
  int* vflag = reinterpret_cast<int*>(Vs + BN * LV);

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * BM, dv0 = blockIdx.z * DVC;
  const __nv_bfloat16* Q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* V = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* O = p.o + b * p.o_sb + h * p.o_sh;
  const uint8_t* M = p.mask ? p.mask + b * p.mask_sb : nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;

  load_tile<BM, DQK>(Qs, LQ, Q, p.q_ss, q0, p.Sq, 0, p.D);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  const int nkt = (p.Sk + BN - 1) / BN;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // earlier tile's shared-memory reads are done
    int valid = 0;
    if (threadIdx.x < BN) {
      const int kk = k0 + threadIdx.x;
      valid = kk < p.Sk && (M == nullptr || M[kk] != 0);
      vflag[threadIdx.x] = valid;
    }
    const int nvalid = __syncthreads_count(valid);
    if (nvalid == 0) continue;  // fully masked tile: skipped
    const bool mixed = nvalid < BN;
    load_tile<BN, DQK>(Ks, LQ, K, p.k_ss, k0, p.Sk, 0, p.D);
    load_tile<BN, DVC>(Vs, LV, V, p.v_ss, k0, p.Sk, dv0, p.D);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK; kk += 16) {
      uint32_t a[4];
      a[0] = ld_pair(Qs + (r0 + g) * LQ + kk + 2 * t);
      a[1] = ld_pair(Qs + (r0 + g + 8) * LQ + kk + 2 * t);
      a[2] = ld_pair(Qs + (r0 + g) * LQ + kk + 8 + 2 * t);
      a[3] = ld_pair(Qs + (r0 + g + 8) * LQ + kk + 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* kb = Ks + (j * 8 + g) * LQ + kk + 2 * t;
        mma_bf16_16816(s[j], a, ld_pair(kb), ld_pair(kb + 8));
      }
    }

    // scale (log2 domain), mask, row max over the quad of lanes sharing g
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale_log2;
        if (mixed && !vflag[j * 8 + 2 * t + (e & 1)]) x = -CUDART_INF_F;
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // the tile holds a valid key, so the new maxima are finite
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }

    // O += P V: P (bf16) straight from the logit accumulators
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      uint32_t a[4];
      a[0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
      a[1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
      a[2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      a[3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vb = Vs + (kc * 16 + 2 * t) * LV + n * 8 + g;
        mma_bf16_16816(o[n], a, pack_raw(vb[0], vb[LV]), pack_raw(vb[8 * LV], vb[9 * LV]));
      }
    }
  }

  // rows with no valid key (l == 0) are exact zeros
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int ra = q0 + r0 + g, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = dv0 + n * 8 + 2 * t;
    if (col >= p.D) continue;
    if (ra < p.Sq)
      *reinterpret_cast<uint32_t*>(O + ra * p.o_ss + col) = pack_f32(o[n][0] * inv0, o[n][1] * inv0);
    if (rb < p.Sq)
      *reinterpret_cast<uint32_t*>(O + rb * p.o_ss + col) = pack_f32(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int DQK, int DVC>
cudaError_t launch(const FlashParams& p, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DQK, DVC>();
  auto kern = flash_fwd_kernel<DQK, DVC>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((p.Sq + BM - 1) / BM, B * p.H, (p.D + DVC - 1) / DVC);
  kern<<<grid, NTHREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fresco_flash_attn_fwd(const void* q, const void* k, const void* v,
                                     const void* mask, void* o, int B, int H, int Sq, int Sk,
                                     int D, long long q_sb, long long q_sh, long long q_ss,
                                     long long k_sb, long long k_sh, long long k_ss,
                                     long long v_sb, long long v_sh, long long v_ss,
                                     long long o_sb, long long o_sh, long long o_ss,
                                     long long mask_sb, float scale, void* stream) {
  FlashParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.mask = static_cast<const uint8_t*>(mask);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.Sq = Sq;
  p.Sk = Sk;
  p.D = D;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.mask_sb = mask_sb;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || D > 512) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  // head dim padded to the next instantiated width
  if (D <= 32) return launch<32, 32>(p, B, s);
  if (D <= 48) return launch<48, 48>(p, B, s);
  if (D <= 64) return launch<64, 64>(p, B, s);
  if (D <= 80) return launch<80, 80>(p, B, s);
  if (D <= 128) return launch<128, 128>(p, B, s);
  if (D <= 160) return launch<160, 160>(p, B, s);
  if (D <= 256) return launch<256, 128>(p, B, s);
  return launch<512, 128>(p, B, s);
}
