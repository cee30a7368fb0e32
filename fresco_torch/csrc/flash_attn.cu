// Masked flash attention, forward only, bf16 in / bf16 out, f32 softmax
// statistics and accumulators, for sm_90a.  One kernel family with two
// product cores behind one C entry point: wgmma (warpgroup tensor-core
// products) at head dims up to 160, mma.sync with ldmatrix at 256 and 512.
// Both are fed by the same cp.async ring over the same list of key tiles.
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
//   * online softmax with m, l and the output accumulator in f32, P rounded
//     to bf16 for the second product.
// Ragged Sq / Sk are masked at the edges (keys past Sk count as invalid,
// rows past Sq are not stored), so no caller pads.  The softmax scale must
// be positive (the row maximum is kept on the unscaled logits).
//
// What bounds it on the H100.  The arithmetic floor at the main path's small
// head dims (d = 40, 80) is the softmax, not the products: a logit costs
// 2·d product operations on the tensor cores but also one exp2 on the
// special-function units (16 a clock a SM) and four or five float32
// instructions, and at d = 40 the exp2 alone takes longer than the products
// at their peak.  What the kernel runs into first, though, is the stream of
// K and V tiles from L2 into shared memory: every block of BM query rows
// pulls all of K and V through.  With the copies left out (wrong results,
// timing only; H100 80GB HBM3, 700 W) the kernel took 24 % less time at
// d = 40, 44 % less at d = 80 and 60 % less at d = 512, where only 64 query
// rows fit beside a K/V ring in 227 KB, so the stream per row is largest.
//
// Design.
//   * K and V tiles arrive by 16-byte cp.async (zero fill past Sk and past
//     D) into a ring of STAGES tiles; the tile after next is in flight
//     while this one is multiplied; one block-wide barrier per tile.  A
//     thread's chunks keep their places from tile to tile, so its offsets
//     and column checks are computed once, before the loop (KVLoader).
//   * Before the ring starts, the block counts the valid keys of every key
//     tile of its batch row into shared memory and compacts the tiles that
//     hold one into a list.  The ring walks that list, so a fully masked
//     tile costs no load, no product and no vote, and every listed tile
//     holds a valid key (the running maximum is finite from the first
//     processed tile on; exp2(-inf - -inf) cannot arise).  Tiles with fewer
//     than BN valid keys take the mask pass, which reads the mask bytes of
//     the thread's own columns; the others skip it.  The list holds MAXT
//     tiles; longer key axes are walked MAXT tiles at a time.
//   * Softmax per logit: max on the raw logit, then one FMA
//     (s·c - m·c, c = scale·log2 e) and one ex2.approx; row sums are kept
//     per thread and reduced across the quad once, after the loop.
//   * d <= 160, the wgmma core: a warpgroup (4 warps) owns 64 query rows and
//     all of the head dim, two warpgroups a block (128 rows).  Both products
//     are wgmma.mma_async with A in registers: the Q fragments, read once
//     from global memory, for S = Q K^T, and P straight from the logit
//     accumulators (the accumulator layout is the A-fragment layout) for
//     O += P V.  B is the K or V tile in shared memory in the no-swizzle
//     core-matrix layout, which the cp.async ring writes directly; V lies
//     [key][d], the MN-major B of the second product (transposed-B flag).
//     No fragment passes through ldmatrix.  The tiles are copied with
//     cp.async.ca: blocks of one (batch, head) run side by side on a SM and
//     then find each other's K and V in L1.
//   * d = 256 and d = 512, the mma.sync core, in one pass: a 16 x D float32
//     output would take 128 or 256 registers a thread, so the warps of a
//     block form 4 row slabs x WC column groups.  For each key tile a warp
//     computes its slab's logits for BN/WC of the keys over all of d (Q by
//     ldmatrix from shared memory, K by ldmatrix); the slab's row maxima are
//     combined through shared memory; each warp writes its part of P (bf16)
//     to shared memory once and reads the whole slab's P back as A fragments
//     for its D/WC output columns (V by ldmatrix.trans).  Logits are computed
//     once (grid z is 1 everywhere).  Two slab-wide named barriers per tile
//     beside the ring's block-wide one.  Shared-memory rows have a pitch of
//     DP + 8 elements, an odd number of 16-byte chunks, so the 8 rows of
//     every ldmatrix phase (plain or .trans) fall in 8 different bank groups.
//     A wgmma version of this split (two warpgroups, P through a core-matrix
//     tile) measured slower (2.0 against 1.8 ms at d = 512, H100 80GB HBM3,
//     700 W): with the copies removed it took 0.8 ms, so the K/V stream, not
//     the products, bounds these widths, and the 16-warp version hides it
//     better.
//
// Instantiations (head dim padded to DP; rows a block BM; key tile BN; ring
// depth; dynamic shared memory, the 2,064 bytes of the tile lists included):
//   wgmma     DP  32  BM 128  BN 64  3 stages   26,640 B
//             DP  48  BM 128  BN 64  3 stages   38,928 B
//             DP  64  BM 128  BN 64  3 stages   51,216 B
//             DP  80  BM 128  BN 64  3 stages   63,504 B
//             DP 128  BM 128  BN 64  3 stages  100,368 B
//             DP 160  BM 128  BN 64  2 stages   83,984 B
//   mma.sync  DP 256  BM  64  4 x 2 warps  BN 64  2 stages  180,752 B (Q, P)
//             DP 512  BM  64  4 x 4 warps  BN 32  2 stages  207,888 B (Q, P)
#include "mma_util.cuh"
#include "wgmma_util.cuh"

#include <math_constants.h>

namespace {

using fresco::cp_async16;
using fresco::cp_async_commit;
using fresco::cp_async_wait;
using fresco::ex2;
using fresco::fence_proxy_async;
using fresco::ldmatrix_x4;
using fresco::ldmatrix_x4_trans;
using fresco::mma_bf16_16816;
using fresco::pack_bf16x2;
using fresco::wgmma_commit;
using fresco::wgmma_desc;
using fresco::wgmma_fence;
using fresco::wgmma_reg_fence;
using fresco::wgmma_rs;
using fresco::wgmma_wait;

constexpr int MAXT = 512;  // key tiles listed at a time
constexpr int LIST_BYTES = 2 * MAXT * 2 + 16;

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
  float scale_log2;  // softmax scale * log2(e), > 0
};

// What one thread copies of every K and V tile.  Its chunks' places in the
// tile never change, so the shared-memory offsets, the offsets from the
// tile's first row in global memory and the column checks are computed once,
// before the loop: per tile a chunk then costs a row check, an add and the
// cp.async.  CORES picks the shared-memory layout: rows of pitch LD, or 8 x
// 16-byte core matrices (chunk i at byte 16 i, so 8 consecutive threads fill
// one core matrix; see the wgmma core below).
template <int ROWS, int DP, int NTHREADS, bool CORES, int LD = 0>
struct KVLoader {
  static constexpr int NDC = DP / 8, NCH = ROWS * NDC, LPT = (NCH + NTHREADS - 1) / NTHREADS;
  int soff[LPT];  // element offset in the shared-memory tile
  int row[LPT];   // row in the tile; -1: no chunk; >= ROWS: a column past D (always zeros)
  int koff[LPT], voff[LPT];  // element offsets from the tile's first row in K and V

  __device__ __forceinline__ void init(long long k_ss, long long v_ss, int ncols) {
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      const int r = CORES ? (i / (8 * NDC)) * 8 + i % 8 : i / NDC;
      const int c = (CORES ? (i / 8) % NDC : i % NDC) * 8;
      soff[j] = CORES ? i * 8 : r * LD + c;
      row[j] = i >= NCH ? -1 : (c < ncols ? r : ROWS + r);
      koff[j] = r * static_cast<int>(k_ss) + c;
      voff[j] = r * static_cast<int>(v_ss) + c;
    }
  }
  // rows [row0, row0 + ROWS) of K and V (zeros from row `nrows` on) into ks, vs
  __device__ __forceinline__ void load(__nv_bfloat16* ks, __nv_bfloat16* vs, const __nv_bfloat16* K,
                                       const __nv_bfloat16* V, long long k_ss, long long v_ss,
                                       int row0, int nrows) const {
    const __nv_bfloat16* k0 = K + row0 * k_ss;
    const __nv_bfloat16* v0 = V + row0 * v_ss;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      if (row[j] < 0) continue;
      const bool in = row[j] < ROWS && row0 + row[j] < nrows;
      cp_async16<CORES>(ks + soff[j], in ? k0 + koff[j] : K, in);
      cp_async16<CORES>(vs + soff[j], in ? v0 + voff[j] : V, in);
    }
  }
};

// The valid keys of each of the `nt` key tiles from tile `tbase` on into
// cnt[], and the tiles that hold a valid key, in order, into live[]; their
// number into *n_live_s.  Called by every thread of the block; ends with a
// barrier.
template <int BN, int NWARPS>
__device__ __forceinline__ void list_live_tiles(const uint8_t* M, int Sk, int tbase, int nt,
                                                unsigned short* cnt, unsigned short* live,
                                                int* n_live_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < nt; i += NWARPS) {
    int n = 0;
#pragma unroll
    for (int off = 0; off < BN; off += 32) {
      const int kk = (tbase + i) * BN + off + lane;
      n += __popc(__ballot_sync(0xffffffffu, kk < Sk && (M == nullptr || M[kk] != 0)));
    }
    if (lane == 0) cnt[i] = static_cast<unsigned short>(n);
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int base = 0; base < nt; base += 32) {
      const int i = base + lane;
      const bool has = i < nt && cnt[i] > 0;
      const unsigned vote = __ballot_sync(0xffffffffu, has);
      if (has) live[n + __popc(vote & ((1u << lane) - 1u))] = static_cast<unsigned short>(i);
      n += __popc(vote);
    }
    if (lane == 0) *n_live_s = n;
  }
  __syncthreads();
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
// barrier over the `count` threads that use the same id (1..15)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A thread's logits of one key tile, in both cores: s[4j], s[4j+1] are row g,
// s[4j+2], s[4j+3] row g+8 of its warp's 16-row slab, at the tile's columns
// 8j + 2t and 8j + 2t + 1 (lane = 4g + t).
//
// Mask pass: -inf where the key is past Sk or masked.  `key` is the key of
// s[0] (the thread's first column).
template <int NS>
__device__ __forceinline__ void mask_logits(float (&s)[NS * 4], int key, int Sk, const uint8_t* M) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kk = key + j * 8 + e;
      if (!(kk < Sk && (M == nullptr || M[kk] != 0))) s[4 * j + e] = s[4 * j + e + 2] = -CUDART_INF_F;
    }
}
// The two rows' maxima over the tile's columns of the quad of lanes sharing g.
template <int NS>
__device__ __forceinline__ void row_max(const float (&s)[NS * 4], float& x0, float& x1) {
  x0 = x1 = -CUDART_INF_F;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
    x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  x0 = quad_max(x0);
  x1 = quad_max(x1);
}
// One step of the online softmax for the thread's two rows: the running
// maxima m0, m1 take in the tile's (x0, x1; finite, the tile holds a valid
// key), s becomes P = 2^(s·c - m·c) in place, the thread's parts l0, l1 of the
// row sums are updated, and al0, al1 are what the output sums must be scaled
// by before P V is added.
template <int NS>
__device__ __forceinline__ void softmax_step(float (&s)[NS * 4], float c, float x0, float x1,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float& al0, float& al1) {
  const float mn0 = fmaxf(m0, x0), mn1 = fmaxf(m1, x1);
  al0 = ex2((m0 - mn0) * c);
  al1 = ex2((m1 - mn1) * c);
  const float mc0 = mn0 * c, mc1 = mn1 * c;
  m0 = mn0;
  m1 = mn1;
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], c, -mc0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -mc0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -mc1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -mc1));
    rs0 += s[4 * j] + s[4 * j + 1];
    rs1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * al0 + rs0;
  l1 = l1 * al1 + rs1;
}
template <int NO>
__device__ __forceinline__ void scale_rows(float (&o)[NO * 4], float al0, float al1) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[4 * n] *= al0;
    o[4 * n + 1] *= al0;
    o[4 * n + 2] *= al1;
    o[4 * n + 3] *= al1;
  }
}
// The thread's two rows of the output, divided by the row sums l0, l1 (a row
// with no valid key, l == 0, is exact zeros), as bf16 at columns col0 + 8n + 2t.
template <int NO>
__device__ __forceinline__ void store_rows(const float (&o)[NO * 4], float l0, float l1,
                                           __nv_bfloat16* O, long long o_ss, int ra, int Sq,
                                           int col0, int D) {
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  const int rb = ra + 8;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int col = col0 + n * 8;
    if (col >= D) continue;
    if (ra < Sq)
      *reinterpret_cast<uint32_t*>(O + ra * o_ss + col) = pack_bf16x2(o[4 * n] * inv0, o[4 * n + 1] * inv0);
    if (rb < Sq)
      *reinterpret_cast<uint32_t*>(O + rb * o_ss + col) =
          pack_bf16x2(o[4 * n + 2] * inv1, o[4 * n + 3] * inv1);
  }
}

// ---------------------------------------------------------------- wgmma core
// One warpgroup (4 warps) owns 64 query rows; both products are
// wgmma.mma_async with A in registers and B a shared-memory tile in the
// no-swizzle core-matrix layout: chunk (key, c) of a [BN keys][DP] tile lies
// at ((key / 8) * (DP / 8) + c) * 128 + (key % 8) * 16 bytes.  K is then the
// K-major B of the first product (LBO 128, SBO DP·16) and V the MN-major B of
// the second (transposed-B flag; LBO DP·16, SBO 128), from the same ring.
// Products and softmax alternate inside a warpgroup; the other warpgroups of
// the SM (4 at d <= 80) fill the tensor cores meanwhile.  (Overlapping the
// second product with the next tile's softmax inside a warpgroup measured
// the same, 1.345 against 1.315 ms at d = 40 on an H100 80GB HBM3 at 700 W,
// and was not kept.)
template <int DP_, int STAGES_, int MINB_>
struct WgmmaCfg {
  static constexpr int DP = DP_, STAGES = STAGES_;
  static constexpr int MINB = MINB_;  // blocks a SM the register allocation must allow
  static constexpr int NWG = 2, BN = 64;  // warpgroups a block, keys a tile
  static constexpr int NWARPS = NWG * 4, NTHREADS = NWG * 128, BM = NWG * 64;
  static constexpr int KV_ELEMS = BN * DP;
  static constexpr int SMEM_BYTES = 2 * STAGES * KV_ELEMS * 2 + LIST_BYTES;
  static_assert(DP % 16 == 0 && BN % 32 == 0 && STAGES >= 2, "tile shape");
};

template <class C>
__global__ void __launch_bounds__(C::NTHREADS, C::MINB) flash_fwd_wgmma_kernel(FlashParams p) {
  constexpr int DP = C::DP, BN = C::BN, STAGES = C::STAGES;
  constexpr int NS = BN / 8;   // n8 tiles of logits a thread
  constexpr int NO = DP / 8;   // n8 tiles of output a thread
  constexpr int KS = DP / 16;  // k16 steps of Q K^T
  constexpr uint32_t GROUP_BYTES = DP * 16;  // 8 keys of a tile
  extern __shared__ __align__(128) unsigned char smem_cores[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_cores);
  __nv_bfloat16* Vs = Ks + STAGES * C::KV_ELEMS;
  unsigned short* cnt = reinterpret_cast<unsigned short*>(Vs + STAGES * C::KV_ELEMS);
  unsigned short* live = cnt + MAXT;
  int* n_live_s = reinterpret_cast<int*>(live + MAXT);

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * C::BM;
  const __nv_bfloat16* Q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* V = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* O = p.o + b * p.o_sb + h * p.o_sh;
  const uint8_t* M = p.mask ? p.mask + b * p.mask_sb : nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16;  // the warp's first row in the block
  const float c = p.scale_log2;
  const uint32_t ks_addr = static_cast<uint32_t>(__cvta_generic_to_shared(Ks));
  const uint32_t vs_addr = static_cast<uint32_t>(__cvta_generic_to_shared(Vs));

  // Q fragments for the whole loop, straight from global memory
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + r0 + g + (e & 1) * 8;
      const int col = ks * 16 + 2 * t + (e >> 1) * 8;
      qf[ks][e] = (row < p.Sq && col < p.D)
                      ? *reinterpret_cast<const uint32_t*>(Q + row * p.q_ss + col)
                      : 0u;
    }

  float o[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  KVLoader<BN, DP, C::NTHREADS, true> loader;
  loader.init(p.k_ss, p.v_ss, p.D);
  const int nkt = (p.Sk + BN - 1) / BN;
  for (int tbase = 0; tbase < nkt; tbase += MAXT) {
    const int nt = min(MAXT, nkt - tbase);
    list_live_tiles<BN, C::NWARPS>(M, p.Sk, tbase, nt, cnt, live, n_live_s);
    const int n_live = *n_live_s;

    auto fetch = [&](int i) {  // listed tile i into its ring slot
      const int st = i % STAGES;
      loader.load(Ks + st * C::KV_ELEMS, Vs + st * C::KV_ELEMS, K, V, p.k_ss, p.v_ss,
                  (tbase + live[i]) * BN, p.Sk);
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < n_live) fetch(st);
      cp_async_commit();
    }

    for (int it = 0; it < n_live; ++it) {
      cp_async_wait<STAGES - 2>();  // tile `it` has landed
      fence_proxy_async();          // ... and the tensor cores may read it
      __syncthreads();              // for every thread; tile it-1 is no longer read
      if (it + STAGES - 1 < n_live) fetch(it + STAGES - 1);
      cp_async_commit();  // an empty group keeps the count in step
      const int tile = live[it];
      const uint32_t kt = ks_addr + (it % STAGES) * (C::KV_ELEMS * 2);
      const uint32_t vt = vs_addr + (it % STAGES) * (C::KV_ELEMS * 2);

      // S = Q K^T: 64 rows x BN keys a warpgroup
      float s[NS * 4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_rs<0>(s, qf[ks], wgmma_desc(kt + ks * 256, 128, GROUP_BYTES), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_reg_fence(s);

      if (cnt[tile] < BN) mask_logits<NS>(s, (tbase + tile) * BN + 2 * t, p.Sk, M);
      float x0, x1, al0, al1;
      row_max<NS>(s, x0, x1);
      softmax_step<NS>(s, c, x0, x1, m0, m1, l0, l1, al0, al1);
      scale_rows<NO>(o, al0, al1);

      // O += P V: P (bf16) straight from the logit accumulators
      uint32_t a[BN / 16][4];
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[kc][e] = pack_bf16x2(s[8 * kc + 2 * e], s[8 * kc + 2 * e + 1]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
        wgmma_rs<1>(o, a[kc], wgmma_desc(vt + kc * 2 * GROUP_BYTES, GROUP_BYTES, 128), 1);
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_reg_fence(o);
    }
    cp_async_wait<0>();
    __syncthreads();  // the lists and the ring are free again
  }

  store_rows<NO>(o, quad_sum(l0), quad_sum(l1), O, p.o_ss, q0 + r0 + g, p.Sq, 2 * t, p.D);
}

// ------------------------------------------------------------- mma.sync core
// d = 256 and d = 512: NWARPS warps as 4 row slabs x WC column groups over 64
// query rows (see the note at the top).
template <int DP_, int BN_, int WC_>
struct SplitCfg {
  static constexpr int DP = DP_, BN = BN_, WC = WC_, STAGES = 2, MINB = 1;
  static constexpr int BM = 64, NWARPS = BM / 16 * WC, NTHREADS = NWARPS * 32;
  static constexpr int LD = DP + 8;   // pitch of Q, K, V rows in shared memory
  static constexpr int LP = BN + 8;   // pitch of P rows
  static constexpr int NK = BN / WC;  // keys of S a warp computes
  static constexpr int DV = DP / WC;  // output columns a warp owns
  static constexpr int KV_ELEMS = BN * LD, Q_ELEMS = BM * LD, P_ELEMS = BM * LP;
  static constexpr int SMEM_BYTES =
      (Q_ELEMS + 2 * STAGES * KV_ELEMS + P_ELEMS) * 2 + BM * WC * 4 + LIST_BYTES;
  static_assert(DP % 16 == 0 && BN % 32 == 0 && STAGES >= 2, "tile shape");
  static_assert(NK % 16 == 0 || (NK == 8 && DP % 32 == 0), "keys a warp");
  static_assert(DV % 16 == 0, "columns a warp");
};

template <class C>
__global__ void __launch_bounds__(C::NTHREADS, C::MINB) flash_fwd_split_kernel(FlashParams p) {
  constexpr int DP = C::DP, BN = C::BN, STAGES = C::STAGES, WC = C::WC;
  constexpr int LD = C::LD, LP = C::LP, NK = C::NK, DV = C::DV;
  constexpr int NS = NK / 8;   // n8 tiles of logits a warp
  constexpr int NO = DV / 8;   // n8 tiles of output a warp
  constexpr int KS = DP / 16;  // k16 steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + C::Q_ELEMS;
  __nv_bfloat16* Vs = Ks + STAGES * C::KV_ELEMS;
  __nv_bfloat16* Ps = Vs + STAGES * C::KV_ELEMS;
  float* red = reinterpret_cast<float*>(Ps + C::P_ELEMS);
  unsigned short* cnt = reinterpret_cast<unsigned short*>(red + C::BM * WC);
  unsigned short* live = cnt + MAXT;
  int* n_live_s = reinterpret_cast<int*>(live + MAXT);

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H;
  const int q0 = blockIdx.x * C::BM;
  const __nv_bfloat16* Q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* K = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* V = p.v + b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* O = p.o + b * p.o_sb + h * p.o_sh;
  const uint8_t* M = p.mask ? p.mask + b * p.mask_sb : nullptr;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / WC, wc = warp % WC;
  const int r0 = wr * 16;    // the warp's first row in the block
  const int key0 = wc * NK;  // its first key column in a tile
  const int col0 = wc * DV;  // its first output column
  const float c = p.scale_log2;

  // the Q tile: rows past Sq and columns past D are zeros
  for (int i = threadIdx.x; i < C::BM * (DP / 8); i += C::NTHREADS) {
    const int r = i / (DP / 8), col = (i % (DP / 8)) * 8;
    const bool in = q0 + r < p.Sq && col < p.D;
    cp_async16<false>(Qs + r * LD + col, in ? Q + (q0 + r) * p.q_ss + col : Q, in);
  }
  cp_async_commit();  // lands with the first K/V tile, or before the exit

  float o[NO * 4];
#pragma unroll
  for (int i = 0; i < NO * 4; ++i) o[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;

  KVLoader<BN, DP, C::NTHREADS, false, LD> loader;
  loader.init(p.k_ss, p.v_ss, p.D);
  const int nkt = (p.Sk + BN - 1) / BN;
  for (int tbase = 0; tbase < nkt; tbase += MAXT) {
    const int nt = min(MAXT, nkt - tbase);
    list_live_tiles<BN, C::NWARPS>(M, p.Sk, tbase, nt, cnt, live, n_live_s);
    const int n_live = *n_live_s;

    auto fetch = [&](int i) {  // listed tile i into its ring slot
      const int st = i % STAGES;
      loader.load(Ks + st * C::KV_ELEMS, Vs + st * C::KV_ELEMS, K, V, p.k_ss, p.v_ss,
                  (tbase + live[i]) * BN, p.Sk);
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < n_live) fetch(st);
      cp_async_commit();
    }

    for (int it = 0; it < n_live; ++it) {
      cp_async_wait<STAGES - 2>();  // tile `it` has landed
      __syncthreads();              // ... for every thread, and tile it-1 is no longer read
      if (it + STAGES - 1 < n_live) fetch(it + STAGES - 1);
      cp_async_commit();  // an empty group keeps the count in step
      const int tile = live[it];
      const __nv_bfloat16* Kt = Ks + (it % STAGES) * C::KV_ELEMS;
      const __nv_bfloat16* Vt = Vs + (it % STAGES) * C::KV_ELEMS;

      // S = Q K^T: the warp's 16 rows x its NK keys, over all of d
      float s[NS * 4];
#pragma unroll
      for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
      if constexpr (NK % 16 == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t a[4];
          ldmatrix_x4(a, Qs + (r0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int jj = 0; jj < NK / 16; ++jj) {
            // keys 16jj..16jj+15 x k 16ks..16ks+15: b0, b1 of two n8 tiles
            uint32_t r[4];
            ldmatrix_x4(r, Kt + (key0 + jj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                               ((lane >> 3) & 1) * 8);
            mma_bf16_16816(reinterpret_cast<float(&)[4]>(s[8 * jj]), a, r[0], r[1]);
            mma_bf16_16816(reinterpret_cast<float(&)[4]>(s[8 * jj + 4]), a, r[2], r[3]);
          }
        }
      } else {
        // one n8 tile of keys: an ldmatrix.x4 spans two k16 steps; two
        // accumulators halve the dependent chain
        float s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < KS; ks += 2) {
          uint32_t r[4], a0[4], a1[4];
          ldmatrix_x4(r, Kt + (key0 + (lane & 7)) * LD + ks * 16 + (lane >> 3) * 8);
          ldmatrix_x4(a0, Qs + (r0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8);
          ldmatrix_x4(a1, Qs + (r0 + (lane & 15)) * LD + ks * 16 + 16 + (lane >> 4) * 8);
          mma_bf16_16816(reinterpret_cast<float(&)[4]>(s[0]), a0, r[0], r[1]);
          mma_bf16_16816(s2, a1, r[2], r[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) s[e] += s2[e];
      }

      if (cnt[tile] < BN) mask_logits<NS>(s, (tbase + tile) * BN + key0 + 2 * t, p.Sk, M);
      // row maxima over the quad, then over the slab's WC warps through shared memory
      float x0, x1, al0, al1;
      row_max<NS>(s, x0, x1);
      if (t == 0) {
        red[(r0 + g) * WC + wc] = x0;
        red[(r0 + g + 8) * WC + wc] = x1;
      }
      named_barrier(1 + wr, WC * 32);
#pragma unroll
      for (int w = 0; w < WC; ++w) {
        x0 = fmaxf(x0, red[(r0 + g) * WC + w]);
        x1 = fmaxf(x1, red[(r0 + g + 8) * WC + w]);
      }
      softmax_step<NS>(s, c, x0, x1, m0, m1, l0, l1, al0, al1);
      scale_rows<NO>(o, al0, al1);

      // O += P V: the warp's part of P to shared memory, the slab's whole P back
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        __nv_bfloat16* pp = Ps + (r0 + g) * LP + key0 + j * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(pp) = pack_bf16x2(s[4 * j], s[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(pp + 8 * LP) = pack_bf16x2(s[4 * j + 2], s[4 * j + 3]);
      }
      named_barrier(1 + wr, WC * 32);
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) {
        uint32_t a[4];
        ldmatrix_x4(a, Ps + (r0 + (lane & 15)) * LP + kc * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nn = 0; nn < NO / 2; ++nn) {
          // keys 16kc..16kc+15 x columns 16nn..16nn+15: b0, b1 of two n8 tiles
          uint32_t r[4];
          ldmatrix_x4_trans(r, Vt + (kc * 16 + (lane & 15)) * LD + col0 + nn * 16 + (lane >> 4) * 8);
          mma_bf16_16816(reinterpret_cast<float(&)[4]>(o[8 * nn]), a, r[0], r[1]);
          mma_bf16_16816(reinterpret_cast<float(&)[4]>(o[8 * nn + 4]), a, r[2], r[3]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the lists and the ring are free again
  }

  // row sums over the quad and the slab's warps
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t == 0) {
    red[(r0 + g) * WC + wc] = l0;
    red[(r0 + g + 8) * WC + wc] = l1;
  }
  named_barrier(1 + wr, WC * 32);
  l0 = l1 = 0.f;
#pragma unroll
  for (int w = 0; w < WC; ++w) {
    l0 += red[(r0 + g) * WC + w];
    l1 += red[(r0 + g + 8) * WC + w];
  }
  store_rows<NO>(o, l0, l1, O, p.o_ss, q0 + r0 + g, p.Sq, col0 + 2 * t, p.D);
}

template <class C, class Kern>
cudaError_t launch(Kern kern, const FlashParams& p, int B, cudaStream_t stream) {
  if (C::SMEM_BYTES > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_BYTES);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((p.Sq + C::BM - 1) / C::BM, B * p.H, 1);
  kern<<<grid, C::NTHREADS, C::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}
template <int DP, int STAGES, int MINB>
cudaError_t launch_wgmma(const FlashParams& p, int B, cudaStream_t stream) {
  using C = WgmmaCfg<DP, STAGES, MINB>;
  return launch<C>(flash_fwd_wgmma_kernel<C>, p, B, stream);
}
template <int DP, int BN, int WC>
cudaError_t launch_split(const FlashParams& p, int B, cudaStream_t stream) {
  using C = SplitCfg<DP, BN, WC>;
  return launch<C>(flash_fwd_split_kernel<C>, p, B, stream);
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
  // a tile's offsets from its first row are kept in 32 bits
  constexpr long long MAX_ROW_STRIDE = 1 << 22;
  if (D <= 0 || D % 8 != 0 || D > 512 || !(scale > 0.f) || k_ss < 0 || k_ss > MAX_ROW_STRIDE ||
      v_ss < 0 || v_ss > MAX_ROW_STRIDE)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  // head dim padded to the next instantiated width; the core of each width is
  // the one that measured faster on the card:
  //                               DP  stages  blocks a SM
  if (D <= 32) return launch_wgmma<32, 3, 2>(p, B, s);
  if (D <= 48) return launch_wgmma<48, 3, 2>(p, B, s);
  if (D <= 64) return launch_wgmma<64, 3, 2>(p, B, s);
  if (D <= 80) return launch_wgmma<80, 3, 2>(p, B, s);
  if (D <= 128) return launch_wgmma<128, 3, 1>(p, B, s);
  if (D <= 160) return launch_wgmma<160, 2, 1>(p, B, s);
  //                               DP  BN  column groups
  if (D <= 256) return launch_split<256, 64, 2>(p, B, s);
  return launch_split<512, 32, 4>(p, B, s);
}
