// Spatial feature-optimization gradient with a factored reference gram:
//   out = sign(v v^T - r r^T) v,  v, r [B, hw, c] bf16,  out [B, hw, c] f32,
// unscaled (the caller applies 2/(B hw^2)), f32 accumulation throughout.
//
// Replaces no Pallas kernel.  The JAX package leaves the factored path to
// XLA (fresco_tpu/diffusion/guidance.py:394-413: bf16 einsums with
// preferred_element_type=float32, one row chunk at a time).  The port ran
// it as three float32 CUDA-core products a 1024-row chunk plus elementwise
// passes over [B, 1024, hw] float32 temporaries.  It is taken when the
// dense reference gram C = r r^T would exceed `dense_corr_max_mb`: at the
// 512x640 finest decoder stage, v [16, 5120, 640] (C would be 800 MiB).
//
// What bounds it on the H100: operations.  The least work is 4 B hw^2 c
// FLOPs (half of the symmetric D = v v^T - r r^T, B hw^2 c for each
// product, then S v, 2 B hw^2 c) against 2 x 105 MB of bf16 operands and
// a 210 MB f32 output: 1.07e12 FLOPs, 1.09 ms at the bf16 tensor peak
// (989 TFLOP/s) at [16, 5120, 640], 0.13 ms of memory.  A block here owns
// rows and forms its D tiles whole, 6 B hw^2 c FLOPs, so the floor this
// design can reach is 1.63 ms.
//
// Why fusing pays here when sign_gram.cu's note says it does not for the
// dense case: there is no C to read (the dense pair reads C and writes S,
// [B, hw, hw] each, and fusion would only have saved S's round trip), and
// the output row is c = 640 wide, not 1280, so a 64-row output panel fits
// the registers of two warpgroups.  Unfused, the sign matrix would make a
// [B, hw, hw] round trip (1.7 GB at [16, 5120, 640]); here no [B, hw, hw]
// or [B, rows, hw] tensor exists anywhere.
//
// Design (the wgmma core, 128-byte swizzle, descriptors and cp.async ring
// of sign_gram.cu and bmm.cu; no TMA, no clusters):
//   * A block owns BM = 64 rows i of one image and BLOCK_COLS = 640 output
//     columns; 256 threads, two warpgroups sharing the rows, each owning
//     320 output columns: 64 x 320 float32 = 160 accumulators a thread.
//     c > 640 takes ceil(c / 640) blocks a row panel, each forming D again.
//   * It walks j tiles of BN = 128 rows.  For each, D = v_i v_j^T - r_i r_j^T
//     is formed channel chunk by channel chunk (64 channels, one 128-byte
//     swizzle row) in one float32 accumulator: the r product runs with the
//     wgmma's A scale at -1, so no operand is negated in memory.  Warpgroup
//     w forms the 64 x 64 block of D for j columns 64w..64w+63 (32
//     accumulators a thread).
//   * Its sign, -1, 0 or +1 (exact in bf16), goes from the accumulators
//     into a 64 x 128 bf16 S tile in shared memory (16 KB, the swizzled
//     K-major layout of a wgmma A operand), and both warpgroups multiply S
//     by v_j into their output accumulators: S is the A operand, v_j's
//     64-column chunks the MN-major B operand (a j row of the tile is one
//     128-byte swizzle row, as in the products that formed D).
//   * Shared memory cannot hold the i panel (64 x 1280 bf16 of v and r,
//     160 KB) beside a ring deep enough to hide the L2 stream, nor v_j
//     whole (128 x 640) until the sign is known, so both stream through a
//     ring of STAGES = 4 slots of 48 KB, AHEAD = 3 steps ahead: a D step
//     holds one channel chunk of v_j, r_j (128 rows each), v_i, r_i (64
//     rows); an apply step the two warpgroups' 64-column chunks of v_j.
//     Each step's products are waited for before the barrier that hands
//     its slot back; the refill goes out while the tensor cores work.
//     (3 stages, or one wgmma group left running across a step's end with
//     2 steps ahead, measured slower: PERF.md.)
//   * The output is written once per block, straight from the
//     accumulators (float2 stores, 32-byte sectors whole).
//
// Edges: any hw; ragged rows and channels are zero-filled by cp.async, so
// a row past hw gives D = 0 and sign 0 and adds nothing.  c % 8 == 0 and
// v, r 16-byte aligned (a 16-byte chunk is then wholly inside or outside
// a row); stores are masked.
#include "mma_util.cuh"
#include "wgmma_util.cuh"

namespace {

using fresco::cp_async16;
using fresco::cp_async_commit;
using fresco::cp_async_wait;
using fresco::fence_proxy_async;
using fresco::pack_bf16x2;
using fresco::wgmma_commit;
using fresco::wgmma_desc_sw128;
using fresco::wgmma_fence;
using fresco::wgmma_reg_fence;
using fresco::wgmma_wait;

constexpr int BM = 64, BN = 128, BK = 64;
constexpr int THREADS = 256;                 // two warpgroups
constexpr int WG_COLS = 320;                 // output columns a warpgroup
constexpr int BLOCK_COLS = 2 * WG_COLS;
constexpr int NA = WG_COLS / BK;             // 64-column output chunks a warpgroup
constexpr int STAGES = 4, AHEAD = STAGES - 1;
constexpr int J_BYTES = BN * BK * 2, I_BYTES = BM * BK * 2;
constexpr int STAGE_BYTES = 2 * J_BYTES + 2 * I_BYTES;
constexpr int S_BYTES = BM * BN * 2;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + S_BYTES + 1024;  // + 1 KB to align the atoms
static_assert(BN == 2 * 64 && BM == 64 && BK == 64, "a warpgroup forms 64 j columns of D; 128-byte rows");
static_assert(SMEM_BYTES <= 232448, "a block's shared memory");

struct Params {
  const __nv_bfloat16* v;  // [B, hw, ch]
  const __nv_bfloat16* r;  // [B, hw, ch]
  float* out;              // [B, hw, ch]
  int hw, ch, tiles_m, n_cb;
};

// m64n64k16, both operands from shared memory: d (+)= SCALE_A * A x B; B
// transposed (MN-major) when TNSP_B
template <int SCALE_A, int TNSP_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, %35, 1, 0, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(SCALE_A), "n"(TNSP_B));
}

// ROWS rows of `src` (row stride ch; n_rows of them inside the matrix),
// channels k0..k0+63, into a swizzled tile: a row is one 128-byte swizzle
// row, chunk k of row r at chunk k ^ (r % 8)
template <int ROWS>
__device__ __forceinline__ void load_chunk(unsigned char* tile, const __nv_bfloat16* src, int n_rows, int k0, int ch) {
  static_assert(ROWS * 8 % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int j = 0; j < ROWS * 8 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int row = i / 8, kc = i % 8;
    const int gk = k0 + kc * 8;
    const bool in = row < n_rows && gk < ch;
    cp_async16<false>(tile + row * 128 + ((kc ^ (row & 7)) << 4), in ? src + (long long)row * ch + gk : src, in);
  }
}

__device__ __forceinline__ float sign_of(float d) { return static_cast<float>((d > 0.f) - (d < 0.f)); }

__global__ void __launch_bounds__(THREADS, 1) factored_sign_gram_kernel(Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzle atoms need 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) % 1024) % 1024);
  unsigned char* s_tile = smem + STAGES * STAGE_BYTES;
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t s_addr = smem_addr + STAGES * STAGE_BYTES;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  const int pm = blockIdx.x % p.tiles_m, cb = (blockIdx.x / p.tiles_m) % p.n_cb;
  const long long b = blockIdx.x / p.tiles_m / p.n_cb;
  const int m0 = pm * BM, c0 = cb * BLOCK_COLS;
  const __nv_bfloat16* V = p.v + b * p.hw * p.ch;
  const __nv_bfloat16* R = p.r + b * p.hw * p.ch;
  const int nkc = (p.ch + BK - 1) / BK;                             // D steps a tile
  const int na = min(NA, (p.ch - c0 + BK - 1) / BK);                 // apply steps a tile
  const int spt = nkc + na, tiles_j = (p.hw + BN - 1) / BN;
  const int steps = tiles_j * spt;

  // the loader's position: j tile lt, step lk of it
  int lt = 0, lk = 0;
  auto load_step = [&](int slot) {
    unsigned char* st = smem + slot * STAGE_BYTES;
    const int j0 = lt * BN;
    const __nv_bfloat16* vj = V + (long long)j0 * p.ch;
    if (lk < nkc) {
      const __nv_bfloat16* rj = R + (long long)j0 * p.ch;
      load_chunk<BN>(st, vj, p.hw - j0, lk * BK, p.ch);
      load_chunk<BN>(st + J_BYTES, rj, p.hw - j0, lk * BK, p.ch);
      load_chunk<BM>(st + 2 * J_BYTES, V + (long long)m0 * p.ch, p.hw - m0, lk * BK, p.ch);
      load_chunk<BM>(st + 2 * J_BYTES + I_BYTES, R + (long long)m0 * p.ch, p.hw - m0, lk * BK, p.ch);
    } else {
      const int a = lk - nkc;
      load_chunk<BN>(st, vj, p.hw - j0, c0 + a * BK, p.ch);
      load_chunk<BN>(st + J_BYTES, vj, p.hw - j0, c0 + WG_COLS + a * BK, p.ch);
    }
    if (++lk == spt) lk = 0, ++lt;
  };

  float acc[32];      // this warpgroup's 64 x 64 block of D
  float out[NA][32];  // this warpgroup's 64 x 320 output panel
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) out[a][i] = 0.f;

#pragma unroll
  for (int s = 0; s < AHEAD; ++s) {
    if (s < steps) load_step(s);
    cp_async_commit();
  }
  int q = 0;  // the step being multiplied
  // a step: its slot has landed (this thread's copies, then every thread's
  // through the barrier, by which both warpgroups have also retired step
  // q - 1); the products; the refill of step q - 1's slot; the wait
  auto begin_step = [&]() -> uint32_t {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    wgmma_fence();
    return smem_addr + (q % STAGES) * STAGE_BYTES;
  };
  auto end_step = [&]() {
    wgmma_commit();
    if (q + AHEAD < steps) load_step((q + AHEAD) % STAGES);
    cp_async_commit();  // an empty group keeps the count in step
    wgmma_wait<0>();
    ++q;
  };

  for (int jt = 0; jt < tiles_j; ++jt) {
    for (int kc = 0; kc < nkc; ++kc) {
      const uint32_t st = begin_step();
      const uint32_t vj = st + wg * 64 * 128, rj = vj + J_BYTES;
      const uint32_t vi = st + 2 * J_BYTES, ri = vi + I_BYTES;
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        wgmma_n64<1, 0>(acc, wgmma_desc_sw128(vi + ks * 32, 16, 1024), wgmma_desc_sw128(vj + ks * 32, 16, 1024),
                        (kc | ks) != 0);
        wgmma_n64<-1, 0>(acc, wgmma_desc_sw128(ri + ks * 32, 16, 1024), wgmma_desc_sw128(rj + ks * 32, 16, 1024),
                         1);
      }
      end_step();
    }
    // S = sign(D) into the warpgroup's 64-column block of the S tile
    wgmma_reg_fence(acc);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + g + 8 * h;
        *reinterpret_cast<uint32_t*>(s_tile + wg * (BM * 128) + row * 128 + ((jj ^ (row & 7)) << 4) + 4 * t) =
            pack_bf16x2(sign_of(acc[4 * jj + 2 * h]), sign_of(acc[4 * jj + 2 * h + 1]));
      }
    }
    // out += S v_j, one 64-column chunk of each warpgroup's panel a step
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      if (a >= na) break;
      const uint32_t bj = begin_step() + wg * J_BYTES;
#pragma unroll
      for (int ks = 0; ks < BN / 16; ++ks)
        wgmma_n64<1, 1>(out[a], wgmma_desc_sw128(s_addr + (ks / 4) * (BM * 128) + (ks % 4) * 32, 16, 1024),
                        wgmma_desc_sw128(bj + ks * 2048, J_BYTES, 1024), 1);
      end_step();
    }
  }
  cp_async_wait<0>();

  // the panel out, straight from the accumulators
  float* O = p.out + b * p.hw * p.ch;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    if (a >= na) break;
    wgmma_reg_fence(out[a]);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = c0 + wg * WG_COLS + a * BK + 8 * jj + 2 * t;
      if (col >= p.ch) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp * 16 + g + 8 * h;
        if (row < p.hw)
          *reinterpret_cast<float2*>(O + (long long)row * p.ch + col) =
              make_float2(out[a][4 * jj + 2 * h], out[a][4 * jj + 2 * h + 1]);
      }
    }
  }
}

}  // namespace

// out [B, hw, ch] f32 = sign(v v^T - r r^T) v for v, r [B, hw, ch] bf16,
// contiguous, 16-byte aligned, ch % 8 == 0; out 8-byte aligned.  Returns a
// cudaError_t.
extern "C" int fresco_factored_sign_gram(const void* v, const void* r, void* out, int B, int hw, int ch,
                                         void* stream) {
  if (B == 0 || hw == 0) return 0;
  if (ch <= 0 || ch % 8 != 0 || reinterpret_cast<uintptr_t>(v) % 16 != 0 || reinterpret_cast<uintptr_t>(r) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.r = static_cast<const __nv_bfloat16*>(r);
  p.out = static_cast<float*>(out);
  p.hw = hw;
  p.ch = ch;
  p.tiles_m = (hw + BM - 1) / BM;
  p.n_cb = (ch + BLOCK_COLS - 1) / BLOCK_COLS;
  const long long blocks = (long long)p.tiles_m * p.n_cb * B;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(factored_sign_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  factored_sign_gram_kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
