// Fused from-image PatchMatch candidate evaluation: one launch runs one
// PatchMatch iteration of fresco_tpu/propagate/patchmatch.py
// (`eval_cand` + `consider`, :287-307 and :367-374; the jump-flood and
// random-search candidate sets of `pm_iter`, :401-425).
//
// Replaces the Pallas probe `_strip_kernel` of scripts/bench_fused_eval.py
// (:94, call :149), which DMAs for each candidate pixel the source strip
// that covers its patch and reduces it.  The probe asked whether candidate
// evaluation could read patches straight from the source image instead
// of from the pre-stacked [sh·sw, 25·C] table; this kernel is that
// evaluation: gather from the image, SSD, argmin, in one kernel.
//
// For every active pixel p = (y, x) of the target grid, with the current
// match (by, bx) = nnf_in[p] and error be = e_in[p] (or, when e_in is
// null, the current match clamped and evaluated), candidates are taken in
// the JAX order and kept only when strictly better (e < be):
//   1. for each d in shifts, for (dy, dx) in (d,0), (-d,0), (0,d), (0,-d):
//      n = nnf_in[clamp(y+dy), clamp(x+dx)], candidate n - (dy, dx);
//   2. for each random delta j: candidate (by, bx) + deltas[j, y, x],
//      relative to the best so far.
// Candidate centres are clamped to [r, sh-1-r] x [r, sw-1-r].  The error
// of centre (cy, cx) is, over the patch offsets o and channels c,
//   e = sum w_c · d², d = src[(cy,cx)+o, c] - tgt[clamp(p+o), c]
// in float32 on the bf16 operands, plus the bf16 omega (uniformity) term
// at (cy, cx).  The JAX code writes the difference in bf16, but XLA forms
// it in float32 without rounding it back (measured on the CPU: rounding
// it moves the error by up to 3.5e-4 relative), and this follows what the
// reference computes.
// Inactive pixels, and pixels of tiles not listed, are not written: the
// caller passes outputs that already hold their values.
//
// Bound: on the H100 at 512x640, C = 15 and 15-20 candidates, the work is
// ~4·25·15 = 1,500 float32 operations per candidate and pixel on the CUDA
// cores (67 TFLOP/s) against ~11 MB of unique bytes (the source and target
// images, the NNF, the deltas); operations bound it by far.
//
// Design (simple first): one block per 16x16 target tile holds the tile
// plus its patch halo of the target image in shared memory (20·20·16·2 B
// = 12.8 KB at C padded to 16, patch 5); each thread evaluates one pixel's
// candidates, reading each source patch row (5 pixels x 32 bytes,
// contiguous) as 16-byte __ldg vectors, served from L2 (the source image
// is ~10 MB).  Channels are padded to CP = 16 or 32 with zero weight, so
// every pixel is whole 16-byte vectors.  A tile list skips tiles with no
// active pixel (freeze compaction); a per-pixel mask idles the rest.  The
// candidate loops are not unrolled, so the one inlined patch sum per loop
// body keeps the kernel at ~44 registers with no spills.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kMaxShifts = 8;

struct Shifts {
  int n;
  int d[kMaxShifts];
};

struct Args {
  const uint4* src;  // [sh, sw, CP] bf16
  const uint4* tgt;  // [th, tw, CP] bf16
  const float* weights;  // [CP]
  const __nv_bfloat16* omega;  // [sh, sw] or null
  const int2* nnf_in;  // [th, tw]
  const float* e_in;   // [th, tw] or null
  int2* nnf_out;
  float* e_out;
  const int2* deltas;  // [n_rand, th, tw] or null
  const int32_t* tiles;  // [n_tiles] or null (every tile)
  const uint8_t* mask;   // [th, tw] or null (every pixel)
  int sh, sw, th, tw, n_rand;
};

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ float sq_pair(uint32_t s, uint32_t t, float w0, float w1, float e) {
  const float d0 = bf_lo(s) - bf_lo(t);
  const float d1 = bf_hi(s) - bf_hi(t);
  e += w0 * (d0 * d0);
  e += w1 * (d1 * d1);
  return e;
}

template <int CP, int PATCH>
__device__ __forceinline__ float patch_error(const Args& a, const uint4* __restrict__ tile_tgt,
                                             const float (&w)[CP], int ty, int tx, int cy, int cx) {
  constexpr int R = PATCH / 2;
  constexpr int V = CP / 8;  // 16-byte vectors per pixel
  constexpr int HALO = kTile + 2 * R;
  float e = 0.f;
#pragma unroll
  for (int dy = 0; dy < PATCH; ++dy) {
    const uint4* srow = a.src + ((long long)(cy - R + dy) * a.sw + (cx - R)) * V;
    const uint4* trow = tile_tgt + ((ty + dy) * HALO + tx) * V;
#pragma unroll
    for (int k = 0; k < PATCH * V; ++k) {
      const uint4 s = __ldg(srow + k);
      const uint4 t = trow[k];
      const int c = (k % V) * 8;
      e = sq_pair(s.x, t.x, w[c + 0], w[c + 1], e);
      e = sq_pair(s.y, t.y, w[c + 2], w[c + 3], e);
      e = sq_pair(s.z, t.z, w[c + 4], w[c + 5], e);
      e = sq_pair(s.w, t.w, w[c + 6], w[c + 7], e);
    }
  }
  if (a.omega) e += __bfloat162float(a.omega[(long long)cy * a.sw + cx]);
  return e;
}

template <int CP, int PATCH>
__global__ void __launch_bounds__(kTile * kTile) patch_eval_kernel(Args a, Shifts shifts) {
  constexpr int R = PATCH / 2;
  constexpr int V = CP / 8;
  constexpr int HALO = kTile + 2 * R;
  extern __shared__ uint4 tile_tgt[];  // [HALO, HALO, V]

  const int tiles_x = (a.tw + kTile - 1) / kTile;
  const int tile = a.tiles ? a.tiles[blockIdx.x] : (int)blockIdx.x;
  const int y0 = (tile / tiles_x) * kTile, x0 = (tile % tiles_x) * kTile;

  // target tile + halo, edge-clamped (the JAX target patches pad by edge)
  for (int i = threadIdx.x; i < HALO * HALO * V; i += blockDim.x) {
    const int px = i / V, v = i % V;
    const int gy = min(max(y0 - R + px / HALO, 0), a.th - 1);
    const int gx = min(max(x0 - R + px % HALO, 0), a.tw - 1);
    tile_tgt[i] = __ldg(a.tgt + ((long long)gy * a.tw + gx) * V + v);
  }
  __syncthreads();

  const int ty = threadIdx.x / kTile, tx = threadIdx.x % kTile;
  const int y = y0 + ty, x = x0 + tx;
  if (y >= a.th || x >= a.tw) return;
  const long long p = (long long)y * a.tw + x;
  if (a.mask && !a.mask[p]) return;

  float w[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) w[c] = __ldg(a.weights + c);
  const int lo_y = R, hi_y = a.sh - 1 - R, lo_x = R, hi_x = a.sw - 1 - R;

  int2 cur = a.nnf_in[p];
  int by, bx;
  float be;
  if (a.e_in) {
    by = cur.x;
    bx = cur.y;
    be = a.e_in[p];
  } else {
    by = min(max(cur.x, lo_y), hi_y);
    bx = min(max(cur.y, lo_x), hi_x);
    be = patch_error<CP, PATCH>(a, tile_tgt, w, ty, tx, by, bx);
  }

  for (int s = 0; s < shifts.n; ++s) {
    const int d = shifts.d[s];
    // not unrolled: four inlined patch sums spill 1.7 KB a thread
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const int dy = k == 0 ? d : (k == 1 ? -d : 0);
      const int dx = k == 2 ? d : (k == 3 ? -d : 0);
      const int qy = min(max(y + dy, 0), a.th - 1), qx = min(max(x + dx, 0), a.tw - 1);
      const int2 n = a.nnf_in[(long long)qy * a.tw + qx];
      const int cy = min(max(n.x - dy, lo_y), hi_y);
      const int cx = min(max(n.y - dx, lo_x), hi_x);
      const float e = patch_error<CP, PATCH>(a, tile_tgt, w, ty, tx, cy, cx);
      if (e < be) {
        by = cy;
        bx = cx;
        be = e;
      }
    }
  }
  const long long plane = (long long)a.th * a.tw;
  for (int j = 0; j < a.n_rand; ++j) {
    const int2 dl = a.deltas[j * plane + p];
    const int cy = min(max(by + dl.x, lo_y), hi_y);
    const int cx = min(max(bx + dl.y, lo_x), hi_x);
    const float e = patch_error<CP, PATCH>(a, tile_tgt, w, ty, tx, cy, cx);
    if (e < be) {
      by = cy;
      bx = cx;
      be = e;
    }
  }
  a.nnf_out[p] = make_int2(by, bx);
  a.e_out[p] = be;
}

template <int CP, int PATCH>
cudaError_t launch(const Args& a, const Shifts& s, int n_blocks, cudaStream_t stream) {
  constexpr int HALO = kTile + 2 * (PATCH / 2);
  const size_t smem = (size_t)HALO * HALO * (CP / 8) * sizeof(uint4);
  patch_eval_kernel<CP, PATCH><<<n_blocks, kTile * kTile, smem, stream>>>(a, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fresco_patch_eval(const void* src, const void* tgt, const void* weights,
                                 const void* omega, const void* nnf_in, const void* e_in,
                                 void* nnf_out, void* e_out, const void* deltas, const void* tiles,
                                 const void* mask, int sh, int sw, int th, int tw, int cp, int patch,
                                 int n_shift, const int* shift_values, int n_rand, int n_tiles,
                                 void* stream) {
  if (n_shift < 0 || n_shift > kMaxShifts || n_rand < 0) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const uint4*>(src), static_cast<const uint4*>(tgt),
         static_cast<const float*>(weights), static_cast<const __nv_bfloat16*>(omega),
         static_cast<const int2*>(nnf_in), static_cast<const float*>(e_in),
         static_cast<int2*>(nnf_out), static_cast<float*>(e_out), static_cast<const int2*>(deltas),
         static_cast<const int32_t*>(tiles), static_cast<const uint8_t*>(mask),
         sh, sw, th, tw, n_rand};
  Shifts s{n_shift, {}};
  for (int i = 0; i < n_shift; ++i) s.d[i] = shift_values[i];
  const int n_blocks = tiles ? n_tiles : ((th + kTile - 1) / kTile) * ((tw + kTile - 1) / kTile);
  if (n_blocks <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (cp == 16 && patch == 5) return launch<16, 5>(a, s, n_blocks, st);
  if (cp == 16 && patch == 3) return launch<16, 3>(a, s, n_blocks, st);
  if (cp == 32 && patch == 5) return launch<32, 5>(a, s, n_blocks, st);
  if (cp == 32 && patch == 3) return launch<32, 3>(a, s, n_blocks, st);
  return (int)cudaErrorInvalidValue;
}
