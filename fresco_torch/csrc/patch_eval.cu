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
// Bound: on the H100 at 512x640, C = 15 and 15 candidates, the function
// is ~4·25·15 = 1,500 float32 operations per candidate and pixel (0.110
// ms at 67 TFLOP/s) against ~11 MB of unique bytes; operations bound it.
// What bounds the kernel, measured (kernel_report.py --kernel patch_eval,
// timing-only variants; PERF.md §6 "PR 8"): the one-thread-a-pixel kernel
// this replaces spent ~80 % of its 0.74 ms on source loads at addresses
// random to its warp (50 16-byte loads a candidate, up to 32 lines each;
// 0.145 ms with every patch read from fixed rows), none on arithmetic,
// and ran every candidate as one serial chain; its coarse levels launched
// 2-80 blocks and took 0.07-0.09 ms each.  This kernel takes ~0.46 ms
// there, still bound by its load path first (0.27 ms with one fixed patch
// a pixel; prefetching the next patch into L1 or L2 doubles the L1
// requests and costs 40 %), then by issue (0.34 ms without the
// arithmetic); its coarse levels take 0.008-0.013 ms.
//
// Design: kLanes = 8 lanes of a warp evaluate one pixel's candidate
// together, so a warp holds the 4 pixels of one row of a 4x4 target tile.
// Lane j owns the 16-byte vectors j, j+8, ... of the patch (row-major,
// 5 pixels x 32 bytes a row at CP = 16), so the 8 lanes of one load
// instruction read 128 contiguous bytes of one or two patch rows, and
// neighbouring pixels, whose matches agree, read overlapping lines.  As 8
// is a multiple of the vectors a pixel holds, each lane always sees the
// same 8 channels: it keeps its target vectors in registers for the whole
// call and sums d² per channel, so an element costs two unpacks, one
// subtract and one FMA, and the weights are applied once per candidate;
// the 8 lanes' sums are combined by an xor butterfly, after which every
// lane holds the same bits.  Every candidate sums in the same order, so
// candidates with identical patches tie exactly and, as in the reference,
// the earlier one is kept.  Candidates are taken one after another in the
// JAX order, the strict e < be decided identically in all 8 lanes; the
// jump-flood centres and the random deltas are read up front, lane j
// holding those of candidates j, j+8, ..., and handed round by shuffles.
// The one-candidate set (the current match's error) has a kernel of its
// own with one lane per 8 channels, which reads its target once from
// memory (fewer warps and registers: it is one short chain a pixel).  A
// block of 128 threads holds one 4x4 tile, or several for the
// one-candidate kernel, so the coarse levels spread over many SMs (20
// tiles at 16x20) and the tile list stays fine.  A warp whose pixels are
// all inactive leaves at once; otherwise inactive pixels and pixels past
// the ragged edge compute on a clamped twin (the shuffles need the whole
// warp) and write nothing.  No shared memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 4;   // target tile edge in pixels (propagate/patch_eval.py TILE)
constexpr int kThreads = 128;  // a block: one tile or more
constexpr int kLanes = 8;  // lanes evaluating one pixel's candidate
constexpr int kMinBlocks = 4;  // blocks a SM that __launch_bounds__ asks for
constexpr int kLanesOne = 2;  // the same in the one-candidate kernel (raised to one a channel group)
constexpr int kMinBlocksOne = 8;
constexpr int kMaxShifts = 8;
constexpr int kPre = (4 * kMaxShifts + kLanes - 1) / kLanes;  // jump-flood centres a lane holds
constexpr unsigned kFull = 0xffffffffu;

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
  int n_tiles;  // listed tiles, or every tile of the grid
};

__device__ __forceinline__ float bf_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// Where a lane keeps the target elements of its vectors for the call.
enum Target { kPacked = 0, kLoad = 1 };

template <int CP, int PATCH, bool ONE>
struct Layout {
  static constexpr int V = CP / 8;                 // 16-byte vectors a pixel
  static constexpr int LANES = ONE ? (kLanesOne > V ? kLanesOne : V) : kLanes;
  static constexpr int TILE_THREADS = kTile * kTile * LANES;
  static constexpr int TILES = kThreads / TILE_THREADS;  // tiles a block
  static_assert(TILES >= 1 && TILES * TILE_THREADS == kThreads && TILE_THREADS % 32 == 0,
                "a tile is whole warps and a block whole tiles");
  static constexpr int R = PATCH / 2;
  static constexpr int ROW = PATCH * V;            // vectors a patch row
  static constexpr int NVEC = PATCH * ROW;         // vectors a patch
  static constexpr int ITERS = (NVEC + LANES - 1) / LANES;  // vectors a lane
  // one candidate reads its target once, from memory; more keep it in registers
  static constexpr int TGT = ONE ? kLoad : kPacked;
  static_assert(LANES % V == 0, "a lane must keep one channel group");
};

// What a lane keeps for the whole call: its vectors' offsets from a
// patch's top-left vector, its target elements (or their offsets) and its
// 8 weights.
template <int CP, int PATCH, bool ONE>
struct LaneState {
  using L = Layout<CP, PATCH, ONE>;
  int off[L::ITERS];
  uint4 tp[L::TGT == kPacked ? L::ITERS : 1];
  int toff[L::TGT == kLoad ? L::ITERS : 1];
  float w[8];
  bool last;  // whether the lane's last vector lies inside the patch
};

// The error of centre (cy, cx) for the lane's pixel; the same bits in all
// the lanes of the pixel.  Called by the whole warp.
template <int CP, int PATCH, bool ONE>
__device__ __forceinline__ float cand_error(const Args& a, const LaneState<CP, PATCH, ONE>& ls, int cy, int cx) {
  using L = Layout<CP, PATCH, ONE>;
  const float om = a.omega ? __bfloat162float(a.omega[(long long)cy * a.sw + cx]) : 0.f;
  const uint4* base = a.src + ((long long)(cy - L::R) * a.sw + (cx - L::R)) * L::V;
  uint4 s[L::ITERS];
#pragma unroll
  for (int i = 0; i < L::ITERS; ++i)
    s[i] = (i + 1 < L::ITERS || ls.last) ? __ldg(base + ls.off[i]) : make_uint4(0u, 0u, 0u, 0u);
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.f;
#pragma unroll
  for (int i = 0; i < L::ITERS; ++i) {
    uint4 tv = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (L::TGT == kPacked) tv = ls.tp[i];
    if constexpr (L::TGT == kLoad) {
      if (i + 1 < L::ITERS || ls.last) tv = __ldg(a.tgt + ls.toff[i]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t u = word(s[i], q);
      const float d0 = bf_lo(u) - bf_lo(word(tv, q)), d1 = bf_hi(u) - bf_hi(word(tv, q));
      acc[2 * q] = fmaf(d0, d0, acc[2 * q]);
      acc[2 * q + 1] = fmaf(d1, d1, acc[2 * q + 1]);
    }
  }
  float e = ((fmaf(ls.w[1], acc[1], ls.w[0] * acc[0]) + fmaf(ls.w[3], acc[3], ls.w[2] * acc[2])) +
             (fmaf(ls.w[5], acc[5], ls.w[4] * acc[4]) + fmaf(ls.w[7], acc[7], ls.w[6] * acc[6])));
  // a + b == b + a bit for bit, so every lane of the butterfly ends equal
#pragma unroll
  for (int m = 1; m < L::LANES; m <<= 1) e += __shfl_xor_sync(kFull, e, m);
  return a.omega ? e + om : e;
}

// ONE: the one-candidate set (no shifts, no deltas, no e_in): the current
// match clamped and evaluated, with the target read once from memory.
template <int CP, int PATCH, bool ONE>
__global__ void __launch_bounds__(kThreads, ONE ? kMinBlocksOne : kMinBlocks) patch_eval_kernel(Args a, Shifts shifts) {
  using L = Layout<CP, PATCH, ONE>;
  const int tiles_x = (a.tw + kTile - 1) / kTile;
  const int slot = blockIdx.x * L::TILES + threadIdx.x / L::TILE_THREADS;  // whole warps
  if (slot >= a.n_tiles) return;
  const int tile = a.tiles ? a.tiles[slot] : slot;
  const int lane = threadIdx.x % L::LANES, pix = (threadIdx.x % L::TILE_THREADS) / L::LANES;
  const int group0 = (threadIdx.x % 32) & ~(L::LANES - 1);  // the pixel's first lane in the warp
  const int y = (tile / tiles_x) * kTile + pix / kTile, x = (tile % tiles_x) * kTile + pix % kTile;
  // a pixel past the ragged edge works on its clamped twin and writes nothing
  const int yc = min(y, a.th - 1), xc = min(x, a.tw - 1);
  const long long p = (long long)yc * a.tw + xc;
  const bool active = y < a.th && x < a.tw && (!a.mask || a.mask[p]);
  if (!__any_sync(kFull, active)) return;  // the whole warp, before any shuffle

  LaneState<CP, PATCH, ONE> ls;
  ls.last = (L::ITERS - 1) * L::LANES + lane < L::NVEC;
#pragma unroll
  for (int i = 0; i < L::ITERS; ++i) {
    int dy, col;
    if constexpr (L::LANES == L::V) {  // a vector of each patch pixel: its row is known here
      dy = i / PATCH;
      col = (i % PATCH) * L::V + lane;
    } else {
      const int k = min(i * L::LANES + lane, L::NVEC - 1);
      dy = k / L::ROW;
      col = k % L::ROW;
    }
    ls.off[i] = dy * a.sw * L::V + col;
    // the target patch pads by edge
    const int gy = clampi(yc - L::R + dy, 0, a.th - 1), gx = clampi(xc - L::R + col / L::V, 0, a.tw - 1);
    const int toff = (gy * a.tw + gx) * L::V + col % L::V;
    if constexpr (L::TGT == kLoad) {
      ls.toff[i] = toff;
    } else {
      ls.tp[i] = (i + 1 < L::ITERS || ls.last) ? __ldg(a.tgt + toff) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) ls.w[c] = __ldg(a.weights + (lane % L::V) * 8 + c);

  const int lo_y = L::R, hi_y = a.sh - 1 - L::R, lo_x = L::R, hi_x = a.sw - 1 - L::R;
  const int2 cur = a.nnf_in[p];
  int by, bx;
  float be;
  if (ONE || !a.e_in) {
    by = clampi(cur.x, lo_y, hi_y);
    bx = clampi(cur.y, lo_x, hi_x);
    be = cand_error<CP, PATCH, ONE>(a, ls, by, bx);
  } else {
    by = cur.x;
    bx = cur.y;
    be = a.e_in[p];
  }
  if constexpr (!ONE) {
    // Jump-flood candidate k = 4 s + dir in the JAX order; lane j of the
    // pixel reads the neighbour matches of candidates j, j + kLanes, ...
    // up front, and each is handed round by a shuffle when its turn comes.
    const int n_shift = 4 * shifts.n;
    int2 pre[kPre];
#pragma unroll
    for (int r = 0; r < kPre; ++r) {
      const int k = r * kLanes + lane;
      pre[r] = make_int2(0, 0);
      if (k < n_shift) {
        const int d = shifts.d[k >> 2], dir = k & 3;
        const int dy = dir == 0 ? d : (dir == 1 ? -d : 0), dx = dir == 2 ? d : (dir == 3 ? -d : 0);
        const int2 n = a.nnf_in[clampi(yc + dy, 0, a.th - 1) * a.tw + clampi(xc + dx, 0, a.tw - 1)];
        pre[r] = make_int2(clampi(n.x - dy, lo_y, hi_y), clampi(n.y - dx, lo_x, hi_x));
      }
    }
    const long long plane = (long long)a.th * a.tw;
    const int2 dpre = lane < a.n_rand ? a.deltas[lane * plane + p] : make_int2(0, 0);
#pragma unroll 1
    for (int k = 0; k < n_shift; ++k) {
      int2 c = pre[0];
#pragma unroll
      for (int r = 1; r < kPre; ++r)
        if (k >= r * kLanes) c = pre[r];
      const int cy = __shfl_sync(kFull, c.x, group0 + k % kLanes);
      const int cx = __shfl_sync(kFull, c.y, group0 + k % kLanes);
      const float e = cand_error<CP, PATCH, ONE>(a, ls, cy, cx);
      if (e < be) {
        by = cy;
        bx = cx;
        be = e;
      }
    }
    // random search, relative to the best so far; lane j read delta j
    for (int j = 0; j < a.n_rand; ++j) {
      int2 dl;
      if (j < kLanes) {
        dl = make_int2(__shfl_sync(kFull, dpre.x, group0 + j), __shfl_sync(kFull, dpre.y, group0 + j));
      } else {
        dl = a.deltas[j * plane + p];
      }
      const int cy = clampi(by + dl.x, lo_y, hi_y), cx = clampi(bx + dl.y, lo_x, hi_x);
      const float e = cand_error<CP, PATCH, ONE>(a, ls, cy, cx);
      if (e < be) {
        by = cy;
        bx = cx;
        be = e;
      }
    }
  }
  if (active && lane == 0) {
    a.nnf_out[p] = make_int2(by, bx);
    a.e_out[p] = be;
  }
}

template <int CP, int PATCH, bool ONE>
void launch_kernel(const Args& a, const Shifts& s, cudaStream_t stream) {
  constexpr int per_block = Layout<CP, PATCH, ONE>::TILES;
  patch_eval_kernel<CP, PATCH, ONE><<<(a.n_tiles + per_block - 1) / per_block, kThreads, 0, stream>>>(a, s);
}

template <int CP, int PATCH>
cudaError_t launch(const Args& a, const Shifts& s, cudaStream_t stream) {
  if (s.n == 0 && a.n_rand == 0 && !a.e_in)
    launch_kernel<CP, PATCH, true>(a, s, stream);
  else
    launch_kernel<CP, PATCH, false>(a, s, stream);
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
         sh, sw, th, tw, n_rand,
         tiles ? n_tiles : ((th + kTile - 1) / kTile) * ((tw + kTile - 1) / kTile)};
  Shifts s{n_shift, {}};
  for (int i = 0; i < n_shift; ++i) s.d[i] = shift_values[i];
  if (a.n_tiles <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (cp == 16 && patch == 5) return launch<16, 5>(a, s, st);
  if (cp == 16 && patch == 3) return launch<16, 3>(a, s, st);
  if (cp == 32 && patch == 5) return launch<32, 5>(a, s, st);
  if (cp == 32 && patch == 3) return launch<32, 3>(a, s, st);
  return (int)cudaErrorInvalidValue;
}
