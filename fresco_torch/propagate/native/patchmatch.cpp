// Native CPU patch-synthesis backend (exact-parity mode), fresco_torch's
// copy of fresco_tpu/propagate/native/patchmatch.cpp: the algorithm below
// is unchanged, so both packages give the same level bit for bit.
//
// The device path (fresco_torch/propagate/patchmatch.py) re-formulates
// PatchMatch propagation as data-parallel jump-flooding.  This backend
// provides the classic *serpentine* propagation + exponentially decaying
// random search + uniformity (omega) penalty of the reference's native
// engine (reference src/ebsynth/deps/ebsynth/src/ebsynth_cpu.cpp
// patchmatch :530-662, tryPatch :511-528, omega :470-508, vote :95-136);
// coarse-to-fine driving stays in Python (patchmatch._synthesize_native).
//
// Layout: all images are float32 row-major [H, W, C].  The NNF is
// int32 [H, W, 2] storing (y, x) source patch centers.
//
// Build (fresco_torch/propagate/native/binding.py, into fresco_torch/_build):
//   g++ -O3 -march=native -fopenmp -shared -fPIC -std=c++17
// Exposed C API (ctypes): pm_synthesize_level(...).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Size { int h, w; };

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Weighted SSD between the source patch at (sy,sx) and target patch at
// (ty,tx) over `cs` style channels (styleT = current voted target style)
// and `cg` guide channels, with early-out once `best` is exceeded.
float patch_ssd(const float* styleS, const float* styleT,
                const float* guideS, const float* guideT,
                const float* wS, const float* wG,
                Size src, Size tgt, int cs, int cg, int r,
                int sy, int sx, int ty, int tx, float best) {
  float acc = 0.f;
  for (int dy = -r; dy <= r; ++dy) {
    for (int dx = -r; dx <= r; ++dx) {
      const int syy = clampi(sy + dy, 0, src.h - 1);
      const int sxx = clampi(sx + dx, 0, src.w - 1);
      const int tyy = clampi(ty + dy, 0, tgt.h - 1);
      const int txx = clampi(tx + dx, 0, tgt.w - 1);
      const float* ss = styleS + (syy * src.w + sxx) * cs;
      const float* st = styleT + (tyy * tgt.w + txx) * cs;
      for (int c = 0; c < cs; ++c) {
        const float d = ss[c] - st[c];
        acc += wS[c] * d * d;
      }
      const float* gs = guideS + (syy * src.w + sxx) * cg;
      const float* gt = guideT + (tyy * tgt.w + txx) * cg;
      for (int c = 0; c < cg; ++c) {
        const float d = gs[c] - gt[c];
        acc += wG[c] * d * d;
      }
    }
    if (acc > best) return acc;  // early-out (ebsynth PatchSSD early-out)
  }
  return acc;
}

// omega: per-source-pixel usage count spread over patch footprints.
void compute_omega(const int32_t* nnf, Size src, Size tgt, int r,
                   std::vector<float>* omega) {
  std::fill(omega->begin(), omega->end(), 0.f);
  std::vector<float> counts(src.h * src.w, 0.f);
  for (int y = 0; y < tgt.h; ++y)
    for (int x = 0; x < tgt.w; ++x) {
      const int sy = nnf[(y * tgt.w + x) * 2 + 0];
      const int sx = nnf[(y * tgt.w + x) * 2 + 1];
      counts[clampi(sy, 0, src.h - 1) * src.w + clampi(sx, 0, src.w - 1)] += 1.f;
    }
  // box-spread (separable)
  std::vector<float> tmp(src.h * src.w, 0.f);
  for (int y = 0; y < src.h; ++y)
    for (int x = 0; x < src.w; ++x) {
      float s = 0.f;
      for (int d = -r; d <= r; ++d) s += counts[y * src.w + clampi(x + d, 0, src.w - 1)];
      tmp[y * src.w + x] = s;
    }
  for (int y = 0; y < src.h; ++y)
    for (int x = 0; x < src.w; ++x) {
      float s = 0.f;
      for (int d = -r; d <= r; ++d) s += tmp[clampi(y + d, 0, src.h - 1) * src.w + x];
      (*omega)[y * src.w + x] = s;
    }
}

}  // namespace

extern "C" {

// Run sv_iters x (pm_iters serpentine passes + vote) at one pyramid level.
// styleS [sh,sw,cs], guideS [sh,sw,cg], guideT [th,tw,cg],
// nnf in/out [th,tw,2], out_style [th,tw,cs], out_error [th,tw].
void pm_synthesize_level(const float* styleS, const float* guideS,
                         const float* guideT, const float* wS, const float* wG,
                         int sh, int sw, int th, int tw, int cs, int cg,
                         int patch, int pm_iters, int sv_iters,
                         float uniformity, uint64_t seed,
                         int32_t* nnf, float* out_style, float* out_error) {
  const Size src{sh, sw}, tgt{th, tw};
  const int r = patch / 2;
  const float omega_best =
      float(th) * float(tw) / (float(sh) * float(sw)) * float(patch * patch);

  std::vector<float> styleT(th * tw * cs, 0.f);
  std::vector<float> err(th * tw, 0.f);
  std::vector<float> omega(sh * sw, 0.f);

  auto vote = [&]() {
    std::memset(styleT.data(), 0, styleT.size() * sizeof(float));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int y = 0; y < th; ++y) {
      for (int x = 0; x < tw; ++x) {
        float* acc = &styleT[(y * tw + x) * cs];
        for (int dy = -r; dy <= r; ++dy)
          for (int dx = -r; dx <= r; ++dx) {
            const int ny = clampi(y + dy, 0, th - 1);
            const int nx = clampi(x + dx, 0, tw - 1);
            const int sy = clampi(nnf[(ny * tw + nx) * 2 + 0] - dy, 0, sh - 1);
            const int sx = clampi(nnf[(ny * tw + nx) * 2 + 1] - dx, 0, sw - 1);
            const float* sp = styleS + (sy * sw + sx) * cs;
            for (int c = 0; c < cs; ++c) acc[c] += sp[c];
          }
        const float inv = 1.f / float(patch * patch);
        for (int c = 0; c < cs; ++c) acc[c] *= inv;
      }
    }
  };

  auto eval_at = [&](int ty, int tx, int sy, int sx, float best) -> float {
    float e = patch_ssd(styleS, styleT.data(), guideS, guideT, wS, wG, src,
                        tgt, cs, cg, r, sy, sx, ty, tx, best);
    if (uniformity > 0.f) {
      e += uniformity *
           omega[clampi(sy, 0, sh - 1) * sw + clampi(sx, 0, sw - 1)] /
           omega_best;
    }
    return e;
  };

  std::mt19937_64 rng(seed);
  vote();

  for (int sv = 0; sv < sv_iters; ++sv) {
    if (uniformity > 0.f) compute_omega(nnf, src, tgt, r, &omega);

    // initial errors for this search phase
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int i = 0; i < th * tw; ++i) {
      const int y = i / tw, x = i % tw;
      err[i] = eval_at(y, x, nnf[i * 2], nnf[i * 2 + 1], 1e30f);
    }

    for (int pm = 0; pm < pm_iters; ++pm) {
      const bool rev = (pm % 2) == 1;  // serpentine direction
      const int y0 = rev ? th - 1 : 0, y1 = rev ? -1 : th, ys = rev ? -1 : 1;
      // NOTE: rows are processed sequentially (true serpentine); columns
      // within a row too.  This is the exact-parity mode — slow but
      // faithful to the reference's propagation order.
      for (int y = y0; y != y1; y += ys) {
        for (int xi = 0; xi < tw; ++xi) {
          const int x = rev ? tw - 1 - xi : xi;
          const int i = y * tw + x;
          int by = nnf[i * 2], bx = nnf[i * 2 + 1];
          float be = err[i];
          // propagate from the two already-visited neighbors
          const int ny[2] = {y - ys, y};
          const int nx[2] = {x, rev ? x + 1 : x - 1};
          for (int n = 0; n < 2; ++n) {
            if (ny[n] < 0 || ny[n] >= th || nx[n] < 0 || nx[n] >= tw) continue;
            const int j = ny[n] * tw + nx[n];
            const int cy = clampi(nnf[j * 2 + 0] + (y - ny[n]), r, sh - 1 - r);
            const int cx = clampi(nnf[j * 2 + 1] + (x - nx[n]), r, sw - 1 - r);
            const float e = eval_at(y, x, cy, cx, be);
            if (e < be) { be = e; by = cy; bx = cx; }
          }
          // random search
          int rad = std::max(sh, sw);
          while (rad >= 1) {
            const int cy =
                clampi(by + int(rng() % (2 * rad + 1)) - rad, r, sh - 1 - r);
            const int cx =
                clampi(bx + int(rng() % (2 * rad + 1)) - rad, r, sw - 1 - r);
            const float e = eval_at(y, x, cy, cx, be);
            if (e < be) { be = e; by = cy; bx = cx; }
            rad /= 2;
          }
          nnf[i * 2] = by; nnf[i * 2 + 1] = bx; err[i] = be;
        }
      }
    }
    vote();
  }

  std::memcpy(out_style, styleT.data(), styleT.size() * sizeof(float));
  std::memcpy(out_error, err.data(), err.size() * sizeof(float));
}

}  // extern "C"
