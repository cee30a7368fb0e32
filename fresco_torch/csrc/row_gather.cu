// Row gather out[k, :] = table[idx[k], :] for the PatchMatch vote.
//
// Replaces the Pallas row-DMA gathers of scripts/bench_pallas_gather.py:
// `_flat_kernel` (:31, one DMA per row) and `_group_kernel` (:82, 8-row
// group DMA plus an in-kernel row select) — both compute this function;
// on the TPU they probed the per-row cost of `jnp.take` on the patch
// table (fresco_tpu/propagate/patchmatch.py:317-328).
//
// Bound: bytes, no arithmetic.  A random row of row_bytes touches the
// 32-byte sectors from its first byte to its last: a 300-byte row (float32
// W = 75, the vote's finest table) starting on a multiple of 4 touches
// 10.25 sectors on average, 328 bytes.  So the least traffic is those
// sectors plus the row written and the 4-byte index, K·(328 + 300 + 4)
// bytes over 3.35 TB/s.
//
// Latency is what keeps a gather under that rate: a row's loads cannot
// start before its index has arrived, and filling 3.35 TB/s at ~600 ns of
// latency takes ~15 KB in flight a SM.  One warp a row with one load a lane
// in flight before its store keeps about half that.
//
// Design: a warp takes kRows rows.  Lanes 0..kRows-1 read the rows'
// indices in one coalesced load and hand them out with __shfl_sync; then
// every lane issues all of its loads for those rows into registers before
// its first store.  The rows are cut into units of the widest size (16,
// 8, 4, 2 or 1 bytes) that divides row_bytes and the alignment of both
// base pointers, and the warp's kRows·units units are dealt to the lanes in
// order, so a warp instruction reads consecutive units of one or two rows.
// The widths of the vote's finest table and of the TPU probe are template
// arguments, so the count of loads a lane holds is known at compile time
// and the loop is unrolled (float32 W = 75: 19 four-byte loads a lane,
// 2,400 bytes a warp in flight; bf16 W = 384: 12 sixteen-byte loads);
// other widths take a run-time loop of kBatch loads, then kBatch stores.
// The table is read through the non-coherent path into L1 (a 300-byte row
// shares its first and last sectors with the warp instructions beside it;
// L1::no_allocate measured 7-11 % slower) and the output written with
// st.global.cs (1-2 % faster than a default store).  An index outside
// [0, n_rows) gives a row of zeros instead of a fault.  No shared memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;   // rows a warp
constexpr int kWarps = 8;  // warps a block
constexpr int kBatch = 8;  // loads a lane holds before it stores (run-time widths)
constexpr unsigned kFull = 0xffffffffu;

// the table through the non-coherent path (volatile: the compiler must not
// speculate a load whose index is out of range)
__device__ __forceinline__ uint4 ld_table(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ uint2 ld_table(const uint2* p) {
  uint2 v;
  asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_table(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint16_t ld_table(const uint16_t* p) { return __ldg(p); }
__device__ __forceinline__ uint8_t ld_table(const uint8_t* p) { return __ldg(p); }

// the output with the streaming hint (evict first): 98 MB at the vote's
// finest level does not stay in the 50 MB L2 for the shifted adds anyway
template <typename T>
__device__ __forceinline__ void st_out(T* p, const T& v) { __stcs(p, v); }

// NU > 0: units a row, fixed at compile time (unrolled); NU == 0: `units`
// at run time
template <typename T, int NU>
__global__ void __launch_bounds__(kWarps * 32)
    row_gather_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx, T* __restrict__ out,
                      long long n_rows, long long k, long long units_rt) {
  const long long r0 = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kRows;
  if (r0 >= k) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int nr = (int)min((long long)kRows, k - r0);
  // the warp's indices, one a lane; -1: outside [0, n_rows), a zero row
  int my = -1;
  if (lane < nr) {
    const int32_t i = __ldg(idx + r0 + lane);
    if (i >= 0 && (long long)i < n_rows) my = i;
  }
  if constexpr (NU > 0) {
    constexpr int L = (kRows * NU + 31) / 32;
    T v[L];
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int u = lane + 32 * i;  // unit of the warp's rows
      const int r = u / NU, c = u - r * NU;
      const int s = __shfl_sync(kFull, my, r & (kRows - 1));
      v[i] = (r < nr && s >= 0) ? ld_table(table + (long long)s * NU + c) : T{};
    }
    T* dst = out + r0 * NU;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      const int u = lane + 32 * i;
      if (u < nr * NU) st_out(dst + u, v[i]);
    }
  } else {
    const long long units = units_rt, total = nr * units;
    T* dst = out + r0 * units;
    for (long long base = 0; base < total; base += 32 * kBatch) {  // the same trip count in every lane
      T v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const long long u = base + lane + 32 * i;
        const long long r = min(u / units, (long long)kRows - 1);
        const int s = __shfl_sync(kFull, my, (int)r);
        v[i] = (u < total && s >= 0) ? ld_table(table + (long long)s * units + (u - r * units)) : T{};
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const long long u = base + lane + 32 * i;
        if (u < total) st_out(dst + u, v[i]);
      }
    }
  }
}

template <typename T, int NU>
cudaError_t launch(const void* table, const int32_t* idx, void* out, long long n_rows, long long k,
                   long long row_bytes, cudaStream_t stream) {
  constexpr long long per_block = (long long)kRows * kWarps;
  const long long blocks = (k + per_block - 1) / per_block;
  row_gather_kernel<T, NU><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), n_rows, k, row_bytes / (long long)sizeof(T));
  return cudaGetLastError();
}

}  // namespace

extern "C" int fresco_row_gather(const void* table, const void* idx, void* out, long long n_rows,
                                 long long k, long long row_bytes, void* stream) {
  if (k <= 0 || row_bytes <= 0) return 0;
  if ((k + kRows * kWarps - 1) / (kRows * kWarps) > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto* ix = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out | (uintptr_t)row_bytes;
  if (align % 16 == 0) {
    if (row_bytes == 768) return launch<uint4, 48>(table, ix, out, n_rows, k, row_bytes, s);  // bf16 W = 384
    return launch<uint4, 0>(table, ix, out, n_rows, k, row_bytes, s);
  }
  if (align % 8 == 0) return launch<uint2, 0>(table, ix, out, n_rows, k, row_bytes, s);
  if (align % 4 == 0) {
    if (row_bytes == 300) return launch<uint32_t, 75>(table, ix, out, n_rows, k, row_bytes, s);  // f32 W = 75
    return launch<uint32_t, 0>(table, ix, out, n_rows, k, row_bytes, s);
  }
  if (align % 2 == 0) return launch<uint16_t, 0>(table, ix, out, n_rows, k, row_bytes, s);
  return launch<uint8_t, 0>(table, ix, out, n_rows, k, row_bytes, s);
}
