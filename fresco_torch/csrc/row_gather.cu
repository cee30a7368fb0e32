// Row gather out[k, :] = table[idx[k], :] for the PatchMatch vote.
//
// Replaces the Pallas row-DMA gathers of scripts/bench_pallas_gather.py:
// `_flat_kernel` (:31, one DMA per row) and `_group_kernel` (:82, 8-row
// group DMA plus an in-kernel row select) — both compute this function;
// on the TPU they probed the per-row cost of `jnp.take` on the patch
// table (fresco_tpu/propagate/patchmatch.py:317-328).
//
// Bound: bytes.  The work is K rows of row_bytes read and written plus
// the K int32 indices: (2·row_bytes + 4)·K over 3.35 TB/s.  No arithmetic.
//
// Design: one warp per output row.  The row is copied in the widest unit
// (16, 8, 4, 2 or 1 bytes) that divides row_bytes and the alignment of
// both base pointers, so every row start is aligned to the unit and a
// row of 768 bytes (bf16 W = 384) moves as 16-byte vectors, one of 300
// bytes (float32 W = 75) as 4-byte words.  Lanes read consecutive units,
// so each warp's loads coalesce within the row.  The table is read
// through the read-only path (__ldg).  An index outside [0, n_rows) gives
// a row of zeros instead of a fault.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void row_gather_kernel(const T* __restrict__ table, const int32_t* __restrict__ idx,
                                  T* __restrict__ out, long long n_rows, long long k,
                                  long long units) {
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= k) return;
  const int lane = threadIdx.x & 31;
  const long long src_row = __ldg(idx + row);
  T* dst = out + row * units;
  if (src_row < 0 || src_row >= n_rows) {
    for (long long u = lane; u < units; u += 32) dst[u] = T{};
    return;
  }
  const T* src = table + src_row * units;
  for (long long u = lane; u < units; u += 32) dst[u] = __ldg(src + u);
}

template <typename T>
cudaError_t launch(const void* table, const int32_t* idx, void* out, long long n_rows,
                   long long k, long long row_bytes, cudaStream_t stream) {
  const long long blocks = (k + kWarpsPerBlock - 1) / kWarpsPerBlock;
  row_gather_kernel<T><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<T*>(out), n_rows, k,
      row_bytes / (long long)sizeof(T));
  return cudaGetLastError();
}

}  // namespace

extern "C" int fresco_row_gather(const void* table, const void* idx, void* out, long long n_rows,
                                 long long k, long long row_bytes, void* stream) {
  if (k <= 0 || row_bytes <= 0) return 0;
  if ((k + kWarpsPerBlock - 1) / kWarpsPerBlock > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto* ix = static_cast<const int32_t*>(idx);
  auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = (uintptr_t)table | (uintptr_t)out | (uintptr_t)row_bytes;
  if (align % 16 == 0) return launch<uint4>(table, ix, out, n_rows, k, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(table, ix, out, n_rows, k, row_bytes, s);
  if (align % 4 == 0) return launch<uint32_t>(table, ix, out, n_rows, k, row_bytes, s);
  if (align % 2 == 0) return launch<uint16_t>(table, ix, out, n_rows, k, row_bytes, s);
  return launch<uint8_t>(table, ix, out, n_rows, k, row_bytes, s);
}
