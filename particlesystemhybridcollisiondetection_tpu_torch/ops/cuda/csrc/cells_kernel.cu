// Morton-code cells lookup of the sorted spatial pipeline (kernel B2).
//
// Replaces the TPU kernel _cells_kernel of the JAX package
// (particlesystemhybridcollisiondetection_tpu/ops/pallas/window_kernel.py,
// launched by cells_window_lookup).  For each particle, in sorted order,
// it reads packed = (start << 8) | min(count, 255) from the Morton-code-
// indexed table and returns start = (packed >> 8) & 0xFFFFFF (arithmetic
// shift, then the 24-bit mask: start bit 23 makes the word negative) and
// count, or count = -1 on a lookup miss.
//
// Miss semantics are the TPU kernel's, exactly, because misses feed the
// overflow mask: each row of 128 sorted particles has two code windows
// of wc codes, one starting at lo (from the row minimum), one at hi
// (ending at the row maximum, used only when hi > lo).  A key outside
// both windows, or a cell with 255 or more candidates, is a miss.  Where
// a window holds the key, the TPU's window gather returns table[key], so
// this kernel reads table[key] directly.  On a miss the TPU kernel's
// start is undefined; here it is 0.  Keys outside the table (never made
// by morton_key) are misses too.
//
// Design: one thread per particle, one 128-thread block per row.  What
// bounds it on the H100 is bytes: 4 B key in, 8 B out per particle, plus
// one 4 B table read per distinct key; the table reads are scattered,
// so a row's reads fall in at most two 2 KB code windows.  Staging those
// windows in shared memory (TMA / cp.async) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;

__global__ void __launch_bounds__(LANE) cells_window_lookup_kernel(
    const int32_t* __restrict__ key, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, const int32_t* __restrict__ table,
    int64_t table_len, int32_t* __restrict__ start_out,
    int32_t* __restrict__ count_out, int32_t wc) {
  const int64_t i = (int64_t)blockIdx.x * LANE + threadIdx.x;
  const int32_t k = key[i];
  const int32_t l = lo[blockIdx.x];
  const int32_t h = hi[blockIdx.x];
  const int32_t rel_lo = k - l;
  const int32_t rel_hi = k - h;
  const bool ok_lo = rel_lo >= 0 && rel_lo < wc;
  const bool ok_hi = rel_hi >= 0 && rel_hi < wc && h > l;
  const bool ok = (ok_lo || ok_hi) && k >= 0 && (int64_t)k < table_len;
  const int32_t packed = ok ? table[k] : 0;
  const int32_t cnt = packed & 255;
  start_out[i] = (packed >> 8) & 0xFFFFFF;
  count_out[i] = (ok && cnt < 255) ? cnt : -1;
}

}  // namespace

// n must be a multiple of 128 (the wrapper checks); returns cudaGetLastError().
extern "C" int psys_cells_window_lookup(
    const int32_t* key, const int32_t* lo, const int32_t* hi,
    const int32_t* table, int64_t table_len, int32_t* start_out,
    int32_t* count_out, int64_t n, int32_t wc, void* stream) {
  const int64_t rows = n / LANE;
  if (rows > 0) {
    cells_window_lookup_kernel<<<(unsigned)rows, LANE, 0, (cudaStream_t)stream>>>(
        key, lo, hi, table, table_len, start_out, count_out, wc);
  }
  return (int)cudaGetLastError();
}
