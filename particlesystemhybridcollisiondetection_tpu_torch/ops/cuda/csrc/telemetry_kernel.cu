// In-graph telemetry of the episode runners' steps (the sorted and the
// p2p runner, their calls with with_stats=True; ops/cuda/telemetry_kernel.py
// wraps these).  No TPU kernel stands behind it: the JAX package times its
// steps from outside.
//
// psys_stamp_kernel: one thread writes the device's %globaltimer (ns)
// into slot `slot` of the ring row that the device step counter selects
// (row = step % cap of an int64 [cap, width] ring).  The step's last stamp
// also copies the step's counters into the row's slots `counters_at` ..
// `counters_at` + 2 (the window overflow, the screen-space stage's
// undecided real lanes, the worklist launch's listed lanes; -1 where a pointer
// is null), sets the undecided accumulator back to 0 and advances the
// step counter.  Nothing is read on the host inside a step: the stamps
// ride the captured graph between the stages they separate, in stream
// order.
//
// undecided_count_kernel: adds to *acc the lanes that the screen-space
// stage left undecided and that are real (|x| below the sentinel bound,
// core/state.py::active_mask): one __syncthreads_count a block and pass,
// one atomicAdd a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COUNT_THREADS = 256;
constexpr int COUNT_BLOCKS = 1024;

__global__ void psys_stamp_kernel(int64_t* __restrict__ ring, int32_t* __restrict__ step,
                                  int32_t cap, int32_t width, int32_t slot,
                                  int32_t counters_at, const int32_t* __restrict__ n_over,
                                  int32_t* __restrict__ undecided,
                                  const int32_t* __restrict__ n_lanes) {
  uint64_t now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  int64_t* row = ring + (int64_t)(*step % cap) * width;
  row[slot] = (int64_t)now;
  if (counters_at >= 0) {
    row[counters_at] = n_over ? *n_over : -1;
    row[counters_at + 1] = undecided ? *undecided : -1;
    row[counters_at + 2] = n_lanes ? *n_lanes : -1;
    if (undecided) *undecided = 0;
    *step += 1;
  }
}

__global__ void __launch_bounds__(COUNT_THREADS) undecided_count_kernel(
    const uint8_t* __restrict__ und, const float* __restrict__ x, int64_t n, float bound,
    int32_t* __restrict__ acc) {
  int32_t c = 0;
  // every thread of a block takes the same number of passes
  for (int64_t base = (int64_t)blockIdx.x * COUNT_THREADS; base < n;
       base += (int64_t)gridDim.x * COUNT_THREADS) {
    const int64_t i = base + threadIdx.x;
    c += __syncthreads_count(i < n && und[i] && fabsf(x[i]) < bound);
  }
  if (threadIdx.x == 0 && c) atomicAdd(acc, c);
}

}  // namespace

// Returns cudaGetLastError().
extern "C" int psys_stamp(int64_t* ring, int32_t* step, int32_t cap, int32_t width,
                          int32_t slot, int32_t counters_at, const int32_t* n_over,
                          int32_t* undecided, const int32_t* n_lanes, void* stream) {
  psys_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(ring, step, cap, width, slot,
                                                       counters_at, n_over, undecided,
                                                       n_lanes);
  return (int)cudaGetLastError();
}

extern "C" int psys_undecided_count(const uint8_t* und, const float* x, int64_t n,
                                    float bound, int32_t* acc, void* stream) {
  if (n > 0) {
    int64_t blocks = (n + COUNT_THREADS - 1) / COUNT_THREADS;
    if (blocks > COUNT_BLOCKS) blocks = COUNT_BLOCKS;
    undecided_count_kernel<<<(unsigned)blocks, COUNT_THREADS, 0, (cudaStream_t)stream>>>(
        und, x, n, bound, acc);
  }
  return (int)cudaGetLastError();
}
