// Sorted 9-run window kernel of particle-particle collisions (kernel B3).
//
// Replaces the TPU kernel _p2p_kernel of the JAX package
// (particlesystemhybridcollisiondetection_tpu/ops/pallas/p2p_window_kernel.py,
// launched by p2p_window_collide_sorted).
//
// Per particle i, in cell-sorted order: for each of the nine (dx, dy)
// groups g, its candidates are a run of consecutive sorted particles,
// read as columns of rows_pad [8, n_pad] (pos xyz, vel xyz, radius,
// restitution; the last w columns are inert padding).  Candidate k of
// group g is column ws[b, g, j] + rel[g, i] + k, where b is the
// particle's block of 1024 and j its row of 128 within the block.  The
// sphere-sphere contact model (ops/p2p.py): touching iff
// 0 < dist^2 < (r_i + r_j)^2 (dist^2 > 0 rejects the self pair), an
// impulse along the normal when approaching, a positional correction
// beta * overlap * m_j / (m_i + m_j), m = r * r * r, accumulated in
// (g, k) order.  Out: pos + dp, vel + dv, contact count.
//
// The TPU kernel loops k < k_cap[b, g] for the whole block and masks
// k < cnt and rel + k < w per lane.  Here each thread loops
// k < min(cnt, k_cap, w - rel): the same candidates in the same order
// (rel arrives clipped to [0, w - 1], so w - rel >= 1).  The arithmetic
// is the plain PyTorch version's
// (p2p_window_kernel.py::p2p_window_collide_sorted_plain, through
// ops/p2p.py::pair_contact), operation for operation, in select form;
// built with --fmad=false and IEEE division and square root, the two
// agree lane for lane.
//
// Design: one thread per particle, one 128-thread block per row (one
// window per group), candidate columns read straight from global memory
// and outputs written to separate arrays (a thread reads its
// neighbours' input rows).  Neighbours in a row share cells, so most
// candidate reads hit L1/L2.  What bounds it on the H100 is bytes: per
// lane 104 B of inputs (72 B of them rel and cnt) and 28 B out, against
// 53 float operations per candidate.  Staging each row's windows
// in shared memory (cp.async / TMA), warp-cooperative loads and a
// narrower rel/cnt encoding are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int SUB = 8;
constexpr int N_GROUPS = 9;

// max(a, b) for a constant b that lets a NaN in a through, as torch.clamp
__device__ __forceinline__ float max_nan(float a, float b) { return a < b ? b : a; }

__global__ void __launch_bounds__(LANE) p2p_window_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ radius, const float* __restrict__ restit,
    const float* __restrict__ rows_pad, int64_t n_pad,
    const int32_t* __restrict__ rel, const int32_t* __restrict__ cnt,
    const int32_t* __restrict__ ws, const int32_t* __restrict__ k_cap,
    float* __restrict__ pos_out, float* __restrict__ vel_out,
    int32_t* __restrict__ ncon_out, int64_t n, int32_t w, float beta) {
  const int64_t i = (int64_t)blockIdx.x * LANE + threadIdx.x;
  const int64_t b = blockIdx.x / SUB;
  const int j = blockIdx.x % SUB;
  const float px = pos[i], py = pos[n + i], pz = pos[2 * n + i];
  const float vx = vel[i], vy = vel[n + i], vz = vel[2 * n + i];
  const float r = radius[i];
  const float e = restit[i];
  const float m = r * r * r;

  float dvx = 0.f, dvy = 0.f, dvz = 0.f;
  float dpx = 0.f, dpy = 0.f, dpz = 0.f;
  int32_t ncon = 0;

  for (int g = 0; g < N_GROUPS; ++g) {
    const int32_t rs = rel[g * n + i];
    const int32_t kmax =
        min(min(cnt[g * n + i], k_cap[b * N_GROUPS + g]), w - rs);
    const float* col0 = rows_pad + ws[(b * N_GROUPS + g) * SUB + j] + rs;
    for (int32_t k = 0; k < kmax; ++k) {
      const float* col = col0 + k;
      const float dx = px - col[0];
      const float dy = py - col[n_pad];
      const float dz = pz - col[2 * n_pad];
      const float rj = col[6 * n_pad];
      const float dist2 = dx * dx + dy * dy + dz * dz;
      const float rsum = r + rj;
      const bool touching = (dist2 < rsum * rsum) && (dist2 > 0.f);

      const float dist = sqrtf(max_nan(dist2, 1e-30f));
      const float nx = dx / dist, ny = dy / dist, nz = dz / dist;
      const float rvx = vx - col[3 * n_pad];
      const float rvy = vy - col[4 * n_pad];
      const float rvz = vz - col[5 * n_pad];
      const float vn = rvx * nx + rvy * ny + rvz * nz;
      const bool approaching = touching && (vn < 0.f);

      const float ee = 0.5f * (e + col[7 * n_pad]);
      const float mj = rj * rj * rj;
      const float wgt = mj / (m + mj);
      const float imp = approaching ? -(1.0f + ee) * vn * wgt : 0.f;
      const float overlap = touching ? rsum - dist : 0.f;
      const float push = beta * overlap * wgt;
      dvx = dvx + nx * imp;
      dvy = dvy + ny * imp;
      dvz = dvz + nz * imp;
      dpx = dpx + nx * push;
      dpy = dpy + ny * push;
      dpz = dpz + nz * push;
      ncon += touching ? 1 : 0;
    }
  }

  pos_out[i] = px + dpx;
  pos_out[n + i] = py + dpy;
  pos_out[2 * n + i] = pz + dpz;
  vel_out[i] = vx + dvx;
  vel_out[n + i] = vy + dvy;
  vel_out[2 * n + i] = vz + dvz;
  ncon_out[i] = ncon;
}

}  // namespace

// n must be a multiple of 1024 and rows_pad hold at least n + w columns
// (the wrapper checks); rel, cnt are [9, n], ws [n/1024, 9, 8], k_cap
// [n/1024, 9].  Returns cudaGetLastError().
extern "C" int psys_p2p_window_collide(
    const float* pos, const float* vel, const float* radius, const float* restit,
    const float* rows_pad, int64_t n_pad, const int32_t* rel, const int32_t* cnt,
    const int32_t* ws, const int32_t* k_cap, float* pos_out, float* vel_out,
    int32_t* ncon_out, int64_t n, int32_t w, float beta, void* stream) {
  const int64_t rows = n / LANE;
  if (rows > 0) {
    p2p_window_kernel<<<(unsigned)rows, LANE, 0, (cudaStream_t)stream>>>(
        pos, vel, radius, restit, rows_pad, n_pad, rel, cnt, ws, k_cap, pos_out,
        vel_out, ncon_out, n, w, beta);
  }
  return (int)cudaGetLastError();
}
