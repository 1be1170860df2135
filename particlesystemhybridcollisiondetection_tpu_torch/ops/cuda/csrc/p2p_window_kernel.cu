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
// group g is column ws_g + rel_g + k, where ws_g is the window start
// that the particle's row of 128 sorted particles has in group g.  The
// sphere-sphere contact model (ops/p2p.py): touching iff
// 0 < dist^2 < (r_i + r_j)^2 (dist^2 > 0 rejects the self pair), an
// impulse along the normal when approaching, a positional correction
// beta * overlap * m_j / (m_i + m_j), m = r * r * r, accumulated in
// (g, k) order.  Out: pos + dp, vel + dv, contact count.
//
// One device body, two entry points:
//
//   * psys_p2p_window_collide, the explicit plan: rel, cnt i32[9, n],
//     ws i32[n/1024, 9, 8] and k_cap i32[n/1024, 9] come from
//     ops/p2p_plan.py::window_geometry, as the TPU kernel takes them.
//   * psys_p2p_window_collide_cells, the plan in the kernel: from the
//     sorted cell ids and the CSR offsets over cells each block derives
//     what run_table, run_bounds and window_geometry of ops/p2p_plan.py
//     derive for its row: the run [offsets[c + off - 1],
//     offsets[c + off + 2]) of each group with the table's clamping,
//     count 0 for out-of-grid rows and parked particles; the row's
//     window start (block minimum of the live run starts, rounded down
//     to 128, clamped to [0, n]); rel, the overflow flag
//     cnt > 0 && (rel < 0 || rel + cnt > w), and rel clipped to
//     [0, w - 1].  It also writes the overflow flag per lane.  The step
//     then builds no [18, C] run table and no [9, N] plan array.
//
// The TPU kernel loops k < k_cap[b, g] for the whole block and masks
// k < cnt and rel + k < w per lane.  Here a lane's candidates are
// k < min(cnt, k_cap, w - rel): the same set in the same order.  The
// arithmetic of a touching candidate is the plain PyTorch version's
// (ops/p2p.py::pair_contact), operation for operation; built with
// --fmad=false and IEEE division and square root, the two agree bit for
// bit.  A candidate that does not touch is skipped after the distance
// test: in the plain version it adds +-0 to accumulators that start at
// +0, which leaves their bits as they are.
//
// What bounds it on the H100 is bytes: per lane 32 B of own row in and
// 28 B out (36 B with the cell id and 29 B on the second entry point),
// plus every distinct candidate column once, against ~20 operations for
// a candidate that does not touch.  What it loses time to is latency: a
// row has few candidates per lane (about 14 over nine groups in the
// falling box) behind a chain of dependent loads (cell id, CSR offsets,
// candidates).  The first version read each candidate with eight
// scattered 4 B loads from global memory, evaluated three divisions and
// a square root for every candidate, and read, per lane, 72 B of rel and
// cnt that are the same for every particle of a cell.  The design now:
//
//   * One block per row of 128 sorted particles.  The spans of all nine
//     groups, [min rel, max(rel + bound)) of each window (typically
//     130-260 columns), are found first with warp reductions
//     (__reduce_min_sync / __reduce_max_sync).
//   * Each group's span is staged in shared memory with 16 B cp.async
//     copies, one warp per staged row, so candidate reads come from
//     shared memory.  Only the four rows the distance test reads (pos
//     xyz, radius) are staged: the velocity and restitution of the rare
//     candidate that touches come from global memory.  Three buffers of
//     [4][w] floats (48w bytes of dynamic shared memory, 24 KB at
//     w = 512): groups g + 1 and g + 2 are in flight while group g is
//     computed, and one barrier per group is enough, since the buffer
//     that a copy refills was last read two barriers earlier.  cp.async,
//     not TMA: a span is four short rows at a data-dependent offset, a
//     copy that 128 threads make in one or two instructions each.
//   * Each lane keeps its own serial loop over its candidates, in (g, k)
//     order, so sums do not change; lanes of a row have similar counts.
//   * __launch_bounds__(128, 8) holds the kernel to 64 registers, so
//     eight rows are resident on an SM.
//
// Measured on the falling box (1M particles, 14 candidates per lane),
// the staging layout hardly matters: two buffers of eight rows, all
// spans packed into two large buffers and this layout read 0.106, 0.132
// and 0.101 ms on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py).  The
// dependent loads ahead of the candidates dominate there.  Whether the
// staging pays on a pile, where a column is read by many lanes, is read
// by bench/p2p_profile.py ("density"); against an unstaged body it is
// still to be measured.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int SUB = 8;
constexpr int N_GROUPS = 9;
constexpr int WARPS = LANE / 32;
constexpr int STAGED = 4;  // rows staged per column: pos xyz, radius
constexpr int BIG = 1 << 30;

// max(a, b) for a constant b that lets a NaN in a through, as torch.clamp
__device__ __forceinline__ float max_nan(float a, float b) { return a < b ? b : a; }

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Grid {
  const int32_t* cid_s;    // i32[n] sorted linear cell ids, parked = num_cells
  const int32_t* offsets;  // i32[num_cells + 2] CSR offsets over cells
  int32_t num_cells, dx, dy, dz;
};

struct Plan {
  const int32_t* rel;    // i32[9, n]
  const int32_t* cnt;    // i32[9, n]
  const int32_t* ws;     // i32[n/1024, 9, 8]
  const int32_t* k_cap;  // i32[n/1024, 9]
};

// CELLS == false: the lane's values come from pos, vel, radius, restit
// and the plan from `plan`.  CELLS == true: the lane's values are its
// column of rows_pad, the plan is derived from `grid`, and ovf_out gets
// the overflow flag.  vec_ok: rows_pad is 16 B aligned and n_pad and w
// are multiples of 4, so spans may be copied 16 B at a time.
template <bool CELLS>
__global__ void __launch_bounds__(LANE, 8) p2p_window_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ radius, const float* __restrict__ restit,
    const float* __restrict__ rows_pad, int64_t n_pad, Plan plan, Grid grid,
    float* __restrict__ pos_out, float* __restrict__ vel_out,
    int32_t* __restrict__ ncon_out, uint8_t* __restrict__ ovf_out, int64_t n,
    int32_t w, float beta, int vec_ok) {
  extern __shared__ __align__(16) float s_buf[];  // [3][STAGED][w]
  __shared__ int32_t s_red[3][WARPS][N_GROUPS];
  __shared__ int32_t s_src[N_GROUPS];  // first staged column (in rows_pad)
  __shared__ int32_t s_len[N_GROUPS];  // staged columns
  __shared__ int32_t s_lo[N_GROUPS];   // first staged column (in the window)

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t i = (int64_t)blockIdx.x * LANE + tid;

  float px, py, pz, vx, vy, vz, r, e;
  if (CELLS) {
    px = rows_pad[i];
    py = rows_pad[n_pad + i];
    pz = rows_pad[2 * n_pad + i];
    vx = rows_pad[3 * n_pad + i];
    vy = rows_pad[4 * n_pad + i];
    vz = rows_pad[5 * n_pad + i];
    r = rows_pad[6 * n_pad + i];
    e = rows_pad[7 * n_pad + i];
  } else {
    px = pos[i], py = pos[n + i], pz = pos[2 * n + i];
    vx = vel[i], vy = vel[n + i], vz = vel[2 * n + i];
    r = radius[i];
    e = restit[i];
  }
  const float m = r * r * r;

  // ---- the plan: per group the row's window start, the lane's first
  // candidate (rel, in the window) and its candidate bound ----
  int32_t rel[N_GROUPS], bnd[N_GROUPS], ws[N_GROUPS];
  if (CELLS) {
    const int32_t c = grid.cid_s[i];
    const bool live = c < grid.num_cells;
    const int32_t cs = min(c, grid.num_cells - 1);
    const int32_t cx = cs / (grid.dy * grid.dz);
    const int32_t cy = (cs / grid.dz) % grid.dy;
    int32_t start[N_GROUPS], cnt[N_GROUPS];
#pragma unroll
    for (int g = 0; g < N_GROUPS; ++g) {
      const int ox = g / 3 - 1, oy = g % 3 - 1;
      const int32_t off = (ox * grid.dy + oy) * grid.dz;
      // the run table's zero / last padding is a clamp of the index
      const int32_t st = grid.offsets[min(max(cs + off - 1, 0), grid.num_cells)];
      const int32_t en = grid.offsets[min(max(cs + off + 2, 0), grid.num_cells)];
      const bool ok = live && (cx + ox >= 0) && (cx + ox < grid.dx) &&
                      (cy + oy >= 0) && (cy + oy < grid.dy);
      start[g] = st;
      cnt[g] = ok ? en - st : 0;
      const int32_t mn = __reduce_min_sync(0xffffffffu, cnt[g] > 0 ? st : BIG);
      if (lane == 0) s_red[0][warp][g] = mn;
    }
    __syncthreads();
    bool ovf = false;
#pragma unroll
    for (int g = 0; g < N_GROUPS; ++g) {
      int32_t mn = s_red[0][0][g];
      for (int q = 1; q < WARPS; ++q) mn = min(mn, s_red[0][q][g]);
      if (mn == BIG) mn = 0;
      mn = (mn / LANE) * LANE;
      mn = min(max(mn, 0), (int32_t)n);  // rows_pad holds n + w columns
      ws[g] = mn;
      const int32_t rl = start[g] - mn;
      ovf = ovf || (cnt[g] > 0 && (rl < 0 || rl + cnt[g] > w));
      rel[g] = min(max(rl, 0), w - 1);
      bnd[g] = min(cnt[g], w - rel[g]);
    }
    ovf_out[i] = ovf ? 1 : 0;
  } else {
    const int64_t b = blockIdx.x / SUB;
    const int j = blockIdx.x % SUB;
#pragma unroll
    for (int g = 0; g < N_GROUPS; ++g) {
      rel[g] = min(max(plan.rel[g * n + i], 0), w - 1);
      bnd[g] = max(0, min(min(plan.cnt[g * n + i], plan.k_cap[b * N_GROUPS + g]),
                          w - rel[g]));
      ws[g] = plan.ws[(b * N_GROUPS + g) * SUB + j];
    }
  }

  // ---- the columns each group's candidates use: [lo, hi) of the window ----
#pragma unroll
  for (int g = 0; g < N_GROUPS; ++g) {
    const int32_t lo = __reduce_min_sync(0xffffffffu, bnd[g] > 0 ? rel[g] : BIG);
    const int32_t hi = __reduce_max_sync(0xffffffffu, bnd[g] > 0 ? rel[g] + bnd[g] : 0);
    if (lane == 0) {
      s_red[1][warp][g] = lo;
      s_red[2][warp][g] = hi;
    }
  }
  __syncthreads();
  if (tid < N_GROUPS) {
    int32_t lo = s_red[1][0][tid], hi = s_red[2][0][tid];
    for (int q = 1; q < WARPS; ++q) {
      lo = min(lo, s_red[1][q][tid]);
      hi = max(hi, s_red[2][q][tid]);
    }
    lo = hi > 0 ? (lo & ~3) : 0;  // 16 B copies start at a multiple of 4
    s_lo[tid] = lo;
    s_len[tid] = hi > 0 ? hi - lo : 0;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < N_GROUPS; ++g) {
    if (tid == 0) s_src[g] = ws[g] + s_lo[g];  // ws is the same in every lane
    rel[g] -= s_lo[g];
  }
  __syncthreads();

  // copy group g's span into buffer g % 3 (one commit, empty without
  // candidates): one warp per staged row, rows_pad rows 0, 1, 2 (pos) and
  // 6 (radius)
  auto stage_group = [&](int g) {
    const int32_t len = s_len[g];
    if (len > 0) {
      const int c = tid >> 5, q0 = tid & 31;
      const float* src = rows_pad + (int64_t)(c < 3 ? c : 6) * n_pad + s_src[g];
      float* dst = s_buf + ((g % 3) * STAGED + c) * w;
      if (vec_ok && (s_src[g] & 3) == 0) {
        for (int32_t q = 4 * q0; q < len; q += 128) cp_async16(dst + q, src + q);
      } else {
        for (int32_t q = q0; q < len; q += 32) cp_async4(dst + q, src + q);
      }
    }
    cp_async_commit();
  };
  float dvx = 0.f, dvy = 0.f, dvz = 0.f;
  float dpx = 0.f, dpy = 0.f, dpz = 0.f;
  int32_t ncon = 0;

  stage_group(0);
  stage_group(1);
#pragma unroll
  for (int g = 0; g < N_GROUPS; ++g) {
    cp_async_wait<1>();  // all but the newest commit: group g has landed
    __syncthreads();     // ... for every thread, and group g - 1 is read
    if (g + 2 < N_GROUPS) stage_group(g + 2); else cp_async_commit();
    const float* b = s_buf + (g % 3) * STAGED * w;
    const float* far = rows_pad + s_src[g];  // the same columns in global memory
    for (int32_t k = 0; k < bnd[g]; ++k) {
      const int32_t col = rel[g] + k;
      const float dx = px - b[col];
      const float dy = py - b[w + col];
      const float dz = pz - b[2 * w + col];
      const float rj = b[3 * w + col];
      const float dist2 = dx * dx + dy * dy + dz * dz;
      const float rsum = r + rj;
      if ((dist2 < rsum * rsum) && (dist2 > 0.f)) {  // touching
        const float dist = sqrtf(max_nan(dist2, 1e-30f));
        const float nx = dx / dist, ny = dy / dist, nz = dz / dist;
        const float rvx = vx - far[3 * n_pad + col];
        const float rvy = vy - far[4 * n_pad + col];
        const float rvz = vz - far[5 * n_pad + col];
        const float vn = rvx * nx + rvy * ny + rvz * nz;
        const float ee = 0.5f * (e + far[7 * n_pad + col]);
        const float mj = rj * rj * rj;
        const float wgt = mj / (m + mj);
        const float imp = (vn < 0.f) ? -(1.0f + ee) * vn * wgt : 0.f;
        const float overlap = rsum - dist;
        const float push = beta * overlap * wgt;
        dvx = dvx + nx * imp;
        dvy = dvy + ny * imp;
        dvz = dvz + nz * imp;
        dpx = dpx + nx * push;
        dpy = dpy + ny * push;
        dpz = dpz + nz * push;
        ncon += 1;
      }
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

template <bool CELLS>
int launch(const float* pos, const float* vel, const float* radius, const float* restit,
           const float* rows_pad, int64_t n_pad, Plan plan, Grid grid, float* pos_out,
           float* vel_out, int32_t* ncon_out, uint8_t* ovf_out, int64_t n, int32_t w,
           float beta, void* stream) {
  const int64_t rows = n / LANE;
  if (rows <= 0) return 0;
  const size_t smem = (size_t)3 * STAGED * w * sizeof(float);
  if (smem > 40 * 1024) {  // 48 KB with the static part, unless more is allowed
    const cudaError_t err = cudaFuncSetAttribute(
        p2p_window_kernel<CELLS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int vec_ok = ((uintptr_t)rows_pad % 16 == 0) && (n_pad % 4 == 0) && (w % 4 == 0);
  p2p_window_kernel<CELLS><<<(unsigned)rows, LANE, smem, (cudaStream_t)stream>>>(
      pos, vel, radius, restit, rows_pad, n_pad, plan, grid, pos_out, vel_out, ncon_out,
      ovf_out, n, w, beta, vec_ok);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points: n must be a multiple of 1024 and rows_pad hold at
// least n + w columns (the wrappers check).  Return the first CUDA
// error, 0 if none.

// The explicit plan: rel, cnt are [9, n], ws [n/1024, 9, 8] (multiples of
// 128 in [0, n]), k_cap [n/1024, 9].
extern "C" int psys_p2p_window_collide(
    const float* pos, const float* vel, const float* radius, const float* restit,
    const float* rows_pad, int64_t n_pad, const int32_t* rel, const int32_t* cnt,
    const int32_t* ws, const int32_t* k_cap, float* pos_out, float* vel_out,
    int32_t* ncon_out, int64_t n, int32_t w, float beta, void* stream) {
  const Plan plan = {rel, cnt, ws, k_cap};
  const Grid grid = {nullptr, nullptr, 0, 0, 0, 0};
  return launch<false>(pos, vel, radius, restit, rows_pad, n_pad, plan, grid, pos_out,
                       vel_out, ncon_out, nullptr, n, w, beta, stream);
}

// The plan in the kernel: cid_s i32[n] sorted cell ids (parked particles
// = num_cells), offsets i32[num_cells + 2] CSR offsets over cells, grid
// dims (dx, dy, dz) with dx * dy * dz == num_cells.  ovf_out u8[n] gets 1
// where a run of the lane does not fit its window.
extern "C" int psys_p2p_window_collide_cells(
    const float* rows_pad, int64_t n_pad, const int32_t* cid_s, const int32_t* offsets,
    int32_t num_cells, int32_t dx, int32_t dy, int32_t dz, float* pos_out,
    float* vel_out, int32_t* ncon_out, uint8_t* ovf_out, int64_t n, int32_t w,
    float beta, void* stream) {
  const Plan plan = {nullptr, nullptr, nullptr, nullptr};
  const Grid grid = {cid_s, offsets, num_cells, dx, dy, dz};
  return launch<true>(nullptr, nullptr, nullptr, nullptr, rows_pad, n_pad, plan, grid,
                      pos_out, vel_out, ncon_out, ovf_out, n, w, beta, stream);
}
