// Sorted block-window narrow phase + response + integration (kernel B1).
//
// Replaces the TPU kernel _kernel of the JAX package
// (particlesystemhybridcollisiondetection_tpu/ops/pallas/window_kernel.py,
// launched by window_collide_sorted), both as the main pass of every
// sorted step and as the phase-1 rescue kernel.
//
// Per particle, in sorted order: the exact swept-sphere test against its
// candidates k < count, read from rows ws + rel + k of the planar
// Morton-ordered pair table [9, p_pad] (v0 v1 v2 xyz), where ws is the
// window start of the particle's row of 128 sorted particles.  Two
// offset-plane ray-triangle tests, three edge cylinders with the
// geometric cap test, three vertex spheres; the span check
// t^2 <= |v|^2 dt^2; the nearest hit by strict < (the earliest candidate
// wins ties).  Then the response (reflect * e|v| - g dt, snap to the hit
// point, back off, rebound) and the fused integrator on every lane,
// padding included.
//
// The TPU kernel loops k < min(k_cap, k_static) per 1024-particle block
// and masks k < count and rel + k < w per lane.  Here a lane's
// candidates are k < min(count, k_cap, k_static, w - rel): the same set.
// The arithmetic per candidate is the TPU kernel's select form,
// operation for operation; built with --fmad=false and IEEE division and
// square root, it agrees with the plain PyTorch version
// (window_kernel.py) bit for bit.  1 / sqrt stands where the TPU kernel
// has rsqrt, as in the plain version.
//
// What bounds it on the H100: by the count of bytes and operations,
// bytes (70 B per lane in and out; candidates are few: 0.06 per lane on
// the falling dragon scene, 36 B of pair row and about 550 float
// operations each, IEEE divisions and square roots among them).  What it
// lost its time to was the densest lane: candidates are spread very
// unevenly (most lanes have none, a lane in a dense cell up to the
// demotion threshold of 192), and with one thread looping over its own
// lane's candidates a launch lasted as long as its densest lane (0.36 ms
// against 0.02 ms of memory time).  The design:
//
//   * One block owns one row of 128 sorted particles (one window).  The
//     owner threads put their lane (position, direction, radius, span,
//     rel) and candidate bound in shared memory; an exclusive scan of the
//     bounds gives the row's total T.  A row with T == 0 (most rows in
//     free fall) goes straight to the response and the integrator.
//   * Otherwise the row's candidates are one flat list of (owner, k)
//     items that all threads of the block walk with a stride of the
//     block size; an item finds its owner by a binary search in the
//     scan.  Neighbouring threads evaluate neighbouring candidates of
//     one owner, so no thread waits for a dense lane.
//   * The nearest hit of the sequential strict-< fold is the
//     lexicographic minimum of (t^2, k).  A hit's t^2 is never NaN and
//     never negative, so its float bits order as an unsigned integer,
//     and the minimum is a 64-bit atomicMin on (bits(t^2) << 32) | k in
//     shared memory.  Only a candidate that passes the span check with a
//     finite t^2 posts a key, so "some key was posted" is the old
//     any_hit && best_t2 < INF.  The owner then evaluates candidate k*
//     once more for t and the flipped normal: the arithmetic is
//     deterministic, so the bits are those of the first evaluation.
//   * The pair rows that the row's candidates use, [min rel,
//     max(rel + bound)) of its window, are staged in shared memory
//     ([9][w] floats of dynamic shared memory: 36 KB at w = 1024, 72 KB
//     at w = 2048, above 48 KB by cudaFuncSetAttribute) with plain
//     coalesced loads.  The span is read once and used straight away, so
//     there is nothing to overlap the copy with inside the block
//     (cp.async or TMA would buy nothing); the other blocks on the SM
//     hide its latency.
//   * A launch with few rows (the rescue chunk: 8192 compacted overflow
//     lanes, 64 rows) would fill 64 blocks of a 132-SM card.
//     There the wrapper asks for `split` blocks per row: each takes an
//     equal share of the row's flat list, stages only the span of its
//     share, reduces in shared memory and then folds its keys into a
//     64-bit key buffer in global memory (scratch that the wrapper
//     allocates; a small kernel fills it first) with atomicMin.  A
//     finishing kernel, one thread per lane, evaluates candidate k* and
//     does the response and the integrator.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int SUB = 8;
constexpr int MAX_THREADS = 256;
constexpr int BIG = 1 << 30;
// (bits(+inf) << 32) | 0xffffffff: above every key a hit can post
constexpr unsigned long long NO_HIT = 0x7f800000ffffffffull;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 divs(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
// jnp.maximum(a, b) for a constant b: NaN in a propagates
__device__ __forceinline__ float max_nan(float a, float b) { return a < b ? b : a; }

__device__ __forceinline__ void consider(bool hit, float t, float& c_t2, float& c_t,
                                         bool& c_hit) {
  const float t2 = t * t;
  if (hit && t2 < c_t2) {
    c_t2 = t2;
    c_t = t;
  }
  c_hit = c_hit || hit;
}

// One candidate triangle against one lane (position p, unit direction d,
// radius r): the nearest of its eight sub-tests before the span check
// (c_t2, c_t; c_hit if any sub-test hit) and the normal flipped against
// the motion.
__device__ __forceinline__ void eval_candidate(V3 p, V3 d, float r, V3 v0, V3 v1, V3 v2,
                                               float& c_t2, float& c_t, bool& c_hit,
                                               V3& nr) {
  const float INF = __int_as_float(0x7f800000);
  // triangle normal flipped against the motion (compute:169-171)
  nr = cross(sub(v1, v0), sub(v2, v0));
  const float nlen = sqrtf(max_nan(dot(nr, nr), 1e-37f));
  nr = divs(nr, nlen);
  if (dot(nr, d) > 0.f) nr = neg(nr);
  const V3 off = mul(nr, r);

  c_t2 = INF;
  c_t = INF;
  c_hit = false;

  // offset planes (compute:174-198)
  for (int s = 0; s < 2; ++s) {
    const V3 so = s == 0 ? off : neg(off);
    const V3 a0 = add(v0, so), a1 = add(v1, so), a2 = add(v2, so);
    const V3 e1 = sub(a1, a0), e2 = sub(a2, a0), rov = sub(p, a0);
    const V3 nn = cross(e1, e2), q = cross(rov, d);
    const float dd = 1.0f / dot(d, nn);
    const float u = dd * -dot(q, e2);
    const float vv = dd * dot(q, e1);
    const float t = dd * -dot(nn, rov);
    const bool hit = !((u < 0.f) || (vv < 0.f) || ((u + vv) > 1.f));
    consider(hit, t, c_t2, c_t, c_hit);
  }

  // edge cylinders (compute:103-142, geometric cap test)
  const V3 ea[3] = {v0, v1, v2};
  const V3 eb[3] = {v1, v2, v0};
  for (int c = 0; c < 3; ++c) {
    const V3 ba = sub(eb[c], ea[c]), oc = sub(p, ea[c]);
    const float baba = dot(ba, ba), bard = dot(ba, d), baoc = dot(ba, oc);
    const float k2 = baba - bard * bard;
    const float k1 = baba * dot(oc, d) - baoc * bard;
    const float k0 = baba * dot(oc, oc) - baoc * baoc - r * r * baba;
    const float h = k1 * k1 - k2 * k0;
    const float hs = sqrtf(max_nan(h, 0.f));
    const float t_body = (-k1 - hs) / k2;
    const float y = baoc + t_body * bard;
    const bool body_hit = (h >= 0.f) && (y > 0.f) && (y < baba);
    const float yc = (y < 0.f) ? 0.f : baba;
    const float t_cap = (yc - baoc) / bard;
    const V3 qq = sub(add(oc, mul(d, t_cap)), mul(ba, yc / baba));
    const bool cap_hit = (h >= 0.f) && (dot(qq, qq) < r * r);
    consider(body_hit || cap_hit, body_hit ? t_body : t_cap, c_t2, c_t, c_hit);
  }

  // vertex spheres (compute:144-161)
  for (int c = 0; c < 3; ++c) {
    const V3 oc = sub(ea[c], p);
    const float proj = dot(oc, d);
    const float disc = r * r - (dot(oc, oc) - proj * proj);
    consider(disc >= 0.f, proj - sqrtf(max_nan(disc, 0.f)), c_t2, c_t, c_hit);
  }
}

struct Step {
  float gx, gy, gz, dt, dt2, backoff;
};

struct Lane {
  V3 p, v, d;
  float r, e, speed2, seg2;
};

__device__ __forceinline__ Lane load_lane(const float* __restrict__ pos,
                                          const float* __restrict__ vel,
                                          const float* __restrict__ radius,
                                          const float* __restrict__ restit, int64_t n,
                                          int64_t i, float dt2) {
  Lane l;
  l.p = {pos[i], pos[n + i], pos[2 * n + i]};
  l.v = {vel[i], vel[n + i], vel[2 * n + i]};
  l.r = radius[i];
  l.e = restit[i];
  l.speed2 = dot(l.v, l.v);
  const float inv_speed = 1.0f / sqrtf(max_nan(l.speed2, 1e-37f));
  l.d = mul(l.v, inv_speed);
  l.seg2 = l.speed2 * dt2;
  return l;
}

// Response (compute:332-352) + integrator (PSReactionUpdate:18-19) of one
// lane.  `found`: the lane's nearest hit is the triangle v0 v1 v2.
__device__ __forceinline__ void respond_store(const Lane& l, bool found, V3 v0, V3 v1,
                                              V3 v2, const Step& st,
                                              float* __restrict__ pos_out,
                                              float* __restrict__ vel_out,
                                              int32_t* __restrict__ hit_out, int64_t n,
                                              int64_t i) {
  float best_t = __int_as_float(0x7f800000);
  V3 bn = {0.f, 0.f, 0.f};
  if (found) {
    float c_t2;
    bool c_hit;
    eval_candidate(l.p, l.d, l.r, v0, v1, v2, c_t2, best_t, c_hit, bn);
  }
  const bool hit = found && (l.speed2 != 0.f);

  const V3 gdt = {st.gx * st.dt, st.gy * st.dt, st.gz * st.dt};
  const V3 col = add(l.p, mul(l.d, best_t));
  const float dn = dot(l.d, bn);
  V3 refl = sub(l.d, mul(bn, 2.0f * dn));
  refl = divs(refl, sqrtf(max_nan(dot(refl, refl), 1e-37f)));
  const V3 ce = sub(add(l.p, mul(l.v, st.dt)), col);
  const float col_to_end = sqrtf(max_nan(dot(ce, ce), 0.f));
  const float speed = sqrtf(l.speed2);
  const V3 new_vel = sub(mul(refl, l.e * speed), gdt);
  const V3 new_pos =
      add(sub(col, mul(l.d, st.backoff * l.r)), mul(refl, col_to_end * l.e));
  V3 ov = hit ? new_vel : l.v;
  V3 op = hit ? new_pos : l.p;
  ov = add(ov, gdt);
  op = add(op, mul(ov, st.dt));

  pos_out[i] = op.x;
  pos_out[n + i] = op.y;
  pos_out[2 * n + i] = op.z;
  vel_out[i] = ov.x;
  vel_out[n + i] = ov.y;
  vel_out[2 * n + i] = ov.z;
  hit_out[i] = hit ? 1 : 0;
}

__device__ __forceinline__ int32_t lane_bound(const int32_t* __restrict__ count,
                                              const int32_t* __restrict__ k_cap,
                                              int64_t i, int row, int32_t k_static,
                                              int32_t w, int32_t rs) {
  return max(0, min(min(count[i], k_cap[row / SUB]), min(k_static, w - rs)));
}

// SPLIT == false: grid (rows), the block does the whole row and writes
// the outputs.  SPLIT == true: grid (rows, split), block (row, y) takes
// the y-th share of the row's flat candidate list and folds its nearest
// hits into keys[n]; finish_kernel writes the outputs.
template <bool SPLIT>
__global__ void __launch_bounds__(MAX_THREADS) window_collide_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ radius, const float* __restrict__ restit,
    const int32_t* __restrict__ rel, const int32_t* __restrict__ count,
    const int32_t* __restrict__ ws, const int32_t* __restrict__ k_cap,
    const float* __restrict__ pairs, int64_t p_pad, float* __restrict__ pos_out,
    float* __restrict__ vel_out, int32_t* __restrict__ hit_out,
    unsigned long long* __restrict__ keys, int64_t n, int32_t w, int32_t k_static,
    Step st) {
  extern __shared__ __align__(16) float s_pairs[];  // [9][w], the staged span
  __shared__ float s_px[LANE], s_py[LANE], s_pz[LANE];
  __shared__ float s_dx[LANE], s_dy[LANE], s_dz[LANE];
  __shared__ float s_r[LANE], s_seg2[LANE];
  __shared__ int32_t s_rel[LANE];
  __shared__ int32_t s_off[LANE + 1];  // exclusive scan of the bounds
  __shared__ int32_t s_wsum[MAX_THREADS / 32];
  __shared__ int32_t s_lo, s_hi;
  __shared__ unsigned long long s_best[LANE];

  const float INF = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row = blockIdx.x;
  const bool owner = tid < LANE;
  const int64_t i = (int64_t)row * LANE + tid;

  Lane l = {};
  int32_t rs = 0, bound = 0;
  if (owner) {
    l = load_lane(pos, vel, radius, restit, n, i, st.dt2);
    rs = rel[i];
    bound = lane_bound(count, k_cap, i, row, k_static, w, rs);
    s_px[tid] = l.p.x;
    s_py[tid] = l.p.y;
    s_pz[tid] = l.p.z;
    s_dx[tid] = l.d.x;
    s_dy[tid] = l.d.y;
    s_dz[tid] = l.d.z;
    s_r[tid] = l.r;
    s_seg2[tid] = l.seg2;
    s_rel[tid] = rs;
    s_best[tid] = NO_HIT;
  }
  if (tid == 0) {
    s_lo = BIG;
    s_hi = 0;
  }

  // exclusive scan of the bounds over the owner threads
  int32_t incl = bound;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if ((tid & 31) >= o) incl += y;
  }
  if ((tid & 31) == 31) s_wsum[tid >> 5] = incl;
  __syncthreads();
  if (owner) {
    int32_t base = 0;
    for (int q = 0; q < (tid >> 5); ++q) base += s_wsum[q];
    s_off[tid] = base + incl - bound;
    if (tid == LANE - 1) s_off[LANE] = base + incl;
  }
  __syncthreads();
  const int32_t total = s_off[LANE];

  if (total > 0) {
    // this block's share [begin, end) of the flat list
    int32_t begin = 0, end = total;
    if (SPLIT) {
      begin = (int32_t)((int64_t)total * blockIdx.y / gridDim.y);
      end = (int32_t)((int64_t)total * (blockIdx.y + 1) / gridDim.y);
    }
    if (begin < end) {
      // owner of item x: the largest o with s_off[o] <= x
      auto owner_of = [&](int32_t x) {
        int lo = 0, hi = LANE - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_off[mid] <= x) lo = mid; else hi = mid - 1;
        }
        return lo;
      };
      const int o_first = owner_of(begin), o_last = owner_of(end - 1);

      // pair rows used by the owners of the share: [lo, hi) of the window
      const bool mine = owner && bound > 0 && tid >= o_first && tid <= o_last;
      const int32_t wlo = __reduce_min_sync(0xffffffffu, mine ? rs : BIG);
      const int32_t whi = __reduce_max_sync(0xffffffffu, mine ? rs + bound : 0);
      if ((tid & 31) == 0) {
        atomicMin(&s_lo, wlo);
        atomicMax(&s_hi, whi);
      }
      __syncthreads();
      const int32_t lo = s_lo, span = s_hi - s_lo;
      const float* src = pairs + ws[row] + lo;
      for (int c = 0; c < 9; ++c)
        for (int32_t j = tid; j < span; j += nt) s_pairs[c * w + j] = src[c * p_pad + j];
      __syncthreads();

      for (int32_t x = begin + tid; x < end; x += nt) {
        const int o = owner_of(x);
        const int32_t k = x - s_off[o];
        const int32_t j = s_rel[o] + k - lo;
        const V3 v0 = {s_pairs[j], s_pairs[w + j], s_pairs[2 * w + j]};
        const V3 v1 = {s_pairs[3 * w + j], s_pairs[4 * w + j], s_pairs[5 * w + j]};
        const V3 v2 = {s_pairs[6 * w + j], s_pairs[7 * w + j], s_pairs[8 * w + j]};
        float c_t2, c_t;
        bool c_hit;
        V3 nr;
        eval_candidate({s_px[o], s_py[o], s_pz[o]}, {s_dx[o], s_dy[o], s_dz[o]},
                       s_r[o], v0, v1, v2, c_t2, c_t, c_hit, nr);
        // span check (compute:226-231); a hit with t2 == INF never wins
        if (c_hit && (c_t2 <= s_seg2[o]) && (c_t2 < INF)) {
          const unsigned long long key =
              ((unsigned long long)__float_as_uint(c_t2) << 32) | (uint32_t)k;
          atomicMin(&s_best[o], key);
        }
      }
      __syncthreads();

      if (owner) {
        const unsigned long long key = s_best[tid];
        if (SPLIT) {
          if (key != NO_HIT) atomicMin(&keys[i], key);
        } else {
          const bool found = key != NO_HIT;
          const int32_t j = found ? rs + (int32_t)(uint32_t)key - lo : 0;
          respond_store(l, found, {s_pairs[j], s_pairs[w + j], s_pairs[2 * w + j]},
                        {s_pairs[3 * w + j], s_pairs[4 * w + j], s_pairs[5 * w + j]},
                        {s_pairs[6 * w + j], s_pairs[7 * w + j], s_pairs[8 * w + j]},
                        st, pos_out, vel_out, hit_out, n, i);
        }
      }
      return;
    }
  }
  if (!SPLIT && owner) {
    const V3 z = {0.f, 0.f, 0.f};
    respond_store(l, false, z, z, z, st, pos_out, vel_out, hit_out, n, i);
  }
}

// Before the split kernel: no lane has a hit yet.
__global__ void __launch_bounds__(LANE) fill_keys_kernel(
    unsigned long long* __restrict__ keys) {
  keys[(int64_t)blockIdx.x * LANE + threadIdx.x] = NO_HIT;
}

// After the split kernel: one thread per lane, its nearest hit from keys.
__global__ void __launch_bounds__(LANE) finish_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ radius, const float* __restrict__ restit,
    const int32_t* __restrict__ rel, const int32_t* __restrict__ ws,
    const float* __restrict__ pairs, int64_t p_pad,
    const unsigned long long* __restrict__ keys, float* __restrict__ pos_out,
    float* __restrict__ vel_out, int32_t* __restrict__ hit_out, int64_t n, Step st) {
  const int64_t i = (int64_t)blockIdx.x * LANE + threadIdx.x;
  const Lane l = load_lane(pos, vel, radius, restit, n, i, st.dt2);
  const unsigned long long key = keys[i];
  const bool found = key != NO_HIT;
  V3 v0 = {0.f, 0.f, 0.f}, v1 = v0, v2 = v0;
  if (found) {
    const float* r = pairs + ws[blockIdx.x] + rel[i] + (int32_t)(uint32_t)key;
    v0 = {r[0], r[p_pad], r[2 * p_pad]};
    v1 = {r[3 * p_pad], r[4 * p_pad], r[5 * p_pad]};
    v2 = {r[6 * p_pad], r[7 * p_pad], r[8 * p_pad]};
  }
  respond_store(l, found, v0, v1, v2, st, pos_out, vel_out, hit_out, n, i);
}

// A block may use 48 KB of shared memory, static and dynamic together,
// unless more is allowed for its kernel; the kernels here hold under 8 KB
// of static shared memory.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 40 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// n must be a multiple of 1024 (the wrapper checks); ws holds one window
// start per row of 128, k_cap one bound per block of 1024.  split == 1:
// one block of `threads` threads per row does everything.  split > 1:
// keys (u64[n] of scratch) is filled with "no hit", `split` blocks per row
// fold their hits into it, then a finishing kernel writes the outputs.  threads: a multiple of 32 in [128, 256].  Returns the first
// CUDA error, 0 if none.
extern "C" int psys_window_collide(
    const float* pos, const float* vel, const float* radius, const float* restit,
    const int32_t* rel, const int32_t* count, const int32_t* ws,
    const int32_t* k_cap, const float* pairs, int64_t p_pad, float* pos_out,
    float* vel_out, int32_t* hit_out, int64_t n, int32_t w, int32_t k_static,
    float gx, float gy, float gz, float dt, float dt2, float backoff,
    int32_t split, int32_t threads, unsigned long long* keys, void* stream) {
  const int64_t rows = n / LANE;
  if (rows <= 0) return 0;
  if (threads < LANE || threads > MAX_THREADS || threads % 32 || split < 1 ||
      (split > 1 && keys == nullptr))
    return (int)cudaErrorInvalidValue;
  const Step st = {gx, gy, gz, dt, dt2, backoff};
  const size_t smem = (size_t)9 * w * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (split == 1) {
    err = allow_smem(window_collide_kernel<false>, smem);
    if (err != cudaSuccess) return (int)err;
    window_collide_kernel<false><<<(unsigned)rows, threads, smem, s>>>(
        pos, vel, radius, restit, rel, count, ws, k_cap, pairs, p_pad, pos_out,
        vel_out, hit_out, nullptr, n, w, k_static, st);
    return (int)cudaGetLastError();
  }
  err = allow_smem(window_collide_kernel<true>, smem);
  if (err != cudaSuccess) return (int)err;
  fill_keys_kernel<<<(unsigned)rows, LANE, 0, s>>>(keys);
  window_collide_kernel<true><<<dim3((unsigned)rows, (unsigned)split), threads, smem, s>>>(
      pos, vel, radius, restit, rel, count, ws, k_cap, pairs, p_pad, pos_out,
      vel_out, hit_out, keys, n, w, k_static, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_kernel<<<(unsigned)rows, LANE, 0, s>>>(pos, vel, radius, restit, rel, ws, pairs,
                                               p_pad, keys, pos_out, vel_out, hit_out,
                                               n, st);
  return (int)cudaGetLastError();
}
