// Sorted block-window narrow phase + response + integration (kernel B1).
//
// Replaces the TPU kernel _kernel of the JAX package
// (particlesystemhybridcollisiondetection_tpu/ops/pallas/window_kernel.py,
// launched by window_collide_sorted), as the main pass of every sorted
// step, as the phase-1 kernel of the host-looped reference rescue and,
// through a second entry point (psys_window_collide_worklist, at the end),
// as the steps' rescue: a list of lanes compacted on the device, each
// alone, with no window.  That entry
// point stands for the phase-2 rescue of the TPU kernel's callers
// (core/step.py:840-1103 of the JAX package, which relaunches _kernel on
// rows of isolated lanes).  What bounds it is operations where the listed
// lanes are dense (the protocol's 2M particles) and bytes where they are
// few (the 1M scene: candidate rows and lane state); its design, a flat
// list of (lane, k) items spread over the card, is set out at the entry
// point's kernels.  The rescue's front (psys_rescue_front, near the
// end), which lists that entry point's lanes, is set out at its kernels.
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

// Rescue phase 2 (the worklist entry point): the listed lanes
// lanes[0 .. *n_lanes), each alone, on rows start + k, k < bound =
// min(count, k_static), of the pair table (a lane alone in its row needs
// no window).  The list's length stays in device memory and the grid does
// not depend on it.  The arithmetic is the row kernel's -- load_lane,
// eval_candidate, the nearest hit as the minimum of the 64-bit key
// (bits(t2) << 32) | k, respond_store -- so a listed lane gets the bits
// that the row kernel gives it alone in a row of 128
// (window_collide_worklist_plain holds that on the CPU).
//
// The work is a flat list of (listed lane, k) items spread evenly over
// the card, the row kernel's split design applied across the list.  A
// listed lane owns units = max(bound, 1) items: a lane with no candidate
// still owns one, its response and integrator.  Two kernels:
//
//   * worklist_scan_kernel: block c takes chunk c of the list (ceil(m /
//     scan blocks) entries), writes each entry's exclusive offset of
//     units within its chunk to off[] and the chunk's sum to bsum[c]; it
//     also resets the edge slots below.
//   * worklist_collide_kernel, a grid sized from occupancy: every block
//     scans bsum[] into chunk bases in shared memory (the total T), takes
//     the items [T b / G, T (b + 1) / G), finds the entries that own its
//     first and last item (a binary search of the bases, then off[]
//     within a chunk, 32 probes a round), and walks those entries in
//     batches of WL_THREADS: each
//     thread stages one entry (lane state, first row, the entry's items
//     inside the share), a block scan of the clipped counts, then all
//     threads walk the batch's items with a stride of the block size and
//     fold each hit's key by atomicMin into the entry's shared slot.
//     A lane wholly inside the share is finished by its staging thread
//     (candidate k* evaluated once more, response, integrator).  A lane
//     across a share's edge folds its key into a global slot (the share
//     of its first item: one lane a slot) and adds its items to the
//     slot's count; the block that brings the count to the lane's units
//     finishes it (__threadfence between the two atomics).
//
// What bounds it on the H100: by the table's count (about 550 float
// operations a candidate, each one), operations where lanes are dense
// (the protocol's 3.2M candidates) and bytes where they are few (36 B of
// pair row a distinct row, the lane state); in fact the instructions
// issued, since the IEEE divisions and square roots of the --fmad=false
// build expand to about 600 FP32 instructions a candidate in the SASS.
// One warp a lane (the first version of this entry point) left a dense
// lane's candidates to 32 threads, a serial tail on lane 0, and a
// quarter of the card's warps; here no thread waits for a dense lane,
// the tail is one thread a lane, and the grid fills what occupancy
// allows.
constexpr int WL_THREADS = 256;
// most blocks of the scan kernel (chunk bases fit one per thread)
constexpr int WL_SCAN_MAX = WL_THREADS;
// blocks an SM the collide kernel is held to: more resident warps to
// hide the candidate test's dependent latency; ptxas keeps it to 64
// registers with a few bytes spilled outside the walk (its -Xptxas -v
// report, which chip_smoke.py prints)
constexpr int WL_MIN_BLOCKS = 4;

// Exclusive scan of v over the block (every thread calls it, WL_THREADS
// of them); total gets the block's sum.  s_w: WL_THREADS / 32 slots.
template <typename T>
__device__ __forceinline__ T block_scan(T v, T* s_w, T& total) {
  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, incl, o);
    if (wl >= o) incl += y;
  }
  if (wl == 31) s_w[warp] = incl;
  __syncthreads();
  T base = 0, sum = 0;
  for (int q = 0; q < WL_THREADS / 32; ++q) {
    const T w = s_w[q];
    if (q < warp) base += w;
    sum += w;
  }
  __syncthreads();
  total = sum;
  return base + incl - v;
}

__device__ __forceinline__ int32_t wl_bound(const int32_t* __restrict__ count,
                                            int64_t i, int32_t k_static) {
  return max(0, min(count[i], k_static));
}

__global__ void __launch_bounds__(WL_THREADS) worklist_scan_kernel(
    const int32_t* __restrict__ count, const int32_t* __restrict__ lanes,
    const int32_t* __restrict__ n_lanes, int32_t k_static, int32_t* __restrict__ off,
    int32_t* __restrict__ bsum, unsigned long long* __restrict__ edge_key,
    uint32_t* __restrict__ edge_cnt, int32_t blocks) {
  __shared__ int32_t s_w[WL_THREADS / 32];
  const int32_t m = *n_lanes;
  if (m == 0) return;
  for (int32_t s = blockIdx.x * WL_THREADS + threadIdx.x; s < blocks;
       s += gridDim.x * WL_THREADS) {
    edge_key[s] = NO_HIT;
    edge_cnt[s] = 0;
  }
  const int32_t chunk = (m + gridDim.x - 1) / gridDim.x;
  const int32_t j0 = (int32_t)blockIdx.x * chunk, j1 = min(m, j0 + chunk);
  int32_t run = 0;
  for (int32_t jb = j0; jb < j1; jb += WL_THREADS) {
    const int32_t j = jb + threadIdx.x;
    const int32_t u = j < j1 ? max(1, wl_bound(count, lanes[j], k_static)) : 0;
    int32_t tile;
    const int32_t excl = block_scan(u, s_w, tile);
    if (j < j1) off[j] = run + excl;
    run += tile;
  }
  if (threadIdx.x == 0) bsum[blockIdx.x] = run;
}

__global__ void __launch_bounds__(WL_THREADS, WL_MIN_BLOCKS) worklist_collide_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ radius, const float* __restrict__ restit,
    const int32_t* __restrict__ start, const int32_t* __restrict__ count,
    const int32_t* __restrict__ lanes, const int32_t* __restrict__ n_lanes,
    const int32_t* __restrict__ off, const int32_t* __restrict__ bsum,
    int32_t scan_blocks, unsigned long long* __restrict__ edge_key,
    uint32_t* __restrict__ edge_cnt, const float* __restrict__ pairs, int64_t p_pad,
    float* __restrict__ pos_out, float* __restrict__ vel_out,
    int32_t* __restrict__ hit_out, int64_t n, int32_t k_static, Step st) {
  __shared__ long long s_base[WL_SCAN_MAX + 1];  // chunk bases, then T
  __shared__ long long s_w64[WL_THREADS / 32];
  __shared__ int32_t s_w[WL_THREADS / 32];
  __shared__ int32_t s_own[2];
  // the batch's entries: lane state, first row and first k of the share,
  // candidates left from that k, offset in the batch's items, nearest key
  __shared__ float s_px[WL_THREADS], s_py[WL_THREADS], s_pz[WL_THREADS];
  __shared__ float s_dx[WL_THREADS], s_dy[WL_THREADS], s_dz[WL_THREADS];
  __shared__ float s_r[WL_THREADS], s_seg2[WL_THREADS];
  __shared__ int32_t s_row[WL_THREADS], s_klo[WL_THREADS], s_left[WL_THREADS];
  __shared__ int32_t s_off[WL_THREADS];
  __shared__ unsigned long long s_best[WL_THREADS];

  const float INF = __int_as_float(0x7f800000);
  const int tid = threadIdx.x;
  const int32_t m = *n_lanes;
  if (m == 0) return;
  const int32_t chunk = (m + scan_blocks - 1) / scan_blocks;
  const int32_t c_last = (m - 1) / chunk;  // the last chunk holding entries
  long long total;
  const long long b = tid < scan_blocks ? bsum[tid] : 0;
  const long long base = block_scan(b, s_w64, total);
  if (tid < scan_blocks) s_base[tid] = base;
  if (tid == 0) s_base[scan_blocks] = total;
  __syncthreads();
  const long long G = gridDim.x;
  const long long s_b = total * blockIdx.x / G, e_b = total * (blockIdx.x + 1) / G;
  if (s_b == e_b) return;

  // the entry owning item x: the largest j with base[j / chunk] + off[j]
  // <= x (units >= 1, so the offsets rise strictly).  Warp 0 finds the
  // owner of the share's first item, warp 1 of its last: the chunk by a
  // binary search of the bases, then within the chunk 32 probes a round
  // (the probes at or below x are a prefix of the warp), so a chunk of
  // up to 32 entries costs one round of loads
  if (tid < 64) {
    const int wl = tid & 31;
    const long long x = tid < 32 ? s_b : e_b - 1;
    int lo = 0, hi = c_last;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (s_base[mid] <= x) lo = mid; else hi = mid - 1;
    }
    const long long rx = x - s_base[lo];
    int32_t a = lo * chunk, z = min(m, a + chunk);  // owner in [a, z), off[a] = 0
    while (z - a > 1) {
      const int32_t step = (z - a + 31) / 32;
      const int32_t p = a + wl * step;
      const unsigned below = __ballot_sync(0xffffffffu, p < z && off[p] <= rx);
      a += (__popc(below) - 1) * step;
      z = min(z, a + step);
    }
    if (wl == 0) s_own[tid >> 5] = a;
  }
  __syncthreads();
  const int32_t o_first = s_own[0], o_last = s_own[1];

  for (int32_t jb = o_first; jb <= o_last; jb += WL_THREADS) {
    const int32_t j = jb + tid;
    const bool own = j <= o_last;
    const int nv = min(WL_THREADS, o_last - jb + 1);
    int64_t i = 0;
    long long g = 0;
    int32_t units = 0, klo = 0, khi = 0;
    if (own) {
      i = lanes[j];
      const int32_t bound = wl_bound(count, i, k_static);
      units = max(1, bound);
      g = s_base[j / chunk] + off[j];
      klo = (int32_t)(max(g, s_b) - g);
      khi = (int32_t)(min(g + units, e_b) - g);
      const Lane l = load_lane(pos, vel, radius, restit, n, i, st.dt2);
      s_px[tid] = l.p.x;
      s_py[tid] = l.p.y;
      s_pz[tid] = l.p.z;
      s_dx[tid] = l.d.x;
      s_dy[tid] = l.d.y;
      s_dz[tid] = l.d.z;
      s_r[tid] = l.r;
      s_seg2[tid] = l.seg2;
      s_row[tid] = start[i] + klo;
      s_klo[tid] = klo;
      s_left[tid] = bound - klo;  // <= 0: the one item of a lane with none
      s_best[tid] = NO_HIT;
    }
    int32_t items;
    const int32_t excl = block_scan(own ? khi - klo : 0, s_w, items);
    s_off[tid] = excl;
    __syncthreads();

    for (int32_t x = tid; x < items; x += WL_THREADS) {
      int o = 0, hi = nv - 1;
      while (o < hi) {
        const int mid = (o + hi + 1) >> 1;
        if (s_off[mid] <= x) o = mid; else hi = mid - 1;
      }
      const int32_t q = x - s_off[o];
      if (q < s_left[o]) {
        const float* r = pairs + s_row[o] + q;
        const V3 v0 = {r[0], r[p_pad], r[2 * p_pad]};
        const V3 v1 = {r[3 * p_pad], r[4 * p_pad], r[5 * p_pad]};
        const V3 v2 = {r[6 * p_pad], r[7 * p_pad], r[8 * p_pad]};
        float c_t2, c_t;
        bool c_hit;
        V3 nr;
        eval_candidate({s_px[o], s_py[o], s_pz[o]}, {s_dx[o], s_dy[o], s_dz[o]},
                       s_r[o], v0, v1, v2, c_t2, c_t, c_hit, nr);
        // span check (compute:226-231); a hit with t2 == INF never wins
        if (c_hit && (c_t2 <= s_seg2[o]) && (c_t2 < INF)) {
          const unsigned long long key =
              ((unsigned long long)__float_as_uint(c_t2) << 32) | (uint32_t)(s_klo[o] + q);
          atomicMin(&s_best[o], key);
        }
      }
    }
    __syncthreads();

    if (own) {
      unsigned long long key = s_best[tid];
      bool finish = true;
      if (klo > 0 || khi < units) {
        // across a share's edge: the slot of the share holding item g
        const int32_t slot = (int32_t)min(G - 1, ((g + 1) * G - 1) / total);
        if (key != NO_HIT) atomicMin(&edge_key[slot], key);
        __threadfence();
        const uint32_t part = (uint32_t)(khi - klo);
        finish = atomicAdd(&edge_cnt[slot], part) + part == (uint32_t)units;
        if (finish) {
          __threadfence();
          key = atomicMin(&edge_key[slot], NO_HIT);  // reads the folded key
        }
      }
      if (finish) {
        const Lane l = load_lane(pos, vel, radius, restit, n, i, st.dt2);
        const bool found = key != NO_HIT;
        V3 v0 = {0.f, 0.f, 0.f}, v1 = v0, v2 = v0;
        if (found) {
          const float* r = pairs + start[i] + (int32_t)(uint32_t)key;
          v0 = {r[0], r[p_pad], r[2 * p_pad]};
          v1 = {r[3 * p_pad], r[4 * p_pad], r[5 * p_pad]};
          v2 = {r[6 * p_pad], r[7 * p_pad], r[8 * p_pad]};
        }
        respond_store(l, found, v0, v1, v2, st, pos_out, vel_out, hit_out, n, i);
      }
    }
    __syncthreads();  // the next batch reuses the shared arrays
  }
}

// The rescue's front (rescue_front_kernel, then rescue_list_kernel): what
// the steps' rescue does over all N sorted lanes before its worklist.
// Each lane to look up gets its cell's (start, count) by the midpoint
// lookup and the fit test (start % 128 + count <= the rescue window, or
// no candidate); the overflow lanes are counted; the lanes that overflow
// and fit are listed in lane order, with their count.  It replaces no TPU
// kernel: the JAX package leaves this to XLA.  Its plain version is
// core/step.py's _rescue_front_plain (_phase2_plan, compact_lanes and the
// overflow's sum, the CPU route of _device_rescue), whose bits it gives:
// the list, both counts, (start, count) at every listed lane and, with
// the fit mask asked for (scenes where the packed phase can run), the
// mask at every lane.  The lookup is ops/grid.py's lookup_pos, cell_coords and cell_index in their
// order of operations: pos + vel * (dt / 2), minus the origin, times 1 /
// cell size, floor, a clamp in float that keeps a NaN (whose cast then
// gives 0, as PyTorch's cast on the card does), the linear id.
//
// What bounds it on the H100: bytes, and few of them.  Every lane's
// overflow flag (1 B) is read; only a lane to look up reads its position
// and velocity (24 B) and its cell's (start, count) (8 B), and only a
// listed lane writes its (start, count) and its list entry (12 B); a
// ballot word of 32 lanes is written and read.  Without the mask that is
// about 5 MB at the protocol's 2M lanes with 55,000 of them overflowing,
// 1.5 us of memory time: the eager front it replaces made some 35
// launches over full-N temporaries.  The design keeps it to two
// launches whose grids, one block a tile of RF_TILE lanes, depend on N
// alone, never on the list:
//
//   * rescue_front_kernel: a thread takes RF_ITEMS lanes, a warp 32
//     neighbouring ones at a time.  All of a thread's loads of one kind go
//     out before any is used (flags, then rows, then the table), so the
//     chain of dependent loads is three deep whatever RF_ITEMS is.  A
//     warp's ballot of "listed" is one word of a bitmap; the block writes
//     its tile's counts of listed and overflow lanes.
//   * rescue_list_kernel: a block sums the listed counts of the tiles
//     before it (its first slot in the list), scans its tile's words, and
//     each thread writes its listed lanes at that slot + the bits of the
//     words before its word + the bits below its own: the list in lane
//     order.  The last block writes the two counts.  Slots past the count
//     are left unwritten: the worklist kernels read lanes[j] for j below
//     it only.
constexpr int RF_THREADS = WL_THREADS;  // block_scan's block
constexpr int RF_ITEMS = 8;
constexpr int RF_TILE = RF_THREADS * RF_ITEMS;
constexpr int RF_WORDS = RF_TILE / 32;

// The grid of the lookup (ops/grid.py::GridMeta), each value as the
// float32 the plain version computes with.
struct CellGrid {
  float ox, oy, oz;  // the origin
  float inv_h;       // 1 / cell size
  float half_dt;     // dt * 0.5
  int32_t dx, dy, dz;
};

// torch.clamp(c, 0, d - 1) on the card (a NaN stays NaN), then the cast
// to int32.
__device__ __forceinline__ int32_t clamp_cell(float c, int32_t d) {
  if (!isnan(c)) c = fminf(fmaxf(c, 0.f), (float)(d - 1));
  return (int32_t)c;
}

template <bool WITH_FIT>
__global__ void __launch_bounds__(RF_THREADS) rescue_front_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const uint8_t* __restrict__ overflow, const int32_t* __restrict__ cells2,
    int64_t n_cells, CellGrid g, int32_t w, int64_t n, int32_t* __restrict__ start,
    int32_t* __restrict__ count, uint8_t* __restrict__ fit_out,
    uint32_t* __restrict__ words, int32_t* __restrict__ tiles) {
  __shared__ int32_t s_listed[RF_THREADS / 32], s_over[RF_THREADS / 32];
  const int64_t first = (int64_t)blockIdx.x * RF_TILE + threadIdx.x;
  bool ovf[RF_ITEMS], look[RF_ITEMS];
#pragma unroll
  for (int i = 0; i < RF_ITEMS; ++i) {
    const int64_t l = first + i * RF_THREADS;
    ovf[i] = l < n && overflow[l] != 0;
    look[i] = WITH_FIT ? l < n : ovf[i];
  }
  float mx[RF_ITEMS], my[RF_ITEMS], mz[RF_ITEMS];
#pragma unroll
  for (int i = 0; i < RF_ITEMS; ++i) {
    const int64_t l = first + i * RF_THREADS;
    if (look[i]) {
      const float vx = vel[l] * g.half_dt, vy = vel[n + l] * g.half_dt,
                  vz = vel[2 * n + l] * g.half_dt;
      mx[i] = pos[l] + vx;
      my[i] = pos[n + l] + vy;
      mz[i] = pos[2 * n + l] + vz;
    }
  }
  int32_t s[RF_ITEMS], c[RF_ITEMS];
#pragma unroll
  for (int i = 0; i < RF_ITEMS; ++i) {
    if (look[i]) {
      const int32_t cx = clamp_cell(floorf((mx[i] - g.ox) * g.inv_h), g.dx);
      const int32_t cy = clamp_cell(floorf((my[i] - g.oy) * g.inv_h), g.dy);
      const int32_t cz = clamp_cell(floorf((mz[i] - g.oz) * g.inv_h), g.dz);
      const int32_t cid = (cx * g.dy + cy) * g.dz + cz;
      s[i] = cells2[cid];
      c[i] = cells2[n_cells + cid];
    }
  }
  int32_t listed = 0, over = 0;
#pragma unroll
  for (int i = 0; i < RF_ITEMS; ++i) {
    const int64_t l = first + i * RF_THREADS;
    bool take = false;
    if (look[i]) {
      // start % 128 with Python's sign rule is its low seven bits
      const bool fit = c[i] <= 0 || (s[i] & (LANE - 1)) + c[i] <= w;
      if (WITH_FIT) fit_out[l] = fit;
      take = ovf[i] && fit;
      if (take) {
        start[l] = s[i];
        count[l] = c[i];
      }
    }
    const uint32_t word = __ballot_sync(0xffffffffu, take);
    if ((threadIdx.x & 31) == 0 && l < n) words[l >> 5] = word;
    listed += __popc(word);
    over += __popc(__ballot_sync(0xffffffffu, ovf[i]));
  }
  if ((threadIdx.x & 31) == 0) {
    s_listed[threadIdx.x >> 5] = listed;
    s_over[threadIdx.x >> 5] = over;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t tl = 0, to = 0;
    for (int q = 0; q < RF_THREADS / 32; ++q) {
      tl += s_listed[q];
      to += s_over[q];
    }
    tiles[blockIdx.x] = tl;
    tiles[gridDim.x + blockIdx.x] = to;
  }
}

__global__ void __launch_bounds__(RF_THREADS) rescue_list_kernel(
    const uint32_t* __restrict__ words, const int32_t* __restrict__ tiles, int64_t n,
    int32_t* __restrict__ lanes, int32_t* __restrict__ counts) {
  __shared__ int32_t s_w[RF_THREADS / 32];
  __shared__ uint32_t s_word[RF_WORDS];
  __shared__ int32_t s_off[RF_WORDS];
  const int32_t b = blockIdx.x, nt = gridDim.x;
  const bool last = b == nt - 1;  // the same in the whole block
  int32_t before = 0, over = 0, slot0, n_over = 0;
  for (int32_t t = threadIdx.x; t < b; t += RF_THREADS) before += tiles[t];
  block_scan(before, s_w, slot0);
  if (last) {
    for (int32_t t = threadIdx.x; t < nt; t += RF_THREADS) over += tiles[nt + t];
    block_scan(over, s_w, n_over);
  }
  const int64_t w0 = (int64_t)b * RF_WORDS;
  uint32_t word = 0;
  if (threadIdx.x < RF_WORDS && w0 + threadIdx.x < (n + 31) / 32) word = words[w0 + threadIdx.x];
  int32_t in_tile;
  const int32_t off = block_scan((int32_t)__popc(word), s_w, in_tile);
  if (threadIdx.x < RF_WORDS) {
    s_word[threadIdx.x] = word;
    s_off[threadIdx.x] = off;
  }
  __syncthreads();
  const int64_t lane0 = (int64_t)b * RF_TILE;
  const uint32_t below = (1u << (threadIdx.x & 31)) - 1u;
#pragma unroll
  for (int i = 0; i < RF_ITEMS; ++i) {
    const int j = i * RF_THREADS + threadIdx.x;  // the lane within the tile
    const uint32_t wd = s_word[j >> 5];
    if ((wd >> (j & 31)) & 1u)
      lanes[slot0 + s_off[j >> 5] + __popc(wd & below)] = (int32_t)(lane0 + j);
  }
  if (last && threadIdx.x == 0) {
    counts[0] = slot0 + in_tile;
    counts[1] = n_over;
  }
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

// Rescue phase 2: lanes[0 .. *n_lanes) (sorted-lane indices; *n_lanes in
// device memory) each alone.  start/count: each lane's rows in the pair
// table.  Two launches: the scan kernel (scan_blocks blocks, at most
// 256) and the collide kernel (`blocks` blocks of 256 threads, from
// psys_window_worklist_occupancy).  Scratch: `scratch` i32[n +
// scan_blocks + blocks] (each entry's offset within its chunk, the
// chunks' sums, the edge slots' counts), edge_key u64[blocks]; neither
// needs filling.  Writes pos_out/vel_out/hit_out at the listed lanes
// only.  Returns the first CUDA error, 0 if none.
extern "C" int psys_window_collide_worklist(
    const float* pos, const float* vel, const float* radius, const float* restit,
    const int32_t* start, const int32_t* count, const int32_t* lanes,
    const int32_t* n_lanes, const float* pairs, int64_t p_pad, float* pos_out,
    float* vel_out, int32_t* hit_out, int64_t n, int32_t k_static, float gx, float gy,
    float gz, float dt, float dt2, float backoff, int32_t blocks, int32_t scan_blocks,
    int32_t* scratch, unsigned long long* edge_key, void* stream) {
  if (blocks < 1 || scan_blocks < 1 || scan_blocks > WL_SCAN_MAX)
    return (int)cudaErrorInvalidValue;
  const Step st = {gx, gy, gz, dt, dt2, backoff};
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* off = scratch;
  int32_t* bsum = scratch + n;
  uint32_t* edge_cnt = (uint32_t*)(scratch + n + scan_blocks);
  worklist_scan_kernel<<<(unsigned)scan_blocks, WL_THREADS, 0, s>>>(
      count, lanes, n_lanes, k_static, off, bsum, edge_key, edge_cnt, blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  worklist_collide_kernel<<<(unsigned)blocks, WL_THREADS, 0, s>>>(
      pos, vel, radius, restit, start, count, lanes, n_lanes, off, bsum, scan_blocks,
      edge_key, edge_cnt, pairs, p_pad, pos_out, vel_out, hit_out, n, k_static, st);
  return (int)cudaGetLastError();
}

// The rescue's front over the n sorted lanes (pos/vel f32[3, n], overflow
// bool[n]; cells2 i32[2, n_cells], the grid g, the rescue window w):
// start/count i32[n] at every listed lane, fit bool[n] at every lane
// unless null, lanes i32[n] (the listed lanes first, the slots past them
// unwritten), counts i32[2] (listed, overflow).  Scratch: `scratch_len`
// i32, at least ceil(n / 32) + 2 ceil(n / RF_TILE) (a bitmap word of 32
// lanes, a tile's counts), filled by the first kernel before the second
// reads it.  n < 2^31.  Returns the first CUDA error, 0 if none.
extern "C" int psys_rescue_front(const float* pos, const float* vel,
                                 const uint8_t* overflow, const int32_t* cells2,
                                 int64_t n_cells, float ox, float oy, float oz,
                                 float inv_h, float half_dt, int32_t dx, int32_t dy,
                                 int32_t dz, int32_t w, int64_t n, int32_t* start,
                                 int32_t* count, uint8_t* fit, int32_t* lanes,
                                 int32_t* counts, int32_t* scratch, int64_t scratch_len,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaMemsetAsync(counts, 0, 2 * sizeof(int32_t), s);
  const int64_t n_words = (n + 31) / 32, n_tiles = (n + RF_TILE - 1) / RF_TILE;
  if (n >= ((int64_t)1 << 31) || scratch_len < n_words + 2 * n_tiles)
    return (int)cudaErrorInvalidValue;
  const CellGrid g = {ox, oy, oz, inv_h, half_dt, dx, dy, dz};
  uint32_t* words = (uint32_t*)scratch;
  int32_t* tiles = scratch + n_words;
  if (fit != nullptr)
    rescue_front_kernel<true><<<(unsigned)n_tiles, RF_THREADS, 0, s>>>(
        pos, vel, overflow, cells2, n_cells, g, w, n, start, count, fit, words, tiles);
  else
    rescue_front_kernel<false><<<(unsigned)n_tiles, RF_THREADS, 0, s>>>(
        pos, vel, overflow, cells2, n_cells, g, w, n, start, count, fit, words, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rescue_list_kernel<<<(unsigned)n_tiles, RF_THREADS, 0, s>>>(words, tiles, n, lanes,
                                                              counts);
  return (int)cudaGetLastError();
}

// The worklist collide kernel's resident blocks per SM at its block size
// (the grid is that times the SM count), its registers a thread and its
// local memory (spills) in bytes a thread.  Returns the CUDA error, 0 if
// none.
extern "C" int psys_window_worklist_occupancy(int32_t* blocks_per_sm, int32_t* regs,
                                              int32_t* local_bytes) {
  int nb = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &nb, worklist_collide_kernel, WL_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, worklist_collide_kernel);
  if (err != cudaSuccess) return (int)err;
  *blocks_per_sm = nb;
  *regs = attr.numRegs;
  *local_bytes = (int32_t)attr.localSizeBytes;
  return 0;
}
