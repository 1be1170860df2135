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
// and masks k < count and rel + k < w per lane.  Here each thread loops
// k < min(count, k_cap, k_static, w - rel): the same candidates in the
// same order, so the result is identical.  The arithmetic is the TPU
// kernel's select form, operation for operation; built with
// --fmad=false and IEEE division and square root, it agrees with the
// plain PyTorch version (window_kernel.py) lane for lane.  1 / sqrt
// stands where the TPU kernel has rsqrt, as in the plain version.
//
// Design: one thread per particle, one 128-thread block per row (one
// window), candidate rows read straight from global memory (neighbours
// in a row share cells, so most reads hit L1/L2).  What bounds it on the
// H100 is operations: about 500 float operations per candidate against
// 36 B of candidate row.  Staging each row's window in shared memory
// (TMA / cp.async) and warp-cooperative candidate loads are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANE = 128;
constexpr int SUB = 8;

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

__global__ void __launch_bounds__(LANE) window_collide_kernel(
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ radius, const float* __restrict__ restit,
    const int32_t* __restrict__ rel, const int32_t* __restrict__ count,
    const int32_t* __restrict__ ws, const int32_t* __restrict__ k_cap,
    const float* __restrict__ pairs, int64_t p_pad, float* __restrict__ pos_out,
    float* __restrict__ vel_out, int32_t* __restrict__ hit_out, int64_t n,
    int32_t w, int32_t k_static, float gx, float gy, float gz, float dt,
    float dt2, float backoff) {
  const int64_t i = (int64_t)blockIdx.x * LANE + threadIdx.x;
  const float INF = __int_as_float(0x7f800000);
  const V3 p = {pos[i], pos[n + i], pos[2 * n + i]};
  const V3 v = {vel[i], vel[n + i], vel[2 * n + i]};
  const float r = radius[i];
  const float e = restit[i];
  const int32_t rs = rel[i];
  const int64_t base = (int64_t)ws[blockIdx.x] + rs;
  const int32_t kmax =
      min(min(count[i], k_cap[blockIdx.x / SUB]), min(k_static, w - rs));

  const float speed2 = dot(v, v);
  const float inv_speed = 1.0f / sqrtf(max_nan(speed2, 1e-37f));
  const V3 d = mul(v, inv_speed);
  const float seg2 = speed2 * dt2;

  float best_t2 = INF, best_t = INF;
  V3 bn = {0.f, 0.f, 0.f};
  bool any_hit = false;

  for (int32_t k = 0; k < kmax; ++k) {
    const float* row = pairs + base + k;
    const V3 v0 = {row[0], row[p_pad], row[2 * p_pad]};
    const V3 v1 = {row[3 * p_pad], row[4 * p_pad], row[5 * p_pad]};
    const V3 v2 = {row[6 * p_pad], row[7 * p_pad], row[8 * p_pad]};

    // triangle normal flipped against the motion (compute:169-171)
    V3 nr = cross(sub(v1, v0), sub(v2, v0));
    const float nlen = sqrtf(max_nan(dot(nr, nr), 1e-37f));
    nr = divs(nr, nlen);
    if (dot(nr, d) > 0.f) nr = neg(nr);
    const V3 off = mul(nr, r);

    float c_t2 = INF, c_t = INF;
    bool c_hit = false;

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

    // span check (compute:226-231), then the running nearest (strict <)
    const bool tri_hit = c_hit && (c_t2 <= seg2);
    if (!tri_hit) c_t2 = INF;
    if (c_t2 < best_t2) {
      best_t2 = c_t2;
      best_t = c_t;
      bn = nr;
    }
    any_hit = any_hit || tri_hit;
  }

  const bool hit = any_hit && (best_t2 < INF) && (speed2 != 0.f);

  // response (compute:332-352) + integrator (PSReactionUpdate:18-19)
  const V3 gdt = {gx * dt, gy * dt, gz * dt};
  const V3 col = add(p, mul(d, best_t));
  const float dn = dot(d, bn);
  V3 refl = sub(d, mul(bn, 2.0f * dn));
  refl = divs(refl, sqrtf(max_nan(dot(refl, refl), 1e-37f)));
  const V3 ce = sub(add(p, mul(v, dt)), col);
  const float col_to_end = sqrtf(max_nan(dot(ce, ce), 0.f));
  const float speed = sqrtf(speed2);
  const V3 new_vel = sub(mul(refl, e * speed), gdt);
  const V3 new_pos = add(sub(col, mul(d, backoff * r)), mul(refl, col_to_end * e));
  V3 ov = hit ? new_vel : v;
  V3 op = hit ? new_pos : p;
  ov = add(ov, gdt);
  op = add(op, mul(ov, dt));

  pos_out[i] = op.x;
  pos_out[n + i] = op.y;
  pos_out[2 * n + i] = op.z;
  vel_out[i] = ov.x;
  vel_out[n + i] = ov.y;
  vel_out[2 * n + i] = ov.z;
  hit_out[i] = hit ? 1 : 0;
}

}  // namespace

// n must be a multiple of 1024 (the wrapper checks); ws holds one window
// start per row of 128, k_cap one bound per block of 1024.  Returns
// cudaGetLastError().
extern "C" int psys_window_collide(
    const float* pos, const float* vel, const float* radius, const float* restit,
    const int32_t* rel, const int32_t* count, const int32_t* ws,
    const int32_t* k_cap, const float* pairs, int64_t p_pad, float* pos_out,
    float* vel_out, int32_t* hit_out, int64_t n, int32_t w, int32_t k_static,
    float gx, float gy, float gz, float dt, float dt2, float backoff,
    void* stream) {
  const int64_t rows = n / LANE;
  if (rows > 0) {
    window_collide_kernel<<<(unsigned)rows, LANE, 0, (cudaStream_t)stream>>>(
        pos, vel, radius, restit, rel, count, ws, k_cap, pairs, p_pad, pos_out,
        vel_out, hit_out, n, w, k_static, gx, gy, gz, dt, dt2, backoff);
  }
  return (int)cudaGetLastError();
}
