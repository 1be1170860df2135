// The screen-space depth collision stage of the screen-space and hybrid
// methods (ops/cuda/screenspace_kernel.py wraps it; ops/screenspace.py::
// screen_space_collide_plain is its plain version and oracle).
//
// It replaces no TPU kernel: the JAX package runs this stage in XLA
// (ops/screenspace.py of that package, no Pallas kernel).  It was added
// because the stage, as some 160 eager elementwise PyTorch operations
// inside the hybrid runner's captured step, was the hybrid step's
// largest cost, each operation reading and writing [N] temporaries.
//
// Each lane, in one pass: read pos and vel, the radius, the restitution
// and the collision count; skip a lane at rest (speed2 == 0); project
// through view, then proj, ((m0 x + m1 y) + m2 z) + m3 w, as the plain
// version's _transform; divide by clip.w; map to [0, 1]; visible = inside
// the screen and in front of the camera.  Only a visible lane gathers
// its texel (depth, normal xyz), one 16 B load from the interleaved
// [H*W, 4] table (CameraTextures.texels; 16% less device time on an
// H100 than four loads from the planar [4, H*W] one), at the index of
// _pixel_index: the truncating cast (cvt.rzi.s32.f32, as PyTorch's
// .to(torch.int32)) first, then the clamp, so NaN, infinite or 1e38
// coordinates index inside the table.  Then eye distance,
// near-surface, into, collide, and the response in the plain version's
// order: normalize(vel), reflect, normalize, restitution * speed, minus
// gravity * dt, pos + vel' dt - vel dt.  The hybrid's mask is
// undecided = moving & (~visible | occluded).  Built with --fmad=false
// and IEEE division and square root, every lane rounds as the plain
// version's unfused operations do: bit for bit, sentinels included.
//
// Bound by bytes on the H100: 32 B of rows and 4 B of count in a lane,
// 24 B of pos and vel and 4 B of count out where a lane collides, the
// 1 B mask out every lane, and a 16 B texel a visible lane (the 1920 x
// 1080 table is 33 MB, inside the 50 MB L2).  One thread a lane in a
// grid-stride loop over as many blocks as the SMs hold at once: each of
// the row reads is coalesced, and the camera constants (two 4 x 4
// matrices, its position and forward, gravity), read from the device,
// are loaded once a thread.  Two entry points share the body:
//   * out of place (psys_screen_space_collide): fresh pos, vel, count for
//     every lane, and the mask where one is asked for;
//   * in place on the runner's carried rows (psys_screen_space_collide_
//     rows): rows 0-5 of the [8, N] rows and the count written only
//     where a lane collides (an unchanged lane keeps its bits because it
//     is never written), the mask on every lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Camera {
  float view[16], proj[16], cam_pos[3], cam_fwd[3], gravity[3];
};

__device__ __forceinline__ void load_camera(Camera& c, const float* __restrict__ view,
                                            const float* __restrict__ proj,
                                            const float* __restrict__ cam_pos,
                                            const float* __restrict__ cam_fwd,
                                            const float* __restrict__ gravity) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    c.view[k] = __ldg(view + k);
    c.proj[k] = __ldg(proj + k);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.cam_pos[k] = __ldg(cam_pos + k);
    c.cam_fwd[k] = __ldg(cam_fwd + k);
    c.gravity[k] = __ldg(gravity + k);
  }
}

// pos/vel: rows of stride n (pos x at pos[i], y at pos[n + i], ...).  In
// place (kInPlace) pos_o == pos, vel_o == vel and coll_o == coll.
template <bool kInPlace>
__global__ void __launch_bounds__(THREADS) screen_space_kernel(
    const float* pos, const float* vel, const float* __restrict__ radius,
    const float* __restrict__ rest, const int32_t* coll, float* pos_o, float* vel_o,
    int32_t* coll_o, uint8_t* __restrict__ und, const float* __restrict__ tex,
    int32_t h_px, int32_t w_px, const float* __restrict__ view,
    const float* __restrict__ proj, const float* __restrict__ cam_pos,
    const float* __restrict__ cam_fwd, const float* __restrict__ gravity, float dt,
    int64_t n) {
  Camera c;
  load_camera(c, view, proj, cam_pos, cam_fwd, gravity);
  const float wf = (float)w_px, hf = (float)h_px;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    const float px = pos[i], py = pos[n + i], pz = pos[2 * n + i];
    const float vx = vel[i], vy = vel[n + i], vz = vel[2 * n + i];
    const float speed2 = vx * vx + vy * vy + vz * vz;
    const bool moving = speed2 != 0.0f;
    bool collide = false, undecided = false;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (moving) {
      const float* m = c.view;
      const float e0 = m[0] * px + m[1] * py + m[2] * pz + m[3];
      const float e1 = m[4] * px + m[5] * py + m[6] * pz + m[7];
      const float e2 = m[8] * px + m[9] * py + m[10] * pz + m[11];
      const float e3 = m[12] * px + m[13] * py + m[14] * pz + m[15];
      const float* q = c.proj;
      const float c0 = q[0] * e0 + q[1] * e1 + q[2] * e2 + q[3] * e3;
      const float c1 = q[4] * e0 + q[5] * e1 + q[6] * e2 + q[7] * e3;
      const float c3 = q[12] * e0 + q[13] * e1 + q[14] * e2 + q[15] * e3;
      const float sx = (c0 / c3) * 0.5f + 0.5f;
      const float sy = (c1 / c3) * 0.5f + 0.5f;
      const bool inside = sx >= 0.0f && sx <= 1.0f && sy >= 0.0f && sy <= 1.0f;
      const float tx = px - c.cam_pos[0], ty = py - c.cam_pos[1], tz = pz - c.cam_pos[2];
      const bool in_front = c.cam_fwd[0] * tx + c.cam_fwd[1] * ty + c.cam_fwd[2] * tz > 0.0f;
      const bool visible = inside && in_front;
      bool occluded = false;
      if (visible) {
        const int32_t ix = min(max(__float2int_rz(sx * wf), 0), w_px - 1);
        const int32_t iy = min(max(__float2int_rz(sy * hf), 0), h_px - 1);
        const int64_t t = (int64_t)(iy * w_px + ix);
        const float4 texel = __ldg(reinterpret_cast<const float4*>(tex) + t);
        const float depth = texel.x;
        nx = texel.y;
        ny = texel.z;
        nz = texel.w;
        const float eye = sqrtf(tx * tx + ty * ty + tz * tz);
        const bool near_surface = fabsf(eye - depth) <= radius[i];
        const bool into = nx * vx + ny * vy + nz * vz < 0.0f;
        collide = near_surface && into;
        occluded = !near_surface && eye > depth;
      }
      undecided = !visible || occluded;
    }
    if (und) und[i] = undecided;
    if (collide) {
      // vel' = normalize(reflect(normalize(vel), n)) * (e * speed) - g dt;
      // pos' = pos + vel' dt - vel dt
      const float len = sqrtf(speed2);
      const float dx = vx / len, dy = vy / len, dz = vz / len;
      const float d2 = 2.0f * (dx * nx + dy * ny + dz * nz);
      const float rx = dx - d2 * nx, ry = dy - d2 * ny, rz = dz - d2 * nz;
      const float rl = sqrtf(rx * rx + ry * ry + rz * rz);
      const float es = rest[i] * sqrtf(speed2);
      const float wx = (rx / rl) * es - c.gravity[0] * dt;
      const float wy = (ry / rl) * es - c.gravity[1] * dt;
      const float wz = (rz / rl) * es - c.gravity[2] * dt;
      pos_o[i] = px + wx * dt - vx * dt;
      pos_o[n + i] = py + wy * dt - vy * dt;
      pos_o[2 * n + i] = pz + wz * dt - vz * dt;
      vel_o[i] = wx;
      vel_o[n + i] = wy;
      vel_o[2 * n + i] = wz;
      coll_o[i] = coll[i] + 1;
    } else if (!kInPlace) {
      pos_o[i] = px;
      pos_o[n + i] = py;
      pos_o[2 * n + i] = pz;
      vel_o[i] = vx;
      vel_o[n + i] = vy;
      vel_o[2 * n + i] = vz;
      coll_o[i] = coll[i];
    }
  }
}

unsigned grid_for(int64_t n, int32_t max_blocks) {
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  return (unsigned)blocks;
}

}  // namespace

// The constants (view, proj f32[16]; cam_pos, cam_fwd, gravity f32[3])
// are device pointers; tex is the interleaved f32[h_px * w_px, 4] table
// (16 B aligned); und may be null (no mask).  Returns cudaGetLastError().
extern "C" int psys_screen_space_collide(
    const float* pos, const float* vel, const float* radius, const float* rest,
    const int32_t* coll, float* pos_o, float* vel_o, int32_t* coll_o, uint8_t* und,
    const float* tex, int32_t h_px, int32_t w_px, const float* view, const float* proj,
    const float* cam_pos, const float* cam_fwd, const float* gravity, float dt, int64_t n,
    int32_t max_blocks, void* stream) {
  if (n > 0) {
    screen_space_kernel<false><<<grid_for(n, max_blocks), THREADS, 0, (cudaStream_t)stream>>>(
        pos, vel, radius, rest, coll, pos_o, vel_o, coll_o, und, tex, h_px, w_px, view, proj, cam_pos, cam_fwd, gravity, dt, n);
  }
  return (int)cudaGetLastError();
}

// In place on rows f32[8, n] (pos 0-2, vel 3-5, radius 6, restitution 7),
// the count coll i32[n] and the mask und bool[n].
extern "C" int psys_screen_space_collide_rows(
    float* rows, int32_t* coll, uint8_t* und, const float* tex, int32_t h_px, int32_t w_px,
    const float* view, const float* proj, const float* cam_pos, const float* cam_fwd,
    const float* gravity, float dt, int64_t n, int32_t max_blocks, void* stream) {
  if (n > 0) {
    screen_space_kernel<true><<<grid_for(n, max_blocks), THREADS, 0, (cudaStream_t)stream>>>(
        rows, rows + 3 * n, rows + 6 * n, rows + 7 * n, coll, rows, rows + 3 * n, coll, und,
        tex, h_px, w_px, view, proj, cam_pos, cam_fwd, gravity, dt, n);
  }
  return (int)cudaGetLastError();
}
