// Native acceleration-structure tier (host side).
//
// A copy of the JAX package's native tier, so the PyTorch port builds the
// same structures without importing that package:
//
//   * sphere-BVH build over a triangle soup (Morton-ordered top levels +
//     SAH leaf splits, the reference's construction, ParticleSys.cs:1103-1305)
//     and swept-sphere-vs-BVH nearest-hit queries (offset planes, edge
//     cylinders, vertex spheres; explicit traversal stack,
//     SpatialStructureCollisionDetection.compute:235-356): the exact CPU
//     oracle for validation at scale.  Sampling is deterministic.
//   * multithreaded uniform-grid CSR binning, bit-identical to
//     ops/grid.py's NumPy binning (compiled with -ffp-contract=off, see
//     the L2 prefilter below).
//
// Exposed as a plain C ABI consumed via ctypes.


#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

static inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float len(V3 a) { return std::sqrt(dot(a, a)); }
static inline V3 norm(V3 a) {
  float l = len(a);
  return l > 0 ? a * (1.0f / l) : V3{0, 0, 0};
}

struct Tri {
  V3 v[3];
  V3 centroid;
  uint32_t morton;
};

struct Node {
  V3 center{0, 0, 0};
  float radius = 0;
  // leaf: first = -first_tri_index, second = count; internal: child ids
  int32_t a = 0, b = 0;
  bool leaf() const { return a <= 0; }
};

struct Bvh {
  std::vector<Node> nodes;
  std::vector<Tri> tris;
  std::vector<int64_t> order;  // sorted-tri -> original index
};

uint32_t expand_bits(uint32_t v) {
  v &= 0x3ff;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

uint32_t morton3(float fx, float fy, float fz) {
  // 10 bits per axis over the unit cube (1024^3 grid, matching the
  // reference's grid resolution, ParticleSys.cs:858).
  auto q = [](float f) {
    int v = (int)std::floor(f * 1024.0f);
    return (uint32_t)std::min(std::max(v, 0), 1023);
  };
  return (expand_bits(q(fx)) << 2) | (expand_bits(q(fy)) << 1) | expand_bits(q(fz));
}

void bounding_sphere(const Tri* tris, const int64_t* idx, int64_t n, V3& c, float& r) {
  // centroid of all vertices, then max distance (+pad) -- the same
  // two-pass construction the reference uses (ParticleSys.cs:889-926).
  double sx = 0, sy = 0, sz = 0;
  for (int64_t i = 0; i < n; i++)
    for (int k = 0; k < 3; k++) {
      sx += tris[idx[i]].v[k].x;
      sy += tris[idx[i]].v[k].y;
      sz += tris[idx[i]].v[k].z;
    }
  double cnt = std::max<int64_t>(3 * n, 1);
  c = {(float)(sx / cnt), (float)(sy / cnt), (float)(sz / cnt)};
  float best = 0;
  for (int64_t i = 0; i < n; i++)
    for (int k = 0; k < 3; k++) {
      float d = len(tris[idx[i]].v[k] - c);
      best = std::max(best, d);
    }
  r = best + 1e-3f;
}

float sphere_area(float r) { return 4.0f * 3.14159265358979f * r * r; }

struct BuildCtx {
  std::vector<Tri>* tris;
  std::vector<int64_t>* order;  // permutation being refined in place
  std::vector<Node>* nodes;
  int32_t max_level;
  int32_t max_leaf;
  int32_t sah_samples;
};

void split_recursive(BuildCtx& ctx, int32_t node_id, int64_t first, int64_t count,
                     int32_t level) {
  auto& nodes = *ctx.nodes;
  auto& tris = *ctx.tris;
  auto& ord = *ctx.order;
  {
    V3 c;
    float r;
    bounding_sphere(tris.data(), ord.data() + first, count, c, r);
    if ((int32_t)nodes.size() <= node_id) nodes.resize(node_id + 1);
    nodes[node_id].center = c;
    nodes[node_id].radius = r;
    nodes[node_id].a = (int32_t)-first;
    nodes[node_id].b = (int32_t)count;
  }
  if (count <= ctx.max_leaf || level >= ctx.max_level) return;

  // Sampled SAH over centroid positions: deterministic evenly-spaced
  // samples (cost = count * sphere area per side, as in
  // ParticleSys.cs:1257-1281).
  int samples = std::min<int64_t>(ctx.sah_samples, count);
  float best_cost = 3.4e38f;
  int best_axis = -1;
  float best_pos = 0;
  std::vector<int64_t> side_idx;
  for (int s = 0; s < samples; s++) {
    int64_t pick = first + (int64_t)((s + 0.5) * count / samples);
    const Tri& t = tris[ord[pick]];
    for (int axis = 0; axis < 3; axis++) {
      float pos = axis == 0 ? t.centroid.x : axis == 1 ? t.centroid.y : t.centroid.z;
      // evaluate
      int64_t c0 = 0, c1 = 0;
      side_idx.clear();
      std::vector<int64_t> left, right;
      for (int64_t i = first; i < first + count; i++) {
        const Tri& u = tris[ord[i]];
        float v = axis == 0 ? u.centroid.x : axis == 1 ? u.centroid.y : u.centroid.z;
        if (v < pos) {
          left.push_back(ord[i]);
          c0++;
        } else {
          right.push_back(ord[i]);
          c1++;
        }
      }
      if (c0 == 0 || c1 == 0) continue;
      V3 cc;
      float r0, r1;
      bounding_sphere(tris.data(), left.data(), c0, cc, r0);
      bounding_sphere(tris.data(), right.data(), c1, cc, r1);
      float cost = c0 * sphere_area(r0) + c1 * sphere_area(r1);
      if (cost < best_cost) {
        best_cost = cost;
        best_axis = axis;
        best_pos = pos;
      }
    }
  }
  if (best_axis < 0) return;  // degenerate: keep as leaf

  auto mid = std::partition(ord.begin() + first, ord.begin() + first + count,
                            [&](int64_t ti) {
                              const Tri& u = tris[ti];
                              float v = best_axis == 0   ? u.centroid.x
                                        : best_axis == 1 ? u.centroid.y
                                                         : u.centroid.z;
                              return v < best_pos;
                            });
  int64_t n_left = mid - (ord.begin() + first);
  if (n_left == 0 || n_left == count) return;

  int32_t left_id = (int32_t)nodes.size();
  nodes.resize(nodes.size() + 2);
  nodes[node_id].a = left_id;
  nodes[node_id].b = left_id + 1;
  split_recursive(ctx, left_id, first, n_left, level + 1);
  split_recursive(ctx, left_id + 1, first + n_left, count - n_left, level + 1);
}

// exact swept-sphere narrow phase (scalar mirror of ops/narrow_phase.py)
bool ray_tri(V3 ro, V3 rd, V3 v0, V3 v1, V3 v2, float& t) {
  V3 v1v0 = v1 - v0, v2v0 = v2 - v0, rov0 = ro - v0;
  V3 n = cross(v1v0, v2v0);
  V3 q = cross(rov0, rd);
  float d = 1.0f / dot(rd, n);
  float u = d * dot(q * -1.0f, v2v0);
  float v = d * dot(q, v1v0);
  t = d * dot(n * -1.0f, rov0);
  return !(u < 0.0f || v < 0.0f || (u + v) > 1.0f);
}

bool ray_cyl(V3 ro, V3 rd, V3 a, V3 b, float r, float& t) {
  V3 ba = b - a, oc = ro - a;
  float baba = dot(ba, ba), bard = dot(ba, rd), baoc = dot(ba, oc);
  float k2 = baba - bard * bard;
  float k1 = baba * dot(oc, rd) - baoc * bard;
  float k0 = baba * dot(oc, oc) - baoc * baoc - r * r * baba;
  float h = k1 * k1 - k2 * k0;
  if (h < 0.0f) return false;
  float hs = std::sqrt(h);
  float tb = (-k1 - hs) / k2;
  float y = baoc + tb * bard;
  if (y > 0.0f && y < baba) {
    t = tb;
    return true;
  }
  float yc = y < 0.0f ? 0.0f : baba;
  float tc = (yc - baoc) / bard;
  V3 q = oc + rd * tc - ba * (yc / baba);
  if (dot(q, q) < r * r) {
    t = tc;
    return true;
  }
  return false;
}

bool ray_sph(V3 ro, V3 rd, V3 c, float r, float& t) {
  V3 oc = c - ro;
  float proj = dot(oc, rd);
  float disc = r * r - (dot(oc, oc) - proj * proj);
  if (disc < 0.0f) return false;
  t = proj - std::sqrt(disc);
  return true;
}

bool particle_tri(V3 p0, V3 rd, float seg2, const Tri& tri, float radius,
                  float& t_out) {
  V3 n = norm(cross(tri.v[1] - tri.v[0], tri.v[2] - tri.v[0]));
  if (dot(n, rd) > 0.0f) n = n * -1.0f;
  V3 off = n * radius;
  bool any = false;
  float best2 = 3.4e38f, best_t = 0, t;
  auto consider = [&](bool hit) {
    if (hit) {
      any = true;
      if (t * t < best2) {
        best2 = t * t;
        best_t = t;
      }
    }
  };
  consider(ray_tri(p0, rd, tri.v[0] + off, tri.v[1] + off, tri.v[2] + off, t));
  consider(ray_tri(p0, rd, tri.v[0] - off, tri.v[1] - off, tri.v[2] - off, t));
  for (int i = 0; i < 3; i++)
    consider(ray_cyl(p0, rd, tri.v[i], tri.v[(i + 1) % 3], radius, t));
  for (int i = 0; i < 3; i++) consider(ray_sph(p0, rd, tri.v[i], radius, t));
  if (!any || best2 > seg2) return false;
  t_out = best_t;
  return true;
}

bool sphere_sweep_node(V3 p0, V3 rd, float seg_len, float radius, const Node& n) {
  // conservative: ray vs (node.radius + particle radius) sphere within
  // [ -(r+R), seg_len + r + R ] -- matches the reference's inflated-node
  // broad test semantics (SpatialStructure...compute:41-65).
  float rr = n.radius + radius;
  V3 oc = n.center - p0;
  if (dot(oc, oc) < rr * rr) return true;
  float proj = dot(oc, rd);
  float disc = rr * rr - (dot(oc, oc) - proj * proj);
  if (disc < 0.0f) return false;
  float t = proj - std::sqrt(disc);
  return t <= seg_len && t >= -rr;
}

}  // namespace

extern "C" {

// ---------- BVH ----------

void* psys_bvh_build(const float* tris_f, int64_t n_tris, int32_t max_level,
                     int32_t max_leaf, int32_t sah_samples) {
  auto* bvh = new Bvh();
  bvh->tris.resize(n_tris);
  V3 lo{3.4e38f, 3.4e38f, 3.4e38f}, hi{-3.4e38f, -3.4e38f, -3.4e38f};
  for (int64_t i = 0; i < n_tris; i++) {
    Tri& t = bvh->tris[i];
    for (int k = 0; k < 3; k++) {
      t.v[k] = {tris_f[i * 9 + k * 3], tris_f[i * 9 + k * 3 + 1],
                tris_f[i * 9 + k * 3 + 2]};
      lo.x = std::min(lo.x, t.v[k].x); hi.x = std::max(hi.x, t.v[k].x);
      lo.y = std::min(lo.y, t.v[k].y); hi.y = std::max(hi.y, t.v[k].y);
      lo.z = std::min(lo.z, t.v[k].z); hi.z = std::max(hi.z, t.v[k].z);
    }
    t.centroid = (t.v[0] + t.v[1] + t.v[2]) * (1.0f / 3.0f);
  }
  V3 ext = hi - lo;
  ext.x = std::max(ext.x, 1e-6f); ext.y = std::max(ext.y, 1e-6f);
  ext.z = std::max(ext.z, 1e-6f);
  for (auto& t : bvh->tris)
    t.morton = morton3((t.centroid.x - lo.x) / ext.x, (t.centroid.y - lo.y) / ext.y,
                       (t.centroid.z - lo.z) / ext.z);
  bvh->order.resize(n_tris);
  for (int64_t i = 0; i < n_tris; i++) bvh->order[i] = i;
  std::sort(bvh->order.begin(), bvh->order.end(), [&](int64_t a, int64_t b) {
    return bvh->tris[a].morton < bvh->tris[b].morton;
  });

  BuildCtx ctx{&bvh->tris, &bvh->order, &bvh->nodes, max_level, max_leaf,
               sah_samples};
  bvh->nodes.reserve(4 * (size_t)std::max<int64_t>(n_tris / std::max(max_leaf, 1), 1));
  bvh->nodes.resize(1);
  if (n_tris > 0) split_recursive(ctx, 0, 0, n_tris, 0);
  return bvh;
}

int64_t psys_bvh_num_nodes(void* h) { return ((Bvh*)h)->nodes.size(); }

// nodes_out: 6 floats per node (cx, cy, cz, r, a, b -- a/b as float-cast
// ints); order_out: sorted-position -> original triangle index.
void psys_bvh_export(void* h, float* nodes_out, int64_t* order_out) {
  Bvh* bvh = (Bvh*)h;
  for (size_t i = 0; i < bvh->nodes.size(); i++) {
    const Node& n = bvh->nodes[i];
    nodes_out[i * 6 + 0] = n.center.x;
    nodes_out[i * 6 + 1] = n.center.y;
    nodes_out[i * 6 + 2] = n.center.z;
    nodes_out[i * 6 + 3] = n.radius;
    nodes_out[i * 6 + 4] = (float)n.a;
    nodes_out[i * 6 + 5] = (float)n.b;
  }
  for (size_t i = 0; i < bvh->order.size(); i++) order_out[i] = bvh->order[i];
}

void psys_bvh_free(void* h) { delete (Bvh*)h; }

// Swept-sphere nearest-hit query for n particles; hit_tri = original
// triangle index or -1; t_out = signed ray parameter of the winning hit.
void psys_bvh_query(void* h, const float* p0_f, const float* vel_f, int64_t n,
                    const float* radius, float dt, int64_t* hit_tri,
                    float* t_out, int32_t n_threads) {
  Bvh* bvh = (Bvh*)h;
  if (bvh->nodes.empty()) {
    for (int64_t i = 0; i < n; i++) hit_tri[i] = -1;
    return;
  }
  auto worker = [&](int64_t beg, int64_t end) {
    std::vector<int32_t> stack;
    stack.reserve(256);
    for (int64_t i = beg; i < end; i++) {
      hit_tri[i] = -1;
      t_out[i] = 0;
      V3 v{vel_f[i * 3], vel_f[i * 3 + 1], vel_f[i * 3 + 2]};
      float sp2 = dot(v, v);
      if (sp2 == 0.0f) continue;
      V3 p0{p0_f[i * 3], p0_f[i * 3 + 1], p0_f[i * 3 + 2]};
      float sp = std::sqrt(sp2);
      V3 rd = v * (1.0f / sp);
      float seg = sp * dt;
      float seg2 = seg * seg;
      float r = radius[i];
      float best2 = 3.4e38f;
      stack.clear();
      stack.push_back(0);
      while (!stack.empty()) {
        int32_t ni = stack.back();
        stack.pop_back();
        const Node& node = bvh->nodes[ni];
        if (!sphere_sweep_node(p0, rd, seg, r, node)) continue;
        if (!node.leaf()) {
          stack.push_back(node.a);
          stack.push_back(node.b);
          continue;
        }
        int64_t first = -(int64_t)node.a;
        for (int64_t k = 0; k < node.b; k++) {
          const Tri& tri = bvh->tris[bvh->order[first + k]];
          float t;
          if (particle_tri(p0, rd, seg2, tri, r, t)) {
            if (t * t < best2) {
              best2 = t * t;
              hit_tri[i] = bvh->order[first + k];
              t_out[i] = t;
            }
          }
        }
      }
    }
  };
  int nt = std::max(1, n_threads);
  if (nt == 1 || n < 1024) {
    worker(0, n);
  } else {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++)
      ts.emplace_back(worker, n * t / nt, n * (t + 1) / nt);
    for (auto& th : ts) th.join();
  }
}

// ---------- uniform grid CSR binning ----------
// Same contract as ops/grid.py::build_triangle_grid: expanded-AABB cells.
// Two-phase: count pass sizes the CSR, fill pass writes sorted pairs.

struct GridBuild {
  std::vector<int64_t> offsets;
  std::vector<int32_t> tri_ids;
  int64_t dims[3];
  double origin[3];
  double h;
};

void* psys_grid_build(const float* tris_f, int64_t n_tris, double cell,
                      double expand, double margin, int32_t n_threads) {
  auto* g = new GridBuild();
  g->h = cell;
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (int64_t i = 0; i < n_tris * 9; i++) {
    int ax = i % 3;
    lo[ax] = std::min(lo[ax], (double)tris_f[i]);
    hi[ax] = std::max(hi[ax], (double)tris_f[i]);
  }
  for (int a = 0; a < 3; a++) {
    g->origin[a] = lo[a] - expand - cell;
    double top = hi[a] + expand + cell;
    g->dims[a] = std::max<int64_t>((int64_t)std::ceil((top - g->origin[a]) / cell), 1);
  }
  int64_t C = g->dims[0] * g->dims[1] * g->dims[2];
  std::vector<std::atomic<int64_t>> counts(C);
  for (auto& c : counts) c.store(0, std::memory_order_relaxed);

  auto cell_range = [&](int64_t t, int64_t* clo, int64_t* chi,
                        double* tlo, double* thi) {
    for (int a = 0; a < 3; a++) {
      tlo[a] = 1e300;
      thi[a] = -1e300;
    }
    for (int k = 0; k < 3; k++)
      for (int a = 0; a < 3; a++) {
        double v = tris_f[t * 9 + k * 3 + a];
        tlo[a] = std::min(tlo[a], v);
        thi[a] = std::max(thi[a], v);
      }
    for (int a = 0; a < 3; a++) {
      clo[a] = std::min(std::max(
          (int64_t)std::floor((tlo[a] - expand - margin - g->origin[a]) / cell),
          (int64_t)0), g->dims[a] - 1);
      chi[a] = std::min(std::max(
          (int64_t)std::floor((thi[a] + expand + margin - g->origin[a]) / cell),
          (int64_t)0), g->dims[a] - 1);
    }
  };

  // L2 prefilter: keep (tri, cell) only when the Euclidean distance
  // between the tri AABB and the cell box is <= expand + margin (the
  // axis ranges above test the L-infinity distance -- a cube, ~1.9x the
  // volume of the required ball for small triangles).  MUST stay the
  // bit-identical double expression used by ops/grid.py (compiled with
  // -ffp-contract=off so no FMA contraction diverges from NumPy).
  const double ee = expand + margin;
  const double ee2 = ee * ee;
  auto pair_keep = [&](const double* tlo, const double* thi, int64_t x,
                       int64_t y, int64_t z) {
    const int64_t c[3] = {x, y, z};
    double d2 = 0.0;
    for (int a = 0; a < 3; a++) {
      double box_lo = g->origin[a] + (double)c[a] * cell;
      double box_hi = g->origin[a] + (double)(c[a] + 1) * cell;
      double gp = std::max(std::max(tlo[a] - box_hi, box_lo - thi[a]), 0.0);
      d2 = d2 + gp * gp;
    }
    return d2 <= ee2;
  };

  int nt = std::max(1, n_threads);
  auto count_worker = [&](int64_t beg, int64_t end) {
    int64_t clo[3], chi[3];
    double tlo[3], thi[3];
    for (int64_t t = beg; t < end; t++) {
      cell_range(t, clo, chi, tlo, thi);
      for (int64_t x = clo[0]; x <= chi[0]; x++)
        for (int64_t y = clo[1]; y <= chi[1]; y++)
          for (int64_t z = clo[2]; z <= chi[2]; z++)
            if (pair_keep(tlo, thi, x, y, z))
              counts[(x * g->dims[1] + y) * g->dims[2] + z].fetch_add(
                  1, std::memory_order_relaxed);
    }
  };
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++)
      ts.emplace_back(count_worker, n_tris * t / nt, n_tris * (t + 1) / nt);
    for (auto& th : ts) th.join();
  }
  g->offsets.resize(C + 1);
  g->offsets[0] = 0;
  for (int64_t c = 0; c < C; c++)
    g->offsets[c + 1] = g->offsets[c] + counts[c].load(std::memory_order_relaxed);
  g->tri_ids.resize(g->offsets[C]);
  std::vector<std::atomic<int64_t>> cursor(C);
  for (int64_t c = 0; c < C; c++)
    cursor[c].store(g->offsets[c], std::memory_order_relaxed);
  auto fill_worker = [&](int64_t beg, int64_t end) {
    int64_t clo[3], chi[3];
    double tlo[3], thi[3];
    for (int64_t t = beg; t < end; t++) {
      cell_range(t, clo, chi, tlo, thi);
      for (int64_t x = clo[0]; x <= chi[0]; x++)
        for (int64_t y = clo[1]; y <= chi[1]; y++)
          for (int64_t z = clo[2]; z <= chi[2]; z++) {
            if (!pair_keep(tlo, thi, x, y, z)) continue;
            int64_t c = (x * g->dims[1] + y) * g->dims[2] + z;
            g->tri_ids[cursor[c].fetch_add(1, std::memory_order_relaxed)] =
                (int32_t)t;
          }
    }
  };
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; t++)
      ts.emplace_back(fill_worker, n_tris * t / nt, n_tris * (t + 1) / nt);
    for (auto& th : ts) th.join();
  }
  // deterministic order within each cell (threads race on cursor order)
  for (int64_t c = 0; c < C; c++)
    std::sort(g->tri_ids.begin() + g->offsets[c], g->tri_ids.begin() + g->offsets[c + 1]);
  return g;
}

void psys_grid_info(void* h, int64_t* dims, double* origin, int64_t* n_pairs) {
  auto* g = (GridBuild*)h;
  for (int a = 0; a < 3; a++) {
    dims[a] = g->dims[a];
    origin[a] = g->origin[a];
  }
  *n_pairs = (int64_t)g->tri_ids.size();
}

void psys_grid_export(void* h, int64_t* offsets_out, int32_t* tri_ids_out) {
  auto* g = (GridBuild*)h;
  std::memcpy(offsets_out, g->offsets.data(), g->offsets.size() * sizeof(int64_t));
  std::memcpy(tri_ids_out, g->tri_ids.data(), g->tri_ids.size() * sizeof(int32_t));
}

void psys_grid_free(void* h) { delete (GridBuild*)h; }

}  // extern "C"
