// Uniform-grid CSR binning of a triangle soup (host side, once per scene).
//
// A copy of the grid binner of the JAX package's native tier, so the
// PyTorch port builds the same tables without importing that package.
// Multithreaded; output is bit-identical to ops/grid.py's NumPy builder
// (compiled with -ffp-contract=off, see the L2 prefilter below).
//
// Exposed as a plain C ABI consumed via ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

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
