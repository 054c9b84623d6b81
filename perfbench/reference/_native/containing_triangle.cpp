// Containing-triangle query for points on the unit sphere.
//
// For each query point p (unit vector) find the mesh face whose spherical
// triangle contains it: det([v_i, v_j, p]) >= 0 for all directed edges of a
// CCW (outward-oriented) face. Candidate generation uses a uniform 3D
// spatial hash over face AABBs (robust at poles / longitude wraparound,
// unlike lat/lon bucketing). Falls back to the nearest-margin candidate for
// points numerically on shared edges.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency):
//   gt_containing_triangle(points[n*3], n, verts[m*3], m,
//                          faces[f*3], f, cell_size, out[n])
//
// A frozen copy of the graph compiler's helper, compiled with the same flags:
// where a grid point lies on a face boundary (the poles, meridians the mesh
// edges follow) the face chosen depends on the rounding of these sums, so
// the plain reference has to make the same choice to see the same graph.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Grid {
  double cell;
  int dims;                       // cells per axis over [-1, 1]
  std::vector<std::vector<int32_t>> cells;

  int clampi(int v) const { return std::max(0, std::min(dims - 1, v)); }
  int idx_of(double x) const {
    return clampi(static_cast<int>((x + 1.0) / cell));
  }
  size_t flat(int ix, int iy, int iz) const {
    return (static_cast<size_t>(ix) * dims + iy) * dims + iz;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success.
int gt_containing_triangle(const double* points, int64_t n_points,
                           const double* verts, int64_t n_verts,
                           const int32_t* faces, int64_t n_faces,
                           double cell_size, int64_t* out) {
  (void)n_verts;
  Grid grid;
  grid.cell = cell_size;
  grid.dims = std::max(1, static_cast<int>(std::ceil(2.0 / cell_size)));
  grid.cells.assign(static_cast<size_t>(grid.dims) * grid.dims * grid.dims,
                    {});

  // Insert each face into every cell its (slightly expanded) AABB overlaps.
  const double eps = 1e-9;
  for (int64_t f = 0; f < n_faces; ++f) {
    double lo[3] = {2, 2, 2}, hi[3] = {-2, -2, -2};
    for (int k = 0; k < 3; ++k) {
      const double* v = verts + 3 * static_cast<int64_t>(faces[3 * f + k]);
      for (int d = 0; d < 3; ++d) {
        lo[d] = std::min(lo[d], v[d]);
        hi[d] = std::max(hi[d], v[d]);
      }
    }
    int ix0 = grid.idx_of(lo[0] - eps), ix1 = grid.idx_of(hi[0] + eps);
    int iy0 = grid.idx_of(lo[1] - eps), iy1 = grid.idx_of(hi[1] + eps);
    int iz0 = grid.idx_of(lo[2] - eps), iz1 = grid.idx_of(hi[2] + eps);
    for (int ix = ix0; ix <= ix1; ++ix)
      for (int iy = iy0; iy <= iy1; ++iy)
        for (int iz = iz0; iz <= iz1; ++iz)
          grid.cells[grid.flat(ix, iy, iz)].push_back(
              static_cast<int32_t>(f));
  }

  // Precompute edge normals n_e = v_i x v_j per face.
  std::vector<double> normals(static_cast<size_t>(n_faces) * 9);
  for (int64_t f = 0; f < n_faces; ++f) {
    const double* v0 = verts + 3 * static_cast<int64_t>(faces[3 * f + 0]);
    const double* v1 = verts + 3 * static_cast<int64_t>(faces[3 * f + 1]);
    const double* v2 = verts + 3 * static_cast<int64_t>(faces[3 * f + 2]);
    double* nf = &normals[9 * f];
    const double* pairs[3][2] = {{v0, v1}, {v1, v2}, {v2, v0}};
    for (int e = 0; e < 3; ++e) {
      const double* a = pairs[e][0];
      const double* b = pairs[e][1];
      nf[3 * e + 0] = a[1] * b[2] - a[2] * b[1];
      nf[3 * e + 1] = a[2] * b[0] - a[0] * b[2];
      nf[3 * e + 2] = a[0] * b[1] - a[1] * b[0];
    }
  }

  const double tol = -1e-12;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 1024)
#endif
  for (int64_t i = 0; i < n_points; ++i) {
    const double* p = points + 3 * i;
    int ix = grid.idx_of(p[0]);
    int iy = grid.idx_of(p[1]);
    int iz = grid.idx_of(p[2]);

    int64_t best = -1;
    double best_margin = -1e30;
    // Expand rings of cells until a containing face is found. Ring 1
    // suffices when cell_size >= max face extent; keep expanding for
    // numerical stragglers.
    for (int ring = 1; ring <= grid.dims && best_margin < tol; ++ring) {
      int x0 = grid.clampi(ix - ring), x1 = grid.clampi(ix + ring);
      int y0 = grid.clampi(iy - ring), y1 = grid.clampi(iy + ring);
      int z0 = grid.clampi(iz - ring), z1 = grid.clampi(iz + ring);
      for (int cx = x0; cx <= x1; ++cx)
        for (int cy = y0; cy <= y1; ++cy)
          for (int cz = z0; cz <= z1; ++cz) {
            // Only the new shell (skip the interior already scanned).
            if (ring > 1 && cx != x0 && cx != x1 && cy != y0 && cy != y1 &&
                cz != z0 && cz != z1)
              continue;
            for (int32_t f : grid.cells[grid.flat(cx, cy, cz)]) {
              const double* nf = &normals[9 * f];
              // margin = min over three half-space tests.
              double d0 = nf[0] * p[0] + nf[1] * p[1] + nf[2] * p[2];
              double d1 = nf[3] * p[0] + nf[4] * p[1] + nf[5] * p[2];
              double d2 = nf[6] * p[0] + nf[7] * p[1] + nf[8] * p[2];
              double margin = std::min(d0, std::min(d1, d2));
              if (margin > best_margin) {
                best_margin = margin;
                best = f;
              }
            }
          }
      if (best_margin >= tol) break;
    }
    out[i] = best;
  }
  return 0;
}

}  // extern "C"
