// Native geometry runtime for lbm_tpu_torch: triangle-mesh smoothing and
// STL voxelization (lbm_tpu's tools/native/lbm_geo.cpp, the same code).
//
// These are the TPU-era replacements for the reference's offline MATLAB/C
// pipeline (SURVEY.md sections 2.2-2.3): the three smoothpatch MEX kernels
// (vertex adjacency, curvature-weighted and inverse-distance Laplacian
// smoothing) and the geo_preprocess voxelizer the reference describes but
// does not ship (README.md item E; CartGen paper). Implementations are
// from the standard literature (umbrella/cotangent Laplacian smoothing,
// parity ray casting), not ports.
//
// C ABI, consumed via ctypes (lbm_tpu_torch/geometry/native.py, which
// builds it with g++ at first use).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Vertex adjacency: CSR neighbor lists from a face list.
// Returns total neighbor count; call once with counts_only=1 to size the
// output, then again to fill (offsets: nv+1 entries, neighbors: total).
// ---------------------------------------------------------------------------
int64_t build_adjacency(
    const int64_t* faces, int64_t nf, int64_t nv,
    int64_t* offsets, int64_t* neighbors, int counts_only) {
  std::vector<std::vector<int64_t>> adj(nv);
  auto add = [&](int64_t a, int64_t b) {
    for (int64_t x : adj[a])
      if (x == b) return;
    adj[a].push_back(b);
  };
  for (int64_t f = 0; f < nf; ++f) {
    int64_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    add(a, b); add(a, c);
    add(b, a); add(b, c);
    add(c, a); add(c, b);
  }
  int64_t total = 0;
  for (int64_t v = 0; v < nv; ++v) total += (int64_t)adj[v].size();
  if (counts_only) return total;
  int64_t pos = 0;
  for (int64_t v = 0; v < nv; ++v) {
    offsets[v] = pos;
    for (int64_t x : adj[v]) neighbors[pos++] = x;
  }
  offsets[nv] = pos;
  return total;
}

// ---------------------------------------------------------------------------
// Iterative Laplacian smoothing.
// mode 0: inverse-distance umbrella weights w = 1/(|p_j - p_v| + sigma)
// mode 1: curvature-flow (cotangent-weighted Laplacian, Desbrun et al.)
// lambda_: step size per iteration.
// vertices: (nv, 3) double, updated in place.
// ---------------------------------------------------------------------------
void smooth_mesh(
    double* vertices, int64_t nv,
    const int64_t* faces, int64_t nf,
    int iterations, int mode, double sigma, double lambda_) {
  std::vector<double> next(3 * nv);
  std::vector<double> wsum(nv);
  std::vector<double> acc(3 * nv);

  // Adjacency (vertex mode) built once.
  std::vector<std::vector<int64_t>> adj;
  if (mode == 0) {
    adj.resize(nv);
    auto add = [&](int64_t a, int64_t b) {
      for (int64_t x : adj[a])
        if (x == b) return;
      adj[a].push_back(b);
    };
    for (int64_t f = 0; f < nf; ++f) {
      int64_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
      add(a, b); add(a, c);
      add(b, a); add(b, c);
      add(c, a); add(c, b);
    }
  }

  for (int it = 0; it < iterations; ++it) {
    std::memset(acc.data(), 0, sizeof(double) * 3 * nv);
    std::memset(wsum.data(), 0, sizeof(double) * nv);

    if (mode == 0) {
      for (int64_t v = 0; v < nv; ++v) {
        const double* pv = vertices + 3 * v;
        for (int64_t j : adj[v]) {
          const double* pj = vertices + 3 * j;
          double dx = pj[0] - pv[0], dy = pj[1] - pv[1], dz = pj[2] - pv[2];
          double w = 1.0 / (std::sqrt(dx * dx + dy * dy + dz * dz) + sigma);
          acc[3 * v] += w * pj[0];
          acc[3 * v + 1] += w * pj[1];
          acc[3 * v + 2] += w * pj[2];
          wsum[v] += w;
        }
      }
    } else {
      // Cotangent weights accumulated per face corner.
      for (int64_t f = 0; f < nf; ++f) {
        int64_t idx[3] = {faces[3 * f], faces[3 * f + 1], faces[3 * f + 2]};
        for (int corner = 0; corner < 3; ++corner) {
          int64_t o = idx[corner];                 // opposite vertex
          int64_t a = idx[(corner + 1) % 3];
          int64_t b = idx[(corner + 2) % 3];
          const double* po = vertices + 3 * o;
          const double* pa = vertices + 3 * a;
          const double* pb = vertices + 3 * b;
          double u[3] = {pa[0] - po[0], pa[1] - po[1], pa[2] - po[2]};
          double w[3] = {pb[0] - po[0], pb[1] - po[1], pb[2] - po[2]};
          double dot = u[0] * w[0] + u[1] * w[1] + u[2] * w[2];
          double cx = u[1] * w[2] - u[2] * w[1];
          double cy = u[2] * w[0] - u[0] * w[2];
          double cz = u[0] * w[1] - u[1] * w[0];
          double cross = std::sqrt(cx * cx + cy * cy + cz * cz);
          double cot = dot / (cross + 1e-12);
          if (cot < 0.0) cot = 0.0;  // clamp for robustness
          // cot(angle at o) weights edge (a, b) symmetrically.
          for (int d = 0; d < 3; ++d) {
            acc[3 * a + d] += cot * vertices[3 * b + d];
            acc[3 * b + d] += cot * vertices[3 * a + d];
          }
          wsum[a] += cot;
          wsum[b] += cot;
        }
      }
    }

    for (int64_t v = 0; v < nv; ++v) {
      if (wsum[v] <= 0.0) {
        for (int d = 0; d < 3; ++d) next[3 * v + d] = vertices[3 * v + d];
        continue;
      }
      for (int d = 0; d < 3; ++d) {
        double target = acc[3 * v + d] / wsum[v];
        next[3 * v + d] =
            (1.0 - lambda_) * vertices[3 * v + d] + lambda_ * target;
      }
    }
    std::memcpy(vertices, next.data(), sizeof(double) * 3 * nv);
  }
}

// ---------------------------------------------------------------------------
// Watertight-surface voxelizer: parity ray casting along +z columns with a
// 2D triangle bucket grid. tris: (ntri, 9) double (v0, v1, v2). Cell (i,j,k)
// center = origin + (i+0.5, j+0.5, k+0.5) * spacing. out: (nx*ny*nz) int32,
// x-major like the lattice: out[(i*ny + j)*nz + k].
// ---------------------------------------------------------------------------
void voxelize(
    const double* tris, int64_t ntri,
    const double* origin, double spacing,
    int64_t nx, int64_t ny, int64_t nz,
    int32_t* out) {
  // Bucket triangles by x-column range.
  std::vector<std::vector<int64_t>> buckets((size_t)nx * ny);
  for (int64_t t = 0; t < ntri; ++t) {
    const double* v = tris + 9 * t;
    double minx = v[0], maxx = v[0], miny = v[1], maxy = v[1];
    for (int k = 1; k < 3; ++k) {
      minx = std::fmin(minx, v[3 * k]);
      maxx = std::fmax(maxx, v[3 * k]);
      miny = std::fmin(miny, v[3 * k + 1]);
      maxy = std::fmax(maxy, v[3 * k + 1]);
    }
    int64_t i0 = (int64_t)std::floor((minx - origin[0]) / spacing - 0.5);
    int64_t i1 = (int64_t)std::ceil((maxx - origin[0]) / spacing - 0.5);
    int64_t j0 = (int64_t)std::floor((miny - origin[1]) / spacing - 0.5);
    int64_t j1 = (int64_t)std::ceil((maxy - origin[1]) / spacing - 0.5);
    if (i0 < 0) i0 = 0;
    if (j0 < 0) j0 = 0;
    if (i1 >= nx) i1 = nx - 1;
    if (j1 >= ny) j1 = ny - 1;
    for (int64_t i = i0; i <= i1; ++i)
      for (int64_t j = j0; j <= j1; ++j)
        buckets[(size_t)(i * ny + j)].push_back(t);
  }

  std::vector<double> zs;
  for (int64_t i = 0; i < nx; ++i) {
    double px = origin[0] + (i + 0.5) * spacing;
    for (int64_t j = 0; j < ny; ++j) {
      double py = origin[1] + (j + 0.5) * spacing;
      zs.clear();
      for (int64_t t : buckets[(size_t)(i * ny + j)]) {
        const double* v = tris + 9 * t;
        // 2D point-in-triangle (xy projection) + z interpolation.
        double x0 = v[0], y0 = v[1], z0 = v[2];
        double x1 = v[3], y1 = v[4], z1 = v[5];
        double x2 = v[6], y2 = v[7], z2 = v[8];
        double d = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
        if (std::fabs(d) < 1e-30) continue;  // degenerate in xy
        double l0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) / d;
        double l1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) / d;
        double l2 = 1.0 - l0 - l1;
        // Half-open rule to avoid double counting shared edges.
        if (l0 < 0.0 || l1 < 0.0 || l2 <= 0.0) continue;
        zs.push_back(l0 * z0 + l1 * z1 + l2 * z2);
      }
      if (zs.empty()) continue;
      for (int64_t k = 0; k < nz; ++k) {
        double pz = origin[2] + (k + 0.5) * spacing;
        int count = 0;
        for (double z : zs)
          if (z > pz) ++count;
        if (count & 1) out[(i * ny + j) * nz + k] = 1;
      }
    }
  }
}

}  // extern "C"
