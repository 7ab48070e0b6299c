// The native host geometry library of tetranerf_torch: the face adjacency
// of a tetrahedral mesh and the grid k-NN average point spacing.
//
// The port's own copy of the JAX package's csrc/tetra_geom.cpp, with the
// same C interface: tetra_build_adjacency mirrors the information of the
// reference's convert_tetrahedra_to_triangles
// (src/tetrahedra_tracer.cpp:45-71 of the reference, a triangle ->
// (tet_a, tet_b) map for OptiX), here by a bucket sort in place of JAX's
// face-hash map; tetra_average_spacing, JAX's arithmetic unchanged,
// replaces CGAL::compute_average_spacing (src/triangulation.cpp:121-134).
// Host code, no device: tetranerf_torch/geometry/native.py builds it with
// g++ at first use and binds it over ctypes; geometry/mesh.py and
// geometry/delaunay.py keep the numpy and KD-tree paths beside it.
//
// The adjacency is unique (each face is shared by at most two cells), so
// the table equals the numpy face-key sort's bit for bit. The spacing sums
// f32 squared distances and their f64 square roots, so it is not the
// KD-tree's f64 value bit for bit (tests/test_torch_native.py holds the two
// to 1e-6 relative).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct FaceKey {
  int32_t a, b, c;  // sorted ascending
};

inline FaceKey make_face(int32_t x, int32_t y, int32_t z) {
  if (x > y) std::swap(x, y);
  if (y > z) std::swap(y, z);
  if (x > y) std::swap(x, y);
  return FaceKey{x, y, z};
}

}  // namespace

extern "C" {

// neighbors[c*4 + k] = cell sharing the face opposite vertex k, else -1.
// Returns 0 on success, 1 if a face is shared by more than two cells, 2
// if a vertex id is negative.
//
// Faces are bucketed by their smallest vertex (a counting sort over the
// vertex ids), and each bucket, a few dozen faces, is sorted by its other
// two vertices; equal neighbours in a bucket are the two sides of a face.
// The table is unique, so this gives the face-hash map's answer (the JAX
// package's csrc/tetra_geom.cpp) without its per-face allocations.
int tetra_build_adjacency(const int32_t* cells, int64_t num_cells,
                          int32_t* neighbors) {
  std::fill(neighbors, neighbors + num_cells * 4, -1);
  static const int kOpp[4][3] = {{1, 2, 3}, {0, 2, 3}, {0, 1, 3}, {0, 1, 2}};
  const int64_t num_faces = num_cells * 4;
  int32_t vmax = -1;
  for (int64_t i = 0; i < num_faces; ++i) {
    if (cells[i] < 0) return 2;
    vmax = std::max(vmax, cells[i]);
  }
  // start[a]: the first slot of the faces whose smallest vertex is a.
  std::vector<int64_t> start(static_cast<size_t>(vmax) + 2, 0);
  for (int64_t f = 0; f < num_faces; ++f) {
    const int32_t* v = cells + (f >> 2) * 4;
    const int* o = kOpp[f & 3];
    start[std::min(v[o[0]], std::min(v[o[1]], v[o[2]])) + 1]++;
  }
  for (size_t a = 1; a < start.size(); ++a) start[a] += start[a - 1];
  // Each slot: (b, c) packed, then the face's flat index (cell * 4 + k).
  std::vector<std::pair<uint64_t, int64_t>> slots(static_cast<size_t>(num_faces));
  {
    std::vector<int64_t> cursor(start.begin(), start.end() - 1);
    for (int64_t f = 0; f < num_faces; ++f) {
      const int32_t* v = cells + (f >> 2) * 4;
      const int* o = kOpp[f & 3];
      const FaceKey key = make_face(v[o[0]], v[o[1]], v[o[2]]);
      slots[cursor[key.a]++] = {(static_cast<uint64_t>(key.b) << 32) |
                                    static_cast<uint32_t>(key.c), f};
    }
  }
  for (size_t a = 0; a + 1 < start.size(); ++a) {
    auto* first = slots.data() + start[a];
    auto* last = slots.data() + start[a + 1];
    std::sort(first, last);
    for (auto* s = first; s + 1 < last; ++s) {
      if (s[0].first != s[1].first) continue;
      if (s + 2 < last && s[2].first == s[0].first) return 1;
      const int64_t f0 = s[0].second, f1 = s[1].second;
      neighbors[f0] = static_cast<int32_t>(f1 >> 2);
      neighbors[f1] = static_cast<int32_t>(f0 >> 2);
      ++s;
    }
  }
  return 0;
}

// Average distance to the num_neighbors nearest neighbors, averaged over
// all points (uniform-grid k-NN; exact by ring expansion).
double tetra_average_spacing(const float* points, int64_t num_points,
                             int num_neighbors) {
  if (num_points < 2) return 0.0;
  int k = std::min<int64_t>(num_neighbors, num_points - 1);

  float lo[3] = {points[0], points[1], points[2]};
  float hi[3] = {points[0], points[1], points[2]};
  for (int64_t i = 0; i < num_points; ++i) {
    for (int d = 0; d < 3; ++d) {
      lo[d] = std::min(lo[d], points[i * 3 + d]);
      hi[d] = std::max(hi[d], points[i * 3 + d]);
    }
  }
  // Grid resolution targeting ~8 points per cell; cap the total cell
  // count by the point count so degenerate (flat/linear) extents cannot
  // blow up the ring search.
  double volume = 1.0;
  for (int d = 0; d < 3; ++d)
    volume *= std::max(1e-12, static_cast<double>(hi[d] - lo[d]));
  double cell = std::cbrt(volume * 8.0 / static_cast<double>(num_points));
  int dims[3];
  for (int d = 0; d < 3; ++d) {
    dims[d] = std::max(
        1, static_cast<int>(std::floor((hi[d] - lo[d]) / cell)) + 1);
    dims[d] = std::min(dims[d], 512);
  }
  while (static_cast<int64_t>(dims[0]) * dims[1] * dims[2] >
         std::max<int64_t>(1, num_points)) {
    int dmax = 0;
    if (dims[1] > dims[dmax]) dmax = 1;
    if (dims[2] > dims[dmax]) dmax = 2;
    if (dims[dmax] <= 1) break;
    dims[dmax] = (dims[dmax] + 1) / 2;
  }
  double inv_cell[3];
  for (int d = 0; d < 3; ++d)
    inv_cell[d] = dims[d] / std::max(1e-12, double(hi[d] - lo[d]) * (1 + 1e-9));

  auto cell_of = [&](const float* p, int out[3]) {
    for (int d = 0; d < 3; ++d) {
      int c = static_cast<int>((p[d] - lo[d]) * inv_cell[d]);
      out[d] = std::max(0, std::min(dims[d] - 1, c));
    }
  };

  int64_t total_cells =
      static_cast<int64_t>(dims[0]) * dims[1] * dims[2];
  std::vector<int32_t> counts(total_cells + 1, 0);
  std::vector<int32_t> order(num_points);
  auto flat = [&](const int c[3]) {
    return (static_cast<int64_t>(c[0]) * dims[1] + c[1]) * dims[2] + c[2];
  };
  {
    int cc[3];
    for (int64_t i = 0; i < num_points; ++i) {
      cell_of(points + i * 3, cc);
      counts[flat(cc) + 1]++;
    }
    for (int64_t i = 0; i < total_cells; ++i) counts[i + 1] += counts[i];
    std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t i = 0; i < num_points; ++i) {
      cell_of(points + i * 3, cc);
      order[cursor[flat(cc)]++] = static_cast<int32_t>(i);
    }
  }

  double total = 0.0;
  std::vector<float> best;
  int cc[3];
  for (int64_t i = 0; i < num_points; ++i) {
    const float* p = points + i * 3;
    cell_of(p, cc);
    best.assign(k, std::numeric_limits<float>::infinity());
    float worst = std::numeric_limits<float>::infinity();
    int max_ring = std::max(dims[0], std::max(dims[1], dims[2]));
    for (int ring = 0; ring <= max_ring; ++ring) {
      // Points within `ring` grid cells cover distance >= (ring-1)*cell
      // in each axis; stop once the k-th best is closer than the ring
      // guarantee.
      if (ring > 0 && std::isfinite(worst)) {
        double guaranteed = (ring - 1) / std::max(
            {inv_cell[0], inv_cell[1], inv_cell[2]});
        if (guaranteed * guaranteed > worst) break;
      }
      // Iterate the ring's shell in unclamped coordinates (clamping the
      // bounds would re-visit boundary cells and insert duplicates).
      for (int x = cc[0] - ring; x <= cc[0] + ring; ++x)
        for (int y = cc[1] - ring; y <= cc[1] + ring; ++y)
          for (int z = cc[2] - ring; z <= cc[2] + ring; ++z) {
            bool on_shell = (std::abs(x - cc[0]) == ring) ||
                            (std::abs(y - cc[1]) == ring) ||
                            (std::abs(z - cc[2]) == ring);
            if (!on_shell) continue;
            if (x < 0 || y < 0 || z < 0 || x >= dims[0] || y >= dims[1] ||
                z >= dims[2])
              continue;
            int c3[3] = {x, y, z};
            int64_t f = flat(c3);
            for (int32_t j = counts[f]; j < counts[f + 1]; ++j) {
              int32_t idx = order[j];
              if (idx == i) continue;
              const float* q = points + idx * 3;
              float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
              float d2 = dx * dx + dy * dy + dz * dz;
              if (d2 < worst) {
                // Insert into the sorted best-k list.
                int pos = k - 1;
                while (pos > 0 && best[pos - 1] > d2) {
                  best[pos] = best[pos - 1];
                  --pos;
                }
                best[pos] = d2;
                worst = best[k - 1];
              }
            }
          }
      if (ring == max_ring) break;
    }
    double sum = 0.0;
    int found = 0;
    for (int j = 0; j < k; ++j) {
      if (std::isfinite(best[j])) {
        sum += std::sqrt(static_cast<double>(best[j]));
        ++found;
      }
    }
    if (found) total += sum / found;
  }
  return total / static_cast<double>(num_points);
}

}  // extern "C"
