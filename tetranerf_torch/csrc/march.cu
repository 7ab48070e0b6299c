// K1: entry walk + neighbour march, one thread per ray.
//
// Replaces: tetranerf_tpu/ops/fused.py `_walk_packed` (:87) and the
// while_loop/scan march of `march_features` (:125-598: `crossings`,
// `exit_face`, `hop`, `substep`) at hops=1 without the skip grid. The TPU
// version steps every ray of a batch in lock step, with a compaction
// cascade to shed finished rays; here each thread stops at its own ray's
// end, which gives the same outputs.
//
// What bounds it on the H100: each step reads the current cell's 100-byte
// packed row (planes, neighbour ids, vertex ids, occupancy) at an address
// that depends on the previous step, so a ray is a chain of dependent
// L2/HBM reads; arithmetic is a few dozen flops per step. The march is
// latency-bound, and the design answer is many rays in flight: small
// blocks (64 threads) spread one chunk of rays over every SM, and the row
// is read as six 16-byte loads plus one scalar.
//
// Numerics: built with --fmad=false, and every expression keeps the order
// of the PyTorch twin (tetranerf_torch/ops/march.py), so distances round
// the same way and cell sequences agree exactly. Ids are bit-cast int32s
// in float columns (denormals): they are read with __float_as_int only.

#include "common.cuh"

namespace {

constexpr int kRow = 64;
constexpr float kBaryEps = 1e-5f;

struct Row {
  float p[16];  // plane k: (nx, ny, nz, d) at p[4k..4k+3]
  int nb[4];
  int vid[4];
  float occ;
};

__device__ __forceinline__ void load_row(const float* __restrict__ table,
                                         int c, Row& row) {
  const float* base = table + static_cast<long long>(c) * kRow;
  const float4* src = reinterpret_cast<const float4*>(base);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(src + i);
    row.p[4 * i + 0] = v.x;
    row.p[4 * i + 1] = v.y;
    row.p[4 * i + 2] = v.z;
    row.p[4 * i + 3] = v.w;
  }
  const float4 n = __ldg(src + 4);
  row.nb[0] = __float_as_int(n.x);
  row.nb[1] = __float_as_int(n.y);
  row.nb[2] = __float_as_int(n.z);
  row.nb[3] = __float_as_int(n.w);
  const float4 w = __ldg(src + 5);
  row.vid[0] = __float_as_int(w.x);
  row.vid[1] = __float_as_int(w.y);
  row.vid[2] = __float_as_int(w.z);
  row.vid[3] = __float_as_int(w.w);
  row.occ = __ldg(base + 24);
}

__device__ __forceinline__ float plane_eval(const float* p, float x, float y,
                                            float z) {
  return ((p[0] * x + p[1] * y) + p[2] * z) + p[3];
}

// Barycentrics b, their rates den along the ray, and face-crossing
// distances at position t (fused.py `crossings`).
__device__ __forceinline__ void crossings(const Row& row, float t, float ox,
                                          float oy, float oz, float dx,
                                          float dy, float dz, float b[4],
                                          float den[4], float tc[4]) {
  const float px = ox + t * dx;
  const float py = oy + t * dy;
  const float pz = oz + t * dz;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float* p = row.p + 4 * k;
    b[k] = plane_eval(p, px, py, pz);
    den[k] = (p[0] * dx + p[1] * dy) + p[2] * dz;
    const float dd = den[k] == 0.0f ? CUDART_INF_F : den[k];
    tc[k] = t - b[k] / dd;
  }
}

__global__ void __launch_bounds__(64) march_kernel(
    const float* __restrict__ table, const int* __restrict__ hull_cells,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_in, const float* __restrict__ t_out,
    const int* __restrict__ entry_facet, const bool* __restrict__ hit_in,
    int num_rays, int max_steps, int num_steps, int walk_steps, int use_occ,
    float depth_cap, int* __restrict__ cells, float* __restrict__ t0s,
    float* __restrict__ t1s, float* __restrict__ barys,
    int* __restrict__ poss, int* __restrict__ new_vids,
    float* __restrict__ t_entry_out, float* __restrict__ bary_entry_out,
    int* __restrict__ vids0_out, bool* __restrict__ hit_out,
    bool* __restrict__ done_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= num_rays) return;
  const float ox = origins[3 * r], oy = origins[3 * r + 1],
              oz = origins[3 * r + 2];
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float tin = t_in[r], tout = t_out[r];
  bool hit = hit_in[r];

  const float span = nan_max(tout - tin, 1e-30f);
  const float eps_t = 1e-3f * span + 1e-7f;
  const float cap = tout + eps_t;
  const float tloc = tin + eps_t;
  int c = hit ? hull_cells[entry_facet[r]] : -1;

  Row row;
  // Entry walk: move toward the most negative barycentric until inside.
  {
    const float px = ox + tloc * dx;
    const float py = oy + tloc * dy;
    const float pz = oz + tloc * dz;
    bool walk_done = c < 0;
    for (int i = 0; i < walk_steps && !walk_done; ++i) {
      load_row(table, c, row);
      float b_min = plane_eval(row.p, px, py, pz);
      int k = 0;
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const float bj = plane_eval(row.p + 4 * j, px, py, pz);
        if (bj < b_min) {
          b_min = bj;
          k = j;
        }
      }
      if (b_min >= -kBaryEps) {
        walk_done = true;
      } else {
        c = row.nb[k];
        walk_done = c < 0;
      }
    }
  }
  hit = hit && c >= 0;

  // Entry distance and barycentrics from the entry cell's row.
  float b[4], den[4], tc[4];
  load_row(table, c < 0 ? 0 : c, row);
  crossings(row, tloc, ox, oy, oz, dx, dy, dz, b, den, tc);
  float t_entry = -CUDART_INF_F;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    t_entry = nan_max(t_entry, den[k] > 0.0f ? tc[k] : -CUDART_INF_F);
  if (!isfinite(t_entry)) t_entry = tloc;
  t_entry_out[r] = t_entry;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bary_entry_out[4 * r + k] = b[k] + (t_entry - tloc) * den[k];
    vids0_out[4 * r + k] = row.vid[k];
  }

  int vids_prev[4] = {row.vid[0], row.vid[1], row.vid[2], row.vid[3]};
  int pos_prev[4] = {0, 1, 2, 3};
  float t = t_entry;
  float depth = 0.0f;
  bool done = !hit;
  for (int step = 0; step < num_steps && !done; ++step) {
    load_row(table, c, row);
    crossings(row, t, ox, oy, oz, dx, dy, dz, b, den, tc);
    // Exit face: first minimum of the crossings where the ray leaves.
    float t_raw = den[0] < 0.0f ? tc[0] : CUDART_INF_F;
    int k_exit = 0;
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      const float v = den[j] < 0.0f ? tc[j] : CUDART_INF_F;
      if (v < t_raw) {
        t_raw = v;
        k_exit = j;
      }
    }
    if (!isfinite(t_raw)) {  // no exit face: the ray ends unemitted
      done = true;
      break;
    }
    const float t_exit = nan_max(t_raw, t);  // monotone despite roundoff
    const int nxt = row.nb[k_exit];
    bool new_done = nxt < 0 || t_exit >= cap;
    if (use_occ) {
      depth = depth + row.occ * (t_exit - t);
      new_done = new_done || depth > depth_cap;
    }
    // Stream dedup: at most one of the cell's vertices is new.
    int pos_cur[4];
    int new_vid = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool is_new = true;
      int matched = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (row.vid[i] == vids_prev[j]) {
          is_new = false;
          matched += pos_prev[j];
        }
      }
      pos_cur[i] = is_new ? 4 + step : matched;
      if (is_new) new_vid += row.vid[i];
    }
    if (step < max_steps) {
      const long long o = static_cast<long long>(r) * max_steps + step;
      cells[o] = c;
      t0s[o] = t;
      t1s[o] = t_exit;
      new_vids[o] = new_vid;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        barys[4 * o + k] = b[k] + (t_exit - t) * den[k];
        poss[4 * o + k] = pos_cur[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      vids_prev[k] = row.vid[k];
      pos_prev[k] = pos_cur[k];
    }
    c = nxt;
    t = t_exit;
    done = new_done;
  }
  hit_out[r] = hit;
  done_out[r] = done;
}

}  // namespace

extern "C" int tetranerf_march(
    const float* table, const int* hull_cells, const float* origins,
    const float* dirs, const float* t_in, const float* t_out,
    const int* entry_facet, const bool* hit, int num_rays, int max_steps,
    int num_steps, int walk_steps, int use_occ, float depth_cap, int* cells,
    float* t0s, float* t1s, float* barys, int* poss, int* new_vids,
    float* t_entry, float* bary_entry, int* vids0, bool* hit_out,
    bool* done_out, cudaStream_t stream) {
  constexpr int kThreads = 64;
  const int blocks = (num_rays + kThreads - 1) / kThreads;
  march_kernel<<<blocks, kThreads, 0, stream>>>(
      table, hull_cells, origins, dirs, t_in, t_out, entry_facet, hit,
      num_rays, max_steps, num_steps, walk_steps, use_occ, depth_cap, cells,
      t0s, t1s, barys, poss, new_vids, t_entry, bary_entry, vids0, hit_out,
      done_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tetranerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
