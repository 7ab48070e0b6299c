// K1: entry walk + neighbour march, four lanes per ray, every output of
// march() in its final layout in one launch.
//
// Replaces: tetranerf_tpu/ops/fused.py `_walk_packed` (:87) and the
// while_loop/scan march of `march_features` (:125-598: `crossings`,
// `exit_face`, `hop`, `substep`) at hops=1 without the skip grid, with the
// epilogue that assembles FusedMarch (valid, num_valid, hit, overflow and
// the stream's vids/pos/bary). The TPU version steps every ray of a batch
// in lock step, with a compaction cascade to shed finished rays; here each
// ray stops at its own end, which gives the same outputs.
//
// What bounds it on the H100. The byte bound (each table row a ray visits
// read once, each output written once, padding included) is far away: a
// ray is a chain of dependent steps, each of which reads a 100-byte row at
// an address the previous step decided. The least time is then the
// longest ray's rows times the card's dependent-load latency (the latency
// floor; chip_smoke.py phase 3 measures the latency with a pointer chase
// over this table: ~170 ns a hop). A thread per ray took ~9x that floor:
// a step was ~3,000 cycles of instruction latency in one warp, not the
// ~310-cycle load: 7 loads and 12 stores that each touched 32 lines per
// warp instruction, and all four faces' IEEE divisions in one thread.
//
// The design: four lanes per ray, lane k owning face k. A step loads the
// row as each lane's 16-byte plane plus three quad-uniform loads, so a warp
// instruction touches 8 lines (one per ray); each lane does one plane's
// arithmetic and one division; four shuffles give every lane the four
// crossings, and each lane runs the same sequential first-min, carrying
// the neighbour id, so a quad's control flow stays uniform. The whole warp
// runs every loop to the warp's end (a finished ray's lanes step unstored),
// so the shuffles take the full warp. The next row is loaded as soon as
// its id is known, before the stream dedup and the stores of the step
// (a warp issues in order). A step writes its position and weight rows as
// 16 contiguous bytes a quad; the four scalar columns (cells, t0, t1, the
// stream's new id) one lane each, four slots a 16-byte store. Once the
// warp's rays have ended, its 32 lanes write each ray's valid row and
// padding tail with 16-byte stores, so no byte is written twice and no
// fill kernel runs: march() is the hull slab and this one launch.
//
// Numerics: built with --fmad=false, and every expression keeps the order
// of the PyTorch twin (tetranerf_torch/ops/march.py), so distances round
// the same way and cell sequences agree exactly. Ids are bit-cast int32s
// in float columns (denormals): they are read as ints only.

#include "common.cuh"

namespace {

constexpr int kRow = 64;
constexpr float kBaryEps = 1e-5f;
constexpr int kThreads = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float plane_eval(float4 p, float x, float y,
                                            float z) {
  return ((p.x * x + p.y * y) + p.z * z) + p.w;
}

// A quad's four values in every lane of it (the whole warp takes part).
__device__ __forceinline__ float4 gather4(float v) {
  return make_float4(__shfl_sync(kFull, v, 0, 4), __shfl_sync(kFull, v, 1, 4),
                     __shfl_sync(kFull, v, 2, 4), __shfl_sync(kFull, v, 3, 4));
}

// Sequential first minimum (first index on ties), as the twin's
// _first_min, carrying the neighbour id of the face it picks.
__device__ __forceinline__ void first_min(float4 v, int4 nb, float& best, int& id) {
  best = v.x;
  id = nb.x;
  bool take = v.y < best;
  best = take ? v.y : best;
  id = take ? nb.y : id;
  take = v.z < best;
  best = take ? v.z : best;
  id = take ? nb.z : id;
  take = v.w < best;
  best = take ? v.w : best;
  id = take ? nb.w : id;
}

__device__ __forceinline__ int pick(int4 v, int k) {
  int out = v.x;
  out = k == 1 ? v.y : out;
  out = k == 2 ? v.z : out;
  return k == 3 ? v.w : out;
}

__device__ __forceinline__ const float* row_of(const float* table, int c) {
  return table + static_cast<long long>(c) * kRow;
}

// A lane's part of a row: its face's plane, and the quad-uniform
// neighbour ids, vertex ids and occupancy (the same 16 bytes for the four
// lanes, one transaction).
struct Row {
  float4 p;
  int4 nb;
  int4 vid;
  float occ;
};

__device__ __forceinline__ Row load_row(const float* table, int c, int k) {
  const float* row = row_of(table, c);
  Row out;
  out.p = __ldg(reinterpret_cast<const float4*>(row) + k);
  out.nb = __ldg(reinterpret_cast<const int4*>(row + 16));
  out.vid = __ldg(reinterpret_cast<const int4*>(row + 20));
  out.occ = __ldg(row + 24);
  return out;
}

// value into base[begin, end) by the warp's 32 lanes: 16-byte stores over
// the aligned middle (the allocation is 16-byte aligned), single elements
// at the two ends. E elements per 16 bytes.
template <typename V, int E>
__device__ __forceinline__ void fill_span(V* base, long long begin,
                                          long long end, V value, int lane) {
  const long long head = min(end, (begin + E - 1) / E * E);
  const long long body = max(head, end / E * E);
  for (long long i = begin + lane; i < head; i += 32) base[i] = value;
  V v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = value;
  const int4 word = *reinterpret_cast<const int4*>(v);
  for (long long i = head + E * lane; i < body; i += 32 * E)
    *reinterpret_cast<int4*>(base + i) = word;
  for (long long i = body + lane; i < end; i += 32) base[i] = value;
}

// Slots [first, last] of a column from their aligned group of four
// (first = last - 3 for a whole group): one 16-byte store for a whole
// group, single stores for the slots of a partial one that lie in the ray.
__device__ __forceinline__ void store_group(int* col, int first, int last, int4 group) {
  if (first >= 0 && last - first == 3) {
    *reinterpret_cast<int4*>(col + first) = group;
    return;
  }
  const int v[4] = {group.x, group.y, group.z, group.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int slot = first + e;
    if (slot >= 0 && slot <= last) col[slot] = v[e];
  }
}

// Face k's barycentric b, its rate den along the ray and its crossing
// distance at t (fused.py `crossings`).
__device__ __forceinline__ float crossing(float4 p, float t, float ox, float oy,
                                          float oz, float dx, float dy, float dz,
                                          float& b, float& den) {
  const float px = ox + t * dx;
  const float py = oy + t * dy;
  const float pz = oz + t * dz;
  b = plane_eval(p, px, py, pz);
  den = (p.x * dx + p.y * dy) + p.z * dz;
  const float dd = den == 0.0f ? CUDART_INF_F : den;
  return t - b / dd;
}

__global__ void __launch_bounds__(kThreads) march_kernel(
    const float* __restrict__ table, const int* __restrict__ hull_cells,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    const float* __restrict__ t_in, const float* __restrict__ t_out,
    const int* __restrict__ entry_facet, const bool* __restrict__ hit_in,
    int num_rays, int max_steps, int num_steps, int walk_steps, int use_occ,
    float depth_cap, int* __restrict__ cells, float* __restrict__ t0s,
    float* __restrict__ t1s, bool* __restrict__ valid, int* __restrict__ vids,
    int* __restrict__ poss, float* __restrict__ barys,
    float* __restrict__ t_entry_out, int* __restrict__ num_valid_out,
    bool* __restrict__ hit_out, bool* __restrict__ overflow_out) {
  const int lane = threadIdx.x & 31;
  const int k = lane & 3;  // this lane's face
  const long long T = max_steps;
  const int r_raw = (blockIdx.x * blockDim.x + threadIdx.x) >> 2;
  const bool live = r_raw < num_rays;
  // Every lane runs every loop to the warp's end, so that the shuffles
  // take the whole warp; a lane past the last ray marches ray 0 unstored.
  const int r = live ? r_raw : 0;

  const float ox = origins[3 * r], oy = origins[3 * r + 1], oz = origins[3 * r + 2];
  const float dx = dirs[3 * r], dy = dirs[3 * r + 1], dz = dirs[3 * r + 2];
  const float tin = t_in[r], tout = t_out[r];
  bool hit = live && hit_in[r];

  const float span = nan_max(tout - tin, 1e-30f);
  const float eps_t = 1e-3f * span + 1e-7f;
  const float cap = tout + eps_t;
  const float tloc = tin + eps_t;
  int c = hit ? hull_cells[entry_facet[r]] : -1;

  // Entry walk: move toward the most negative barycentric until inside.
  {
    const float px = ox + tloc * dx;
    const float py = oy + tloc * dy;
    const float pz = oz + tloc * dz;
    bool walk_done = c < 0;
    for (int i = 0; i < walk_steps && __any_sync(kFull, !walk_done); ++i) {
      const float* row = row_of(table, walk_done ? 0 : c);
      const float4 p = __ldg(reinterpret_cast<const float4*>(row) + k);
      const int4 nb = __ldg(reinterpret_cast<const int4*>(row + 16));
      float b_min;
      int nxt;
      first_min(gather4(plane_eval(p, px, py, pz)), nb, b_min, nxt);
      if (!walk_done) {
        if (b_min >= -kBaryEps) {
          walk_done = true;
        } else {
          c = nxt;
          walk_done = c < 0;
        }
      }
    }
  }
  hit = hit && c >= 0;

  // Entry distance and barycentrics from the entry cell's row (row 0 for
  // a ray that found none, as the twin's clamped fetch).
  const float* row = row_of(table, c < 0 ? 0 : c);
  float b, den;
  const float tc = crossing(__ldg(reinterpret_cast<const float4*>(row) + k), tloc,
                            ox, oy, oz, dx, dy, dz, b, den);
  const int4 vid0 = __ldg(reinterpret_cast<const int4*>(row + 20));
  const float4 te = gather4(den > 0.0f ? tc : -CUDART_INF_F);
  float t_entry = -CUDART_INF_F;
  t_entry = nan_max(t_entry, te.x);
  t_entry = nan_max(t_entry, te.y);
  t_entry = nan_max(t_entry, te.z);
  t_entry = nan_max(t_entry, te.w);
  if (!isfinite(t_entry)) t_entry = tloc;
  const float bary_entry = b + (t_entry - tloc) * den;

  int4 vprev = vid0;
  int4 pprev = make_int4(0, 1, 2, 3);
  float t = t_entry;
  float depth = 0.0f;
  bool done = !hit;
  int n = 0;  // slots written
  // This lane's slots: its scalar column (lane 0 cells, 1 t0, 2 t1, 3 the
  // stream's new ids), its entry of each position and weight row.
  int* col = k == 0   ? cells + r * T
             : k == 1 ? reinterpret_cast<int*>(t0s) + r * T
             : k == 2 ? reinterpret_cast<int*>(t1s) + r * T
                      : vids + r * (T + 4) + 4;
  // The column's slots go out four at a time as one 16-byte store: slot s
  // sits at position (phase + s) % 4 of its aligned group (the tensors are
  // 16-byte aligned, and r * (T + 4) + 4 = r * T modulo 4 for the ids).
  const int phase = static_cast<int>((r * T) & 3);
  int4 group = make_int4(0, 0, 0, 0);
  int* pos_row = poss + (r * (T + 1) + 1) * 4 + k;
  float* bary_row = barys + (r * (T + 1) + 1) * 4 + k;
  // Software-pipelined: a step's row was loaded by the step before, as
  // soon as that step knew the address, so the dedup and the stores run
  // while the next row is in flight (a warp issues in order). A finished
  // ray's lanes keep stepping on their last row, unstored.
  Row row_c = load_row(table, c < 0 ? 0 : c, k);
  for (int step = 0; step < num_steps && __any_sync(kFull, !done); ++step) {
    const Row cur = row_c;
    const float tc_k = crossing(cur.p, t, ox, oy, oz, dx, dy, dz, b, den);
    // Exit face: first minimum of the crossings where the ray leaves.
    float t_raw;
    int nxt;
    first_min(gather4(den < 0.0f ? tc_k : CUDART_INF_F), cur.nb, t_raw, nxt);
    // No exit face: the ray ends unemitted.
    const bool active = !done && isfinite(t_raw);
    if (active && nxt >= 0) row_c = load_row(table, nxt, k);
    const float t_exit = nan_max(t_raw, t);  // monotone despite roundoff
    bool new_done = !active || nxt < 0 || t_exit >= cap;
    if (use_occ) {
      const float d = depth + cur.occ * (t_exit - t);
      depth = active ? d : depth;
      new_done = new_done || depth > depth_cap;
    }
    // Stream dedup of this lane's vertex: at most one of the cell's
    // vertices is new; the quad adds the new one's id (integers, so the
    // order of the sum does not matter).
    const int v_k = pick(cur.vid, k);
    const bool is_new = v_k != vprev.x && v_k != vprev.y && v_k != vprev.z &&
                        v_k != vprev.w;
    const int matched = (v_k == vprev.x ? pprev.x : 0) + (v_k == vprev.y ? pprev.y : 0) +
                        (v_k == vprev.z ? pprev.z : 0) + (v_k == vprev.w ? pprev.w : 0);
    const int pos_k = is_new ? 4 + step : matched;
    int new_vid = is_new ? v_k : 0;
    new_vid += __shfl_xor_sync(kFull, new_vid, 1, 4);
    new_vid += __shfl_xor_sync(kFull, new_vid, 2, 4);
    if (active && step < max_steps) {
      int value = c;
      value = k == 1 ? __float_as_int(t) : value;
      value = k == 2 ? __float_as_int(t_exit) : value;
      value = k == 3 ? new_vid : value;
      const int j = (phase + step) & 3;
      group.x = j == 0 ? value : group.x;
      group.y = j == 1 ? value : group.y;
      group.z = j == 2 ? value : group.z;
      group.w = j == 3 ? value : group.w;
      if (j == 3) store_group(col, step - 3, step, group);
      pos_row[4 * step] = pos_k;
      bary_row[4 * step] = b + (t_exit - t) * den;
      n = step + 1;
    }
    const int4 pgot = make_int4(__shfl_sync(kFull, pos_k, 0, 4), __shfl_sync(kFull, pos_k, 1, 4),
                                __shfl_sync(kFull, pos_k, 2, 4), __shfl_sync(kFull, pos_k, 3, 4));
    if (active) {
      vprev = cur.vid;
      pprev = pgot;
      c = nxt;
      t = t_exit;
    }
    done = done || new_done;
  }

  if (live && n > 0 && ((phase + n - 1) & 3) != 3)  // the last, partial group
    store_group(col, (n - 1) - ((phase + n - 1) & 3), n - 1, group);

  // Slot 0 of the stream, and the per-ray results.
  if (live) {
    const bool hit_final = hit && n > 0;
    vids[r * (T + 4) + k] = pick(vid0, k);
    poss[r * (T + 1) * 4 + k] = k;
    barys[r * (T + 1) * 4 + k] = hit_final ? bary_entry : 0.0f;
    if (k == 0) t_entry_out[r] = t_entry;
    if (k == 1) num_valid_out[r] = n;
    if (k == 2) hit_out[r] = hit_final;
    if (k == 3) overflow_out[r] = hit_final && !done;
  }

  // The warp's eight rays' valid rows, and their padding tails, slots
  // n..T-1, by all 32 lanes: cells=-1, t0=t1=+inf, valid=false,
  // vids=pos=bary=0.
  const int ray0 = r_raw - (lane >> 2);
#pragma unroll 1
  for (int i = 0; i < 8; ++i) {
    const int ri = ray0 + i;
    const int ni = __shfl_sync(kFull, n, 4 * i);
    if (ri >= num_rays) break;
    const long long o = ri * T;
    const long long s = ri * (T + 1) + 1;
    fill_span<int, 4>(cells, o + ni, o + T, -1, lane);
    fill_span<float, 4>(t0s, o + ni, o + T, CUDART_INF_F, lane);
    fill_span<float, 4>(t1s, o + ni, o + T, CUDART_INF_F, lane);
    fill_span<bool, 16>(valid, o, o + ni, true, lane);
    fill_span<bool, 16>(valid, o + ni, o + T, false, lane);
    fill_span<int, 4>(vids, ri * (T + 4) + 4 + ni, (ri + 1) * (T + 4), 0, lane);
    for (long long slot = ni + lane; slot < T; slot += 32) {
      reinterpret_cast<int4*>(poss)[s + slot] = make_int4(0, 0, 0, 0);
      reinterpret_cast<float4*>(barys)[s + slot] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

}  // namespace

extern "C" int tetranerf_march(
    const float* table, const int* hull_cells, const float* origins,
    const float* dirs, const float* t_in, const float* t_out,
    const int* entry_facet, const bool* hit, int num_rays, int max_steps,
    int num_steps, int walk_steps, int use_occ, float depth_cap, int* cells,
    float* t0s, float* t1s, bool* valid, int* vids, int* poss, float* barys,
    float* t_entry, int* num_valid, bool* hit_out, bool* overflow,
    cudaStream_t stream) {
  const long long threads = 4LL * num_rays;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  march_kernel<<<blocks, kThreads, 0, stream>>>(
      table, hull_cells, origins, dirs, t_in, t_out, entry_facet, hit,
      num_rays, max_steps, num_steps, walk_steps, use_occ, depth_cap, cells,
      t0s, t1s, valid, vids, poss, barys, t_entry, num_valid, hit_out,
      overflow);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* tetranerf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
