// K2: stream blend with the field row gather fused in, for a batch of
// streams over one field.
//
//   out_j[r, e, :] = sum_i bary_j[r, e, i] * field[max(vids_j[r, pos_j[r, e, i]], 0), :]
//
// Replaces: tetranerf_tpu/ops/pallas_interp.py `stream_blend` forward
// (`_blend_fwd_kernel` :172, pallas_call at :214) together with the
// `field[vids]` row gather in front of it (ops/fused.py:733). The TPU kernel
// built a [T+4, T+1] blend matrix per ray and contracted it on the MXU in
// bf16; here each endpoint reads its (at most four) field rows directly and
// sums in f32, so no [R, T+4, F] gathered stream is written to memory. On
// the port's path one launch computes the endpoint features of every
// quantile bucket of a step or render chunk (JAX: one `endpoint_features`
// per bucket).
//
// Design: one block of 8 warps per (job, ray, tile of at most 128
// endpoints).
// 1. The job list (stream and output addresses, shapes, tiling) is a
//    kernel parameter (a `__grid_constant__` struct, as K8's); a block
//    finds its job by binary search over the prefix of the jobs' block
//    counts. A ray's endpoints split into the fewest tiles of at most 128,
//    as even as they come.
// 2. The block stages its tile's pos and bary rows (32 bytes per endpoint)
//    in shared memory with `cp.async` (16 bytes a thread, coalesced), and
//    each staging thread then resolves its endpoint's four vertex ids once,
//    v = bary != 0 ? max(vids[r, pos], 0) : -1, into shared memory. One
//    barrier.
// 3. Lane groups of min(16, F / 4) lanes (rounded up to a power of two)
//    own endpoints, each lane a float4 of columns (float2 where F or an
//    address does not allow 16 bytes, as K3). A lane loads 2 endpoints x 4
//    rows before it adds, sums in f32 in the twin's order,
//    ((w0 x0 + w1 x1) + w2 x2) + w3 x3, and writes each output row once.
//    An endpoint whose four weights are all zero (padding: most of a ray's
//    T+1 slots) writes zeros and reads nothing.
//
// What bounds it on the H100: bytes. The dense [R, T+1, F] f32 output is
// written once, pos + bary read once, the stream ids and the field once
// (1.25 GB at the render slice's 8192 x 513 x 64: 0.374 ms at the 3.35 TB/s
// of an H100 SXM at 700 W, NVIDIA's data sheet; ~0.14 ms for a flagship
// step's 8 buckets). The row reads are gathers from a field that fits the
// 50 MB L2 at 100K vertices (25.6 MB).
//
// The earlier design, one warp per endpoint (a chain of dependent loads:
// pos/bary, then up to 4 stream ids, then up to 4 rows; a float2 per lane,
// so 256 bytes of output per warp) and one launch per bucket: 1.143-1.145
// ms at the render shape, 0.296 ms for the 8 launches of a flagship step,
// on an H100 80GB HBM3 at 700 W.
//
// The low-precision row instances, for `field_stream_dtype` "bfloat16",
// "float16" and the 8- and 4-bit floats (replace the forward of
// tetranerf_tpu/ops/fused.py `gather_rows_lowp` :665-695 before the same
// blend): the field is a [V, F] copy in that type, made once per forward
// (ops/stream_dtypes.py `round_to`, ml_dtypes' rounding); a lane reads 8,
// 4 or 2 bytes of each row (4 or 2 elements) and widens them exactly
// (common.cuh `Row`), then blends and writes f32 as above, as JAX's
// `_run_blend` writes f32. The row bytes shrink by 2x or 4x; the f32
// output is the same, so the bound is close to the f32 instance's. JAX's
// kernel casts the rows to bf16 for the MXU; this one blends them in f32,
// so the two agree where the rows are bf16-exact (every value of an 8-
// or 4-bit type is, and an f16 value with at most 8 significant bits).
//
// The seven software row types (common.cuh `MiniRow`: float8_e4m3fnuz,
// _e5m2fnuz, _e4m3b11fnuz, _e3m4, _e4m3, _e8m0fnu and float4_e2m1fn, one
// code a byte) widen by bit arithmetic in registers; those with NaN or
// infinity codes also take JAX's NaNs (kDenseNan; ops/interp.py
// `dense_nan`): JAX blends a ray's slot rows with a dense matrix, so a
// non-finite slot value reaches every endpoint that does not weight it as
// 0 * x = NaN. The block first counts, per column, the ray's slot rows
// (all U, read once more: U F bytes) that hold one, in shared memory; an
// endpoint's column is NaN where that count exceeds the distinct slots it
// weights that hold one. float8_e8m0fnu has no zero and no sign, so any
// field entry <= 0 is NaN and the forward is NaN where JAX's is.

#include <stdint.h>

#include "common.cuh"

namespace {

struct BlendJob {
  const int* vids;      // [R, U]
  const int4* pos;      // [R, E]
  const float4* bary;   // [R, E]
  float* out;           // [R, E, F]
  int num_end;
  int num_stream;
  int tile;             // endpoints a block owns, at most kMaxTile
  int num_tiles;        // tiles per ray
  int first_block;      // prefix over the jobs of their block counts
};

constexpr int kBlendMaxJobs = 64;

struct BlendBatch {
  int num_jobs;
  BlendJob jobs[kBlendMaxJobs];
};

constexpr int kFwdThreads = 256;
constexpr int kMaxTile = 128;
constexpr int kEndInFlight = 2;  // endpoints a lane loads before it adds
// The widest row of a kDenseNan instance: its per-column counts fill the
// 48 KB of dynamic shared memory a launch gets without opting in.
constexpr int kMaxDenseNanCols = 12288;

// The twin's blend order, ((w0 x0 + w1 x1) + w2 x2) + w3 x3, in f32.
__device__ __forceinline__ float4 blend4(const float4& w, const float4* x) {
  return make_float4(
      ((w.x * x[0].x + w.y * x[1].x) + w.z * x[2].x) + w.w * x[3].x,
      ((w.x * x[0].y + w.y * x[1].y) + w.z * x[2].y) + w.w * x[3].y,
      ((w.x * x[0].z + w.y * x[1].z) + w.z * x[2].z) + w.w * x[3].z,
      ((w.x * x[0].w + w.y * x[1].w) + w.z * x[2].w) + w.w * x[3].w);
}
__device__ __forceinline__ float2 blend4(const float4& w, const float2* x) {
  return make_float2(
      ((w.x * x[0].x + w.y * x[1].x) + w.z * x[2].x) + w.w * x[3].x,
      ((w.x * x[0].y + w.y * x[1].y) + w.z * x[2].y) + w.w * x[3].y);
}

template <int kVec>
__device__ __forceinline__ typename F32Vec<kVec>::T zero_vec();
template <>
__device__ __forceinline__ float4 zero_vec<4>() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
template <>
__device__ __forceinline__ float2 zero_vec<2>() { return make_float2(0.0f, 0.0f); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// At most 64 registers a thread, so 4 blocks share an SM: more row
// gathers and output rows in flight than at 3 blocks (72 registers).
// `T` is the field's row type: float, or a stream row type of common.cuh
// (bf16, f16, an 8- or 4-bit type: rows move at fewer bytes and blend in
// f32 all the same).
template <int kVec, typename T>
__global__ void __launch_bounds__(kFwdThreads, 4) blend_kernel(
    const __grid_constant__ BlendBatch batch, const T* __restrict__ field,
    int num_feat, int group_log2) {
  using V = typename F32Vec<kVec>::T;
  __shared__ int4 s_pos[kMaxTile];
  __shared__ float4 s_w[kMaxTile];
  __shared__ int4 s_v[kMaxTile];
  __shared__ unsigned char s_first[kMaxTile];  // kDenseNan instances
  extern __shared__ int s_bad[];               // [F], kDenseNan instances
  int lo = 0, hi = batch.num_jobs - 1;  // last job with first_block <= block
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (batch.jobs[mid].first_block <= static_cast<int>(blockIdx.x)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const BlendJob& job = batch.jobs[lo];
  const int local = blockIdx.x - job.first_block;
  const long long r = local / job.num_tiles;
  const int e0 = (local % job.num_tiles) * job.tile;
  const int n = min(job.tile, job.num_end - e0);

  if (static_cast<int>(threadIdx.x) < n) {
    const long long e = r * job.num_end + e0 + threadIdx.x;
    cp_async16(s_pos + threadIdx.x, job.pos + e);
    cp_async16(s_w + threadIdx.x, job.bary + e);
    cp_async_wait_all();  // this thread's own copies are now visible to it
    const int4 p = s_pos[threadIdx.x];
    const float4 w = s_w[threadIdx.x];
    const int* vr = job.vids + r * job.num_stream;
    int4 v;
    v.x = w.x != 0.0f ? max(__ldg(vr + p.x), 0) : -1;
    v.y = w.y != 0.0f ? max(__ldg(vr + p.y), 0) : -1;
    v.z = w.z != 0.0f ? max(__ldg(vr + p.z), 0) : -1;
    v.w = w.w != 0.0f ? max(__ldg(vr + p.w), 0) : -1;
    s_v[threadIdx.x] = v;
    if constexpr (kDenseNan<T>) {
      // The distinct slots the endpoint weights: bit j unless an earlier
      // weighted j' names the same slot.
      const int pj[4] = {p.x, p.y, p.z, p.w};
      const float wj[4] = {w.x, w.y, w.z, w.w};
      unsigned first = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bool seen = false;
#pragma unroll
        for (int k = 0; k < j; ++k) seen |= wj[k] != 0.0f && pj[k] == pj[j];
        if (wj[j] != 0.0f && !seen) first |= 1u << j;
      }
      s_first[threadIdx.x] = static_cast<unsigned char>(first);
    }
  }
  __syncthreads();

  const int group = 1 << group_log2;
  const int groups = kFwdThreads >> group_log2;
  const int lane = threadIdx.x & (group - 1);
  const int units = num_feat / kVec;
  if constexpr (kDenseNan<T>) {
    // Per column, the ray's slot rows that hold a NaN or an infinity.
    for (int f = threadIdx.x; f < num_feat; f += kFwdThreads) s_bad[f] = 0;
    __syncthreads();
    const int* vr = job.vids + r * job.num_stream;
    for (int k = threadIdx.x; k < job.num_stream * units; k += kFwdThreads) {
      const int u = k / units, c = k - u * units;
      const V x = RowLoad<T, kVec>::load(
          field + static_cast<long long>(max(__ldg(vr + u), 0)) * num_feat, c);
#pragma unroll
      for (int q = 0; q < kVec; ++q) {
        if (!isfinite(reinterpret_cast<const float*>(&x)[q])) atomicAdd(s_bad + c * kVec + q, 1);
      }
    }
    __syncthreads();
  }
  float* dst = job.out + (r * job.num_end + e0) * num_feat;
  for (int i0 = threadIdx.x >> group_log2; i0 < n; i0 += groups * kEndInFlight) {
    int vs[kEndInFlight][4];
    float4 ws[kEndInFlight];
#pragma unroll
    for (int q = 0; q < kEndInFlight; ++q) {
      const int i = i0 + q * groups;
      int4 v = make_int4(-1, -1, -1, -1);
      ws[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < n) {
        v = s_v[i];
        ws[q] = s_w[i];
      }
      vs[q][0] = v.x;
      vs[q][1] = v.y;
      vs[q][2] = v.z;
      vs[q][3] = v.w;
    }
    for (int c = lane; c < units; c += group) {
      V x[kEndInFlight][4];
#pragma unroll
      for (int q = 0; q < kEndInFlight; ++q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[q][j] = zero_vec<kVec>();
          if (vs[q][j] >= 0) {
            x[q][j] = RowLoad<T, kVec>::load(
                field + static_cast<long long>(vs[q][j]) * num_feat, c);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kEndInFlight; ++q) {
        const int i = i0 + q * groups;
        if (i < n) {
          V out = blend4(ws[q], x[q]);
          if constexpr (kDenseNan<T>) {
            // NaN where a non-finite slot row of the column is one this
            // endpoint does not weight (JAX: 0 * x).
            const unsigned first = s_first[i];
#pragma unroll
            for (int k = 0; k < kVec; ++k) {
              int reached = 0;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                reached += ((first >> j) & 1u) &&
                           !isfinite(reinterpret_cast<const float*>(&x[q][j])[k]);
              }
              if (s_bad[c * kVec + k] > reached) {
                reinterpret_cast<float*>(&out)[k] = CUDART_NAN_F;
              }
            }
          }
          reinterpret_cast<V*>(dst + static_cast<long long>(i) * num_feat)[c] = out;
        }
      }
    }
  }
}

template <int kVec, typename T>
void launch_blend(unsigned grid, const BlendBatch& batch, const void* field,
                  int num_feat, int group_log2, cudaStream_t stream) {
  const size_t smem = kDenseNan<T> ? static_cast<size_t>(num_feat) * sizeof(int) : 0;
  blend_kernel<kVec, T><<<grid, kFwdThreads, smem, stream>>>(
      batch, static_cast<const T*>(field), num_feat, group_log2);
}

}  // namespace

extern "C" int tetranerf_stream_blend_max_jobs() { return kBlendMaxJobs; }

// `jobs` is a host array of `num_jobs` x 7 int64: stream ids, positions,
// weights and output addresses; rays, endpoints and stream slots. The
// field's row type is `field_type` (a RowType); the outputs are f32. F
// must be even, the field and its rows aligned to 2 elements, positions
// and weights to 16 bytes. Jobs with no rays
// or endpoints are skipped; one launch runs the rest (at most
// kBlendMaxJobs), none if nothing is left.
extern "C" int tetranerf_stream_blend_gather_batch(
    const void* field, const long long* jobs, int num_jobs, int num_feat,
    int field_type, cudaStream_t stream) {
  const uint64_t esize = row_type_size(field_type);
  if (num_jobs > kBlendMaxJobs || num_feat <= 0 || num_feat % 2 || esize == 0 ||
      (field_type >= kRowE4M3FNUZ && num_feat > kMaxDenseNanCols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // float4 columns where the rows, the field and every output allow: 4
  // elements of the field's type, 16 bytes of f32 output.
  const uint64_t fbits = reinterpret_cast<uintptr_t>(field) |
                         static_cast<uint64_t>(num_feat) * esize;
  uint64_t obits = static_cast<uint64_t>(num_feat) * sizeof(float);
  for (int i = 0; i < num_jobs; ++i) {
    const long long* j = jobs + 7 * i;
    if ((static_cast<uint64_t>(j[1]) | static_cast<uint64_t>(j[2])) & 15) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    obits |= static_cast<uint64_t>(j[3]);
  }
  if ((obits & 7) || (fbits & (2 * esize - 1))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const int vec = ((obits & 15) == 0 && (fbits & (4 * esize - 1)) == 0) ? 4 : 2;
  const int units = num_feat / vec;
  int group_log2 = 0;
  while (group_log2 < 4 && (1 << group_log2) < units) ++group_log2;

  thread_local BlendBatch batch;  // kept off the host stack
  batch.num_jobs = 0;
  long long blocks = 0;
  for (int i = 0; i < num_jobs; ++i) {
    const long long* j = jobs + 7 * i;
    const long long rays = j[4], num_end = j[5], num_stream = j[6];
    if (rays <= 0 || num_end <= 0) continue;
    if (num_end > 0x7fffffffLL || num_stream > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long num_tiles = (num_end + kMaxTile - 1) / kMaxTile;
    BlendJob& job = batch.jobs[batch.num_jobs++];
    job.vids = reinterpret_cast<const int*>(j[0]);
    job.pos = reinterpret_cast<const int4*>(j[1]);
    job.bary = reinterpret_cast<const float4*>(j[2]);
    job.out = reinterpret_cast<float*>(j[3]);
    job.num_end = static_cast<int>(num_end);
    job.num_stream = static_cast<int>(num_stream);
    job.num_tiles = static_cast<int>(num_tiles);
    job.tile = static_cast<int>((num_end + num_tiles - 1) / num_tiles);
    job.first_block = static_cast<int>(blocks);
    blocks += rays * num_tiles;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>(blocks);
  return with_row_type(field_type, [&](auto tag) {
    using T = typename decltype(tag)::type;
    if (vec == 4) {
      launch_blend<4, T>(grid, batch, field, num_feat, group_log2, stream);
    } else {
      launch_blend<2, T>(grid, batch, field, num_feat, group_log2, stream);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

// K2b: the transpose of the stream blend, onto the per-ray stream rows.
//
//   gsf[r, u, :] = sum_{e, j : pos[r, e, j] == u} bary[r, e, j] * g[r, e, :]
//
// Replaces: tetranerf_tpu/ops/pallas_interp.py `_blend_bwd`
// (`_blend_bwd_kernel` :190, pallas_call at :214 via `_run_blend`), which
// built the [U, E] blend matrix per ray and contracted it with g in bf16 on
// the MXU. The scatter of the stream rows into the [V, F] field gradient is
// K7 (scatter.cu), a separate launch.
//
// Design: a block of 8 warps per (ray, tile of stream slots).
// 1. The grid spans rays x slot tiles; the launcher sizes the tile (at most
//    128 slots, a multiple of 8) from the shared-memory plan below. The
//    block stages its ray's pos and bary rows (E x 32 bytes) in shared
//    memory; beside them lies the tile's [tile, min(F, 64)] f32
//    accumulator.
// 2. Each warp owns a disjoint, equal range of the tile's slots, each lane
//    a float2 of feature columns (64 columns a pass). A warp scans the
//    endpoints in order, 32 at a time from shared memory; a ballot keeps
//    those with a nonzero weight on a slot of its range, and it reads
//    their g rows, eight in flight, and adds each weighted row into its
//    accumulator rows in (e, j) order. An endpoint that names one slot
//    twice adds twice; zero weights are skipped, so the g rows of padding
//    endpoints are never read.
// 3. The warp then writes its rows once, zeros included, in coalesced
//    256-byte rows. No zeroing pass over device memory, no atomics: every
//    output slot is written by one lane of one warp, and two launches give
//    the same bits.
//
// What bounds it on the H100: bytes, writing the dense [R, U, F] f32
// output plus reading the g rows of the weighted endpoints and pos/bary
// (0.23 ms at the train shape, 4096 rays x T=512 x F=64; ~0.13 ms for
// the 8 launches of a flagship step, at the 3.35 TB/s of an H100 SXM at
// 700 W, NVIDIA's data sheet). The g rows are gathers out of L2 (a ray's
// rows are read by the one or two warps whose slots they touch). The
// earlier design, one warp per ray zeroing its [U, F] slab and then adding
// each weighted endpoint with a chain of dependent load-add-stores in
// device memory: 0.64-0.68 ms at the train shape and 1.98 ms for the 8
// launches of a flagship step, on an H100 80GB HBM3 at 700 W.
//
// The low-precision out instances, for `field_stream_dtype` "bfloat16",
// "float16" and the 8- and 4-bit floats (JAX's `_blend_bwd` emits
// the cotangent in the primal's dtype, pallas_interp.py:257-268): the same
// f32 sums, each output pair rounded once to the stream's type as it is
// written (common.cuh `Row<T>::round2`, ml_dtypes' rounding: an e4m3fn
// sum past 464 is NaN, an f16 or e5m2 one past the range infinity, and an
// e4m3fn sum of at most 2^-10 rounds to zero, as in the reference; the
// software types round in integer arithmetic, `MiniRow::round1`), so the
// dense [R, U, F] output is a half or a quarter of the bytes; K7's
// instance of the same type then adds these rows into the f32 field
// gradient.

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdMaxTile = 128;   // stream slots a block owns, at most
constexpr int kBwdCols = 64;       // feature columns a pass (a float2 a lane)
constexpr int kBwdInFlight = 8;    // g rows a warp loads before adding them

// `OutT` is the stream-row gradient's type: float, or the stream's row
// type (the primal's dtype, as JAX's `_blend_bwd` emits it): the sums are
// f32 either way and rounded once, as they are written.
template <typename OutT>
__global__ void __launch_bounds__(kBwdThreads) blend_bwd_kernel(
    const float* __restrict__ g, const int* __restrict__ pos,
    const float* __restrict__ bary, OutT* __restrict__ gsf, int num_end,
    int num_stream, int num_feat, int tile, int num_tiles) {
  extern __shared__ float4 smem4[];
  int4* s_pos = reinterpret_cast<int4*>(smem4);          // [E]
  float4* s_bary = smem4 + num_end;                       // [E]
  float* s_acc = reinterpret_cast<float*>(s_bary + num_end);  // [tile, cols]
  const long long r = blockIdx.x / num_tiles;
  const int u0 = (blockIdx.x % num_tiles) * tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = tile / kBwdWarps;
  const int a = min(u0 + warp * per_warp, num_stream);  // this warp's slots [a, b)
  const int b = min(a + per_warp, num_stream);
  const int cols = min(num_feat, kBwdCols);

  const int4* pr = reinterpret_cast<const int4*>(pos) + r * num_end;
  const float4* br = reinterpret_cast<const float4*>(bary) + r * num_end;
  for (int e = threadIdx.x; e < num_end; e += kBwdThreads) {
    s_pos[e] = __ldg(pr + e);
    s_bary[e] = __ldg(br + e);
  }
  __syncthreads();

  const float* gr = g + r * num_end * num_feat;
  OutT* dst = gsf + r * num_stream * num_feat;
  // The lane's accumulator column in row 0 of the warp's range; rows are
  // `cols` floats apart. Only this lane ever touches these entries.
  float* acc = s_acc + (a - u0) * cols + 2 * lane;
  for (int f0 = 0; f0 < num_feat; f0 += kBwdCols) {
    const int col = f0 + 2 * lane;
    const bool active = 2 * lane < min(num_feat - f0, kBwdCols);
    if (active) {
      for (int j = 0; j < b - a; ++j) {
        *reinterpret_cast<float2*>(acc + j * cols) = make_float2(0.0f, 0.0f);
      }
    }
    for (int base = 0; base < num_end; base += 32) {
      const int e = base + lane;
      bool rel = false;
      if (e < num_end) {
        const int4 p = s_pos[e];
        const float4 w = s_bary[e];
        rel = (w.x != 0.0f && p.x >= a && p.x < b) ||
              (w.y != 0.0f && p.y >= a && p.y < b) ||
              (w.z != 0.0f && p.z >= a && p.z < b) ||
              (w.w != 0.0f && p.w >= a && p.w < b);
      }
      unsigned bal = __ballot_sync(0xffffffffu, rel);
      while (bal) {  // uniform across the warp
        int es[kBwdInFlight];
        float2 xs[kBwdInFlight];
#pragma unroll
        for (int q = 0; q < kBwdInFlight; ++q) {
          es[q] = -1;
          if (bal) {
            es[q] = base + __ffs(bal) - 1;
            bal &= bal - 1;
          }
        }
#pragma unroll
        for (int q = 0; q < kBwdInFlight; ++q) {
          xs[q] = make_float2(0.0f, 0.0f);
          if (es[q] >= 0 && active) {
            xs[q] = __ldg(reinterpret_cast<const float2*>(
                gr + static_cast<long long>(es[q]) * num_feat + col));
          }
        }
#pragma unroll
        for (int q = 0; q < kBwdInFlight; ++q) {
          if (es[q] < 0 || !active) continue;
          const int4 p = s_pos[es[q]];
          const float4 w = s_bary[es[q]];
          const int pj[4] = {p.x, p.y, p.z, p.w};
          const float wj[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (wj[j] != 0.0f && pj[j] >= a && pj[j] < b) {
              float2* row = reinterpret_cast<float2*>(acc + (pj[j] - a) * cols);
              float2 v = *row;
              v.x += wj[j] * xs[q].x;
              v.y += wj[j] * xs[q].y;
              *row = v;
            }
          }
        }
      }
    }
    if (active) {
      for (int j = 0; j < b - a; ++j) {
        store2(dst + static_cast<long long>(a + j) * num_feat + col,
               *reinterpret_cast<const float2*>(acc + j * cols));
      }
    }
  }
}

template <typename OutT>
int launch_blend_bwd(const float* g, const int* pos, const float* bary,
                     void* gsf, int num_rays, int num_end, int num_stream,
                     int num_feat, cudaStream_t stream) {
  constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90
  const size_t cols = static_cast<size_t>(num_feat < kBwdCols ? num_feat : kBwdCols);
  // Fewest tiles of at most kBwdMaxTile slots whose plan fits: the staged
  // pos/bary rows plus the accumulator.
  int num_tiles = (num_stream + kBwdMaxTile - 1) / kBwdMaxTile;
  if (num_tiles < 1) num_tiles = 1;
  int tile;
  size_t smem;
  for (;;) {
    const int slots = (num_stream + num_tiles - 1) / num_tiles;
    tile = kBwdWarps * ((slots + kBwdWarps - 1) / kBwdWarps);
    smem = static_cast<size_t>(num_end) * 32 + static_cast<size_t>(tile) * cols * 4;
    if (smem <= kMaxSmem || tile <= kBwdWarps) break;
    ++num_tiles;
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(num_rays) * num_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_bwd_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) {
    blend_bwd_kernel<OutT><<<static_cast<unsigned>(blocks), kBwdThreads, smem,
                             stream>>>(g, pos, bary, static_cast<OutT*>(gsf),
                                       num_end, num_stream, num_feat, tile,
                                       num_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `gsf`'s row type is `out_type` (a RowType). F must be even.
extern "C" int tetranerf_stream_blend_backward(
    const float* g, const int* pos, const float* bary, void* gsf,
    int num_rays, int num_end, int num_stream, int num_feat, int out_type,
    cudaStream_t stream) {
  if (num_feat <= 0 || num_feat % 2) return static_cast<int>(cudaErrorInvalidValue);
  return with_row_type(out_type, [&](auto tag) {
    using T = typename decltype(tag)::type;
    return launch_blend_bwd<T>(g, pos, bary, gsf, num_rays, num_end, num_stream,
                               num_feat, stream);
  });
}
