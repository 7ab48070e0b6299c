// K7: batched scatter-add of feature rows into one table.
//
//   out = zeros[num_rows, F];  out[idx_j[i], :] += values_j[i, :]
//   for every job j and every i with 0 <= idx_j[i] < num_rows (other rows
//   are dropped).
//
// Replaces: tetranerf_tpu/ops/pallas_scatter.py `scatter_add_rows`
// (`_scatter_kernel` :36, pallas_call at :105), the backward of its
// `gather_rows` (:132-162). On the port's train path one launch scatters
// the stream-row gradients of every quantile bucket of a step (K2b's
// outputs) into the one [V, F] field gradient (the JAX path's autodiff
// scatter of `field[max(vids, 0)]`, ops/fused.py:733, once per bucket).
//
// The TPU kernel kept a window of the table resident in VMEM and walked
// the rows serially, one window per pass over the input. Here:
// 1. The job list (index and value addresses, row counts) is a kernel
//    parameter (a `__grid_constant__` struct, as K8's); each job owns a run
//    of blocks, and a block finds its job by binary search over the prefix
//    of the jobs' block counts.
// 2. A row is owned by a lane group of min(16, F / 4) lanes (rounded up to
//    a power of two), each lane on a float4 of columns: float2 where F or
//    an address does not allow 16 bytes, single floats where F is odd.
//    Each group keeps 4 rows in flight: it reads their indices once (one
//    broadcast load per row), then their value vectors, then adds.
// 3. A lane whose values are all zero issues nothing (adding zero changes
//    nothing: +0 + -0 is +0). Any other lane issues one vector atomic,
//    `atomicAdd(float4*, float4)`, Hopper's `red.global.add.v4.f32`
//    (sm_90 and later, global memory only): a quarter of the atomics of one
//    per element. Most stream rows of a train step are zero (slots past a
//    ray's valid prefix, slots no endpoint weights), and the zero skip also
//    keeps those padding slots, whose vertex id is 0, from piling atomics
//    onto row 0.
// 4. The table is zeroed by cudaMemsetAsync on the same stream, once per
//    entry-point call: the wrapper splits a list longer than kMaxJobs
//    into several launches, and every later one adds into the same table.
// 5. NaN components issue no float add. A float atomic whose value or
//    target is NaN runs about 10x slower on the H100 (a flagship step's
//    float8_e8m0fnu rows, all NaN: 2.148 ms against 0.083-0.111 for the
//    other 8-bit types). A lane whose vector holds a NaN reads the target
//    through L1 and writes the canonical NaN by an integer exchange where
//    the target is not NaN yet: a target that is NaN stays NaN for the
//    rest of the launch, so a stale read costs at most one more exchange,
//    and padding's NaN rows on row 0 cost a cached read each. Its other
//    components are added as before. The sum is what the float atomics
//    gave: NaN wherever one of the rows is NaN.
//
// What bounds it on the H100: bytes. The indices and values are read once
// and the table written once per launch, not once per bucket: at the train
// slice's 4096 x 516 x 64 stream, 0.17 ms at the 3.35 TB/s of an H100 SXM
// at 700 W (NVIDIA's data sheet), of which the 25.6 MB table is 0.008 ms;
// ~0.08 ms for the 8 buckets of a flagship step. The L2 atomic rate for
// the nonzero vectors is the second limit.
//
// The earlier design, one thread per element issuing one scalar atomicAdd,
// one launch with its own zeroed [V, F] table per bucket (and autograd
// summing the 8 tables): 0.655-0.722 ms at the train shape, 0.301 ms of
// kernel time for the 8 launches of a flagship step, on an H100 80GB HBM3
// at 700 W.
//
// The order of the float additions into a row varies from run to run, so
// results agree with the plain version to rounding, not bit for bit.
//
// The low-precision row instances, for `field_stream_dtype` "bfloat16",
// "float16" and the 8- and 4-bit floats (replace the backward of
// tetranerf_tpu/ops/fused.py `gather_rows_lowp` :680-692): the values are
// K2b's stream-row gradients in that type; a lane reads 8, 4, 2 or 1 bytes
// of a row, widens them exactly (common.cuh `Row`) and adds them into the
// f32 table with the same vector atomics. The accumulation stays f32,
// which is the lever's point: 10-200 rows sum into a vertex row, which
// bf16's 8 significant bits (f16's 11, fp8's 1 to 5) could not carry. A
// half or a quarter of the value bytes; the atomics are the same. The
// seven software row types widen by bit arithmetic (common.cuh
// `MiniRow`).

#include <float.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

struct ScatterJob {
  const int* idx;
  const void* values;  // rows of the launch's row type
  int rows;
  int first_block;  // prefix over the jobs of their block counts
};

constexpr int kMaxJobs = 64;

struct ScatterBatch {
  int num_jobs;
  ScatterJob jobs[kMaxJobs];
};

constexpr int kThreads = 256;
constexpr int kRowsInFlight = 4;

template <int kVec>
struct Vec;
template <>
struct Vec<4> {
  __device__ static float4 zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static bool nonzero(float4 v) {
    return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
  }
  __device__ static bool has_nan(float4 v) {
    return v.x != v.x || v.y != v.y || v.z != v.z || v.w != v.w;
  }
  __device__ static float4 load(const float* p) { return __ldca(reinterpret_cast<const float4*>(p)); }
};
template <>
struct Vec<2> {
  __device__ static float2 zero() { return make_float2(0.0f, 0.0f); }
  __device__ static bool nonzero(float2 v) { return v.x != 0.0f || v.y != 0.0f; }
  __device__ static bool has_nan(float2 v) { return v.x != v.x || v.y != v.y; }
  __device__ static float2 load(const float* p) { return __ldca(reinterpret_cast<const float2*>(p)); }
};
template <>
struct Vec<1> {
  __device__ static float zero() { return 0.0f; }
  __device__ static bool nonzero(float v) { return v != 0.0f; }
  __device__ static bool has_nan(float v) { return v != v; }
  __device__ static float load(const float* p) { return __ldca(p); }
};

// `v` added into `*p` in the ordinary f32 add, which keeps a subnormal
// (the card's float atomics flush subnormal inputs and results to zero).
__device__ __forceinline__ void add_keeping_subnormals(float* p, float v) {
  unsigned* u = reinterpret_cast<unsigned*>(p);
  unsigned old = *u, assumed;
  do {
    assumed = old;
    old = atomicCAS(u, assumed, __float_as_uint(__uint_as_float(assumed) + v));
  } while (old != assumed);
}

// One widened row unit `x` added into the table at `dst`. float8_e8m0fnu's
// code 0 is 2^-127, an f32 subnormal, which a float atomic would add as 0:
// its components go through the ordinary add, the rest as before.
template <typename T, int kVec>
__device__ __forceinline__ void add_row(float* dst, const typename F32Vec<kVec>::T& x) {
  if constexpr (std::is_same<T, row_e8m0fnu>::value) {
    const float* xs = reinterpret_cast<const float*>(&x);
    bool subnormal = false;
#pragma unroll
    for (int k = 0; k < kVec; ++k) subnormal |= xs[k] != 0.0f && fabsf(xs[k]) < FLT_MIN;
    if (subnormal) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (xs[k] == 0.0f) continue;
        if (fabsf(xs[k]) < FLT_MIN) {
          add_keeping_subnormals(dst + k, xs[k]);
        } else {
          atomicAdd(dst + k, xs[k]);
        }
      }
      return;
    }
  }
  atomicAdd(reinterpret_cast<typename F32Vec<kVec>::T*>(dst), x);
}

// A widened row unit `x` with a NaN component added into the table at
// `dst` (header, 5.): its NaN components make the target NaN by an integer
// exchange; its other nonzero components are added one by one as `add_row`
// adds them. Both are skipped where the target already reads NaN.
template <typename T, int kVec>
__device__ __forceinline__ void add_nan_row(float* dst, const typename F32Vec<kVec>::T& x) {
  const typename F32Vec<kVec>::T seen = Vec<kVec>::load(dst);
  const float* xs = reinterpret_cast<const float*>(&x);
  const float* ts = reinterpret_cast<const float*>(&seen);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (ts[k] != ts[k]) continue;
    if (xs[k] != xs[k]) {
      atomicExch(reinterpret_cast<unsigned*>(dst + k), __float_as_uint(CUDART_NAN_F));
    } else if (xs[k] != 0.0f) {
      add_row<T, 1>(dst + k, xs[k]);
    }
  }
}

// `T` is the values' row type: float, or a stream row type of common.cuh
// (widened, then added into the f32 table).
template <int kVec, typename T>
__global__ void __launch_bounds__(kThreads) scatter_add_kernel(
    const __grid_constant__ ScatterBatch batch, float* __restrict__ out,
    int num_rows, int num_feat, int group_log2) {
  using V = typename F32Vec<kVec>::T;
  int lo = 0, hi = batch.num_jobs - 1;  // last job with first_block <= block
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (batch.jobs[mid].first_block <= static_cast<int>(blockIdx.x)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const ScatterJob& job = batch.jobs[lo];
  const int group = 1 << group_log2;
  const int groups = kThreads >> group_log2;
  const int lane = threadIdx.x & (group - 1);
  // Row k of this group: base + k * groups, so the groups of a warp read
  // neighbouring rows.
  const long long base =
      static_cast<long long>(blockIdx.x - job.first_block) * groups *
          kRowsInFlight +
      (threadIdx.x >> group_log2);
  int v[kRowsInFlight];
#pragma unroll
  for (int k = 0; k < kRowsInFlight; ++k) {
    const long long row = base + k * groups;
    v[k] = row < job.rows ? __ldg(job.idx + row) : -1;
    if (v[k] >= num_rows) v[k] = -1;
  }
  const int units = num_feat / kVec;
  for (int c = lane; c < units; c += group) {
    V x[kRowsInFlight];
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      x[k] = Vec<kVec>::zero();
      if (v[k] >= 0) {
        x[k] = RowLoad<T, kVec>::load(
            static_cast<const T*>(job.values) + (base + k * groups) * num_feat, c);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      if (v[k] >= 0 && Vec<kVec>::nonzero(x[k])) {
        float* dst = out + static_cast<long long>(v[k]) * num_feat + c * kVec;
        if (Vec<kVec>::has_nan(x[k])) {
          add_nan_row<T, kVec>(dst, x[k]);
        } else {
          add_row<T, kVec>(dst, x[k]);
        }
      }
    }
  }
}

template <int kVec, typename T>
void launch_scatter(unsigned grid, const ScatterBatch& batch, float* out,
                    int num_rows, int num_feat, int group_log2,
                    cudaStream_t stream) {
  scatter_add_kernel<kVec, T><<<grid, kThreads, 0, stream>>>(
      batch, out, num_rows, num_feat, group_log2);
}

template <typename T>
void launch_scatter_vec(int vec, unsigned grid, const ScatterBatch& batch,
                        float* out, int num_rows, int num_feat, int group_log2,
                        cudaStream_t stream) {
  if (vec == 4) {
    launch_scatter<4, T>(grid, batch, out, num_rows, num_feat, group_log2, stream);
  } else if (vec == 2) {
    launch_scatter<2, T>(grid, batch, out, num_rows, num_feat, group_log2, stream);
  } else {
    launch_scatter<1, T>(grid, batch, out, num_rows, num_feat, group_log2, stream);
  }
}

}  // namespace

extern "C" int tetranerf_scatter_add_max_jobs() { return kMaxJobs; }

// `jobs` is a host array of `num_jobs` x 3 int64: index address, values
// address, row count. The values' row type is `values_type` (a RowType);
// the table is f32. `zero` != 0 zeroes the [num_rows, num_feat] table
// first. Jobs with no rows are skipped; one launch runs the rest (at most
// kMaxJobs of them), none if nothing is left.
extern "C" int tetranerf_scatter_add_rows_batch(
    const long long* jobs, int num_jobs, float* out, int num_rows,
    int num_feat, int zero, int values_type, cudaStream_t stream) {
  const uint64_t esize = row_type_size(values_type);
  if (num_jobs > kMaxJobs || num_feat <= 0 || num_rows < 0 || esize == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (zero) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, static_cast<size_t>(num_rows) * num_feat * sizeof(float),
        stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // The widest vector that divides the table's row bytes and address (f32)
  // and every values row and address (in the values' type).
  const uint64_t obits = reinterpret_cast<uintptr_t>(out) |
                         static_cast<uint64_t>(num_feat) * sizeof(float);
  uint64_t vbits = static_cast<uint64_t>(num_feat) * esize;
  for (int i = 0; i < num_jobs; ++i) vbits |= static_cast<uint64_t>(jobs[3 * i + 1]);
  if (vbits & (esize - 1)) return static_cast<int>(cudaErrorMisalignedAddress);
  const int vec = ((obits & 15) == 0 && (vbits & (4 * esize - 1)) == 0)   ? 4
                  : ((obits & 7) == 0 && (vbits & (2 * esize - 1)) == 0) ? 2
                                                                         : 1;
  const int units = num_feat / vec;
  int group_log2 = 0;
  while (group_log2 < 4 && (1 << group_log2) < units) ++group_log2;
  const long long rows_per_block =
      static_cast<long long>(kThreads >> group_log2) * kRowsInFlight;

  thread_local ScatterBatch batch;  // kept off the host stack
  batch.num_jobs = 0;
  long long blocks = 0;
  for (int i = 0; i < num_jobs; ++i) {
    const long long* j = jobs + 3 * i;
    const long long rows = j[2];
    if (rows <= 0) continue;
    if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    ScatterJob& job = batch.jobs[batch.num_jobs++];
    job.idx = reinterpret_cast<const int*>(j[0]);
    job.values = reinterpret_cast<const void*>(j[1]);
    job.rows = static_cast<int>(rows);
    job.first_block = static_cast<int>(blocks);
    blocks += (rows + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>(blocks);
  return with_row_type(values_type, [&](auto tag) {
    launch_scatter_vec<typename decltype(tag)::type>(vec, grid, batch, out, num_rows,
                                                     num_feat, group_log2, stream);
    return static_cast<int>(cudaGetLastError());
  });
}
