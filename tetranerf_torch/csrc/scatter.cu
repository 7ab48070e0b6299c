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
// 2. Every lane reads 16 bytes of a row, whatever the row type: a row is
//    owned by a group of F * sizeof(T) / 16 lanes (at most 16, a power of
//    two; 16 for a 64-wide f32 row, 8 for a 2-byte row, 4 for a 1-byte
//    row). Where the row width or a values address forbids 16 bytes, a
//    lane reads 8, 4 or one element; and where the table's row (F f32)
//    takes no float4, a lane's elements are at most what it takes.
//    float8_e8m0fnu, which has no zero code, takes 4 elements a lane: none
//    of its chunks can be skipped, and its NaN rows (every row of a
//    flagship step: its loss is NaN) wait on reads of the table, which
//    more lanes hide (with 16-byte lanes it ran slower than the earlier
//    layout: PERF.md, K7's rows).
// 3. A lane's 16 bytes are 1, 2 or 4 chunks of 4 elements (one float4
//    each). A chunk whose codes all encode +-0 is neither widened nor added
//    (adding zero changes nothing: +0 + -0 is +0), tested on the raw bits
//    against the row type's zero codes (common.cuh `ZeroCode`, the same
//    table as stream_dtypes.py `StreamType.zero_mask`: 0x00 and 0x80 of
//    e4m3fn, e5m2, e3m4 and e4m3, 0x0000 and 0x8000 of f16 and bf16, 0x0
//    and 0x8 of float4_e2m1fn, only 0x00 of the fnuz types, whose 0x80 is
//    NaN, none of float8_e8m0fnu, whose code 0 is 2^-127). Any other chunk
//    is widened exactly (common.cuh `Row`) and issues one vector atomic,
//    `atomicAdd(float4*, float4)`, Hopper's `red.global.add.v4.f32`
//    (sm_90 and later, global memory only): a quarter of the atomics of one
//    per element. The two lanes of a pair swap half their chunks first, so
//    that each atomic instruction of the pair fills whole 32-byte sectors
//    of the table, as a 16-lane f32 row's do (without the swap a 2-byte
//    row's atomics cost half again as much). Most stream rows of a train
//    step are zero (slots no endpoint weights; every row of the fp8 and
//    software streams in a flagship step), and the zero skip also keeps
//    rows on a hot id from piling atomics onto it.
// 4. Rows in flight: a group holds 4 rows at once, and a block its 256
//    lanes' rows (a block walking more batches of rows, the next one's
//    loaded while the current one is added, and 2 or 8 rows a group were
//    no faster: PERF.md, K7's rows). A row's values are loaded with its id,
//    not after it: only the atomic's address needs the id. That, with
//    16-byte lanes, took the 1-byte instances from the f32 instance's row
//    rate to about its byte rate.
// 5. The table is zeroed by cudaMemsetAsync on the same stream, once per
//    entry-point call: the wrapper splits a list longer than kMaxJobs
//    into several launches, and every later one adds into the same table.
// 6. NaN components issue no float add. A float atomic whose value or
//    target is NaN runs about 10x slower on the H100 (a flagship step's
//    float8_e8m0fnu rows, all NaN: 2.148 ms against 0.083-0.111 for the
//    other 8-bit types). A lane whose row part holds a NaN reads the
//    targets of its NaN chunks through L1, all together, and writes the
//    canonical NaN by an integer exchange where a target is not NaN yet: a
//    target that is NaN stays NaN for the rest of the launch. Its other
//    components are added as before. The sum is what the float atomics
//    gave: NaN wherever one of the rows is NaN.
// 7. A march stream's job may carry its rays' num_valid: a ray's slots past
//    num_valid + 4 are padding that no endpoint weights (37% of a cold
//    flagship step's rows, all on id 0), where K2b wrote the row type's
//    rounding of 0. Their rows are not read. +0 adds nothing;
//    float8_e8m0fnu has no zero, and its padding rows are NaN: K7 reads
//    their ids, not their rows, and adds one NaN row for each run of one
//    id among the job's padding rows (read as rows, a cold step's 435K
//    NaN rows on id 0 piled integer exchanges onto that one row).
//
// What bounds it on the H100: bytes. The indices and values are read once
// and the table written once per launch, not once per bucket: at the train
// slice's 4096 x 516 x 64 stream, 0.17 ms at the 3.35 TB/s of an H100 SXM
// at 700 W (NVIDIA's data sheet), of which the 25.6 MB table is 0.008 ms;
// ~0.08 ms for the 8 buckets of a cold flagship step in f32 with every slot
// read, 0.054 in a 2-byte and 0.032 in a 1-byte row type. The L2 atomic
// rate for the nonzero chunks is the second limit. Until the 16-byte lanes, a group of
// min(16, F / 4) lanes owned a row whatever its type, each lane reading
// 4 elements (4 bytes of a 1-byte row), and a row's values waited for its
// id: the 1-byte instances then handled rows at the f32 instance's rate,
// at 23-39% of their bound (PERF.md, rows 7-f8, 7-sw).
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
// K2b's stream-row gradients in that type, widened exactly and added into
// the f32 table with the same vector atomics. The accumulation stays f32,
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
  // Null, or the rows are `width` slots a ray of a march stream and ray
  // r's slots past num_valid[r] + kStreamHead are not read (header, 7.).
  const int* num_valid;
  int rows;
  int width;
  int first_block;  // prefix over the jobs of their block counts
};

// A march stream's slots before its first step: the entry cell's vertices.
constexpr int kStreamHead = 4;

constexpr int kMaxJobs = 64;
constexpr int kJobFields = 5;

struct ScatterBatch {
  int num_jobs;
  ScatterJob jobs[kMaxJobs];
};

constexpr int kThreads = 256;
// Rows a lane group holds in flight (header, 4.).
constexpr int kRowsInFlight = 4;

template <int kVec>
struct Vec;
template <>
struct Vec<4> {
  __device__ static bool has_nan(float4 v) {
    return v.x != v.x || v.y != v.y || v.z != v.z || v.w != v.w;
  }
  __device__ static float4 load(const float* p) { return __ldca(reinterpret_cast<const float4*>(p)); }
};
template <>
struct Vec<2> {
  __device__ static bool has_nan(float2 v) { return v.x != v.x || v.y != v.y; }
  __device__ static float2 load(const float* p) { return __ldca(reinterpret_cast<const float2*>(p)); }
};
template <>
struct Vec<1> {
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
// `dst`, which read `seen` (header, 6.): its NaN components make the
// target NaN by an integer exchange; its other nonzero components are
// added one by one as `add_row` adds them. Both are skipped where the
// target read NaN.
template <typename T, int kVec>
__device__ __forceinline__ void add_nan_row(float* dst, const typename F32Vec<kVec>::T& x,
                                            const typename F32Vec<kVec>::T& seen) {
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

// kLoad bytes of a row, read as one load through the read-only path and
// held as 32-bit words (below 4 bytes one word, zero-extended).
template <int kLoad>
struct Words {
  static constexpr int kCount = kLoad < 4 ? 1 : kLoad / 4;
  unsigned w[kCount];
  __device__ __forceinline__ void load(const unsigned char* p) {
    if constexpr (kLoad == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = v.x;
      w[1] = v.y;
      w[2] = v.z;
      w[3] = v.w;
    } else if constexpr (kLoad == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x;
      w[1] = v.y;
    } else if constexpr (kLoad == 4) {
      w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else if constexpr (kLoad == 2) {
      w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
    } else {
      w[0] = __ldg(p);
    }
  }
  // Every byte of `word`'s pattern.
  __device__ __forceinline__ void fill(unsigned word) {
#pragma unroll
    for (int i = 0; i < kCount; ++i) w[i] = kLoad < 4 ? word & ((1u << (8 * kLoad)) - 1u) : word;
  }
};

// A lane's kLoad bytes of a row of `T`: kElems elements, added as kChunks
// f32 vectors of kVec (each one `red.global.add` of kVec floats).
template <typename T, int kLoad>
struct Lane {
  static constexpr int kSize = static_cast<int>(sizeof(T));
  static constexpr int kElems = kLoad / kSize;
  static constexpr int kVec = kElems < 4 ? kElems : 4;
  static constexpr int kChunks = kElems / kVec;
  static constexpr int kChunkWords = kVec * kSize / 4;  // 0 below a word: one chunk
  using V = typename F32Vec<kVec>::T;

  // Whether chunk `i` holds only codes of +-0 (ZeroCode), from the raw
  // bits: such a chunk is neither widened nor added.
  __device__ static bool zero(const Words<kLoad>& x, int i) {
    if constexpr (!ZeroCode<T>::kHas) {
      return false;
    } else {
      unsigned bits = x.w[0];
      if constexpr (kChunkWords > 0) {
        bits = x.w[i * kChunkWords];
#pragma unroll
        for (int j = 1; j < kChunkWords; ++j) bits |= x.w[i * kChunkWords + j];
      }
      return (bits & ZeroCode<T>::kWord) == 0u;
    }
  }

  // Chunk `i` widened to f32, exactly (common.cuh `Row`).
  __device__ static V widen(const Words<kLoad>& x, int i) {
    if constexpr (std::is_same<T, float>::value) {
      if constexpr (kVec == 4) {
        return make_float4(__uint_as_float(x.w[4 * i]), __uint_as_float(x.w[4 * i + 1]),
                           __uint_as_float(x.w[4 * i + 2]), __uint_as_float(x.w[4 * i + 3]));
      } else if constexpr (kVec == 2) {
        return make_float2(__uint_as_float(x.w[2 * i]), __uint_as_float(x.w[2 * i + 1]));
      } else {
        return __uint_as_float(x.w[i]);
      }
    } else {
      using R = Row<T>;
      using Pair = typename R::Pair;
      if constexpr (kVec == 4) {
        float2 a, b;
        if constexpr (kSize == 2) {
          a = R::widen2(static_cast<Pair>(x.w[2 * i]));
          b = R::widen2(static_cast<Pair>(x.w[2 * i + 1]));
        } else {
          a = R::widen2(static_cast<Pair>(x.w[i] & 0xFFFFu));
          b = R::widen2(static_cast<Pair>(x.w[i] >> 16));
        }
        return make_float4(a.x, a.y, b.x, b.y);
      } else if constexpr (kVec == 2) {
        return R::widen2(static_cast<Pair>(x.w[0]));
      } else {
        return R::widen(static_cast<typename R::Raw>(x.w[0]));
      }
    }
  }
};

// The chunks of the two lanes of a pair (lanes 2p and 2p + 1 of a group)
// exchanged so that chunk i of lane h is the pair's 4-column block 2i + h:
// each vector atomic of the pair then fills one 32-byte sector of the
// table (header, 3.). Lane h sends the chunks of the other parity. Every
// lane of the warp takes part.
template <typename T, int kLoad>
__device__ __forceinline__ void pair_exchange(Words<kLoad>& x, int h) {
  using L = Lane<T, kLoad>;
  constexpr int kHalf = L::kChunks / 2;
  constexpr int kW = L::kChunkWords;
  unsigned got[kHalf][kW];
#pragma unroll
  for (int m = 0; m < kHalf; ++m) {
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const unsigned send = h ? x.w[2 * m * kW + j] : x.w[(2 * m + 1) * kW + j];
      got[m][j] = __shfl_xor_sync(0xffffffffu, send, 1);
    }
  }
  Words<kLoad> y;
#pragma unroll
  for (int i = 0; i < L::kChunks; ++i) {
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      y.w[i * kW + j] = i < kHalf ? (h ? got[i][j] : x.w[2 * i * kW + j])
                                  : (h ? x.w[(2 * (i - kHalf) + 1) * kW + j]
                                       : got[i - kHalf][j]);
    }
  }
  x = y;
}

// `T` is the values' row type: float, or a stream row type of common.cuh
// (widened, then added into the f32 table). A lane reads kLoad bytes of a
// row, at most 16 (header, 2.).
template <typename T, int kLoad>
__global__ void __launch_bounds__(kThreads) scatter_add_kernel(
    const __grid_constant__ ScatterBatch batch, float* __restrict__ out,
    int num_rows, int num_feat, int group_log2) {
  using L = Lane<T, kLoad>;
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
  const long long row_bytes = static_cast<long long>(num_feat) * L::kSize;
  const int units = static_cast<int>(row_bytes / kLoad);
  const unsigned char* values = static_cast<const unsigned char*>(job.values);
  // Row k of this group: first + k * groups, so the groups of a warp read
  // neighbouring rows.
  const long long first =
      static_cast<long long>(blockIdx.x - job.first_block) * groups * kRowsInFlight +
      (threadIdx.x >> group_log2);
  // Lane pairs exchange chunks where every lane of the warp takes the same
  // loads: 2 or 4 chunks a lane, whole groups of at least 2.
  const bool paired = L::kChunks >= 2 && group >= 2 && units % group == 0;
  const int h = paired ? (lane & 1) : 0;
  const int step = paired ? 2 * L::kVec : L::kVec;  // columns from chunk to chunk
  for (int c = lane; c < units; c += group) {
    const int col = (c - h) * L::kElems + h * L::kVec;
    int id[kRowsInFlight];
    Words<kLoad> x[kRowsInFlight];
    // A row's id and values are loaded together: the values do not wait
    // for the id. A stream job's padding slots are read not at all.
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      const long long row = first + static_cast<long long>(k) * groups;
      bool read = row < job.rows;
      id[k] = -1;
      if (read && job.num_valid != nullptr) {
        const int r = static_cast<int>(static_cast<unsigned>(row) /
                                       static_cast<unsigned>(job.width));
        const int u = static_cast<int>(row) - r * job.width;
        const int used = __ldg(job.num_valid + r) + kStreamHead;
        read = u < used;
        if constexpr (!ZeroCode<T>::kHas) {
          if (!read) {
            const int v = __ldg(job.idx + row);
            bool first_of_run = true;
            if (u > used) {
              first_of_run = __ldg(job.idx + row - 1) != v;
            } else if (r > 0 && __ldg(job.num_valid + r - 1) + kStreamHead < job.width) {
              first_of_run = __ldg(job.idx + row - u - 1) != v;
            }
            if (first_of_run) {
              id[k] = v;
              x[k].fill(ZeroCode<T>::kRoundedWord);
            }
          }
        }
      }
      if (read) {
        id[k] = __ldg(job.idx + row);
        x[k].load(values + row * row_bytes + static_cast<long long>(c) * kLoad);
      }
    }
    if constexpr (L::kChunks >= 2) {
      if (paired) {
#pragma unroll
        for (int k = 0; k < kRowsInFlight; ++k) pair_exchange<T, kLoad>(x[k], h);
      }
    }
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      const int v = id[k];
      if (v < 0 || v >= num_rows) continue;
      float* dst = out + static_cast<long long>(v) * num_feat + col;
      bool nan = false;
#pragma unroll
      for (int i = 0; i < L::kChunks; ++i) {
        nan |= !L::zero(x[k], i) && Vec<L::kVec>::has_nan(L::widen(x[k], i));
      }
      if (!nan) {
#pragma unroll
        for (int i = 0; i < L::kChunks; ++i) {
          if (!L::zero(x[k], i)) add_row<T, L::kVec>(dst + i * step, L::widen(x[k], i));
        }
        continue;
      }
      // A row part with a NaN: the targets of its NaN chunks are read
      // first, all together, then each chunk is added.
      typename L::V seen[L::kChunks];
#pragma unroll
      for (int i = 0; i < L::kChunks; ++i) {
        if (!L::zero(x[k], i) && Vec<L::kVec>::has_nan(L::widen(x[k], i))) {
          seen[i] = Vec<L::kVec>::load(dst + i * step);
        }
      }
#pragma unroll
      for (int i = 0; i < L::kChunks; ++i) {
        if (L::zero(x[k], i)) continue;
        const typename L::V f = L::widen(x[k], i);
        if (Vec<L::kVec>::has_nan(f)) {
          add_nan_row<T, L::kVec>(dst + i * step, f, seen[i]);
        } else {
          add_row<T, L::kVec>(dst + i * step, f);
        }
      }
    }
  }
}

template <typename T, int kLoad>
int launch_scatter(unsigned grid, const ScatterBatch& batch, float* out, int num_rows,
                   int num_feat, int group_log2, cudaStream_t stream) {
  scatter_add_kernel<T, kLoad><<<grid, kThreads, 0, stream>>>(batch, out, num_rows, num_feat,
                                                              group_log2);
  return static_cast<int>(cudaGetLastError());
}

// The launch for a lane load of `load` bytes: 16, 8, 4 or one element (a
// type without zero: 4 or one).
template <typename T>
int launch_scatter_load(int load, unsigned grid, const ScatterBatch& batch, float* out,
                        int num_rows, int num_feat, int group_log2, cudaStream_t stream) {
  if constexpr (ZeroCode<T>::kHas) {
    if (load == 16) {
      return launch_scatter<T, 16>(grid, batch, out, num_rows, num_feat, group_log2, stream);
    }
    if (load == 8) {
      return launch_scatter<T, 8>(grid, batch, out, num_rows, num_feat, group_log2, stream);
    }
  }
  if (load == 4) {
    return launch_scatter<T, 4>(grid, batch, out, num_rows, num_feat, group_log2, stream);
  }
  if constexpr (sizeof(T) < 4) {
    if (load == static_cast<int>(sizeof(T))) {
      return launch_scatter<T, sizeof(T)>(grid, batch, out, num_rows, num_feat, group_log2,
                                          stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int tetranerf_scatter_add_max_jobs() { return kMaxJobs; }

// `jobs` is a host array of `num_jobs` x kJobFields int64: index address,
// values address, row count, and for a march stream's rows its num_valid
// address (i32, a ray each) and slots a ray (0 and 0 for other rows). The
// values' row type is `values_type` (a RowType); the table is f32. `zero` != 0 zeroes the [num_rows, num_feat] table
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
  // A lane's load: the widest of 16, 8 and 4 bytes (or one element) that
  // divides every values row and address; its f32 vectors (up to 4 floats)
  // must divide the table's row bytes and address, so where the table
  // takes fewer than 4 a lane's elements are at most as many.
  const uint64_t obits = reinterpret_cast<uintptr_t>(out) |
                         static_cast<uint64_t>(num_feat) * sizeof(float);
  const uint64_t table_vec = (obits & 15) == 0 ? 4 : (obits & 7) == 0 ? 2 : 1;
  uint64_t vbits = static_cast<uint64_t>(num_feat) * esize;
  for (int i = 0; i < num_jobs; ++i) vbits |= static_cast<uint64_t>(jobs[kJobFields * i + 1]);
  if (vbits & (esize - 1)) return static_cast<int>(cudaErrorMisalignedAddress);
  // A type without a zero code (float8_e8m0fnu) has no chunk to skip:
  // each goes through the widening and the NaN path, and a lane takes one
  // (4 elements), so that four times the lanes share that work (header, 2.).
  uint64_t load = esize;
  const uint64_t widest = row_type_zero_mask(values_type) < 0 ? 4 * esize : 16;
  const uint64_t loads[] = {16, 8, 4};
  for (const uint64_t l : loads) {
    if (l <= widest && l >= esize && (vbits & (l - 1)) == 0 &&
        (table_vec == 4 || l / esize <= table_vec)) {
      load = l;
      break;
    }
  }
  // A row is owned by a group of (row bytes / load) lanes, at most 16,
  // rounded up to a power of two.
  const uint64_t units = static_cast<uint64_t>(num_feat) * esize / load;
  int group_log2 = 0;
  while (group_log2 < 4 && (1u << group_log2) < units) ++group_log2;
  const long long rows_per_block =
      static_cast<long long>(kThreads >> group_log2) * kRowsInFlight;

  thread_local ScatterBatch batch;  // kept off the host stack
  batch.num_jobs = 0;
  long long blocks = 0;
  for (int i = 0; i < num_jobs; ++i) {
    const long long* j = jobs + kJobFields * i;
    const long long rows = j[2];
    if (rows <= 0) continue;
    if (rows > 0x7fffffffLL || (j[3] != 0 && (j[4] <= 0 || rows % j[4] != 0))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    ScatterJob& job = batch.jobs[batch.num_jobs++];
    job.idx = reinterpret_cast<const int*>(j[0]);
    job.values = reinterpret_cast<const void*>(j[1]);
    job.num_valid = reinterpret_cast<const int*>(j[3]);
    job.rows = static_cast<int>(rows);
    job.width = static_cast<int>(j[4]);
    job.first_block = static_cast<int>(blocks);
    blocks += (rows + rows_per_block - 1) / rows_per_block;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  const unsigned grid = static_cast<unsigned>(blocks);
  return with_row_type(values_type, [&](auto tag) {
    return launch_scatter_load<typename decltype(tag)::type>(
        static_cast<int>(load), grid, batch, out, num_rows, num_feat, group_log2, stream);
  });
}

// ZeroCode's mask of the row type `code` (common.cuh `row_type_zero_mask`):
// what the kernels take for +-0 codes, held to stream_dtypes.py's table.
extern "C" int tetranerf_row_zero_mask(int code) { return row_type_zero_mask(code); }
