// K8: batched row gather with a column prefix.
//
//   out_j[i, :w_j] = table_j[idx_j[i], :w_j]    for every job j, i < M_j
//
// One launch runs a list of jobs. Each job names a source (any row stride,
// in bytes), a contiguous destination, its row bytes, an index vector and a
// row count. The kernel copies bytes, so ids bit-cast into float columns
// (denormals) are copied as bits and never pass through float arithmetic;
// nothing here is compiled with fast math. The indices are the caller's
// contract (0 <= idx[i] < N), as in the JAX version.
//
// Replaces: tetranerf_tpu/ops/pallas_gather.py `pallas_gather_rows`
// (`_gather_kernel` :29, pallas_call at :73), which copied one row per DMA
// into a VMEM block, a ring of `num_buffers` copies in flight, and needed
// W % 128 == 0 and M % block_rows == 0. On the port's path one launch cuts
// every quantile bucket of a step out of its march: per bucket its rays'
// interval prefix of cells, t0, t1, valid (1-byte), the stream ids, the
// endpoint positions and weights, the per-ray t_entry, hit, num_valid and
// overflow (1-column jobs) and the rays' origins and directions
// (`ops/fused.py` `slice_march_buckets`, the JAX `_slice_march`,
// ops/fused.py:737-770, once per bucket).
//
// Design. The job list is a kernel parameter (a `__grid_constant__` struct,
// read in place from the constant bank): no copy to the device, no extra
// launch. The host side gives each job a run of blocks, a prefix over the
// jobs' block counts; a block finds its job by binary search over the
// prefix (uniform across the block). Lane width follows alignment, per
// job: 16, 8, 4 or 1 bytes, the widest that divides the source and
// destination addresses, the source stride and the row bytes, so every row
// of the job is aligned and there is no tail. Lanes go to rows by row
// width: a row of n lane-units gets a group of the power of two at or
// above n lanes, at most a warp (a 512-byte row of 16-byte units takes a
// warp, a 4-byte per-ray value one lane), so a warp copies 32 / group rows
// side by side and few lanes idle.
//
// What bounds it on the H100: bytes. Each output byte is read once from
// the source and written once (plus 4 bytes of index per row): 2 * M *
// row_bytes over the 3.35 TB/s of an H100 SXM at 700 W (NVIDIA's data
// sheet). The earlier design, one launch per table and bucket (56 per
// step) with one warp per row: one cold slice's 56 launches took
// 2.09 / 2.49 / 1.95 ms by CUDA events on an H100 80GB HBM3 at 700 W,
// 0.206 ms of kernel time, against 0.171 for `index_select`.

#include <stdint.h>

#include "common.cuh"

namespace {

struct GatherJob {
  const unsigned char* src;
  unsigned char* dst;
  const int* idx;
  long long src_stride;  // bytes
  int row_bytes;
  int rows;
  int first_block;  // prefix over the jobs of their block counts
  int shape;        // log2(lane bytes) | log2(lanes per row) << 8
};

// The job list travels as a kernel parameter (6 KB): CUDA 12.1 raised the
// limit from 4,096 to 32,764 bytes (sm_70 and later). 128 jobs hold the
// preset's 8 buckets x 13; the wrapper splits a longer list.
static_assert(CUDART_VERSION >= 12010, "K8 needs CUDA 12.1 or later");
constexpr int kMaxJobs = 128;

struct GatherBatch {
  int num_jobs;
  GatherJob jobs[kMaxJobs];
};

constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ void copy_row(const unsigned char* src,
                                         unsigned char* dst, int n, int lane,
                                         int group) {
  const T* __restrict__ s = reinterpret_cast<const T*>(src);
  T* __restrict__ d = reinterpret_cast<T*>(dst);
  int j = lane;
  for (; j + 3 * group < n; j += 4 * group) {  // four loads in flight
    const T a = __ldg(s + j), b = __ldg(s + j + group);
    const T c = __ldg(s + j + 2 * group), e = __ldg(s + j + 3 * group);
    d[j] = a;
    d[j + group] = b;
    d[j + 2 * group] = c;
    d[j + 3 * group] = e;
  }
  for (; j < n; j += group) d[j] = __ldg(s + j);
}

__global__ void __launch_bounds__(kThreads)
    gather_kernel(const __grid_constant__ GatherBatch batch) {
  int lo = 0, hi = batch.num_jobs - 1;  // last job with first_block <= block
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (batch.jobs[mid].first_block <= static_cast<int>(blockIdx.x)) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const GatherJob& job = batch.jobs[lo];
  const int lane_log2 = job.shape & 0xff;
  const int group_log2 = job.shape >> 8;
  const int group = 1 << group_log2;
  const long long row =
      (static_cast<long long>(blockIdx.x - job.first_block) * kThreads +
       threadIdx.x) >> group_log2;
  if (row >= job.rows) return;
  const int lane = threadIdx.x & (group - 1);
  const unsigned char* src = job.src + __ldg(job.idx + row) * job.src_stride;
  unsigned char* dst = job.dst + row * job.row_bytes;
  const int n = job.row_bytes >> lane_log2;
  switch (lane_log2) {
    case 4: copy_row<int4>(src, dst, n, lane, group); break;
    case 3: copy_row<uint2>(src, dst, n, lane, group); break;
    case 2: copy_row<unsigned int>(src, dst, n, lane, group); break;
    default: copy_row<unsigned char>(src, dst, n, lane, group); break;
  }
}

}  // namespace

extern "C" int tetranerf_row_gather_max_jobs() { return kMaxJobs; }

// `jobs` is a host array of `num_jobs` x 6 int64: source address, source
// row stride in bytes, destination address, row bytes, index address, row
// count. Jobs with no rows or no bytes are skipped; one launch runs the
// rest (at most kMaxJobs of them), none if nothing is left.
extern "C" int tetranerf_row_gather_batch(const long long* jobs,
                                          int num_jobs, cudaStream_t stream) {
  if (num_jobs > kMaxJobs) return static_cast<int>(cudaErrorInvalidValue);
  thread_local GatherBatch batch;  // 6 KB: kept off the host stack
  batch.num_jobs = 0;
  long long blocks = 0;
  for (int i = 0; i < num_jobs; ++i) {
    const long long* j = jobs + 6 * i;
    const long long row_bytes = j[3], rows = j[5];
    if (rows <= 0 || row_bytes <= 0) continue;
    const uint64_t bits = static_cast<uint64_t>(j[0]) |
                          static_cast<uint64_t>(j[1]) |
                          static_cast<uint64_t>(j[2]) |
                          static_cast<uint64_t>(row_bytes);
    const int lane_log2 =
        (bits & 15) == 0 ? 4 : (bits & 7) == 0 ? 3 : (bits & 3) == 0 ? 2 : 0;
    const long long units = row_bytes >> lane_log2;
    int group_log2 = 0;
    while (group_log2 < 5 && (1LL << group_log2) < units) ++group_log2;
    if (row_bytes > 0x7fffffffLL || rows > 0x7fffffffLL || blocks > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    GatherJob& job = batch.jobs[batch.num_jobs++];
    job.src = reinterpret_cast<const unsigned char*>(j[0]);
    job.src_stride = j[1];
    job.dst = reinterpret_cast<unsigned char*>(j[2]);
    job.row_bytes = static_cast<int>(row_bytes);
    job.idx = reinterpret_cast<const int*>(j[4]);
    job.rows = static_cast<int>(rows);
    job.first_block = static_cast<int>(blocks);
    job.shape = lane_log2 | (group_log2 << 8);
    blocks += ((rows << group_log2) + kThreads - 1) / kThreads;
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        batch);
  }
  return static_cast<int>(cudaGetLastError());
}
