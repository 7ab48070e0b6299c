// K8: row gather with a column prefix.
//
//   out[i, :w] = table[idx[i], :w]    for i < M
//
// `table` is [N, W] with a row stride of its own (a prefix view of a wider
// tensor is fine) and 4-byte or 1-byte elements; `out` is a contiguous
// [M, w]. The kernel copies bytes: `row_bytes = w * element size`, so ids
// bit-cast into any column are copied as bits and never pass through float
// arithmetic. The indices are the caller's contract (0 <= idx[i] < N), as in
// the JAX version.
//
// Replaces: tetranerf_tpu/ops/pallas_gather.py `pallas_gather_rows`
// (`_gather_kernel` :29, pallas_call at :73), which copied one row per DMA
// into a VMEM block, a ring of `num_buffers` copies in flight, and needed
// W % 128 == 0 and M % block_rows == 0. On the port's path it cuts the
// quantile buckets of a march: each bucket's rays and its interval prefix
// of cells, t0, t1, valid (1-byte), the stream ids and the endpoint
// positions and weights (`ops/fused.py` `slice_march`, the JAX
// `_slice_march`, ops/fused.py:737-770).
//
// Design: one warp per output row, none of the Pallas constraints. Where
// the source and destination rows both start on a 16-byte boundary the
// lanes move 16 bytes each (int4 loads and stores, a warp moves 512 bytes
// per pass), else 4 bytes each where both start on a 4-byte boundary;
// whatever is left of the row goes byte by byte. The march tensors the
// path slices have rows of a multiple of 16 bytes at the bucket bounds
// (multiples of 8 steps), so they take the 16-byte path whole.
//
// What bounds it on the H100: bytes. Each output byte is read once from
// the table and written once (plus 4 bytes of index per row): 2 * M *
// row_bytes over the 3.35 TB/s of an H100 SXM at 700 W (NVIDIA's data
// sheet). Rows shorter than 512 bytes leave lanes idle; a later PR can
// give a warp several rows.

#include <stdint.h>

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) gather_kernel(
    const unsigned char* __restrict__ table, const int* __restrict__ idx,
    unsigned char* __restrict__ out, int num_out, long long src_stride,
    int row_bytes) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= num_out) return;
  const unsigned char* src = table + __ldg(idx + row) * src_stride;
  unsigned char* dst = out + row * row_bytes;
  const uintptr_t both =
      reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  int done = 0;
  if ((both & 15) == 0) {
    const int n = row_bytes >> 4;
    const int4* s = reinterpret_cast<const int4*>(src);
    int4* d = reinterpret_cast<int4*>(dst);
    for (int j = lane; j < n; j += 32) d[j] = __ldg(s + j);
    done = n << 4;
  } else if ((both & 3) == 0) {
    const int n = row_bytes >> 2;
    const unsigned int* s = reinterpret_cast<const unsigned int*>(src);
    unsigned int* d = reinterpret_cast<unsigned int*>(dst);
    for (int j = lane; j < n; j += 32) d[j] = __ldg(s + j);
    done = n << 2;
  }
  for (int j = done + lane; j < row_bytes; j += 32) dst[j] = __ldg(src + j);
}

}  // namespace

extern "C" int tetranerf_row_gather(const void* table, const int* idx,
                                    void* out, int num_out,
                                    long long src_stride_bytes, int row_bytes,
                                    cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long blocks =
      (static_cast<long long>(num_out) * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        static_cast<const unsigned char*>(table), idx,
        static_cast<unsigned char*>(out), num_out, src_stride_bytes,
        row_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}
