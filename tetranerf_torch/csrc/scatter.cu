// K7: scatter-add of feature rows into a table.
//
//   out = zeros[num_rows, F];  out[idx[i], :] += values[i, :]
//   for every i with 0 <= idx[i] < num_rows (other rows are dropped).
//
// Replaces: tetranerf_tpu/ops/pallas_scatter.py `scatter_add_rows`
// (`_scatter_kernel` :36, pallas_call at :105), the backward of its
// `gather_rows` (:132-162). On the port's train path it scatters the
// stream-row gradient of K2b into the [V, F] field gradient (the JAX path's
// autodiff scatter of `field[max(vids, 0)]`, ops/fused.py:733).
//
// The TPU kernel kept a window of the table resident in VMEM and walked
// the rows serially, one window per pass over the input. Here every
// (row, column) element is one thread that issues one float atomicAdd into
// the table (a RED to L2, no return value): reads of `values` are
// coalesced, and the 64 columns of a row hit one 256-byte line. The table
// is zeroed with cudaMemsetAsync on the same stream first.
//
// What bounds it on the H100: reading `values` (N x F f32, 541 MB for the
// train slice's 4096 x 516 x 64 stream: 0.16 ms at the 3.35 TB/s of an H100
// SXM at 700 W, NVIDIA's data sheet) and the L2 atomic throughput for
// the nonzero elements. Most stream rows of a train step are zero (padding
// slots past a ray's valid prefix, slots no endpoint references), and
// adding zero changes nothing (+0 + -0 is +0), so zero elements issue no
// atomic. That also keeps the padding slots, whose vertex id is 0, from
// piling atomics onto row 0.
//
// The order of the float additions into a row varies from run to run, so
// results agree with the plain version to rounding, not bit for bit.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) scatter_add_kernel(
    const int* __restrict__ idx, const float* __restrict__ values,
    float* __restrict__ out, long long num_elems, int num_rows,
    int num_feat) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= num_elems) return;
  const long long row = i / num_feat;
  const int col = static_cast<int>(i - row * num_feat);
  const int v = __ldg(idx + row);
  if (v < 0 || v >= num_rows) return;
  const float x = __ldg(values + i);
  if (x == 0.0f) return;
  atomicAdd(out + static_cast<long long>(v) * num_feat + col, x);
}

}  // namespace

extern "C" int tetranerf_scatter_add_rows(
    const int* idx, const float* values, float* out, int num_in,
    int num_rows, int num_feat, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(num_rows) * num_feat * sizeof(float),
      stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  const long long elems = static_cast<long long>(num_in) * num_feat;
  const long long blocks = (elems + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > 0) {
    scatter_add_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(idx, values, out, elems, num_rows,
                                   num_feat);
  }
  return static_cast<int>(cudaGetLastError());
}
