// K2: stream blend with the field row gather fused in.
//
//   out[r, e, :] = sum_j bary[r, e, j] * field[vids[r, pos[r, e, j]], :]
//
// Replaces: tetranerf_tpu/ops/pallas_interp.py `stream_blend` forward
// (`_blend_fwd_kernel` :172, pallas_call at :214) together with the
// `field[vids]` row gather in front of it (ops/fused.py:733). The TPU kernel
// built a [T+4, T+1] blend matrix per ray and contracted it on the MXU in
// bf16; here each endpoint reads its (at most four) field rows directly and
// sums in f32, so no [R, T+4, F] gathered stream is written to memory.
//
// What bounds it on the H100: one warp per endpoint, lanes over the feature
// axis (a float2 each), so every field row read and every output row write
// is one coalesced 256-byte transaction at F=64. The output [R, T+1, F]
// f32 is written densely (1.08 GB at 8192 x 513 x 64, about 0.3 ms of
// HBM write bandwidth); the row reads are random gathers from a field that
// fits the 50 MB L2 at 100K vertices (25.6 MB), so they are L2-gather-bound.
// Padding endpoints (all four weights zero, most of a ray's T+1 slots) skip
// their reads and write zeros.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) blend_kernel(
    const float* __restrict__ field, const int* __restrict__ vids,
    const int* __restrict__ pos, const float* __restrict__ bary,
    float* __restrict__ out, int num_rays, int num_end, int num_stream,
    int num_feat) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(num_rays) * num_end) return;
  const long long r = warp / num_end;
  const int4 p = __ldg(reinterpret_cast<const int4*>(pos) + warp);
  const float4 w = __ldg(reinterpret_cast<const float4*>(bary) + warp);
  const int* vr = vids + r * num_stream;
  const int pj[4] = {p.x, p.y, p.z, p.w};
  const float wj[4] = {w.x, w.y, w.z, w.w};
  const float* rows[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = wj[j] != 0.0f ? max(__ldg(vr + pj[j]), 0) : 0;
    rows[j] = field + static_cast<long long>(v) * num_feat;
  }
  float* dst = out + warp * num_feat;
  for (int f = 2 * lane; f < num_feat; f += 64) {
    float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (wj[j] != 0.0f) {
        const float2 x = __ldg(reinterpret_cast<const float2*>(rows[j] + f));
        acc.x += wj[j] * x.x;
        acc.y += wj[j] * x.y;
      }
    }
    *reinterpret_cast<float2*>(dst + f) = acc;
  }
}

}  // namespace

extern "C" int tetranerf_stream_blend_gather(
    const float* field, const int* vids, const int* pos, const float* bary,
    float* out, int num_rays, int num_end, int num_stream, int num_feat,
    cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long warps = static_cast<long long>(num_rays) * num_end;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  blend_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      field, vids, pos, bary, out, num_rays, num_end, num_stream, num_feat);
  return static_cast<int>(cudaGetLastError());
}
