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
// Design: one warp per ray, each lane owning a float2 of feature columns.
// The warp first zeroes its ray's [U, F] slab, then walks the ray's
// endpoints in order and, for each nonzero weight, adds bary * g[r, e] into
// stream row pos[r, e, j] with a plain load-add-store. Only that lane ever
// touches that column of that ray, so there are no atomics and the sums
// come out in endpoint order every run. Endpoints whose four weights are
// zero (the padding past a ray's valid prefix) are skipped after one 16-byte
// read of their weights.
//
// What bounds it on the H100: writing the dense [R, U, F] f32 output (541 MB
// at 4096 x 516 x 64: 0.16 ms at the 3.35 TB/s of an H100 SXM at 700 W,
// NVIDIA's data sheet) plus reading the g rows
// of the weighted endpoints. The read-modify-writes of a ray's touched rows
// hit L1/L2 (a ray's rows span U * 256 bytes), but each endpoint's update
// waits on the previous one's store: a latency chain of about num_valid steps
// per warp.

namespace {

__global__ void __launch_bounds__(256) blend_bwd_kernel(
    const float* __restrict__ g, const int* __restrict__ pos,
    const float* __restrict__ bary, float* __restrict__ gsf, int num_rays,
    int num_end, int num_stream, int num_feat) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= num_rays) return;
  float* dst = gsf + r * num_stream * num_feat;
  for (int u = 0; u < num_stream; ++u) {
    for (int f = 2 * lane; f < num_feat; f += 64) {
      *reinterpret_cast<float2*>(dst + u * num_feat + f) =
          make_float2(0.0f, 0.0f);
    }
  }
  const int4* pr = reinterpret_cast<const int4*>(pos) + r * num_end;
  const float4* br = reinterpret_cast<const float4*>(bary) + r * num_end;
  const float* gr = g + r * num_end * num_feat;
  for (int e = 0; e < num_end; ++e) {
    const float4 w = __ldg(br + e);
    if (w.x == 0.0f && w.y == 0.0f && w.z == 0.0f && w.w == 0.0f) continue;
    const int4 p = __ldg(pr + e);
    const int pj[4] = {p.x, p.y, p.z, p.w};
    const float wj[4] = {w.x, w.y, w.z, w.w};
    for (int f = 2 * lane; f < num_feat; f += 64) {
      const float2 x =
          __ldg(reinterpret_cast<const float2*>(gr + e * num_feat + f));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (wj[j] != 0.0f) {
          float2* row =
              reinterpret_cast<float2*>(dst + pj[j] * num_feat + f);
          float2 acc = *row;
          acc.x += wj[j] * x.x;
          acc.y += wj[j] * x.y;
          *row = acc;
        }
      }
    }
  }
}

}  // namespace

extern "C" int tetranerf_stream_blend_backward(
    const float* g, const int* pos, const float* bary, float* gsf,
    int num_rays, int num_end, int num_stream, int num_feat,
    cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long blocks =
      (static_cast<long long>(num_rays) * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  blend_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      g, pos, bary, gsf, num_rays, num_end, num_stream, num_feat);
  return static_cast<int>(cudaGetLastError());
}
