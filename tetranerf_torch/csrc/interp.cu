// K3: sample <-> interval match fused with the endpoint lerp.
//
//   k     = #(t1[r, :] <= d)            (binary search on the sorted row)
//   mask  = ray_mask[r] & (k < num_valid[r]) & (d >= t0[r, k])
//   frac  = clip((d - t0[r, k]) / max(t1[r, k] - t0[r, k], 1e-20), 0, 1)
//   out   = mask ? (1 - frac) * feats[r, k_c] + frac * feats[r, k_c + 1] : 0
//
// Replaces: tetranerf_tpu/ops/pallas_interp.py `interp_endpoints` forward
// (`_interp_fwd_kernel` :64, pallas_call at :104) together with the
// compare-sum interval match in front of it (ops/fused.py:917-929). The TPU
// kernel built the two-nonzero [T+1, S] selection matrix per ray and
// contracted it in bf16 on the MXU; here each sample reads its two endpoint
// rows directly and lerps in f32.
//
// What bounds it on the H100: one warp per (ray, sample); every lane runs
// the same binary search over the ray's t1 row (broadcast loads, the row
// stays in L1 for the block's neighbouring samples), then the lanes read
// the two 256-byte endpoint rows as float2s and write the output row
// coalesced. The [R, S, F] f32 output dominates the traffic (0.54 GB at
// 8192 x 257 x 64), so the kernel is bound by HBM write bandwidth.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) interp_kernel(
    const float* __restrict__ t0, const float* __restrict__ t1,
    const int* __restrict__ num_valid, const bool* __restrict__ ray_mask,
    const float* __restrict__ dist, const float* __restrict__ feats,
    float* __restrict__ out, bool* __restrict__ mask_out, int num_rays,
    int max_t, int num_samples, int num_feat) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= static_cast<long long>(num_rays) * num_samples) return;
  const long long r = warp / num_samples;
  const float d = dist[warp];
  const float* t1r = t1 + r * max_t;
  int lo = 0, hi = max_t;  // first slot with t1 > d
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(t1r + mid) <= d) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int k = lo;
  const float t0k = k < max_t ? __ldg(t0 + r * max_t + k) : CUDART_INF_F;
  const float t1k = k < max_t ? __ldg(t1r + k) : CUDART_INF_F;
  const bool m = ray_mask[r] && k < num_valid[r] && d >= t0k;
  float frac = 0.0f;
  if (m) {
    frac = (d - t0k) / fmaxf(t1k - t0k, 1e-20f);
    frac = fminf(fmaxf(frac, 0.0f), 1.0f);
  }
  const int kc = min(k, max_t - 1);
  const float* f0 = feats + (r * (max_t + 1) + kc) * num_feat;
  const float* f1 = f0 + num_feat;
  float* dst = out + warp * num_feat;
  for (int f = 2 * lane; f < num_feat; f += 64) {
    float2 y = make_float2(0.0f, 0.0f);
    if (m) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(f0 + f));
      const float2 b = __ldg(reinterpret_cast<const float2*>(f1 + f));
      y.x = (1.0f - frac) * a.x + frac * b.x;
      y.y = (1.0f - frac) * a.y + frac * b.y;
    }
    *reinterpret_cast<float2*>(dst + f) = y;
  }
  if (lane == 0) mask_out[warp] = m;
}

}  // namespace

extern "C" int tetranerf_sample_interp(
    const float* t0, const float* t1, const int* num_valid,
    const bool* ray_mask, const float* dist, const float* feats, float* out,
    bool* mask_out, int num_rays, int max_t, int num_samples, int num_feat,
    cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long warps = static_cast<long long>(num_rays) * num_samples;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  interp_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      t0, t1, num_valid, ray_mask, dist, feats, out, mask_out, num_rays,
      max_t, num_samples, num_feat);
  return static_cast<int>(cudaGetLastError());
}
