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

// K3b: the transpose of the sample lerp, onto the interval endpoints.
//
//   gfeats[r, k]     += (1 - frac) * g[r, s]
//   gfeats[r, k + 1] +=       frac * g[r, s]     over samples s with mask
//
// with k, frac and mask exactly as K3 computes them (the binary search and
// the same float expressions are redone here rather than saved by the
// forward: the train step then keeps no extra [R, S] tensors, and K3's
// launch is the same in render and train).
//
// Replaces: tetranerf_tpu/ops/pallas_interp.py `_interp_bwd`
// (`_interp_bwd_kernel` :82, pallas_call at :104 via `_run_interp`), and
// `_interp_matmul_bwd` (ops/fused.py:872), the transpose of the one-hot
// matmul that the JAX default `interp_mode="matmul"` runs. Both contracted
// a [T+1, S] selection matrix with g on the MXU.
//
// Design: one warp per ray, each lane owning a float2 of feature columns.
// The warp zeroes its ray's [T+1, F] slab, then walks the ray's samples in
// order. Sorted samples visit non-decreasing k, so a lane keeps the running
// sums of slots k and k+1 in registers and adds them into memory only when
// k moves on (samples out of order are still summed right: a flush adds to
// what the slot holds). No atomics: only that lane touches that column of
// that ray, and the sums come out in sample order every run.
//
// What bounds it on the H100: writing the dense [R, T+1, F] f32 output
// (538 MB at 4096 x 513 x 64: 0.16 ms at the 3.35 TB/s of an H100 SXM at
// 700 W, NVIDIA's data sheet) plus reading
// the g rows of the kept samples. Each sample's binary search over the
// ray's t1 row is a chain of about log2(T) L1-resident loads.

namespace {

__device__ __forceinline__ void add_row(float* row, float2 v) {
  float2* p = reinterpret_cast<float2*>(row);
  float2 acc = *p;
  acc.x += v.x;
  acc.y += v.y;
  *p = acc;
}

__global__ void __launch_bounds__(256) interp_bwd_kernel(
    const float* __restrict__ t0, const float* __restrict__ t1,
    const int* __restrict__ num_valid, const bool* __restrict__ ray_mask,
    const float* __restrict__ dist, const float* __restrict__ g,
    float* __restrict__ gfeats, int num_rays, int max_t, int num_samples,
    int num_feat) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= num_rays) return;
  float* dst = gfeats + r * (max_t + 1) * num_feat;
  for (int t = 0; t <= max_t; ++t) {
    for (int f = 2 * lane; f < num_feat; f += 64) {
      *reinterpret_cast<float2*>(dst + t * num_feat + f) =
          make_float2(0.0f, 0.0f);
    }
  }
  if (!ray_mask[r]) return;
  const int nv = num_valid[r];
  const float* t0r = t0 + r * max_t;
  const float* t1r = t1 + r * max_t;
  const float* dr = dist + r * num_samples;
  const float* gr = g + r * num_samples * num_feat;
  for (int f = 2 * lane; f < num_feat; f += 64) {
    int cur = -1;  // slot whose sums a0 (cur) and a1 (cur + 1) hold
    float2 a0 = make_float2(0.0f, 0.0f), a1 = make_float2(0.0f, 0.0f);
    for (int s = 0; s < num_samples; ++s) {
      const float d = __ldg(dr + s);
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
      if (k >= nv) continue;  // nv <= max_t, so k < max_t below
      const float t0k = __ldg(t0r + k);
      if (!(d >= t0k)) continue;
      const float t1k = __ldg(t1r + k);
      float frac = (d - t0k) / fmaxf(t1k - t0k, 1e-20f);
      frac = fminf(fmaxf(frac, 0.0f), 1.0f);
      const float2 x =
          __ldg(reinterpret_cast<const float2*>(gr + s * num_feat + f));
      const float w0 = 1.0f - frac;
      if (k != cur) {
        if (cur >= 0) {
          add_row(dst + cur * num_feat + f, a0);
          if (k == cur + 1) {
            a0 = a1;
          } else {
            add_row(dst + (cur + 1) * num_feat + f, a1);
            a0 = make_float2(0.0f, 0.0f);
          }
        }
        a1 = make_float2(0.0f, 0.0f);
        cur = k;
      }
      a0.x += w0 * x.x;
      a0.y += w0 * x.y;
      a1.x += frac * x.x;
      a1.y += frac * x.y;
    }
    if (cur >= 0) {
      add_row(dst + cur * num_feat + f, a0);
      add_row(dst + (cur + 1) * num_feat + f, a1);
    }
  }
}

}  // namespace

extern "C" int tetranerf_sample_interp_backward(
    const float* t0, const float* t1, const int* num_valid,
    const bool* ray_mask, const float* dist, const float* g, float* gfeats,
    int num_rays, int max_t, int num_samples, int num_feat,
    cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long blocks =
      (static_cast<long long>(num_rays) * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  interp_bwd_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      t0, t1, num_valid, ray_mask, dist, g, gfeats, num_rays, max_t,
      num_samples, num_feat);
  return static_cast<int>(cudaGetLastError());
}
