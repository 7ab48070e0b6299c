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
// Design: a block of 8 warps per (ray, tile of samples).
// 1. The grid spans rays x sample tiles (at most 128 samples a tile, the
//    tiles of a ray as even as they come). The block stages the ray's t0
//    and t1 rows in shared memory; one thread per sample runs the match
//    (`match_sample`, which K3b calls too, so the two kernels agree on k,
//    frac and mask to the bit) against the staged rows, keeps k and frac
//    in shared memory and writes the tile's mask in one coalesced store.
// 2. Each output row is written by 16 lanes as float4s (float2s where F
//    or an address does not allow 16 bytes), so a warp writes two rows per
//    instruction and a block 4 KB. Sorted samples read the same endpoint
//    rows one after another, which L1 serves.
//
// What bounds it on the H100: bytes, writing the dense [R, S, F] f32
// output (0.54 GB at 8192 x 257 x 64: 0.18 ms at the 3.35 TB/s of an H100
// SXM at 700 W, NVIDIA's data sheet) plus the endpoint rows the kept
// samples read. The earlier design, one warp per (ray, sample) whose 32
// lanes all ran the same binary search in device memory (about 9 dependent
// loads) and then wrote one row, with 1-byte mask stores: 1.03-1.06 ms at
// the render shape and 0.65 ms for the 16 launches of a flagship step, on
// an H100 80GB HBM3 at 700 W.

#include <cstdint>

#include "common.cuh"

namespace {

// The match of K3 and K3b against a ray's t0/t1 rows staged in shared
// memory: k = #(t1 <= d), the first slot whose t1 passes d; the lerp
// weight frac in [0, 1] when the sample lies in a valid interval
// (k < num_valid, d >= t0[k]), else -1.
__device__ __forceinline__ float match_sample(const float* s_t0,
                                              const float* s_t1, int max_t,
                                              int num_valid, float d, int& k) {
  int lo = 0, hi = max_t;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s_t1[mid] <= d) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  k = lo;
  float frac = -1.0f;
  if (k < num_valid && k < max_t) {
    const float t0k = s_t0[k];
    if (d >= t0k) {
      frac = (d - t0k) / fmaxf(s_t1[k] - t0k, 1e-20f);
      frac = fminf(fmaxf(frac, 0.0f), 1.0f);
    }
  }
  return frac;
}

constexpr int kFwdThreads = 256;
constexpr int kFwdMaxTile = 128;  // samples a block matches and writes
constexpr int kRowLanes = 16;     // lanes that write one output row

template <int kVec>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  __device__ static T lerp(float frac, T a, T b) {
    return make_float4((1.0f - frac) * a.x + frac * b.x,
                       (1.0f - frac) * a.y + frac * b.y,
                       (1.0f - frac) * a.z + frac * b.z,
                       (1.0f - frac) * a.w + frac * b.w);
  }
};
template <>
struct Vec<2> {
  using T = float2;
  __device__ static T zero() { return make_float2(0.0f, 0.0f); }
  __device__ static T lerp(float frac, T a, T b) {
    return make_float2((1.0f - frac) * a.x + frac * b.x,
                       (1.0f - frac) * a.y + frac * b.y);
  }
};

template <int kVec>
__global__ void __launch_bounds__(kFwdThreads) interp_kernel(
    const float* __restrict__ t0, const float* __restrict__ t1,
    const int* __restrict__ num_valid, const bool* __restrict__ ray_mask,
    const float* __restrict__ dist, const float* __restrict__ feats,
    float* __restrict__ out, bool* __restrict__ mask_out, int max_t,
    int num_samples, int num_feat, int tile, int num_tiles) {
  using V = typename Vec<kVec>::T;
  extern __shared__ float smem[];
  float* s_t0 = smem;               // [max_t]
  float* s_t1 = s_t0 + max_t;       // [max_t]
  float* s_frac = s_t1 + max_t;     // [tile]: frac, or -1 if not kept
  int* s_k = reinterpret_cast<int*>(s_frac + tile);  // [tile]
  const long long r = blockIdx.x / num_tiles;
  const int s0 = (blockIdx.x % num_tiles) * tile;
  const int ns = min(tile, num_samples - s0);
  const bool ray_ok = ray_mask[r];

  if (ray_ok) {  // uniform across the block
    for (int i = threadIdx.x; i < max_t; i += kFwdThreads) {
      s_t0[i] = __ldg(t0 + r * max_t + i);
      s_t1[i] = __ldg(t1 + r * max_t + i);
    }
  }
  __syncthreads();
  if (threadIdx.x < ns) {
    const long long s = r * num_samples + s0 + threadIdx.x;
    int k = 0;
    float frac = -1.0f;
    if (ray_ok) {
      frac = match_sample(s_t0, s_t1, max_t, num_valid[r], __ldg(dist + s), k);
    }
    s_k[threadIdx.x] = k;
    s_frac[threadIdx.x] = frac;
    mask_out[s] = frac >= 0.0f;
  }
  __syncthreads();

  const int sub = threadIdx.x % kRowLanes;
  const float* fr = feats + r * (max_t + 1) * num_feat;
  float* dst = out + (r * num_samples + s0) * num_feat;
  for (int i = threadIdx.x / kRowLanes; i < ns; i += kFwdThreads / kRowLanes) {
    const float frac = s_frac[i];
    const float* f0 = fr + static_cast<long long>(s_k[i]) * num_feat;
    for (int c = kVec * sub; c < num_feat; c += kVec * kRowLanes) {
      V y = Vec<kVec>::zero();
      if (frac >= 0.0f) {
        y = Vec<kVec>::lerp(frac, __ldg(reinterpret_cast<const V*>(f0 + c)),
                            __ldg(reinterpret_cast<const V*>(f0 + num_feat + c)));
      }
      *reinterpret_cast<V*>(dst + static_cast<long long>(i) * num_feat + c) = y;
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

extern "C" int tetranerf_sample_interp(
    const float* t0, const float* t1, const int* num_valid,
    const bool* ray_mask, const float* dist, const float* feats, float* out,
    bool* mask_out, int num_rays, int max_t, int num_samples, int num_feat,
    cudaStream_t stream) {
  int num_tiles = (num_samples + kFwdMaxTile - 1) / kFwdMaxTile;
  if (num_tiles < 1) num_tiles = 1;
  const int tile = (num_samples + num_tiles - 1) / num_tiles;
  const long long blocks = static_cast<long long>(num_rays) * num_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (2 * static_cast<size_t>(max_t) + 2 * static_cast<size_t>(tile)) *
      sizeof(float);
  const bool vec4 = num_feat % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(feats) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int err = vec4 ? set_smem(interp_kernel<4>, smem)
                       : set_smem(interp_kernel<2>, smem);
  if (err != 0) return err;
  if (blocks > 0) {
    if (vec4) {
      interp_kernel<4><<<static_cast<unsigned>(blocks), kFwdThreads, smem,
                         stream>>>(t0, t1, num_valid, ray_mask, dist, feats,
                                   out, mask_out, max_t, num_samples,
                                   num_feat, tile, num_tiles);
    } else {
      interp_kernel<2><<<static_cast<unsigned>(blocks), kFwdThreads, smem,
                         stream>>>(t0, t1, num_valid, ray_mask, dist, feats,
                                   out, mask_out, max_t, num_samples,
                                   num_feat, tile, num_tiles);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K3b: the transpose of the sample lerp, onto the interval endpoints.
//
//   gfeats[r, k]     += (1 - frac) * g[r, s]
//   gfeats[r, k + 1] +=       frac * g[r, s]     over samples s with mask
//
// into a dense f32[R, T+1, F] that is zero where nothing lands, with k,
// frac and mask from K3's own match (`match_sample` is redone here rather
// than saved by the forward: the train step then keeps no extra [R, S]
// tensors, and K3's launch is the same in render and train).
//
// Replaces: tetranerf_tpu/ops/pallas_interp.py `_interp_bwd`
// (`_interp_bwd_kernel` :82, pallas_call at :104 via `_run_interp`), and
// `_interp_matmul_bwd` (ops/fused.py:872), the transpose of the one-hot
// matmul that the JAX default `interp_mode="matmul"` runs. Both contracted
// a [T+1, S] selection matrix with g on the MXU.
//
// Design: one block of 8 warps per ray.
// 1. The block stages the ray's t0 and t1 rows in shared memory, then runs
//    the match (`match_sample`) once per sample with its threads in
//    parallel and keeps k and frac (-1 where the sample is not kept) in
//    shared memory.
// 2. The warps own disjoint, equal ranges of the T+1 endpoint slots, and
//    each lane a float2 of feature columns. A warp scans the samples in
//    order, 32 at a time from shared memory; a ballot picks the kept ones
//    whose k or k+1 lands in its range, and it reads their g rows, four in
//    flight. So each slot's sum is taken in sample order by one lane, with
//    no atomics: two runs give the same bits.
// 3. Sorted samples (the model always passes them, `ops/sampling.py`) visit
//    non-decreasing k: the lane carries the sums of slots k and k+1 in
//    registers and writes a slot once, when k moves past it, with the
//    empty slots before it as zeros. So every slot of the range is written
//    exactly once, whole, in coalesced rows, with no zeroing pass. Samples
//    out of order (the block checks) take the slow path: the warp zeroes
//    its range, then adds each sample into the two slots in memory.
//
// What bounds it on the H100: bytes, writing the dense output plus reading
// the g rows of the kept samples, the distances and the t rows (0.25 ms at
// the train shape, 4096 rays x T=512 x S=257 x F=64, at the 3.35 TB/s of
// an H100 SXM at 700 W, NVIDIA's data sheet; ~0.02 ms for a 512-ray
// bucket). The earlier design, one warp per ray with a single lane
// walking the samples one after another (a binary search of dependent
// loads each), with a serial zeroing pass: 0.63-0.72 ms at the train shape
// and 2.32 ms for the 8 launches of a flagship step, on an H100 80GB HBM3
// at 700 W.

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

__device__ __forceinline__ void store_row(float* row, float2 v, bool active) {
  if (active) *reinterpret_cast<float2*>(row) = v;
}

__device__ __forceinline__ void add_row(float* row, float w, float2 x,
                                        bool active) {
  if (!active) return;
  float2* p = reinterpret_cast<float2*>(row);
  float2 acc = *p;
  acc.x += w * x.x;
  acc.y += w * x.y;
  *p = acc;
}

__global__ void __launch_bounds__(kBwdThreads) interp_bwd_kernel(
    const float* __restrict__ t0, const float* __restrict__ t1,
    const int* __restrict__ num_valid, const bool* __restrict__ ray_mask,
    const float* __restrict__ dist, const float* __restrict__ g,
    float* __restrict__ gfeats, int max_t, int num_samples, int num_feat) {
  extern __shared__ float smem[];
  float* s_t0 = smem;                     // [max_t]
  float* s_t1 = s_t0 + max_t;             // [max_t]
  float* s_frac = s_t1 + max_t;           // [S]: frac, or -1 if not kept
  int* s_k = reinterpret_cast<int*>(s_frac + num_samples);  // [S]
  const long long r = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int num_slots = max_t + 1;
  const int per_warp = (num_slots + kBwdWarps - 1) / kBwdWarps;
  const int a = min(warp * per_warp, num_slots);  // this warp's slots [a, b)
  const int b = min(a + per_warp, num_slots);
  float* dst = gfeats + r * num_slots * num_feat;

  if (!ray_mask[r]) {  // uniform across the block
    for (int f0 = 0; f0 < num_feat; f0 += 64) {
      const int col = f0 + 2 * lane;
      for (int j = a; j < b; ++j) {
        store_row(dst + j * num_feat + col, make_float2(0.0f, 0.0f),
                  col < num_feat);
      }
    }
    return;
  }

  for (int i = threadIdx.x; i < max_t; i += kBwdThreads) {
    s_t0[i] = __ldg(t0 + r * max_t + i);
    s_t1[i] = __ldg(t1 + r * max_t + i);
  }
  __syncthreads();
  const int nv = num_valid[r];
  const float* dr = dist + r * num_samples;
  for (int s = threadIdx.x; s < num_samples; s += kBwdThreads) {
    int k;
    s_frac[s] = match_sample(s_t0, s_t1, max_t, nv, __ldg(dr + s), k);
    s_k[s] = k;
  }
  __syncthreads();
  bool in_order = true;
  for (int s = threadIdx.x + 1; s < num_samples; s += kBwdThreads) {
    in_order = in_order && s_k[s] >= s_k[s - 1];
  }
  const bool sorted = __syncthreads_and(in_order);

  const float* gr = g + r * num_samples * num_feat;
  for (int f0 = 0; f0 < num_feat; f0 += 64) {
    const int col = f0 + 2 * lane;
    const bool active = col < num_feat;
    if (!sorted) {
      for (int j = a; j < b; ++j) {
        store_row(dst + j * num_feat + col, make_float2(0.0f, 0.0f), active);
      }
    }
    int next = a;     // sorted: the first slot of [a, b) not yet written
    int cur = a - 2;  // sorted: acc0 sums slot cur, acc1 slot cur + 1
    float2 acc0 = make_float2(0.0f, 0.0f), acc1 = acc0;
    // Slot j's sum is final: write the empty slots before it, then it.
    auto emit = [&](int j, float2 v) {
      if (j < a || j >= b) return;
      for (; next < j; ++next) {
        store_row(dst + next * num_feat + col, make_float2(0.0f, 0.0f), active);
      }
      store_row(dst + j * num_feat + col, v, active);
      next = j + 1;
    };
    for (int base = 0; base < num_samples; base += 32) {
      const int s = base + lane;
      const bool rel = s < num_samples && s_frac[s] >= 0.0f &&
                       s_k[s] >= a - 1 && s_k[s] < b;
      unsigned bal = __ballot_sync(0xffffffffu, rel);
      while (bal) {
        int ss[4];
        float2 xs[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ss[q] = -1;
          if (bal) {
            ss[q] = base + __ffs(bal) - 1;
            bal &= bal - 1;
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xs[q] = make_float2(0.0f, 0.0f);
          if (ss[q] >= 0 && active) {
            xs[q] = __ldg(reinterpret_cast<const float2*>(
                gr + static_cast<long long>(ss[q]) * num_feat + col));
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (ss[q] < 0) continue;
          const int k = s_k[ss[q]];
          const float frac = s_frac[ss[q]];
          const float w0 = 1.0f - frac;
          if (!sorted) {
            if (k >= a) add_row(dst + k * num_feat + col, w0, xs[q], active);
            if (k + 1 < b) {
              add_row(dst + (k + 1) * num_feat + col, frac, xs[q], active);
            }
            continue;
          }
          if (k != cur) {
            emit(cur, acc0);
            if (k == cur + 1) {
              acc0 = acc1;
            } else {
              emit(cur + 1, acc1);
              acc0 = make_float2(0.0f, 0.0f);
            }
            acc1 = make_float2(0.0f, 0.0f);
            cur = k;
          }
          acc0.x += w0 * xs[q].x;
          acc0.y += w0 * xs[q].y;
          acc1.x += frac * xs[q].x;
          acc1.y += frac * xs[q].y;
        }
      }
    }
    if (sorted) {
      emit(cur, acc0);
      emit(cur + 1, acc1);
      for (; next < b; ++next) {
        store_row(dst + next * num_feat + col, make_float2(0.0f, 0.0f), active);
      }
    }
  }
}

}  // namespace

extern "C" int tetranerf_sample_interp_backward(
    const float* t0, const float* t1, const int* num_valid,
    const bool* ray_mask, const float* dist, const float* g, float* gfeats,
    int num_rays, int max_t, int num_samples, int num_feat,
    cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(max_t) + 2 * static_cast<size_t>(num_samples)) *
      sizeof(float);
  const int err = set_smem(interp_bwd_kernel, smem);
  if (err != 0) return err;
  if (num_rays > 0) {
    interp_bwd_kernel<<<static_cast<unsigned>(num_rays), kBwdThreads, smem,
                        stream>>>(t0, t1, num_valid, ray_mask, dist, g, gfeats,
                                  max_t, num_samples, num_feat);
  }
  return static_cast<int>(cudaGetLastError());
}
