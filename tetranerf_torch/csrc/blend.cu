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
// Design: a block of 8 warps per (ray, tile of stream slots).
// 1. The grid spans rays x slot tiles; the launcher sizes the tile (at most
//    128 slots, a multiple of 8) from the shared-memory plan below. The
//    block stages its ray's pos and bary rows (E x 32 bytes) in shared
//    memory; beside them lies the tile's [tile, min(F, 64)] f32
//    accumulator.
// 2. Each warp owns a disjoint, equal range of the tile's slots, each lane
//    a float2 of feature columns (64 columns a pass). A warp scans the
//    endpoints in order, 32 at a time from shared memory; a ballot keeps
//    those with a nonzero weight on a slot of its range, and it reads
//    their g rows, eight in flight, and adds each weighted row into its
//    accumulator rows in (e, j) order. An endpoint that names one slot
//    twice adds twice; zero weights are skipped, so the g rows of padding
//    endpoints are never read.
// 3. The warp then writes its rows once, zeros included, in coalesced
//    256-byte rows. No zeroing pass over device memory, no atomics: every
//    output slot is written by one lane of one warp, and two launches give
//    the same bits.
//
// What bounds it on the H100: bytes, writing the dense [R, U, F] f32
// output plus reading the g rows of the weighted endpoints and pos/bary
// (0.23 ms at the train shape, 4096 rays x T=512 x F=64; ~0.13 ms for
// the 8 launches of a flagship step, at the 3.35 TB/s of an H100 SXM at
// 700 W, NVIDIA's data sheet). The g rows are gathers out of L2 (a ray's
// rows are read by the one or two warps whose slots they touch). The
// earlier design, one warp per ray zeroing its [U, F] slab and then adding
// each weighted endpoint with a chain of dependent load-add-stores in
// device memory: 0.64-0.68 ms at the train shape and 1.98 ms for the 8
// launches of a flagship step, on an H100 80GB HBM3 at 700 W.

namespace {

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdMaxTile = 128;   // stream slots a block owns, at most
constexpr int kBwdCols = 64;       // feature columns a pass (a float2 a lane)
constexpr int kBwdInFlight = 8;    // g rows a warp loads before adding them

__global__ void __launch_bounds__(kBwdThreads) blend_bwd_kernel(
    const float* __restrict__ g, const int* __restrict__ pos,
    const float* __restrict__ bary, float* __restrict__ gsf, int num_end,
    int num_stream, int num_feat, int tile, int num_tiles) {
  extern __shared__ float4 smem4[];
  int4* s_pos = reinterpret_cast<int4*>(smem4);          // [E]
  float4* s_bary = smem4 + num_end;                       // [E]
  float* s_acc = reinterpret_cast<float*>(s_bary + num_end);  // [tile, cols]
  const long long r = blockIdx.x / num_tiles;
  const int u0 = (blockIdx.x % num_tiles) * tile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = tile / kBwdWarps;
  const int a = min(u0 + warp * per_warp, num_stream);  // this warp's slots [a, b)
  const int b = min(a + per_warp, num_stream);
  const int cols = min(num_feat, kBwdCols);

  const int4* pr = reinterpret_cast<const int4*>(pos) + r * num_end;
  const float4* br = reinterpret_cast<const float4*>(bary) + r * num_end;
  for (int e = threadIdx.x; e < num_end; e += kBwdThreads) {
    s_pos[e] = __ldg(pr + e);
    s_bary[e] = __ldg(br + e);
  }
  __syncthreads();

  const float* gr = g + r * num_end * num_feat;
  float* dst = gsf + r * num_stream * num_feat;
  // The lane's accumulator column in row 0 of the warp's range; rows are
  // `cols` floats apart. Only this lane ever touches these entries.
  float* acc = s_acc + (a - u0) * cols + 2 * lane;
  for (int f0 = 0; f0 < num_feat; f0 += kBwdCols) {
    const int col = f0 + 2 * lane;
    const bool active = 2 * lane < min(num_feat - f0, kBwdCols);
    if (active) {
      for (int j = 0; j < b - a; ++j) {
        *reinterpret_cast<float2*>(acc + j * cols) = make_float2(0.0f, 0.0f);
      }
    }
    for (int base = 0; base < num_end; base += 32) {
      const int e = base + lane;
      bool rel = false;
      if (e < num_end) {
        const int4 p = s_pos[e];
        const float4 w = s_bary[e];
        rel = (w.x != 0.0f && p.x >= a && p.x < b) ||
              (w.y != 0.0f && p.y >= a && p.y < b) ||
              (w.z != 0.0f && p.z >= a && p.z < b) ||
              (w.w != 0.0f && p.w >= a && p.w < b);
      }
      unsigned bal = __ballot_sync(0xffffffffu, rel);
      while (bal) {  // uniform across the warp
        int es[kBwdInFlight];
        float2 xs[kBwdInFlight];
#pragma unroll
        for (int q = 0; q < kBwdInFlight; ++q) {
          es[q] = -1;
          if (bal) {
            es[q] = base + __ffs(bal) - 1;
            bal &= bal - 1;
          }
        }
#pragma unroll
        for (int q = 0; q < kBwdInFlight; ++q) {
          xs[q] = make_float2(0.0f, 0.0f);
          if (es[q] >= 0 && active) {
            xs[q] = __ldg(reinterpret_cast<const float2*>(
                gr + static_cast<long long>(es[q]) * num_feat + col));
          }
        }
#pragma unroll
        for (int q = 0; q < kBwdInFlight; ++q) {
          if (es[q] < 0 || !active) continue;
          const int4 p = s_pos[es[q]];
          const float4 w = s_bary[es[q]];
          const int pj[4] = {p.x, p.y, p.z, p.w};
          const float wj[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (wj[j] != 0.0f && pj[j] >= a && pj[j] < b) {
              float2* row = reinterpret_cast<float2*>(acc + (pj[j] - a) * cols);
              float2 v = *row;
              v.x += wj[j] * xs[q].x;
              v.y += wj[j] * xs[q].y;
              *row = v;
            }
          }
        }
      }
    }
    if (active) {
      for (int j = 0; j < b - a; ++j) {
        *reinterpret_cast<float2*>(dst + static_cast<long long>(a + j) * num_feat +
                                   col) =
            *reinterpret_cast<const float2*>(acc + j * cols);
      }
    }
  }
}

}  // namespace

extern "C" int tetranerf_stream_blend_backward(
    const float* g, const int* pos, const float* bary, float* gsf,
    int num_rays, int num_end, int num_stream, int num_feat,
    cudaStream_t stream) {
  constexpr size_t kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90
  const size_t cols = static_cast<size_t>(num_feat < kBwdCols ? num_feat : kBwdCols);
  // Fewest tiles of at most kBwdMaxTile slots whose plan fits: the staged
  // pos/bary rows plus the accumulator.
  int num_tiles = (num_stream + kBwdMaxTile - 1) / kBwdMaxTile;
  if (num_tiles < 1) num_tiles = 1;
  int tile;
  size_t smem;
  for (;;) {
    const int slots = (num_stream + num_tiles - 1) / num_tiles;
    tile = kBwdWarps * ((slots + kBwdWarps - 1) / kBwdWarps);
    smem = static_cast<size_t>(num_end) * 32 + static_cast<size_t>(tile) * cols * 4;
    if (smem <= kMaxSmem || tile <= kBwdWarps) break;
    ++num_tiles;
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(num_rays) * num_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (blocks > 0) {
    blend_bwd_kernel<<<static_cast<unsigned>(blocks), kBwdThreads, smem,
                       stream>>>(g, pos, bary, gsf, num_end, num_stream,
                                 num_feat, tile, num_tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
