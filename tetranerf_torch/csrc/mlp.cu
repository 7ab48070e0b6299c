// K4 / K4b: the fused field MLPs, forward and backward.
// K5 / K5b: the fused density MLP (the coarse round's head-free chain),
//           forward and backward.
//
//   base:    h_0 = x;  h_{i+1} = relu(h_i W_i^T + b_i)          i < n_base
//   density: density = softplus(h_top w_d^T + b_d)
//   head:    u_0 = relu(h_top W_bh^T + head_dir[ray])           (K4 only)
//            u_{j} = relu(u_{j-1} W_hj^T + b_hj)                 0 < j < n_head
//   colour:  rgb = sigmoid(u_last W_c^T + b_c)
//
// Every product takes bf16 operands and sums in f32; biases and head_dir
// are added in f32; activations are rounded to bf16 only as the next
// product's operand; the nonlinearities run in f32. The backward recomputes
// the chain and rounds every cotangent to bf16 at each product, keeping
// dhead_dir and the bias gradients as f32 sums of the unrounded cotangents:
// the contract of the JAX kernels.
//
// Replaces: tetranerf_tpu/ops/pallas_mlp.py `fused_field_mlps` (`_fwd_kernel`
// :97, pallas_call at :244), its VJP `_fused_bwd` (`_bwd_kernel` :112,
// pallas_call at :290), `fused_density_mlp` (`_dens_fwd_kernel` :344,
// pallas_call at :415) and `_dens_bwd` (`_dens_bwd_kernel` :353, pallas_call
// at :448).
//
// Design. Rows (samples) are flattened to N = R * S and cut into tiles of
// kRows = 64; the ray of row n is n / S, and the ragged tail is masked.
// Persistent blocks, at most one per SM, walk the tiles. Each block copies
// the weights into shared memory once, as bf16 (115,712 bytes at the
// preset's widths; 124 KB with the row padding that spreads the rows over
// the banks), and keeps a tile's activations there too, so no activation
// reaches device memory: only x, head_dir and the outputs cross it. The
// products run on the tensor cores as mma.sync m16n8k16 (bf16 operands
// from shared memory through ldmatrix, f32 accumulators in registers); a
// warp takes one 16-row tile against up to eight neighbouring 8-column
// tiles at once (as many as still leave a unit for each of the 16 warps),
// so one A fragment feeds several independent accumulators, and the
// epilogue (bias, ReLU, the cast to bf16, the backward's masks and sums)
// works on the accumulators in registers. The density (1 output) and
// colour (3 outputs) products are warp-reduced dot products, 4 rows per
// warp at once.
//
// The TPU kernels add their weight gradients into one output across the
// sequential grid; on the H100 blocks run in parallel in no order. So each
// backward block adds its tiles' weight gradients into a workspace row of
// its own (`ws`, [num_blocks, P] f32, about 30 MB at 132 blocks, which
// stays in L2) with a read-modify-write of its accumulators per 64 rows; the small
// gradients (biases, density and colour weights) stay in shared memory
// until the block ends. A second launch sums the rows over blocks in a
// fixed order, so the weight gradients are the same in every run. The
// backward keeps every recomputed activation of its tile (x and each
// layer's output) and writes each layer's bf16 cotangent over the
// activation it masks, once nothing reads that activation any more.
// dhead_dir sums a ray's rows: a 16-row tile of one ray adds its column
// sums with one float atomic per column, a tile that spans rays one per
// (row, column), so a ray's sum comes out in a run-dependent order. The ReLU masks are
// read from the bf16 copy of each activation: without fast math a positive
// f32 rounds to a zero bf16 only below 2^-133, inside the f32 denormals.
//
// What bounds it on the H100: operations. At the train slice (4096 rays x
// 257 samples, 57,856 MACs per row) K4 does 121.8 GFLOP, 0.123 ms at the
// 989 TFLOP/s bf16 dense peak of an H100 SXM at 700 W (NVIDIA's data
// sheet), against 0.080 ms to read x; K4b about three times that. This
// first version is simple: one block of 16 warps per SM (the weights fill
// half of shared memory), fragments loaded from shared memory without
// software pipelining, a barrier between layers, and the weight-gradient
// read-modify-write through L2 once per 64 rows.

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;          // rows per tile
constexpr int kRowTiles = kRows / 16;
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;            // bf16 elements of padding per row
constexpr int kMaxMats = 20;
constexpr int kMaxSmem = 232448;   // shared memory a block may use

// Matrices in order: base 0..n_base-1, density (n_base), then with a head:
// the first head layer's base rows (n_base + 1), head layers 1..n_head-1,
// colour (n_base + 1 + n_head). Weights are [out, in] (rows x cols),
// packed flat in this order; biases likewise (the first head layer has
// none: its bias is inside head_dir). Activation buffers: 0 is x, 1..n_base
// the base outputs, n_base + 1 + j the output of head layer j.
struct Plan {
  int d_in, hidden, n_base, n_head, n_mats, n_acts, n_w, n_b;
  int rows[kMaxMats], cols[kMaxMats];
  int w_off[kMaxMats];    // float offset in the packed weights (and in ws)
  int b_off[kMaxMats];    // float offset in the packed biases, -1: none
  int s_off[kMaxMats];    // byte offset of the bf16 copy in shared memory
  int act_off[kMaxMats];  // byte offset of activation buffer i
  int bias_off, rowbuf_off, acc_off, bpart_off, smem_bytes;
};

int align_up(int x, int a) { return (x + a - 1) / a * a; }

bool make_plan(int d_in, int hidden, int n_base, int n_head, Plan* p) {
  if (d_in <= 0 || hidden <= 0 || d_in % 16 || hidden % 16 || n_base < 1 ||
      n_head < 0) {
    return false;
  }
  const int n_mats = n_base + 1 + (n_head > 0 ? n_head + 1 : 0);
  if (n_mats > kMaxMats || 1 + n_base + n_head > kMaxMats) return false;
  p->d_in = d_in;
  p->hidden = hidden;
  p->n_base = n_base;
  p->n_head = n_head;
  int m = 0, w = 0, b = 0;
  auto add = [&](int rows, int cols, bool has_bias) {
    p->rows[m] = rows;
    p->cols[m] = cols;
    p->w_off[m] = w;
    w += rows * cols;
    p->b_off[m] = has_bias ? b : -1;
    if (has_bias) b += rows;
    ++m;
  };
  for (int i = 0; i < n_base; ++i) add(hidden, i == 0 ? d_in : hidden, true);
  add(1, hidden, true);
  if (n_head > 0) {
    add(hidden, hidden, false);
    for (int j = 1; j < n_head; ++j) add(hidden, hidden, true);
    add(3, hidden, true);
  }
  p->n_mats = m;
  p->n_w = w;
  p->n_b = b;
  int off = align_up(static_cast<int>(sizeof(Plan)), 128);  // the Plan itself
  for (int i = 0; i < m; ++i) {
    p->s_off[i] = off;
    off += align_up(p->rows[i] * (p->cols[i] + kPad) * 2, 128);
  }
  p->n_acts = 1 + n_base + n_head;
  for (int i = 0; i < p->n_acts; ++i) {
    p->act_off[i] = off;
    off += align_up(kRows * ((i == 0 ? d_in : hidden) + kPad) * 2, 128);
  }
  p->bias_off = off;
  off += align_up(b * 4, 128);
  p->rowbuf_off = off;  // pre_d, gpd [kRows]; rgb, gpc [kRows, 3]; ray_of
  off += align_up(9 * kRows * 4, 128);
  p->acc_off = off;  // bias grads [n_b], d w_d [hidden], d W_c [3, hidden]
  off += align_up((b + 4 * hidden) * 4, 128);
  p->bpart_off = off;
  off += align_up(kRowTiles * hidden * 4, 128);
  p->smem_bytes = off;
  return off <= kMaxSmem;
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float bfr(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shared-memory views of one block.
struct View {
  const Plan& p;
  char* s;
  __device__ bf16* mat(int i) const {
    return reinterpret_cast<bf16*>(s + p.s_off[i]);
  }
  __device__ int mat_ld(int i) const { return p.cols[i] + kPad; }
  __device__ bf16* act(int i) const {
    return reinterpret_cast<bf16*>(s + p.act_off[i]);
  }
  __device__ int act_ld(int i) const {
    return (i == 0 ? p.d_in : p.hidden) + kPad;
  }
  __device__ float* bias() const {
    return reinterpret_cast<float*>(s + p.bias_off);
  }
  __device__ float* pre_d() const {
    return reinterpret_cast<float*>(s + p.rowbuf_off);
  }
  __device__ float* gpd() const { return pre_d() + kRows; }
  __device__ float* rgb() const { return pre_d() + 2 * kRows; }
  __device__ float* gpc() const { return pre_d() + 5 * kRows; }
  // The ray of each row of the tile, -1 past the last row.
  __device__ int* ray_of() const {
    return reinterpret_cast<int*>(pre_d() + 8 * kRows);
  }
  __device__ float* acc() const {
    return reinterpret_cast<float*>(s + p.acc_off);
  }
  __device__ float* bpart() const {
    return reinterpret_cast<float*>(s + p.bpart_off);
  }
};

// The three products, each over the tile's rows or a weight's rows:
enum Kind {
  kXWt,  // a[rows, k] @ w[n, k]^T   (forward; w is [out, in])
  kGW,   // g[rows, k] @ w[k, n]     (cotangents; w is [out = k, in = n])
  kGtA,  // g[k, m]^T @ a[k, n]      (weight gradients, k over the rows)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a @ b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[j] += A(rows i0*16..+16) @ B(cols (j0 + j)*8..+8) over k_dim, for j < NB
// (NB even): one A fragment feeds NB independent accumulators. Lane l
// holds c[j][0..1] at (row l/4, cols 2(l%4)..+1) of its 16x8 tile and
// c[j][2..3] eight rows below (the m16n8 accumulator layout).
template <int kind, int NB>
__device__ __forceinline__ void mma_strip(const bf16* a, int lda, const bf16* b,
                                          int ldb, int k_dim, int i0, int j0,
                                          float (&c)[NB][4]) {
  const int l = threadIdx.x & 31;
  const uint32_t a0 = smem_addr(a), b0 = smem_addr(b);
#pragma unroll 4
  for (int k = 0; k < k_dim; k += 16) {
    uint32_t fa[4];
    if constexpr (kind == kGtA) {  // A(m, k) = g[k, m]: transposed load
      const int row = k + (l & 7) + ((l >> 4) << 3), col = i0 * 16 + ((l >> 3) & 1) * 8;
      ldmatrix_x4_trans(a0 + 2 * (row * lda + col), fa);
    } else {
      const int row = i0 * 16 + (l & 15), col = k + (l >> 4) * 8;
      ldmatrix_x4(a0 + 2 * (row * lda + col), fa);
    }
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t fb[4];  // b0, b1 of tile j, then of tile j + 1
      if constexpr (kind == kXWt) {  // B(k, n) = w[n, k]
        const int n = (j0 + j) * 8 + (l & 7) + ((l >> 4) << 3);
        ldmatrix_x4(b0 + 2 * (n * ldb + k + ((l >> 3) & 1) * 8), fb);
      } else {  // B(k, n) = w[k, n]: transposed load
        const int row = k + (l & 7) + ((l >> 3) & 1) * 8;
        ldmatrix_x4_trans(b0 + 2 * (row * ldb + (j0 + j) * 8 + (l >> 4) * 8), fb);
      }
      mma_16816(c[j], fa, fb[0], fb[1]);
      mma_16816(c[j + 1], fa, fb[2], fb[3]);
    }
  }
}

// For every 16x8 tile of the tile's [kRows, n_cols] product:
// epi(rt, col, c) with this lane's four accumulators, at rows rt*16 + l/4
// (c[0..1]) and 8 below (c[2..3]), columns col and col + 1. A warp takes
// one 16-row tile and NB neighbouring 8-column tiles at a time.
template <int kind, int NB, class Epi>
__device__ void row_pass_n(const bf16* a, int lda, const bf16* b, int ldb,
                           int k_dim, int n_cols, const Epi& epi) {
  const int strips = n_cols / 8 / NB, l = threadIdx.x & 31;
  for (int u = threadIdx.x >> 5; u < kRowTiles * strips; u += kWarps) {
    const int rt = u % kRowTiles, j0 = (u / kRowTiles) * NB;
    float c[NB][4] = {};
    mma_strip<kind, NB>(a, lda, b, ldb, k_dim, rt, j0, c);
#pragma unroll
    for (int j = 0; j < NB; ++j) epi(rt, (j0 + j) * 8 + 2 * (l & 3), c[j]);
  }
}

// The widest strip (8, 4 or 2 tiles of 8 columns) that still gives every
// warp a unit, over `rows16` row tiles and `n8` column tiles.
__device__ __forceinline__ int strip_width(int rows16, int n8) {
  if (n8 % 8 == 0 && rows16 * n8 / 8 >= kWarps) return 8;
  if (n8 % 4 == 0 && rows16 * n8 / 4 >= kWarps) return 4;
  return 2;
}

template <int kind, class Epi>
__device__ void row_pass(const bf16* a, int lda, const bf16* b, int ldb,
                         int k_dim, int n_cols, const Epi& epi) {
  const int nb = strip_width(kRowTiles, n_cols / 8);
  if (nb == 8) {
    row_pass_n<kind, 8>(a, lda, b, ldb, k_dim, n_cols, epi);
  } else if (nb == 4) {
    row_pass_n<kind, 4>(a, lda, b, ldb, k_dim, n_cols, epi);
  } else {
    row_pass_n<kind, 2>(a, lda, b, ldb, k_dim, n_cols, epi);
  }
}

__device__ void load_params(const View& v, const float* w, const float* b) {
  const Plan& p = v.p;
  for (int i = 0; i < p.n_mats; ++i) {
    bf16* dst = v.mat(i);
    const int cols = p.cols[i], ld = v.mat_ld(i), n = p.rows[i] * cols;
    const float* src = w + p.w_off[i];
    for (int e = threadIdx.x; e < n; e += kThreads) {
      dst[(e / cols) * ld + e % cols] = __float2bfloat16(src[e]);
    }
  }
  for (int e = threadIdx.x; e < p.n_b; e += kThreads) v.bias()[e] = b[e];
}

constexpr int kRowsPerWarp = kRows / kWarps;
static_assert(kRowsPerWarp * kWarps == kRows, "rows split evenly over warps");

// out[r, k] = a[r, :] . w[k, :] + bias[k] for k < K: each warp takes its
// kRowsPerWarp rows at once, each lane a stride of the columns.
template <int K>
__device__ void row_dots(const View& v, int in_act, int m, float* out) {
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kRowsPerWarp;
  const bf16* a = v.act(in_act) + r0 * v.act_ld(in_act);
  const int lda = v.act_ld(in_act), ldw = v.mat_ld(m);
  const bf16* w = v.mat(m);
  float s[kRowsPerWarp][K] = {};
  for (int j = lane; j < v.p.hidden; j += 32) {
    float wk[K];
    for (int k = 0; k < K; ++k) wk[k] = bf(w[k * ldw + j]);
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float av = bf(a[i * lda + j]);
      for (int k = 0; k < K; ++k) s[i][k] += av * wk[k];
    }
  }
  for (int o = 16; o; o >>= 1) {
    for (int i = 0; i < kRowsPerWarp; ++i) {
      for (int k = 0; k < K; ++k) s[i][k] += __shfl_xor_sync(0xffffffffu, s[i][k], o);
    }
  }
  if (lane == 0) {
    const float* bias = v.bias() + v.p.b_off[m];
    for (int i = 0; i < kRowsPerWarp; ++i) {
      for (int k = 0; k < K; ++k) out[(r0 + i) * K + k] = s[i][k] + bias[k];
    }
  }
}

// One hidden layer over the tile: out = relu(in @ W_m^T + bias), or with
// `head_dir` + head_dir[ray] in place of the bias.
__device__ void hidden_layer(const View& v, int m, int in_act, int out_act,
                             const float* head_dir) {
  const int g = (threadIdx.x & 31) >> 2, h = v.p.hidden;
  bf16* o = v.act(out_act);
  const int ldo = v.act_ld(out_act);
  const float* bias = v.bias() + v.p.b_off[m];
  const int* ray_of = v.ray_of();
  auto epi = [&](int rt, int col, const float (&c)[4]) {
    for (int half = 0; half < 2; ++half) {
      const int row = rt * 16 + g + 8 * half;
      float2 add;
      if (head_dir) {
        const int ray = ray_of[row];
        add = ray >= 0 ? *reinterpret_cast<const float2*>(
                             head_dir + static_cast<long long>(ray) * h + col)
                       : make_float2(0.0f, 0.0f);
      } else {
        add = make_float2(bias[col], bias[col + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(o + row * ldo + col) =
          __floats2bfloat162_rn(nan_max(c[2 * half] + add.x, 0.0f),
                                nan_max(c[2 * half + 1] + add.y, 0.0f));
    }
  };
  row_pass<kXWt>(v.act(in_act), v.act_ld(in_act), v.mat(m), v.mat_ld(m),
                 v.p.cols[m], h, epi);
  __syncthreads();
}

// The forward chain of one tile into shared memory: every activation,
// pre_d and (with a head) rgb.
__device__ void forward_tile(const View& v, const float* x,
                             const float* head_dir, long long row0,
                             long long num_rows, int num_samples) {
  const Plan& p = v.p;
  {
    bf16* a0 = v.act(0);
    const int ld = v.act_ld(0), q = p.d_in / 4;
    for (int e = threadIdx.x; e < kRows * q; e += kThreads) {
      const int r = e / q, j = (e - r * q) * 4;
      const long long n = row0 + r;
      const float4 val = n < num_rows
                             ? *reinterpret_cast<const float4*>(x + n * p.d_in + j)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      auto* dst = reinterpret_cast<__nv_bfloat162*>(a0 + r * ld + j);
      dst[0] = __floats2bfloat162_rn(val.x, val.y);
      dst[1] = __floats2bfloat162_rn(val.z, val.w);
    }
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const long long n = row0 + r;
      v.ray_of()[r] = n < num_rows ? static_cast<int>(n / num_samples) : -1;
    }
  }
  __syncthreads();
  for (int i = 0; i < p.n_base; ++i) hidden_layer(v, i, i, i + 1, nullptr);
  row_dots<1>(v, p.n_base, p.n_base, v.pre_d());
  if (p.n_head > 0) {
    const int h0 = p.n_base + 1;
    hidden_layer(v, h0, p.n_base, p.n_base + 1, head_dir);
    for (int j = 1; j < p.n_head; ++j) {
      hidden_layer(v, h0 + j, p.n_base + j, p.n_base + 1 + j, nullptr);
    }
    row_dots<3>(v, p.n_base + p.n_head, h0 + p.n_head, v.rgb());
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * 3; e += kThreads) {
      v.rgb()[e] = sigmoid(v.rgb()[e]);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1) mlp_fwd_kernel(
    Plan plan, const float* __restrict__ x, const float* __restrict__ head_dir,
    const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ rgb_out, float* __restrict__ dens_out,
    long long num_rows, int num_samples) {
  extern __shared__ __align__(128) char smem[];
  Plan& p = *reinterpret_cast<Plan*>(smem);
  if (threadIdx.x == 0) p = plan;
  __syncthreads();
  const View v{p, smem};
  load_params(v, w, b);
  __syncthreads();
  const long long tiles = (num_rows + kRows - 1) / kRows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kRows;
    forward_tile(v, x, head_dir, row0, num_rows, num_samples);
    for (int r = threadIdx.x; r < kRows; r += kThreads) {
      const long long n = row0 + r;
      if (n >= num_rows) continue;
      const float pd = v.pre_d()[r];
      dens_out[n] = fmaxf(pd, 0.0f) + log1pf(expf(-fabsf(pd)));
      if (p.n_head > 0) {
        for (int k = 0; k < 3; ++k) rgb_out[n * 3 + k] = v.rgb()[r * 3 + k];
      }
    }
    __syncthreads();
  }
}

// The backward's epilogue for the cotangent of activation `act` (this
// lane's four f32 values, plus the density term when `add_density`):
// masked by act > 0 and written as bf16 over act; its f32 column sums go
// to `bpart` (for a bias gradient) and, with `dhd`, its per-ray sums to
// dhead_dir.
struct MaskEpi {
  const View& v;
  bf16* act;
  int lda;
  float* dhd;  // nullptr: no dhead_dir
  bool add_density, bias;
  __device__ void operator()(int rt, int col, const float (&c)[4]) const {
    const int l = threadIdx.x & 31, g = l >> 2, h = v.p.hidden;
    const bf16* wd = v.mat(v.p.n_base);
    const int* ray_of = v.ray_of();
    float gp[2][2];
    for (int half = 0; half < 2; ++half) {
      const int row = rt * 16 + g + 8 * half;
      float g0 = c[2 * half], g1 = c[2 * half + 1];
      if (add_density) {
        const float gd = bfr(v.gpd()[row]);
        g0 += gd * bf(wd[col]);
        g1 += gd * bf(wd[col + 1]);
      }
      auto* ap = reinterpret_cast<__nv_bfloat162*>(act + row * lda + col);
      const float2 a = __bfloat1622float2(*ap);
      gp[half][0] = a.x > 0.0f ? g0 : 0.0f;
      gp[half][1] = a.y > 0.0f ? g1 : 0.0f;
      *ap = __floats2bfloat162_rn(gp[half][0], gp[half][1]);
    }
    // Column sums over the 16 rows: the lanes that share l % 4.
    float s0 = gp[0][0] + gp[1][0], s1 = gp[0][1] + gp[1][1];
    for (int o = 4; o < 32; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (bias && g == 0) {
      v.bpart()[rt * h + col] = s0;
      v.bpart()[rt * h + col + 1] = s1;
    }
    if (dhd) {
      const int first = ray_of[rt * 16], last = ray_of[rt * 16 + 15];
      if (first == last && first >= 0) {  // the 16 rows of one ray
        if (g == 0) {
          float* dst = dhd + static_cast<long long>(first) * h + col;
          atomicAdd(dst, s0);
          atomicAdd(dst + 1, s1);
        }
      } else {
        for (int half = 0; half < 2; ++half) {
          const int ray = ray_of[rt * 16 + g + 8 * half];
          if (ray < 0) continue;
          float* dst = dhd + static_cast<long long>(ray) * h + col;
          atomicAdd(dst, gp[half][0]);
          atomicAdd(dst + 1, gp[half][1]);
        }
      }
    }
  }
};

// After a MaskEpi pass: the bias gradient of matrix bias_m from `bpart`,
// summed over the row tiles in order.
__device__ void finish_bias(const View& v, int bias_m) {
  __syncthreads();
  if (bias_m >= 0) {
    const int h = v.p.hidden;
    float* acc = v.acc() + v.p.b_off[bias_m];
    for (int j = threadIdx.x; j < h; j += kThreads) {
      float s = 0.0f;
      for (int rt = 0; rt < kRowTiles; ++rt) s += v.bpart()[rt * h + j];
      acc[j] += s;
    }
  }
  __syncthreads();
}

// The cotangent of activation `act_i` through matrix m's product
// (gp of act g_act @ W_m), then MaskEpi.
__device__ void mask_product(const View& v, int g_act, int m, int act_i,
                             int bias_m, float* dhd, bool add_density) {
  const MaskEpi epi{v, v.act(act_i), v.act_ld(act_i), dhd, add_density,
                    bias_m >= 0};
  row_pass<kGW>(v.act(g_act), v.act_ld(g_act), v.mat(m), v.mat_ld(m),
                v.p.rows[m], v.p.hidden, epi);
  finish_bias(v, bias_m);
}

// The same when the cotangent comes from the colour head (bf16(gpc) @ W_c,
// `colour`) or from the density head alone (no head).
__device__ void mask_scalar(const View& v, bool colour, int act_i, int bias_m,
                            float* dhd, bool add_density) {
  const MaskEpi epi{v, v.act(act_i), v.act_ld(act_i), dhd, add_density,
                    bias_m >= 0};
  const int l = threadIdx.x & 31, g = l >> 2;
  const int n8 = v.p.hidden / 8, mc = v.p.n_base + 1 + v.p.n_head;
  for (int t = threadIdx.x >> 5; t < kRowTiles * n8; t += kWarps) {
    const int rt = t / n8, col = (t - rt * n8) * 8 + 2 * (l & 3);
    float c[4] = {};
    if (colour) {
      const bf16* wc = v.mat(mc);
      const int ldc = v.mat_ld(mc);
      for (int half = 0; half < 2; ++half) {
        const int row = rt * 16 + g + 8 * half;
        for (int k = 0; k < 3; ++k) {
          const float gk = bfr(v.gpc()[row * 3 + k]);
          c[2 * half] += gk * bf(wc[k * ldc + col]);
          c[2 * half + 1] += gk * bf(wc[k * ldc + col + 1]);
        }
      }
    }
    epi(rt, col, c);
  }
  finish_bias(v, bias_m);
}

// dW_m += gp(act g_act)^T @ act(in_act) into this block's workspace row:
// each unit reads its accumulators from device memory (L2), adds the
// tile's rows and writes them back.
template <int NB>
__device__ void dw_pass_n(const View& v, int m, int g_act, int in_act,
                          float* ws_row) {
  const int rows = v.p.rows[m], cols = v.p.cols[m], l = threadIdx.x & 31;
  const int mtiles = rows / 16, strips = cols / 8 / NB;
  float* dw = ws_row + v.p.w_off[m];
  for (int u = threadIdx.x >> 5; u < mtiles * strips; u += kWarps) {
    const int mt = u % mtiles, j0 = (u / mtiles) * NB;
    float c[NB][4];
    float* base = dw + (mt * 16 + (l >> 2)) * cols + j0 * 8 + 2 * (l & 3);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float2 lo = *reinterpret_cast<const float2*>(base + j * 8);
      const float2 hi = *reinterpret_cast<const float2*>(base + 8 * cols + j * 8);
      c[j][0] = lo.x;
      c[j][1] = lo.y;
      c[j][2] = hi.x;
      c[j][3] = hi.y;
    }
    mma_strip<kGtA, NB>(v.act(g_act), v.act_ld(g_act), v.act(in_act),
                        v.act_ld(in_act), kRows, mt, j0, c);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      *reinterpret_cast<float2*>(base + j * 8) = make_float2(c[j][0], c[j][1]);
      *reinterpret_cast<float2*>(base + 8 * cols + j * 8) =
          make_float2(c[j][2], c[j][3]);
    }
  }
  __syncthreads();
}

__device__ void dw_pass(const View& v, int m, int g_act, int in_act,
                        float* ws_row) {
  const int nb = strip_width(v.p.rows[m] / 16, v.p.cols[m] / 8);
  if (nb == 8) {
    dw_pass_n<8>(v, m, g_act, in_act, ws_row);
  } else if (nb == 4) {
    dw_pass_n<4>(v, m, g_act, in_act, ws_row);
  } else {
    dw_pass_n<2>(v, m, g_act, in_act, ws_row);
  }
}

__global__ void __launch_bounds__(kThreads, 1) mlp_bwd_kernel(
    Plan plan, const float* __restrict__ x, const float* __restrict__ head_dir,
    const float* __restrict__ w, const float* __restrict__ b,
    const float* __restrict__ g_rgb, const float* __restrict__ g_dens,
    float* __restrict__ dx, float* dhd, float* __restrict__ ws, int ws_stride,
    long long num_rows, int num_samples) {
  extern __shared__ __align__(128) char smem[];
  Plan& p = *reinterpret_cast<Plan*>(smem);
  if (threadIdx.x == 0) p = plan;
  __syncthreads();
  const View v{p, smem};
  load_params(v, w, b);
  const int h = p.hidden, tid = threadIdx.x;
  float* acc = v.acc();
  for (int e = tid; e < p.n_b + 4 * h; e += kThreads) acc[e] = 0.0f;
  float* ws_row = ws + static_cast<long long>(blockIdx.x) * ws_stride;
  __syncthreads();
  const int top = p.n_base, last = p.n_base + p.n_head;
  const int md = p.n_base, h0 = p.n_base + 1, mc = p.n_base + 1 + p.n_head;
  const bool head = p.n_head > 0;
  const long long tiles = (num_rows + kRows - 1) / kRows;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * kRows;
    forward_tile(v, x, head_dir, row0, num_rows, num_samples);
    // Cotangents of the density and colour pre-activations.
    for (int r = tid; r < kRows; r += kThreads) {
      const long long n = row0 + r;
      const bool valid = n < num_rows;
      v.gpd()[r] = valid ? g_dens[n] * sigmoid(v.pre_d()[r]) : 0.0f;
      if (head) {
        for (int k = 0; k < 3; ++k) {
          const float y = v.rgb()[r * 3 + k];
          v.gpc()[r * 3 + k] = valid ? g_rgb[n * 3 + k] * y * (1.0f - y) : 0.0f;
        }
      }
    }
    __syncthreads();
    // d w_d and d W_c (bf16 cotangents), one (output, column) per thread;
    // b_d and b_c (f32 sums).
    for (int e = tid; e < (head ? 4 : 1) * h; e += kThreads) {
      const int k = e / h, j = e - k * h;  // k = 0: density, 1..3: colour
      const bf16* a = v.act(k == 0 ? top : last) + j;
      const int lda = v.act_ld(k == 0 ? top : last);
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) {
        const float g = k == 0 ? v.gpd()[r] : v.gpc()[r * 3 + k - 1];
        s += bfr(g) * bf(a[r * lda]);
      }
      acc[p.n_b + e] += s;
    }
    if (tid == kThreads - 1) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += v.gpd()[r];
      acc[p.b_off[md]] += s;
    } else if (head && tid >= kThreads - 4) {
      const int k = kThreads - 2 - tid;  // 0, 1, 2
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += v.gpc()[r * 3 + k];
      acc[p.b_off[mc] + k] += s;
    }
    __syncthreads();
    if (head) {
      // The last head output, from the colour head.
      mask_scalar(v, true, last, p.n_head > 1 ? h0 + p.n_head - 1 : -1,
                  p.n_head == 1 ? dhd : nullptr, false);
      for (int j = p.n_head - 1; j >= 1; --j) {
        dw_pass(v, h0 + j, p.n_base + 1 + j, p.n_base + j, ws_row);
        mask_product(v, p.n_base + 1 + j, h0 + j, p.n_base + j,
                     j > 1 ? h0 + j - 1 : -1, j == 1 ? dhd : nullptr, false);
      }
      dw_pass(v, h0, p.n_base + 1, top, ws_row);
      mask_product(v, p.n_base + 1, h0, top, p.n_base - 1, nullptr, true);
    } else {
      mask_scalar(v, false, top, p.n_base - 1, nullptr, true);
    }
    for (int i = p.n_base - 1; i >= 1; --i) {
      dw_pass(v, i, i + 1, i, ws_row);
      mask_product(v, i + 1, i, i, i - 1, nullptr, false);
    }
    dw_pass(v, 0, 1, 0, ws_row);
    // dx = gp_0 @ W_0, straight to device memory.
    {
      const int g = (tid & 31) >> 2;
      auto epi = [&](int rt, int col, const float (&c)[4]) {
        for (int half = 0; half < 2; ++half) {
          const long long n = row0 + rt * 16 + g + 8 * half;
          if (n < num_rows) {
            *reinterpret_cast<float2*>(dx + n * p.d_in + col) =
                make_float2(c[2 * half], c[2 * half + 1]);
          }
        }
      };
      row_pass<kGW>(v.act(1), v.act_ld(1), v.mat(0), v.mat_ld(0), h, p.d_in, epi);
    }
    __syncthreads();
  }
  // The gradients kept in shared memory go to this block's row.
  for (int e = tid; e < p.n_b; e += kThreads) ws_row[p.n_w + e] = acc[e];
  for (int j = tid; j < h; j += kThreads) {
    ws_row[p.w_off[md] + j] = acc[p.n_b + j];
    if (head) {
      for (int k = 0; k < 3; ++k) {
        ws_row[p.w_off[mc] + k * h + j] = acc[p.n_b + h + k * h + j];
      }
    }
  }
}

// out[i] = sum over blocks of ws[block, i], in block order.
__global__ void __launch_bounds__(256) sum_rows_kernel(
    const float* __restrict__ ws, int num_blocks, int ws_stride, int n,
    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int blk = 0; blk < num_blocks; ++blk) {
    s += ws[static_cast<long long>(blk) * ws_stride + i];
  }
  out[i] = s;
}

int launch_grid(long long num_rows, int num_blocks) {
  const long long tiles = (num_rows + kRows - 1) / kRows;
  return static_cast<int>(std::min<long long>(num_blocks, tiles));
}

}  // namespace

// Forward (K4 with n_head >= 1, K5 with n_head == 0). w, b: the packed
// weights ([out, in] each) and biases in the Plan's order. rgb and head_dir
// are unused when n_head == 0.
extern "C" int tetranerf_fused_mlp_forward(
    const float* x, const float* head_dir, const float* w, const float* b,
    float* rgb, float* dens, int num_rays, int num_samples, int d_in,
    int hidden, int n_base, int n_head, int num_blocks, cudaStream_t stream) {
  Plan plan;
  if (!make_plan(d_in, hidden, n_base, n_head, &plan) || num_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long num_rows = static_cast<long long>(num_rays) * num_samples;
  if (num_rows == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      plan.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_fwd_kernel<<<launch_grid(num_rows, num_blocks), kThreads,
                   plan.smem_bytes, stream>>>(plan, x, head_dir, w, b, rgb,
                                              dens, num_rows, num_samples);
  return static_cast<int>(cudaGetLastError());
}

// Backward (K4b, K5b). dhd must be zeroed and ws ([num_blocks, ws_stride])
// zeroed by the caller; grads gets the packed weight gradients (n_w floats)
// followed by the bias gradients (n_b floats).
extern "C" int tetranerf_fused_mlp_backward(
    const float* x, const float* head_dir, const float* w, const float* b,
    const float* g_rgb, const float* g_dens, float* dx, float* dhd, float* ws,
    float* grads, int num_rays, int num_samples, int d_in, int hidden,
    int n_base, int n_head, int num_blocks, int ws_stride,
    cudaStream_t stream) {
  Plan plan;
  if (!make_plan(d_in, hidden, n_base, n_head, &plan) || num_blocks < 1 ||
      ws_stride < plan.n_w + plan.n_b || ws_stride % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long num_rows = static_cast<long long>(num_rays) * num_samples;
  if (num_rows > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        plan.smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    mlp_bwd_kernel<<<launch_grid(num_rows, num_blocks), kThreads,
                     plan.smem_bytes, stream>>>(
        plan, x, head_dir, w, b, g_rgb, g_dens, dx, dhd, ws, ws_stride,
        num_rows, num_samples);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n = plan.n_w + plan.n_b;
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, stream>>>(ws, num_blocks,
                                                       ws_stride, n, grads);
  return static_cast<int>(cudaGetLastError());
}
