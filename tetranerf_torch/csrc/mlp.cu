// K4 / K4b: the fused field MLPs, forward and backward.
// K5 / K5b: the fused density MLP (the coarse round's head-free chain),
//           forward and backward.
//
//   base:    a_0 = x;  a_{k+1} = relu(a_k W_k^T + b_k)           k < n_base
//   density: density = softplus(a_nb w_d^T + b_d)                  (nb = n_base)
//   head:    a_{nb+1} = relu(a_nb W_bh^T + head_dir[ray])          (K4 only)
//            a_{k+1} = relu(a_k W_k^T + b_k)                 nb < k < L
//   colour:  rgb = sigmoid(a_L W_c^T + b_c)                        (L = n_base + n_head)
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
// What bounds it on the H100: bf16 operations on the tensor cores. At the
// train slice (4096 rays x 257 samples, 57,856 MACs per row) K4 does 121.8
// GFLOP, 0.123 ms at the 989 TFLOP/s bf16 dense peak of an H100 SXM at
// 700 W, against 0.080 ms to read x; K4b needs three times K4's products.
// On the TPU the backward adds its weight gradients into one output along
// the sequential grid; here blocks run in parallel, so each block needs
// its own f32 weight-gradient sums, 229 KB at the preset's widths: more
// than an SM holds beside the 115 KB of bf16 weights.
//
// Design. Rows (samples) are flattened to N = R * S; the ray of row n is
// n / S. Persistent blocks, one per SM, convert the weights once to bf16
// in shared memory, laid out as wgmma's 8x8 core matrices (no swizzle).
// Each warpgroup owns a 64-row tile. Every layer is one chain of `wgmma`
// m64nNk16 (N = the layer's output width) with B the weight matrix in
// shared memory and A the previous activation in registers: the f32
// accumulator of layer k, after bias, ReLU and the cast to bf16 in
// registers, is layer k+1's A fragment, so activations never touch shared
// memory and layers need no barrier beyond the warpgroup's own wgmma wait.
// The density (1 output) and colour (3) heads are dot products in
// registers reduced over the four lanes that share a row: a padded N = 8
// wgmma would waste 7/8 of its work and still need the same reduction of
// its accumulator layout into rows. x arrives by cp.async, 16 bytes per
// thread into an XOR-swizzled f32 stage per warpgroup; each warpgroup
// starts its next tile's copy as soon as its current x sits in registers,
// so the copy overlaps the whole tile (one stage per warpgroup; where the
// backward's shared memory is short, the stage shares the cotangent
// staging and the copy waits for the tile's end: the plan's `prefetch`).
//
// The backward (option (a) of the redesign: a larger reduction depth per
// weight-gradient write; chosen because a per-pass clock split of the
// first design, which added every 64 rows' weight gradients into a
// workspace in L2, put 39% of its time in that read-modify-write).
// Three launches:
//  1. `mlp_aux_kernel` runs the whole forward chain of every tile and
//     writes what the cotangents need from it into a scratch (`aux`, 80
//     bytes a row at the preset: a bit per element of each layer's ReLU
//     mask, and the cotangents of pre_d and pre_c), with the heads'
//     gradients (w_d, b_d, W_c, b_c) as running sums in registers.
//  2. `mlp_bwd_kernel` runs one phase per hidden matrix W_k, top first,
//     each over all of the block's rows, two warpgroups on a 128-row tile
//     pair: recompute the layers below W_k (a_k staged as bf16 in shared
//     memory), take the masks and head cotangents of the tile from `aux`
//     (copied by cp.async while the tile before it runs), run the
//     cotangents down to gz_{k+1} with `wgmma` (A = the bf16 cotangent in
//     registers, B = W in its MN-major form from the same shared-memory
//     copy) and stage gz_{k+1}; then each warpgroup adds its 64 rows of
//     dW_k += gz^T a over the pair's 128 rows with one shared-memory
//     `wgmma` chain into f32 registers that live for the whole phase, and
//     goes on to its next tile, waiting for the other warpgroup only
//     before it writes the staging again. At the phase's end the block
//     writes its dW_k once into its own workspace row.
//  3. `sum_rows_kernel` adds the workspace rows in block order.
// The weight gradients are the same in every run (no float atomics). Bias
// gradients are f32 column sums of the unrounded cotangents: a reduce-
// scatter over the lanes, running sums per lane, per-warp partials summed
// in warp order. Weight-gradient workspace traffic: (n_w + n_b) f32
// written and read once per block, 2 x 233 KB per 7,975 rows at the train
// slice, 58 bytes per row (the first design: 7.2 KB per row, a read-
// modify-write of the 229 KB every 64 rows). The price is recomputation: 1.7x
// the products of one pass at the preset (294,912 MACs per row against
// 172,032), with x read once per launch and phase and `aux` once per
// phase. Launch 1 holds no weight-gradient registers and launch 2 no head
// state, so each gets the registers it needs: one kernel holding both ran
// out of registers, and ptxas serialised its wgmma. dhead_dir sums a
// ray's rows in f32 with atomics (16 rows of one ray: one atomic per
// column; rows that span rays: one per element), in a run-dependent
// order. A ReLU mask bit is set where the bf16-rounded activation is > 0.

#include <cuda_bf16.h>

#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRows = 64;         // rows per warpgroup tile (wgmma's M)
constexpr int kMaxLayers = 8;     // hidden matrices, n_base + n_head
constexpr int kMaxSmem = 232448;  // shared memory a block may use
constexpr int kMaxFwdGroups = 3;  // warpgroups of a forward block, at most
constexpr int kBwdGroups = 2;     // warpgroups of a backward block
constexpr int kPairBarrier = 8;   // named barrier of the backward's two warpgroups

// The launch plan. Hidden matrix k maps a_k to a_{k+1}: base layers
// k < n_base, then the head layers (k = n_base is W_bh, whose bias is
// head_dir). Offsets of the packed f32 weights (`w_off`, in floats) and
// biases (`b_off`, -1: none) follow ops/mlp.py's `_pack`; `s_off` is the
// byte offset of a matrix's bf16 copy in shared memory. `prefetch`: the x
// stages have room of their own (else they share the backward's cotangent
// staging). The host computes the same plan (ops/mlp.py `launch_plan`)
// and passes `warpgroups`, `prefetch` and `smem_bytes`; a mismatch is
// refused.
struct Plan {
  int d_in, hidden, n_base, n_head, n_layers, n_w, n_b;
  int warpgroups, prefetch;
  int in_dim[kMaxLayers], w_off[kMaxLayers], b_off[kMaxLayers], s_off[kMaxLayers];
  int wd_off, bd_off, wc_off, bc_off;  // the heads' offsets (-1: no colour head)
  int small_off;  // f32: biases [n_b], then bf16-rounded w_d [H] and W_c [3, H]
  int x_off, x_stride;  // x stage of warpgroup w at x_off + w * x_stride
  int g_off, a_off;     // backward: staged cotangents and layer inputs, 128 rows
  int aux_off, aux_words;  // backward: a tile's cached masks and head cotangents
  int smem_bytes;
};

int align_up(int x, int a) { return (x + a - 1) / a * a; }

bool make_plan(int d_in, int hidden, int n_base, int n_head, bool backward,
               int warpgroups, int prefetch, Plan* p) {
  const int n_layers = n_base + n_head;
  if (n_base < 1 || n_head < 0 || n_layers > kMaxLayers) return false;
  if (backward ? warpgroups != kBwdGroups
               : (warpgroups < 1 || warpgroups > kMaxFwdGroups)) {
    return false;
  }
  *p = Plan{};
  p->d_in = d_in;
  p->hidden = hidden;
  p->n_base = n_base;
  p->n_head = n_head;
  p->n_layers = n_layers;
  p->warpgroups = warpgroups;
  p->prefetch = backward ? prefetch : 1;
  // Packed order: base (W, b) pairs, density (w_d, b_d), then W_bh, the
  // other head (W, b) pairs, colour (W_c, b_c); matrices first, then biases.
  int w = 0, b = 0;
  for (int k = 0; k < n_layers; ++k) {
    if (k == n_base) {
      p->wd_off = w;
      w += hidden;
      p->bd_off = b;
      b += 1;
    }
    p->in_dim[k] = k == 0 ? d_in : hidden;
    p->w_off[k] = w;
    w += hidden * p->in_dim[k];
    p->b_off[k] = k == n_base ? -1 : b;
    if (k != n_base) b += hidden;
  }
  if (n_head == 0) {
    p->wd_off = w;
    w += hidden;
    p->bd_off = b;
    b += 1;
    p->wc_off = p->bc_off = -1;
  } else {
    p->wc_off = w;
    w += 3 * hidden;
    p->bc_off = b;
    b += 3;
  }
  p->n_w = w;
  p->n_b = b;
  int off = 0;
  for (int k = 0; k < n_layers; ++k) {
    p->s_off[k] = off;
    off += align_up(hidden * p->in_dim[k] * 2, 128);
  }
  p->small_off = off;
  off += align_up((b + 4 * hidden) * 4, 128);
  const int x_bytes = kRows * d_in * 4;
  if (!backward) {
    p->x_off = off;
    p->x_stride = align_up(x_bytes, 128);
    off += warpgroups * p->x_stride;
  } else {
    // The cotangent staging, with 512 bytes past its end that a padded
    // M = 64 read of H < 64 columns may touch.
    const int g_bytes = align_up(2 * kRows * hidden * 2 + 512, 128);
    if (prefetch) {
      p->x_off = off;
      p->x_stride = align_up(x_bytes, 128);
      off += kBwdGroups * p->x_stride;
    }
    p->g_off = off;
    off += g_bytes;
    p->a_off = off;
    off += align_up(2 * kRows * std::max(d_in, hidden) * 2, 128);
    if (!prefetch) {  // warpgroup w's x in the half of the staging of its rows
      p->x_off = p->g_off;
      p->x_stride = kRows * hidden * 2;
      if (x_bytes > p->x_stride) return false;
    }
    // One tile's block of the aux scratch (see mlp_bwd_kernel), per warpgroup.
    p->aux_words = kRows * 4 + n_layers * ((hidden / 2 + 31) / 32) * 128;
    p->aux_off = off;
    off += kBwdGroups * align_up(p->aux_words * 4, 128);
  }
  p->smem_bytes = off;
  return off <= kMaxSmem;
}

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ float bfr(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Shared-memory writes of the generic proxy made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across a wgmma.
template <int n>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma's shared-memory matrix descriptor, no swizzle: 8x8 core matrices
// of 128 contiguous bytes (8 rows of 16 bytes); `lbo` is the byte stride
// between core matrices along K, `sbo` along M or N.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// Byte offset of element (r, c) of a bf16 matrix with `cols` columns laid
// out as core matrices: row-groups of 8 rows, each a run of cols / 8 core
// matrices of 8 columns. As W [out, in] this is K-major for x W^T and
// MN-major for g W; staged [rows, cols] operands are MN-major for g^T a.
__device__ __forceinline__ int cm_off(int r, int c, int cols) {
  return ((r >> 3) * (cols >> 3) + (c >> 3)) * 128 + (r & 7) * 16 + (c & 7) * 2;
}

// The accumulator layout of an m64nN wgmma: element i of a thread holds
// row 16 * warp + lane / 4 + 8 * sel_of(i), column col_of(i).
__device__ __forceinline__ int sel_of(int i) { return (i >> 1) & 1; }
__device__ __forceinline__ int col_of(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

template <int N, int TB>
struct WgmmaRS;  // d[N/2] (+)= A (registers) x B (shared memory), bf16
template <int N>
struct WgmmaSS;  // d[N/2] += A x B, both MN-major in shared memory, bf16

template <int TB>
struct WgmmaRS<16, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %12, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %13, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b), "n"(TB));
  }
};

template <>
struct WgmmaSS<16> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <int TB>
struct WgmmaRS<32, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %20, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %21, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b), "n"(TB));
  }
};

template <>
struct WgmmaSS<32> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <int TB>
struct WgmmaRS<64, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %37, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b), "n"(TB));
  }
};

template <>
struct WgmmaSS<64> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <int TB>
struct WgmmaRS<128, TB> {
  static __device__ __forceinline__ void run(float* d, const uint32_t (&a)[4], uint64_t b, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %69, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(b), "n"(TB));
  }
};

template <>
struct WgmmaSS<128> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
  }
};

// acc = A @ W^T over K = KD: A in registers (bf16 fragments, as the m16n8k16
// A operand of each warp), W [N, KD] in shared memory (K-major).
template <int N, int KD>
__device__ __forceinline__ void layer_fwd(float* acc, const uint32_t (&a)[KD / 16][4],
                                          uint32_t w) {
  fence_regs<N / 2>(acc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KD / 16; ++kc) {
    WgmmaRS<N, 0>::run(acc, a[kc], make_desc(w + kc * 256, 128, KD * 16), kc > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs<N / 2>(acc);
}

// acc = G @ W over K = KH: G in registers, W [KH, N] in shared memory, read
// as B (K = W's rows, N = its columns: MN-major).
template <int N, int KH>
__device__ __forceinline__ void layer_bwd(float* acc, const uint32_t (&a)[KH / 16][4],
                                          uint32_t w) {
  fence_regs<N / 2>(acc);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < KH / 16; ++kc) {
    WgmmaRS<N, 1>::run(acc, a[kc], make_desc(w + kc * N * 32, N * 16, 128), kc > 0);
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs<N / 2>(acc);
}

// The f32 accumulator of an N-column tile as bf16 A fragments over K = N.
template <int N>
__device__ __forceinline__ void to_frags(const float* acc, uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc) {
#pragma unroll
    for (int q = 0; q < 4; ++q) a[kc][q] = pack_bf16(acc[8 * kc + 2 * q], acc[8 * kc + 2 * q + 1]);
  }
}

// Fragments a (K = C) of this warp's 16 rows into a staged [128, C] matrix.
template <int C>
__device__ __forceinline__ void stage_frags(char* buf, int row0, int lane,
                                            const uint32_t (&a)[C / 16][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < C / 16; ++kc) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = row0 + g + 8 * (q & 1), c = 16 * kc + 8 * (q >> 1) + 2 * t;
      *reinterpret_cast<uint32_t*>(buf + cm_off(r, c, C)) = a[kc][q];
    }
  }
}

// x rows [row0, row0 + 64) into a warpgroup's f32 stage by cp.async, 16
// bytes a thread; chunk c of row r lands at c ^ (r & mask) so the
// fragment reads below spread over the banks; rows past the end are zeros.
template <int D>
__device__ __forceinline__ void issue_x(char* stage, const float* x, long long row0,
                                        long long num_rows, int tid) {
  constexpr int kChunks = D / 4, kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  const uint32_t s = smem_u32(stage);
  for (int e = tid; e < kRows * kChunks; e += 128) {
    const int r = e / kChunks, c = e % kChunks;
    const long long n = row0 + r;
    const bool ok = n < num_rows;
    cp_async16(s + (r * kChunks + (c ^ (r & kMask))) * 16, ok ? x + n * D + c * 4 : x,
               ok ? 16 : 0);
  }
  cp_async_commit();
}

template <int D>
__device__ __forceinline__ void x_frags(const char* stage, int warp, int lane,
                                        uint32_t (&a)[D / 16][4]) {
  constexpr int kChunks = D / 4, kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  const float* s = reinterpret_cast<const float*>(stage);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 16 * warp + g + 8 * (q & 1), c = 16 * kc + 8 * (q >> 1) + 2 * t;
      const float2 v = *reinterpret_cast<const float2*>(
          s + (r * kChunks + ((c >> 2) ^ (r & kMask))) * 4 + (c & 3));
      a[kc][q] = pack_bf16(v.x, v.y);
    }
  }
}

// Column sums over a warp's 16 rows of v(i), per element i of an N-column
// accumulator, reduce-scattered over the eight lanes that share lane % 4:
// run[q] += the sum of column sum_col<N>(q, lane).
template <int N, class F>
__device__ __forceinline__ void colsum_add(float (&run)[N / 32], int lane, const F& v) {
  // The sum over a lane's two rows of column pair index c (c = 2j + b).
  const auto rows2 = [&](int c) { return v(4 * (c >> 1) + (c & 1)) + v(4 * (c >> 1) + 2 + (c & 1)); };
  float s1[N / 8], s2[N / 16];
  bool h = lane & 16;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const float lo = rows2(i), hi = rows2(N / 8 + i);
    s1[i] = (h ? hi : lo) + __shfl_xor_sync(0xffffffffu, h ? lo : hi, 16);
  }
  h = lane & 8;
#pragma unroll
  for (int i = 0; i < N / 16; ++i) {
    const float lo = s1[i], hi = s1[N / 16 + i];
    s2[i] = (h ? hi : lo) + __shfl_xor_sync(0xffffffffu, h ? lo : hi, 8);
  }
  h = lane & 4;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    const float lo = s2[i], hi = s2[N / 32 + i];
    run[i] += (h ? hi : lo) + __shfl_xor_sync(0xffffffffu, h ? lo : hi, 4);
  }
}
template <int N>
__device__ __forceinline__ int sum_col(int q, int lane) {
  const int idx = (N / 32) * (lane >> 2) + q;
  return 8 * (idx >> 1) + 2 * (lane & 3) + (idx & 1);
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float row_sum(float v) {  // over the 8 rows of a warp half
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// The weights into shared memory, once per block: each hidden matrix as
// bf16 core matrices; biases f32; w_d and W_c rounded to bf16 (held as f32).
template <int H>
__device__ void load_params(const Plan& p, char* smem, const float* w, const float* b) {
  const int nt = blockDim.x;
  for (int k = 0; k < p.n_layers; ++k) {
    const int in = p.in_dim[k], half = H * in / 2;
    const float* src = w + p.w_off[k];
    char* dst = smem + p.s_off[k];
    for (int e = threadIdx.x; e < half; e += nt) {
      const int r = (2 * e) / in, c = (2 * e) % in;
      const float2 v = *reinterpret_cast<const float2*>(src + 2 * e);
      *reinterpret_cast<uint32_t*>(dst + cm_off(r, c, in)) = pack_bf16(v.x, v.y);
    }
  }
  float* small = reinterpret_cast<float*>(smem + p.small_off);
  for (int e = threadIdx.x; e < p.n_b; e += nt) small[e] = b[e];
  for (int e = threadIdx.x; e < H; e += nt) small[p.n_b + e] = bfr(w[p.wd_off + e]);
  if (p.n_head > 0) {
    for (int e = threadIdx.x; e < 3 * H; e += nt) small[p.n_b + H + e] = bfr(w[p.wc_off + e]);
  }
  fence_async_smem();
  __syncthreads();
}

// One warpgroup tile's rows as this thread sees them: rows 0 and 1 are
// 16 * warp + lane / 4 and 8 below it.
struct Rows {
  long long n[2];
  int ray[2];
  bool valid[2];
};

__device__ __forceinline__ Rows tile_rows(long long row_base, int warp, int lane,
                                          long long num_rows, int num_samples) {
  Rows rw;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    rw.n[s] = row_base + 16 * warp + (lane >> 2) + 8 * s;
    rw.valid[s] = rw.n[s] < num_rows;
    rw.ray[s] = rw.valid[s] ? static_cast<int>(rw.n[s] / num_samples) : 0;
  }
  return rw;
}

// The aux pass's state of one thread (K4b's and K5b's first launch).
template <int H>
struct AuxState {
  float* aux;    // this tile's block of the aux scratch
  int tid;       // thread within the warpgroup
  float g_dens[2], g_rgb[2][3];  // the tile's output cotangents
  float gpd[2], gpc[2][3];       // cotangents of pre_d and pre_c
  // Running column sums (colsum_add's columns) of the heads' gradients.
  float run_wd[H / 32], run_wc[3][H / 32], run_bd, run_bc[3];
};

// The backward phases' staging of a warpgroup's rows for dW.
struct Staging {
  char* a_stage;
  int stage_k;   // stage a_k (k >= 1) in this phase
  int row0;      // this warp's first row within the staged 128
  bool pending;  // the other warpgroup may still read the staging
  // Waits, before the first write into the staging of a tile, until the
  // other warpgroup's dW update of the pair before it is done.
  __device__ __forceinline__ void free_staging() {
    if (pending) {
      bar_sync(kPairBarrier, kBwdGroups * 128);
      pending = false;
    }
  }
};

// A bf16-rounded activation a >= 0 (after ReLU) is > 0 exactly when the
// f32 a is above 2^-134: below, round-to-nearest-even gives bf16 zero.
__device__ __forceinline__ bool bf16_positive(float a) { return a > 0x1p-134f; }

enum ChainMode {
  kPlain,    // K4 / K5: the outputs
  kAuxPass,  // the backward's first launch: masks and head cotangents into
             // the aux scratch, the heads' gradients into the warp's slot
  kPhase,    // a backward phase: the layers below its matrix, a_k staged
};

// The forward chain of one warpgroup tile from its x fragments, over its
// first n_fwd hidden layers; with the heads (kPlain, kAuxPass) pre_d and,
// with a head, rgb per row.
template <int D, int H, int kMode>
__device__ __forceinline__ void forward_chain(const Plan& p, char* smem,
                                              const uint32_t (&ax)[D / 16][4],
                                              const float* head_dir, const Rows& rw,
                                              int lane, int n_fwd, float (&pre_d)[2],
                                              float (&rgb)[2][3], AuxState<H>* st,
                                              Staging* stg) {
  constexpr int kMW = (H / 2 + 31) / 32;
  constexpr bool kHeads = kMode != kPhase;
  const float* bias = reinterpret_cast<const float*>(smem + p.small_off);
  const float* wdr = bias + p.n_b;
  const float* wcr = wdr + H;
  float acc[H / 2];
  uint32_t ah[H / 16][4];
  for (int k = 0; k < n_fwd; ++k) {
    if (k == 0) {
      layer_fwd<H, D>(acc, ax, smem_u32(smem + p.s_off[0]));
    } else {
      layer_fwd<H, H>(acc, ah, smem_u32(smem + p.s_off[k]));
    }
    if (k == p.n_base) {  // W_bh: head_dir[ray] in place of the bias
#pragma unroll
      for (int i = 0; i < H / 2; i += 2) {
        const int s = sel_of(i);
        const float2 hd = rw.valid[s]
                              ? *reinterpret_cast<const float2*>(
                                    head_dir + static_cast<long long>(rw.ray[s]) * H +
                                    col_of(i, lane))
                              : make_float2(0.0f, 0.0f);
        acc[i] = nan_max(acc[i] + hd.x, 0.0f);
        acc[i + 1] = nan_max(acc[i + 1] + hd.y, 0.0f);
      }
    } else {
      const float* bk = bias + p.b_off[k];
#pragma unroll
      for (int i = 0; i < H / 2; ++i) acc[i] = nan_max(acc[i] + bk[col_of(i, lane)], 0.0f);
    }
    to_frags<H>(acc, ah);
    if constexpr (kMode == kAuxPass) {  // the ReLU masks into the aux scratch
#pragma unroll
      for (int wd = 0; wd < kMW; ++wd) {
        uint32_t m = 0;
#pragma unroll
        for (int i = 32 * wd; i < 32 * wd + 32 && i < H / 2; ++i) {
          m |= (bf16_positive(acc[i]) ? 1u : 0u) << (i - 32 * wd);
        }
        st->aux[kRows * 4 + (k * kMW + wd) * 128 + st->tid] = __uint_as_float(m);
      }
    }
    if constexpr (kMode == kPhase) {
      if (stg->stage_k == k + 1) {
        stg->free_staging();
        stage_frags<H>(stg->a_stage, stg->row0, lane, ah);
      }
    }
    if (kHeads && k + 1 == p.n_base) {  // the density head
      float d[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < H / 2; ++i) d[sel_of(i)] += bfr(acc[i]) * wdr[col_of(i, lane)];
#pragma unroll
      for (int s = 0; s < 2; ++s) pre_d[s] = quad_sum(d[s]) + bias[p.bd_off];
      if constexpr (kMode == kAuxPass) {
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          st->gpd[s] = rw.valid[s] ? st->g_dens[s] * sigmoid(pre_d[s]) : 0.0f;
        }
        const float g0 = bfr(st->gpd[0]), g1 = bfr(st->gpd[1]);
        colsum_add<H>(st->run_wd, lane,
                      [&](int i) { return (sel_of(i) ? g1 : g0) * bfr(acc[i]); });
        st->run_bd += st->gpd[0] + st->gpd[1];
      }
    }
  }
  if (kHeads && p.n_head > 0) {  // the colour head on a_L
    float c[2][3] = {};
#pragma unroll
    for (int i = 0; i < H / 2; ++i) {
      const float a = bfr(acc[i]);
      const int col = col_of(i, lane);
#pragma unroll
      for (int q = 0; q < 3; ++q) c[sel_of(i)][q] += a * wcr[q * H + col];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int q = 0; q < 3; ++q) rgb[s][q] = sigmoid(quad_sum(c[s][q]) + bias[p.bc_off + q]);
    }
    if constexpr (kMode == kAuxPass) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float y = rgb[s][q];
          st->gpc[s][q] = rw.valid[s] ? st->g_rgb[s][q] * y * (1.0f - y) : 0.0f;
        }
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float g0 = bfr(st->gpc[0][q]), g1 = bfr(st->gpc[1][q]);
        colsum_add<H>(st->run_wc[q], lane,
                      [&](int i) { return (sel_of(i) ? g1 : g0) * bfr(acc[i]); });
        st->run_bc[q] += st->gpc[0][q] + st->gpc[1][q];
      }
    }
  }
  if constexpr (kMode == kAuxPass) {
    if ((lane & 3) == 0) {  // the rows' head cotangents into the aux scratch
      const int warp = st->tid >> 5;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const bool c = p.n_head > 0;
        reinterpret_cast<float4*>(st->aux)[16 * warp + (lane >> 2) + 8 * s] =
            make_float4(st->gpd[s], c ? st->gpc[s][0] : 0.0f, c ? st->gpc[s][1] : 0.0f,
                        c ? st->gpc[s][2] : 0.0f);
      }
    }
  }
}

// ---------------------------------------------------------------- forward

template <int D, int H>
__global__ void __launch_bounds__(kMaxFwdGroups * 128, 1) mlp_fwd_kernel(
    const __grid_constant__ Plan p, const float* __restrict__ x,
    const float* __restrict__ head_dir, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ rgb_out,
    float* __restrict__ dens_out, long long num_rows, int num_samples) {
  extern __shared__ __align__(128) char smem[];
  load_params<H>(p, smem, w, b);
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const long long tiles = (num_rows + kRows - 1) / kRows;
  const long long stride = static_cast<long long>(gridDim.x) * p.warpgroups;
  char* xs = smem + p.x_off + wg * p.x_stride;
  long long t = static_cast<long long>(blockIdx.x) * p.warpgroups + wg;
  if (t < tiles) issue_x<D>(xs, x, t * kRows, num_rows, tid);
  for (; t < tiles; t += stride) {
    cp_async_wait_all();
    bar_sync(1 + wg, 128);
    uint32_t ax[D / 16][4];
    x_frags<D>(xs, warp, lane, ax);
    bar_sync(1 + wg, 128);
    if (t + stride < tiles) issue_x<D>(xs, x, (t + stride) * kRows, num_rows, tid);
    const Rows rw = tile_rows(t * kRows, warp, lane, num_rows, num_samples);
    float pre_d[2], rgb[2][3];
    forward_chain<D, H, kPlain>(p, smem, ax, head_dir, rw, lane, p.n_layers, pre_d, rgb,
                                nullptr, nullptr);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (!rw.valid[s]) continue;
        const float pd = pre_d[s];
        dens_out[rw.n[s]] = fmaxf(pd, 0.0f) + log1pf(expf(-fabsf(pd)));
        if (p.n_head > 0) {
#pragma unroll
          for (int q = 0; q < 3; ++q) rgb_out[rw.n[s] * 3 + q] = rgb[s][q];
        }
      }
    }
  }
}

// ---------------------------------------------------------------- backward

// This warpgroup's 64 rows of dW_k (N columns) into the block's workspace
// row, then zeroed for the next phase.
template <int N, int H>
__device__ __forceinline__ void write_dw(float* dw, float* dst, int wg, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int o = 64 * wg + 16 * warp + (lane >> 2) + 8 * sel_of(i);
    if (o < H) {
      *reinterpret_cast<float2*>(dst + o * N + col_of(i, lane)) = make_float2(dw[i], dw[i + 1]);
    }
    dw[i] = dw[i + 1] = 0.0f;
  }
}

// The warps' column sums ([8 warps][5H + 4] f32 of the block's slots)
// summed in warp order into the workspace row: the bias of hidden matrix
// kp (kp < 0: none), and with `first` the heads' gradients.
template <int H>
__device__ __forceinline__ void sum_partials(const Plan& p, const float* part, float* ws_row,
                                             int kp, bool first) {
  const int np = 5 * H + 4;
  for (int e = threadIdx.x; e < np; e += kBwdGroups * 128) {
    float s = 0.0f;
    for (int v = 0; v < 4 * kBwdGroups; ++v) s += __ldcg(part + v * np + e);
    int dst = -1;
    if (e < H) {
      dst = kp >= 0 && p.b_off[kp] >= 0 ? p.n_w + p.b_off[kp] + e : -1;
    } else if (first) {
      if (e < 2 * H) {
        dst = p.wd_off + e - H;
      } else if (e < 5 * H) {
        dst = p.n_head > 0 ? p.wc_off + e - 2 * H : -1;
      } else if (e == 5 * H) {
        dst = p.n_w + p.bd_off;
      } else {
        dst = p.n_head > 0 ? p.n_w + p.bc_off + e - 5 * H - 1 : -1;
      }
    }
    if (dst >= 0) ws_row[dst] = s;
  }
}

// Writes a lane's running column sums (colsum_add's columns) into a
// warp's slot of partial sums.
template <int H>
__device__ __forceinline__ void put_sums(float* slot, int lane, const float (&run)[H / 32]) {
#pragma unroll
  for (int q = 0; q < H / 32; ++q) slot[sum_col<H>(q, lane)] = run[q];
}

// dW[64 mb.., :] += (rows 64 mb.. of G^T) @ A over the pair's 128 staged
// rows: G [128, H] and A [128, N] bf16 in shared memory, both MN-major.
template <int N, int H>
__device__ __forceinline__ void dw_update(float* dw, uint32_t g, uint32_t a, int mb) {
  fence_regs<N / 2>(dw);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < 2 * kRows / 16; ++kc) {
    WgmmaSS<N>::run(dw, make_desc(g + mb * 1024 + kc * H * 32, H * 16, 128),
                    make_desc(a + kc * N * 32, N * 16, 128));
  }
  wgmma_commit();
  wgmma_wait();
  fence_regs<N / 2>(dw);
}

// Each warp's partial column sums in global memory (L2), after the aux
// scratch's tiles: [8 warps][5H + 4] f32 a block: the bias of a phase's
// matrix, then (aux pass) w_d, W_c, b_d and b_c; summed in warp order.
template <int H>
__device__ __forceinline__ float* block_parts(const Plan& p, float* aux, long long pairs) {
  return aux + 2 * pairs * p.aux_words +
         static_cast<long long>(blockIdx.x) * 4 * kBwdGroups * (5 * H + 4);
}

// The backward's first launch: the whole forward chain of every tile, its
// ReLU masks and head cotangents into the tile's block of `aux` (80
// bytes a row at the preset), and the heads' gradients (w_d, b_d, W_c,
// b_c) into the workspace row. No dW registers, so the chain runs
// without spills.
template <int D, int H>
__global__ void __launch_bounds__(kBwdGroups * 128, 1) mlp_aux_kernel(
    const __grid_constant__ Plan p, const float* __restrict__ x,
    const float* __restrict__ head_dir, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ g_rgb,
    const float* __restrict__ g_dens, float* __restrict__ ws, int ws_stride, float* aux,
    long long num_rows, int num_samples) {
  extern __shared__ __align__(128) char smem[];
  load_params<H>(p, smem, w, b);
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  const long long pairs = (num_rows + 2 * kRows - 1) / (2 * kRows), tiles = 2 * pairs;
  float* parts = block_parts<H>(p, aux, pairs);
  AuxState<H> st;
  st.tid = tid;
#pragma unroll
  for (int q = 0; q < H / 32; ++q) {
    st.run_wd[q] = st.run_wc[0][q] = st.run_wc[1][q] = st.run_wc[2][q] = 0.0f;
  }
  st.run_bd = st.run_bc[0] = st.run_bc[1] = st.run_bc[2] = 0.0f;
  char* xs = smem + p.x_off + wg * p.x_stride;
  const long long stride = 2 * static_cast<long long>(gridDim.x);
  long long t = 2 * static_cast<long long>(blockIdx.x) + wg;
  if (t < tiles) issue_x<D>(xs, x, t * kRows, num_rows, tid);
  for (; t < tiles; t += stride) {
    cp_async_wait_all();
    bar_sync(1 + wg, 128);
    uint32_t ax[D / 16][4];
    x_frags<D>(xs, warp, lane, ax);
    bar_sync(1 + wg, 128);
    if (t + stride < tiles) issue_x<D>(xs, x, (t + stride) * kRows, num_rows, tid);
    const Rows rw = tile_rows(t * kRows, warp, lane, num_rows, num_samples);
    st.aux = aux + t * p.aux_words;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      st.g_dens[s] = rw.valid[s] ? g_dens[rw.n[s]] : 0.0f;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        st.g_rgb[s][q] = p.n_head > 0 && rw.valid[s] ? g_rgb[rw.n[s] * 3 + q] : 0.0f;
      }
    }
    float pre_d[2], rgb[2][3];
    forward_chain<D, H, kAuxPass>(p, smem, ax, head_dir, rw, lane, p.n_layers, pre_d, rgb,
                                  &st, nullptr);
  }
  float* slot = parts + (4 * wg + warp) * (5 * H + 4);
  put_sums<H>(slot + H, lane, st.run_wd);
#pragma unroll
  for (int q = 0; q < 3; ++q) put_sums<H>(slot + (2 + q) * H, lane, st.run_wc[q]);
  const float sbd = row_sum(st.run_bd);  // the 4 lanes of a row hold the same sums
  float sbc[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) sbc[q] = row_sum(st.run_bc[q]);
  if (lane == 0) {
    slot[5 * H] = sbd;
#pragma unroll
    for (int q = 0; q < 3; ++q) slot[5 * H + 1 + q] = sbc[q];
  }
  __threadfence();  // the slots, before other warps read them
  __syncthreads();
  sum_partials<H>(p, parts, ws + static_cast<long long>(blockIdx.x) * ws_stride, -1, true);
}

// The backward's second launch: one phase per hidden matrix W_kp, top
// first, each over all of the block's tile pairs. Per tile it recomputes
// the layers below W_kp (a_kp staged), takes the masks and head
// cotangents from the tile's aux block (copied into shared memory by
// cp.async while the tile before it runs), runs the cotangents down to
// gz_{kp+1} (staged), and each warpgroup adds its 64 rows of dW_kp.
template <int D, int H>
__global__ void __launch_bounds__(kBwdGroups * 128, 1) mlp_bwd_kernel(
    const __grid_constant__ Plan p, const float* __restrict__ x,
    const float* __restrict__ head_dir, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ dx, float* dhd,
    float* __restrict__ ws, int ws_stride, float* aux, long long num_rows,
    int num_samples) {
  extern __shared__ __align__(128) char smem[];
  constexpr int kMW = (H / 2 + 31) / 32;
  constexpr int kDW = (D > H ? D : H) / 2;
  load_params<H>(p, smem, w, b);
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31;
  float* ws_row = ws + static_cast<long long>(blockIdx.x) * ws_stride;
  const long long pairs = (num_rows + 2 * kRows - 1) / (2 * kRows);
  // This warpgroup's 64 rows (m-block wg) of dW_kp, for a whole phase.
  const bool owns = 64 * wg < H;  // at hidden 32 one m-block covers dW
  float dw[kDW];
#pragma unroll
  for (int i = 0; i < kDW; ++i) dw[i] = 0.0f;
  const float* wdr = reinterpret_cast<const float*>(smem + p.small_off) + p.n_b;
  const float* wcr = wdr + H;
  char* gs = smem + p.g_off;
  char* as = smem + p.a_off;
  char* xs = smem + p.x_off + wg * p.x_stride;
  char* aux_stage = smem + p.aux_off + wg * ((p.aux_words * 4 + 127) / 128 * 128);
  const float* aux_in = reinterpret_cast<const float*>(aux_stage);
  const int n_layers = p.n_layers, nb = p.n_base;
  const bool head = p.n_head > 0;
  float* parts = block_parts<H>(p, aux, pairs);
  float* slot = parts + (4 * wg + warp) * (5 * H + 4);
  float run_b[H / 32] = {};  // running column sums of the bias gradient
  Staging stg{as, 0, 64 * wg + 16 * warp, false};

  // The x copy of the next (phase, pair) is issued while this one runs
  // (or, without room for it, after the dW update); its aux block after
  // this tile's cotangents.
  int phase = 0;
  long long tp = blockIdx.x;
  issue_x<D>(xs, x, tp * 2 * kRows + kRows * wg, num_rows, tid);
  const auto issue_aux = [&](long long pair) {
    const float* src = aux + (pair * 2 + wg) * p.aux_words;
    for (int e = tid; e < p.aux_words / 4; e += 128) {
      cp_async16(smem_u32(aux_stage) + 16 * e, src + 4 * e, 16);
    }
    cp_async_commit();
  };
  issue_aux(tp);
  for (;;) {
    const int kp = n_layers - 1 - phase;
    stg.stage_k = kp;
    const long long row_base = tp * 2 * kRows + kRows * wg;
    cp_async_wait_all();
    bar_sync(1 + wg, 128);
    uint32_t ax[D / 16][4];
    x_frags<D>(xs, warp, lane, ax);
    bar_sync(1 + wg, 128);
    long long ntp = tp + gridDim.x;
    int nphase = phase;
    if (ntp >= pairs) {
      ntp = blockIdx.x;
      ++nphase;
    }
    const bool more = nphase < n_layers;
    if (p.prefetch && more) issue_x<D>(xs, x, ntp * 2 * kRows + kRows * wg, num_rows, tid);
    if (kp == 0) {
      stg.free_staging();
      stage_frags<D>(as, stg.row0, lane, ax);
    }
    const Rows rw = tile_rows(row_base, warp, lane, num_rows, num_samples);
    float pre_d[2], rgb[2][3];
    forward_chain<D, H, kPhase>(p, smem, ax, head_dir, rw, lane, kp, pre_d, rgb, nullptr,
                                &stg);

    // The cotangent chain from the heads down to gz_{kp+1}.
    float gd[2], gc[2][3];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float4 v = reinterpret_cast<const float4*>(aux_in)[16 * warp + (lane >> 2) + 8 * s];
      gd[s] = bfr(v.x);
      gc[s][0] = bfr(v.y);
      gc[s][1] = bfr(v.z);
      gc[s][2] = bfr(v.w);
    }
    float ga[H / 2];
    uint32_t gf[H / 16][4];
    if (head) {
#pragma unroll
      for (int i = 0; i < H / 2; ++i) {
        const int s = sel_of(i), col = col_of(i, lane);
        ga[i] = gc[s][0] * wcr[col] + gc[s][1] * wcr[H + col] + gc[s][2] * wcr[2 * H + col];
      }
    } else {
#pragma unroll
      for (int i = 0; i < H / 2; ++i) ga[i] = gd[sel_of(i)] * wdr[col_of(i, lane)];
    }
    for (int l = n_layers;; --l) {  // ga: the cotangent of a_l
      if (head && l == nb) {
#pragma unroll
        for (int i = 0; i < H / 2; ++i) ga[i] += gd[sel_of(i)] * wdr[col_of(i, lane)];
      }
      uint32_t mask[kMW];
#pragma unroll
      for (int wd = 0; wd < kMW; ++wd) {
        mask[wd] = __float_as_uint(aux_in[kRows * 4 + ((l - 1) * kMW + wd) * 128 + tid]);
      }
#pragma unroll
      for (int i = 0; i < H / 2; ++i) {
        if (!((mask[i >> 5] >> (i & 31)) & 1u)) ga[i] = 0.0f;
      }
      to_frags<H>(ga, gf);
      if (l == kp + 1) break;
      layer_bwd<H, H>(ga, gf, smem_u32(smem + p.s_off[l - 1]));
    }
    // ga = gz_{kp+1} in f32, gf its bf16 fragments.
    stage_frags<H>(gs, stg.row0, lane, gf);
    if (p.b_off[kp] >= 0) colsum_add<H>(run_b, lane, [&](int i) { return ga[i]; });
    if (head && kp == nb) {  // dhead_dir: per-ray sums of gz_{nb+1}
      const long long first = row_base + 16 * warp, last = first + 15;
      if (last < num_rows && first / num_samples == last / num_samples) {
        float sums[H / 32] = {};
        colsum_add<H>(sums, lane, [&](int i) { return ga[i]; });
        float* dst = dhd + (first / num_samples) * H;
#pragma unroll
        for (int q = 0; q < H / 32; ++q) atomicAdd(dst + sum_col<H>(q, lane), sums[q]);
      } else {
#pragma unroll
        for (int i = 0; i < H / 2; ++i) {
          const int s = sel_of(i);
          if (rw.valid[s]) {
            atomicAdd(dhd + static_cast<long long>(rw.ray[s]) * H + col_of(i, lane), ga[i]);
          }
        }
      }
    }
    if (kp == 0) {  // dx = gz_1 @ W_0
      float dxa[D / 2];
      layer_bwd<D, H>(dxa, gf, smem_u32(smem + p.s_off[0]));
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int s = sel_of(i);
        if (rw.valid[s]) {
          *reinterpret_cast<float2*>(dx + rw.n[s] * D + col_of(i, lane)) =
              make_float2(dxa[i], dxa[i + 1]);
        }
      }
    }
    // The pair's gz_{kp+1} and a_kp are staged: each warpgroup adds its
    // 64 rows of dW_kp += gz^T a_kp, then goes on to the next tile and
    // waits for the other only before it writes the staging again.
    fence_async_smem();
    bar_sync(kPairBarrier, kBwdGroups * 128);
    if (owns) {
      if (kp == 0) {
        dw_update<D, H>(dw, smem_u32(gs), smem_u32(as), wg);
      } else {
        dw_update<H, H>(dw, smem_u32(gs), smem_u32(as), wg);
      }
    }
    stg.pending = true;
    if (more) issue_aux(ntp);

    if (nphase != phase) {  // the phase's gradients into the workspace row
      stg.free_staging();
      if (owns) {
        if (kp == 0) {
          write_dw<D, H>(dw, ws_row + p.w_off[kp], wg, warp, lane);
        } else {
          write_dw<H, H>(dw, ws_row + p.w_off[kp], wg, warp, lane);
        }
      }
      put_sums<H>(slot, lane, run_b);
#pragma unroll
      for (int q = 0; q < H / 32; ++q) run_b[q] = 0.0f;
      __threadfence();  // the slots, before other warps read them
      bar_sync(kPairBarrier, kBwdGroups * 128);
      sum_partials<H>(p, parts, ws_row, kp, false);
      bar_sync(kPairBarrier, kBwdGroups * 128);
    }
    if (!p.prefetch && more) {  // x shares the staging: after the dW update
      stg.free_staging();
      issue_x<D>(xs, x, ntp * 2 * kRows + kRows * wg, num_rows, tid);
    }
    if (!more) break;
    phase = nphase;
    tp = ntp;
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

template <int D, int H>
cudaError_t launch_forward(const Plan& plan, const float* x, const float* head_dir,
                           const float* w, const float* b, float* rgb, float* dens,
                           long long num_rows, int num_samples, int num_blocks,
                           cudaStream_t stream) {
  const auto kernel = mlp_fwd_kernel<D, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
  if (err != cudaSuccess) return err;
  const long long tiles = (num_rows + kRows - 1) / kRows;
  const long long groups = (tiles + plan.warpgroups - 1) / plan.warpgroups;
  const int grid = static_cast<int>(std::min<long long>(num_blocks, groups));
  kernel<<<grid, plan.warpgroups * 128, plan.smem_bytes, stream>>>(
      plan, x, head_dir, w, b, rgb, dens, num_rows, num_samples);
  return cudaGetLastError();
}

template <int D, int H>
cudaError_t launch_backward(const Plan& plan, const float* x, const float* head_dir,
                            const float* w, const float* b, const float* g_rgb,
                            const float* g_dens, float* dx, float* dhd, float* ws,
                            int ws_stride, float* aux, long long num_rows,
                            int num_samples, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_aux_kernel<D, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
  if (err != cudaSuccess) return err;
  mlp_aux_kernel<D, H><<<grid, kBwdGroups * 128, plan.smem_bytes, stream>>>(
      plan, x, head_dir, w, b, g_rgb, g_dens, ws, ws_stride, aux, num_rows, num_samples);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_bwd_kernel<D, H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem_bytes);
  if (err != cudaSuccess) return err;
  mlp_bwd_kernel<D, H><<<grid, kBwdGroups * 128, plan.smem_bytes, stream>>>(
      plan, x, head_dir, w, b, dx, dhd, ws, ws_stride, aux, num_rows, num_samples);
  return cudaGetLastError();
}

}  // namespace

// Forward (K4 with n_head >= 1, K5 with n_head == 0). w, b: the packed
// weights ([out, in] each) and biases in ops/mlp.py's order. rgb and
// head_dir are unused when n_head == 0. warpgroups and smem_bytes come
// from the host's launch plan and must match this file's.
extern "C" int tetranerf_fused_mlp_forward(
    const float* x, const float* head_dir, const float* w, const float* b,
    float* rgb, float* dens, int num_rays, int num_samples, int d_in,
    int hidden, int n_base, int n_head, int num_blocks, int warpgroups,
    int smem_bytes, cudaStream_t stream) {
  Plan plan;
  if (!make_plan(d_in, hidden, n_base, n_head, false, warpgroups, 1, &plan) ||
      plan.smem_bytes != smem_bytes || num_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long num_rows = static_cast<long long>(num_rays) * num_samples;
  if (num_rows == 0) return 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (d_in == 16 && hidden == 32) {
    err = launch_forward<16, 32>(plan, x, head_dir, w, b, rgb, dens, num_rows,
                                 num_samples, num_blocks, stream);
  } else if (d_in == 64 && hidden == 128) {
    err = launch_forward<64, 128>(plan, x, head_dir, w, b, rgb, dens, num_rows,
                                  num_samples, num_blocks, stream);
  }
  return static_cast<int>(err);
}

// Backward (K4b, K5b). dhd must be zeroed by the caller; ws is
// [num_blocks, ws_stride] and needs no zeroing (each launched block writes
// its row once); grads gets the packed weight gradients (n_w floats)
// followed by the bias gradients (n_b floats); aux is scratch of
// 2 * ceil(rows / 128) tiles of the plan's aux_words floats, then
// num_blocks * 8 * (5 * hidden + 4) floats of column sums.
extern "C" int tetranerf_fused_mlp_backward(
    const float* x, const float* head_dir, const float* w, const float* b,
    const float* g_rgb, const float* g_dens, float* dx, float* dhd, float* ws,
    float* grads, float* aux, int num_rays, int num_samples, int d_in, int hidden,
    int n_base, int n_head, int num_blocks, int ws_stride, int prefetch,
    int smem_bytes, cudaStream_t stream) {
  Plan plan;
  if (!make_plan(d_in, hidden, n_base, n_head, true, kBwdGroups, prefetch, &plan) ||
      plan.smem_bytes != smem_bytes || num_blocks < 1 ||
      ws_stride < plan.n_w + plan.n_b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long num_rows = static_cast<long long>(num_rays) * num_samples;
  const long long pairs = (num_rows + 2 * kRows - 1) / (2 * kRows);
  const int grid = static_cast<int>(std::min<long long>(num_blocks, pairs));
  if (grid > 0) {
    cudaError_t err = cudaErrorInvalidValue;
    if (d_in == 16 && hidden == 32) {
      err = launch_backward<16, 32>(plan, x, head_dir, w, b, g_rgb, g_dens, dx, dhd,
                                    ws, ws_stride, aux, num_rows, num_samples, grid,
                                    stream);
    } else if (d_in == 64 && hidden == 128) {
      err = launch_backward<64, 128>(plan, x, head_dir, w, b, g_rgb, g_dens, dx, dhd,
                                     ws, ws_stride, aux, num_rows, num_samples, grid,
                                     stream);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n = plan.n_w + plan.n_b;
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, stream>>>(ws, grid, ws_stride, n, grads);
  return static_cast<int>(cudaGetLastError());
}
