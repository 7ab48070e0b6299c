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
// Three routes, chosen on the host by ops/mlp.py `launch_plan` from the
// stack's shape and dtype: the wgmma instances below (bfloat16 at widths
// (d_in, hidden) = (16, 32) and (64, 128), where their shared memory holds
// the stack), the generic route after them (float32, and bfloat16 at any
// other width up to 256 or any depth up to 8), and the layered route at the
// end of this file (any wider or deeper stack: one product kernel a layer).
// The rest of this comment describes the wgmma route.
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

// The packed weights' layout (ops/mlp.py `_pack`), into a plan of either
// route: base (W, b) pairs, density (w_d, b_d), then W_bh, the other head
// (W, b) pairs, colour (W_c, b_c); matrices first, then biases. Needs
// d_in, hidden, n_base, n_head and n_layers set.
template <class P>
void pack_layout(P* p) {
  const int hidden = p->hidden, n_base = p->n_base;
  int w = 0, b = 0;
  for (int k = 0; k < p->n_layers; ++k) {
    if (k == n_base) {
      p->wd_off = w;
      w += hidden;
      p->bd_off = b;
      b += 1;
    }
    p->in_dim[k] = k == 0 ? p->d_in : hidden;
    p->w_off[k] = w;
    w += hidden * p->in_dim[k];
    p->b_off[k] = k == n_base ? -1 : b;
    if (k != n_base) b += hidden;
  }
  if (p->n_head == 0) {
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
}

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
  pack_layout(p);
  const int b = p->n_b;
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

// ---------------------------------------------------------------- the generic route
//
// K4, K4b, K5 and K5b for every stack the wgmma instances above do not take:
// compute_dtype float32 (JAX's Precision.HIGHEST), or bfloat16 at widths
// other than (16, 32) and (64, 128), or a stack too deep for their shared
// memory. Widths 1 <= d_in, hidden <= 256 and depths up to kMaxLayers are
// runtime values. ops/mlp.py `launch_plan` picks the route by shape.
//
// Precision. bfloat16: every product on mma.sync m16n8k16 with bf16
// operands and f32 accumulators, the wgmma route's function up to the order
// of the sums. float32: products on the tensor cores as 3xTF32 (mma.sync
// m16n8k8): each operand x splits into hi = tf32(x) and lo = tf32(x - hi),
// and a k8 step sums lo*hi + hi*lo + hi*hi, which is then added to the f32
// accumulator (the tensor cores' truncating sums stay 8 products long; over
// a whole K they put a layer ~1e-5 off); the dropped lo*lo is below 2^-22
// of a product. Plain TF32 (a 10-bit mantissa) would be ~5e-4 off. The
// exception is the backward's forward chain in float32, which runs as f32
// FMAs in a plain GEMM's order (fma_pass): its pre-activations are then the
// f32 twin's bit for bit, and so are the ReLU masks that gate the
// cotangents (a mask flipped at a pre-activation within rounding of 0
// moves a row's cotangent by a whole term; in the forward it moves an
// output by no more than that pre-activation). Activations, x and
// cotangents are stored as operands (rounded to bf16 in bfloat16); biases,
// head_dir and the bias and head_dir gradients stay f32 sums of unrounded
// values.
//
// What bounds it on the H100: the products. At the preset's widths the
// train slice's forward is 121.8 GFLOP; in bfloat16 the tensor cores' 989
// TFLOP/s make that 0.12 ms (mma.sync reaches part of that rate: only
// wgmma reaches all of it), in float32 three TF32 products for each f32
// one make it 165 TFLOP/s effective, 0.74 ms. The backward needs three
// times the products, and in float32 its forward chain runs on the f32 FMA
// units (67 TFLOP/s).
//
// Design. Rows (samples) are flattened; a block of `warps` warps takes
// `rows` = 16 warps rows at a time (persistent, tiles in block order), each
// warp 16 rows: one m16 tile of every product. Activations live in shared
// memory row-major as operands ([rows][width + pad]; the 16-byte pad puts
// ldmatrix's 8 row addresses in distinct banks). A layer is, per warp,
// C[16][N] = A[16][K] B[K][N] in passes of kCols output columns (8 n8
// tiles of f32 accumulators in registers), A by ldmatrix from the
// activation, B by ldmatrix from the weight matrix in shared memory; the
// epilogue adds the bias (head_dir for W_bh), applies ReLU and stores the
// next activation. The block stages the packed f32 weights (ops/mlp.py
// `_pack`) into shared memory as operands in that layout: each matrix
// [hp][kp + pad], and the heads' [16][hp + pad] (row 0 w_d, rows 1-3 W_c).
// Where the stack fits beside the tiles it stays resident for the launch,
// staged once per block, and the forward's warps then share it with no
// block barrier at all; otherwise each pass's slab of kCols columns is
// staged (16-byte cp.async where the rows allow) between two block
// barriers (the plan's `resident`). The density (1 output) and colour (3)
// heads are one product each with the 16-row head matrix, on every warp.
//
// The backward sums each block's weight gradients in shared memory over
// all of its tiles and writes them into the block's workspace row once;
// sum_rows_kernel adds the rows in block order, so the weight gradients
// are the same bits in every launch. Per tile it runs the forward again
// (every layer's ReLU mask kept as bits), the heads' cotangents, then goes
// down the layers: at each, one block barrier; per warp the cotangent one
// layer down (gz W, with ldmatrix.trans on W), masked, its column sums
// kept (the bias gradients, added in warp order), stored rounded. The
// heads' weight gradients are one product each over the tile's rows.
// dhead_dir takes W_bh's cotangent per ray with atomics (one per column
// where a warp's 16 rows share a ray). Where every matrix's dW and input
// image fit shared memory beside eight warps' tiles (bf16 at field 32,
// hidden 64), that pass also adds each matrix's dW += gz^T a (A = the
// cotangent image, B = the input image, both by ldmatrix.trans; units of
// 16 rows spread over the warps, each element added by one lane): one
// kernel, nothing leaves the chip but dx, dhead_dir and the row. Otherwise
// (float32 at the preset's widths: its dW alone is 231 KB) the work is
// cached in global memory, each value written once and read back once or
// twice: the forward kernel at the forward's warps (fwd_kernel<.., true>)
// runs the chain first and writes a_1 .. a_L, the ReLU bits and the heads'
// cotangents; the backward's pass over the layers starts from them and
// writes each matrix's cotangent (its float32 slabs of g W from a
// transposed copy of the weights); phases after it (each holding a set of
// dW chunks, row ranges of the matrices, top first) read a matrix's
// cotangents and inputs back tile by tile for the same dW products. Every
// dW element is still summed over the block's tiles in shared memory and
// written once; nothing is recomputed.

namespace gen {

constexpr int kMaxWarps = 16;    // warps of a forward block, at most
constexpr int kCacheWarps = 12;  // of the cached backward's forward (170 registers a thread)
constexpr int kMaxBwdWarps = 8;  // of a backward block
constexpr int kCols = 64;        // output columns of a pass, and of a streamed slab
constexpr int kMaxWidth = 256;
constexpr int kMaxChunks = 64;  // the backward's weight-gradient chunks

// A dW chunk's row stride in floats for `in` columns: 8 past a multiple of
// 32, so that a warp's float2 adds (8 rows by 4 column pairs) take two
// wavefronts, with no bank conflict.
__host__ __device__ __forceinline__ int dw_stride(int in) { return (in + 31) / 32 * 32 + 8; }

struct GPlan {
  int d_in, hidden, n_base, n_head, n_layers, n_w, n_b;
  int in_dim[kMaxLayers], w_off[kMaxLayers], b_off[kMaxLayers];
  int wd_off, bd_off, wc_off, bc_off;
  int esz, pad;    // operand bytes; a row's pad in elements (16 bytes)
  int hp, dp, wp;  // hidden and d_in padded to 16, their max
  int kp[kMaxLayers];                    // matrix k's input width, padded
  int pw_off[kMaxLayers + 1], pw_bytes;  // the staged stack in shared memory, bytes
  int resident, warps, rows;
  int slab_bytes, heads_off;  // resident: the pack at 0; else a slab at 0, the heads after
  int pp_off;                 // two activation images [rows][wp + pad]
  // Backward: ReLU bits, the heads' cotangents [rows][4] and as operands
  // [rows][16 + pad] (cols 0-3), per-warp column sums [2][warps][hp] and of
  // the heads' cotangents [warps][4], bias and head-weight gradients, then
  // (one pass) the matrices' input images and dW.
  int bits_off, rows_off, hcot_off, part_off, hpart_off, bias_off, headg_off, phase_off;
  // The dW chunks (matrix chunk_k, its rows [chunk_m0, chunk_m1); matrix
  // n_layers: the density head's w_d) of phase ph: [phase_first[ph],
  // phase_first[ph + 1]). Phase 0 is the pass over the layers; with more
  // phases it holds no chunk and the later ones read the cache.
  int n_chunks, chunk_k[kMaxChunks], chunk_m0[kMaxChunks], chunk_m1[kMaxChunks];
  int n_phases, phase_first[kMaxChunks + 2];
  // Words of the cache for 16 rows (0 with one phase): planes of hp
  // operands a row for a_1 .. a_{L-1} and gz_1 .. gz_L, then with a head
  // the density head's cotangent.
  int cache_words;
  int smem_bytes;
};

// The backward's pass over the layers at `warps` warps, the weights
// resident or streamed: its shared memory up to the dW (returned).
int bwd_fixed(GPlan* p, int warps, bool resident) {
  const int R = 16 * warps, L = p->n_layers, es = p->esz, pad = p->pad;
  const int heads = p->pw_bytes - p->pw_off[L];
  int off = resident ? p->pw_bytes : p->slab_bytes + heads;
  p->resident = resident;
  p->warps = warps;
  p->rows = R;
  p->heads_off = resident ? p->pw_off[L] : p->slab_bytes;
  p->pp_off = off;
  off += 2 * R * (p->wp + pad) * es;
  p->bits_off = off;
  off += L * R * p->hp / 8;
  p->rows_off = off;
  off += R * 16;
  p->hcot_off = off;
  off += R * (16 + pad) * es;
  p->part_off = off;
  off += 2 * warps * p->hp * 4;
  p->hpart_off = off;
  off += warps * 16;
  p->bias_off = off;
  off += align_up(p->n_b, 4) * 4;
  p->headg_off = off;
  off += 4 * p->hp * 4;
  p->phase_off = off;
  return off;
}

// The dW chunks from phase n_phases on, matrix by matrix from the top
// (with `wd` first w_d, as matrix L: its input is a_nb), as many to a
// phase as shared memory holds beside `base` bytes and (with `save`) the
// input image of each of the phase's matrices; false where not even one
// chunk fits. Raises smem_bytes to the largest phase.
bool pack_chunks(GPlan* p, int base, bool save, bool wd) {
  const int L = p->n_layers;
  int used = base;
  unsigned in_phase = 0;
  p->phase_first[p->n_phases] = p->n_chunks;
  for (int k = wd ? L : L - 1; k >= 0; --k) {
    const int in = k == L ? p->hidden : p->in_dim[k], rows = k == L ? 1 : p->hidden;
    const int img = save ? p->rows * (p->kp[k] + p->pad) * p->esz : 0;
    const int group = 16 * dw_stride(in) * 4;
    for (int m = 0; m < rows;) {
      const int need = (in_phase >> k) & 1 ? 0 : img;
      const int room = kMaxSmem - used - need;
      const int groups = room >= group ? room / group : 0;
      if (groups == 0) {
        if (in_phase == 0) return false;
        p->phase_first[++p->n_phases] = p->n_chunks;
        used = base;
        in_phase = 0;
        continue;
      }
      if (p->n_chunks == kMaxChunks) return false;
      const int m1 = std::min(rows, m + 16 * groups);
      p->chunk_k[p->n_chunks] = k;
      p->chunk_m0[p->n_chunks] = m;
      p->chunk_m1[p->n_chunks] = m1;
      ++p->n_chunks;
      used += need + (m1 - m + 15) / 16 * group;
      p->smem_bytes = std::max(p->smem_bytes, used);
      in_phase |= 1u << k;
      m = m1;
    }
  }
  p->phase_first[++p->n_phases] = p->n_chunks;
  return true;
}

// The host's `launch_plan` for the generic route computes the same numbers.
bool make_gplan(int d_in, int hidden, int n_base, int n_head, bool bf16, bool backward,
                GPlan* p) {
  const int n_layers = n_base + n_head;
  if (d_in < 1 || d_in > kMaxWidth || hidden < 1 || hidden > kMaxWidth || n_base < 1 ||
      n_head < 0 || n_layers > kMaxLayers) {
    return false;
  }
  *p = GPlan{};
  p->d_in = d_in;
  p->hidden = hidden;
  p->n_base = n_base;
  p->n_head = n_head;
  p->n_layers = n_layers;
  pack_layout(p);
  p->esz = bf16 ? 2 : 4;
  p->pad = 16 / p->esz;
  const int es = p->esz, pad = p->pad;
  p->hp = align_up(hidden, 16);
  p->dp = align_up(d_in, 16);
  p->wp = std::max(p->hp, p->dp);
  int off = 0, slab = 0;
  for (int k = 0; k < n_layers; ++k) {
    p->kp[k] = k == 0 ? p->dp : p->hp;
    p->pw_off[k] = off;
    off += p->hp * (p->kp[k] + pad) * es;
    slab = std::max(slab, std::min(kCols, p->hp) * (p->kp[k] + pad) * es);
  }
  if (backward) slab = std::max(slab, p->hp * (kCols + pad) * es);
  if (backward && !bf16) slab = std::max(slab, kCols * (p->hp + pad) * es);
  p->pw_off[n_layers] = off;
  const int heads = 16 * (p->hp + pad) * es;
  p->pw_bytes = off + heads;
  p->slab_bytes = slab;
  if (!backward) {
    const int img = 16 * (p->wp + pad) * es;  // a warp's rows of one image
    p->resident = p->pw_bytes + 4 * 2 * img <= kMaxSmem;
    const int w = p->resident ? p->pw_bytes : slab + heads;
    p->warps = std::min(kMaxWarps, (kMaxSmem - w) / (2 * img));
    if (p->warps < 1) return false;
    p->rows = 16 * p->warps;
    p->heads_off = p->resident ? p->pw_off[n_layers] : slab;
    p->pp_off = w;
    p->smem_bytes = w + 2 * p->warps * img;
    return true;
  }
  // One pass where every dW fits beside eight warps' tiles, the weights
  // resident if they fit too.
  for (int resident = 1; resident >= 0; --resident) {
    GPlan q = *p;
    q.smem_bytes = bwd_fixed(&q, kMaxBwdWarps, resident);
    if (pack_chunks(&q, q.smem_bytes, true, false) && q.n_phases == 1) {
      *p = q;
      return true;
    }
  }
  // Else the pass over the layers at the most warps that fit, then the dW
  // phases beside two images of the tile's rows (a cotangent and an input).
  for (int warps = kMaxBwdWarps; warps >= 1; warps /= 2) {
    for (int resident = 1; resident >= 0; --resident) {
      GPlan q = *p;
      q.smem_bytes = bwd_fixed(&q, warps, resident);
      q.n_phases = 1;
      // Two images of the tile's rows, transposed: a cotangent and an input.
      const int images = (q.hp + q.wp) * (q.rows + pad) * es;
      if (q.smem_bytes <= kMaxSmem && pack_chunks(&q, images, false, n_head > 0)) {
        // Per 16 rows: the planes, the density head's cotangents and a_L as
        // operands, the ReLU bits, the heads' cotangents.
        q.cache_words = 4 * es * (2 * n_layers * q.hp + 1) + n_layers * q.hp / 2 + 64;
        *p = q;
        return true;
      }
    }
  }
  return false;
}

// An image in shared memory: element (r, c) at p + (r * st + c) * esz.
struct Img {
  char* p;
  int st;
};

__device__ __forceinline__ void ldsm4(uint32_t a, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ void ldsm4t(uint32_t a, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}
__device__ __forceinline__ float lds(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// x = hi + lo + (below 2^-22 |x|), hi and lo TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// One k16 step of mma_pass in bf16: every fragment of the step is loaded
// before its products, so that the loads overlap and the products issue
// back to back; kFull (nt == 8) drops the per-tile predicates.
template <bool kAT, bool kBK, bool kFull>
__device__ __forceinline__ void mma_step_bf16(uint32_t al, uint32_t bl, int sa, int sb, int k0,
                                              int nt, float (&acc)[8][4]) {
  uint32_t af[4], bf[4][4];
  if (kAT) {
    ldsm4t(al + k0 * sa * 2, af);
  } else {
    ldsm4(al + k0 * 2, af);
  }
  const uint32_t bk = kBK ? bl + k0 * sb * 2 : bl + k0 * 2;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    if (kFull || 2 * jp < nt) {
      if (kBK) {
        ldsm4t(bk + jp * 32, bf[jp]);
      } else {
        ldsm4(bk + jp * 16 * sb * 2, bf[jp]);
      }
    }
  }
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    if (kFull || 2 * jp < nt) {
      mma_bf16(acc[2 * jp], af, bf[jp][0], bf[jp][1]);
      mma_bf16(acc[2 * jp + 1], af, bf[jp][2], bf[jp][3]);
    }
  }
}

// acc[j] (n8 tiles j < nt, nt even, at most 8) += A[16][kdim] B[kdim][8 nt]
// for the warp, kdim a multiple of 16. `a` and `b` are the shared-memory
// addresses of A's and B's element (0, 0), `sa` and `sb` row strides in
// elements. kAT: A[m][k] = a[k][m] (else a[m][k]); kBK: B[k][n] = b[k][n]
// (else b[n][k]). Row-major sources load by ldmatrix, transposed bf16 ones
// by ldmatrix.trans, transposed f32 ones element by element.
template <bool kBf16, bool kAT, bool kBK>
__device__ __forceinline__ void mma_pass(uint32_t a, int sa, uint32_t b, int sb, int kdim,
                                         int nt, float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31;
  if constexpr (kBf16) {
    const uint32_t al = kAT ? a + (((lane & 7) + (lane >> 4) * 8) * sa + ((lane >> 3) & 1) * 8) * 2
                            : a + ((lane & 15) * sa + (lane >> 4) * 8) * 2;
    const uint32_t bl = kBK ? b + (((lane & 7) + ((lane >> 3) & 1) * 8) * sb + (lane >> 4) * 8) * 2
                            : b + (((lane & 7) + (lane >> 4) * 8) * sb + ((lane >> 3) & 1) * 8) * 2;
    if (nt == 8) {
      for (int k0 = 0; k0 < kdim; k0 += 16) {
        mma_step_bf16<kAT, kBK, true>(al, bl, sa, sb, k0, nt, acc);
      }
    } else {
      for (int k0 = 0; k0 < kdim; k0 += 16) {
        mma_step_bf16<kAT, kBK, false>(al, bl, sa, sb, k0, nt, acc);
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const uint32_t al = a + ((lane & 15) * sa + (lane >> 4) * 4) * 4;
    const uint32_t bl = b + (((lane & 7) + (lane >> 4) * 8) * sb + ((lane >> 3) & 1) * 4) * 4;
    for (int k0 = 0; k0 < kdim; k0 += 8) {
      uint32_t ah[4], alo[4];
      {
        float av[4];
        if (kAT) {
          const uint32_t r0 = a + ((k0 + t) * sa + g) * 4, r1 = r0 + 4 * sa * 4;
          av[0] = lds(r0);
          av[1] = lds(r0 + 32);
          av[2] = lds(r1);
          av[3] = lds(r1 + 32);
        } else {
          uint32_t r[4];
          ldsm4(al + k0 * 4, r);
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = __uint_as_float(r[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(av[i], ah[i], alo[i]);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        if (2 * jp < nt) {
          float bv[4];  // b0, b1 of tile 2 jp, then of tile 2 jp + 1
          if (kBK) {
            const uint32_t r0 = b + ((k0 + t) * sb + 16 * jp + g) * 4, r1 = r0 + 4 * sb * 4;
            bv[0] = lds(r0);
            bv[1] = lds(r1);
            bv[2] = lds(r0 + 32);
            bv[3] = lds(r1 + 32);
          } else {
            uint32_t r[4];
            ldsm4(bl + (16 * jp * sb + k0) * 4, r);
#pragma unroll
            for (int i = 0; i < 4; ++i) bv[i] = __uint_as_float(r[i]);
          }
          uint32_t bh[4], blo[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split_tf32(bv[i], bh[i], blo[i]);
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            // The three products of this k8 step on the tensor cores, then
            // one f32 add a sum: their truncating accumulation stays short.
            float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_tf32(c, alo, bh[2 * q], bh[2 * q + 1]);
            mma_tf32(c, ah, blo[2 * q], blo[2 * q + 1]);
            mma_tf32(c, ah, bh[2 * q], bh[2 * q + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[2 * jp + q][e] += c[e];
          }
        }
      }
    }
  }
}

// The backward's float32 forward layers for the warp's 16 rows: acc[i][j]
// = sum over k of A[rh + 2i][k] W[c + 16j][k] (lane = 16 rh + c; j < nc /
// 16), as f32 FMAs in the order k = 0, 1, ...: the order of a plain f32
// GEMM's inner loop, so that the pre-activations are the f32 twin's bit for
// bit and the ReLU masks with them. (Summed in another order, 3xTF32 on
// the tensor cores is as close to the exact sum as the twin, but across
// the ~5e8 pre-activations of a train step a few lie close enough to 0 to
// change side, and a flipped mask moves a row's cotangent by a whole
// term.) A lane's 8 rows and 4 columns take 12 float4 loads a 4-deep k step
// for 128 FMAs; A (the image, a[r][k]) and W (b[n][k]) are row-major
// with strides in floats.
__device__ __forceinline__ void fma_pass(const float* a, int sa, const float* w, int sw,
                                         int kdim, int nc, float (&acc)[8][4]) {
  const int lane = threadIdx.x & 31, rh = lane >> 4, c = lane & 15;
  const float* ar = a + rh * sa;
  const float* wr = w + c * sw;
#pragma unroll 2
  for (int k = 0; k < kdim; k += 4) {
    float4 x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = *reinterpret_cast<const float4*>(ar + 2 * i * sa + k);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (16 * j >= nc) continue;
      const float4 v = *reinterpret_cast<const float4*>(wr + 16 * j * sw + k);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float& q = acc[i][j];
        q = fmaf(x[i].x, v.x, q);
        q = fmaf(x[i].y, v.y, q);
        q = fmaf(x[i].z, v.z, q);
        q = fmaf(x[i].w, v.w, q);
      }
    }
  }
}

// row / num_samples, in 32 bits where the row fits them.
__device__ __forceinline__ long long ray_of(long long row, int num_samples) {
  return row < 0x7fffffff ? static_cast<long long>(static_cast<unsigned>(row) /
                                                   static_cast<unsigned>(num_samples))
                          : row / num_samples;
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  }
}

// v rounded to the operand type.
template <bool kBf16>
__device__ __forceinline__ float op(float v) {
  return kBf16 ? bfr(v) : v;
}
template <bool kBf16>
__device__ __forceinline__ float ld_op(const char* p) {
  if constexpr (kBf16) {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  } else {
    return *reinterpret_cast<const float*>(p);
  }
}
template <bool kBf16>
__device__ __forceinline__ void st_op(char* p, float v) {
  if constexpr (kBf16) {
    *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16(v);
  } else {
    *reinterpret_cast<float*>(p) = v;
  }
}
// Two adjacent elements of a row, as operands.
template <bool kBf16>
__device__ __forceinline__ void st_pair(char* p, float v0, float v1) {
  if constexpr (kBf16) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  }
}

__device__ __forceinline__ uint32_t row_addr(const Img& img, int row, int es) {
  return smem_u32(img.p + row * img.st * es);
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// Rows [r0, r0 + nr) and columns [c0, c0 + nc) of a packed f32 matrix
// (`src`, row stride src_st) into shared memory at `dst` (row stride `st`
// elements) as operands, zero from row valid_r and column valid_c on, by
// the block: cp.async in float32 (the caller waits), converted to bf16 by
// the threads. Four columns at a time where the rows are 16-byte aligned.
template <bool kBf16>
__device__ void stage_block(char* dst, int st, const float* src, int src_st, int r0, int nr,
                            int c0, int nc, int valid_r, int valid_c) {
  if (((reinterpret_cast<uintptr_t>(src) | (src_st * 4) | (c0 * 4)) & 15) == 0 &&
      (valid_c & 3) == 0) {
    const int ng = nc / 4;
    for (int e = threadIdx.x; e < nr * ng; e += blockDim.x) {
      const int r = e / ng, c = 4 * (e % ng), gr = r0 + r, gc = c0 + c;
      const bool ok = gr < valid_r && gc < valid_c;
      const float* s4 = ok ? src + gr * src_st + gc : src;
      if constexpr (kBf16) {
        const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(s4)) : make_float4(0, 0, 0, 0);
        *reinterpret_cast<uint2*>(dst + (r * st + c) * 2) =
            make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
      } else {
        cp_async16(smem_u32(dst + (r * st + c) * 4), s4, ok ? 16 : 0);
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < nr * nc; e += blockDim.x) {
    const int r = e / nc, c = e % nc, gr = r0 + r, gc = c0 + c;
    const bool ok = gr < valid_r && gc < valid_c;
    if constexpr (kBf16) {
      reinterpret_cast<__nv_bfloat16*>(dst)[r * st + c] =
          __float2bfloat16(ok ? __ldg(src + gr * src_st + gc) : 0.0f);
    } else {
      cp_async4(smem_u32(dst + (r * st + c) * 4), ok ? src + gr * src_st + gc : src, ok ? 4 : 0);
    }
  }
}

// At the block's start: every matrix (resident) and the heads' matrix (row
// 0 w_d, rows 1-3 W_c) from the packed weights `w`.
template <bool kBf16>
__device__ void stage_fixed(const GPlan& p, char* smem, const float* w) {
  const int H = p.hidden;
  for (int k = 0; p.resident && k < p.n_layers; ++k) {
    stage_block<kBf16>(smem + p.pw_off[k], p.kp[k] + p.pad, w + p.w_off[k], p.in_dim[k], 0, p.hp,
                       0, p.kp[k], H, p.in_dim[k]);
  }
  char* heads = smem + p.heads_off;
  const int hst = p.hp + p.pad;
  stage_block<kBf16>(heads, hst, w + p.wd_off, H, 0, 1, 0, p.hp, 1, H);
  stage_block<kBf16>(heads + hst * p.esz, hst, w + max(p.wc_off, 0), H, 0, 15, 0, p.hp,
                     p.n_head > 0 ? 3 : 0, H);
  if (!kBf16) {
    cp_async_commit();
    cp_async_wait_all();
  }
}

// B of pass c over matrix k: `kn`, B[i][n] = W[i][n], the pass's columns
// are W's columns (the backward's g W); else B[i][n] = W[n][i], they are
// W's rows (the forward's a W^T). Streamed, every thread of the block
// calls it: the slab is staged between two barriers.
struct View {
  uint32_t a;     // shared-memory address
  const char* p;  // the same, generic
  int st;
};
template <bool kBf16>
__device__ View weights(const GPlan& p, char* smem, const float* w, int k, bool kn, int c,
                        const float* wt = nullptr) {
  const int st = p.kp[k] + p.pad, es = p.esz;
  if (p.resident) {
    const char* m = smem + p.pw_off[k] + (kn ? c * kCols * es : c * kCols * st * es);
    return View{smem_u32(m), m, st};
  }
  const float* src = w + p.w_off[k];
  const int in = p.in_dim[k], sst = !kn ? st : wt != nullptr ? p.hp + p.pad : kCols + p.pad;
  __syncthreads();  // every warp is done with the last slab
  if (kn && wt != nullptr) {  // rows of W^T: B[i][n] = W^T[n][i], as the forward's
    stage_block<kBf16>(smem, sst, wt + p.w_off[k], p.hidden, c * kCols,
                       min(kCols, p.kp[k] - c * kCols), 0, p.hp, in, p.hidden);
  } else if (!kn) {
    stage_block<kBf16>(smem, st, src, in, c * kCols, min(kCols, p.hp - c * kCols), 0, p.kp[k],
                       p.hidden, in);
  } else {
    stage_block<kBf16>(smem, sst, src, in, 0, p.hp, c * kCols, min(kCols, p.kp[k] - c * kCols),
                       p.hidden, in);
  }
  if (!kBf16) {
    cp_async_commit();
    cp_async_wait_all();
  }
  __syncthreads();
  return View{smem_u32(smem), smem, sst};
}

// x rows [row0, row0 + 16) into the warp's rows of `img` as operands, zero
// past d_in and past the last row.
template <bool kBf16>
__device__ void load_x(const GPlan& p, const Img& img, int wrow, const float* x, long long row0,
                       long long num_rows) {
  const int lane = threadIdx.x & 31;
  const float* xr = x + min(row0, num_rows - 1) * p.d_in;
  const int nr = static_cast<int>(min(16LL, num_rows - row0));
  for (int c = lane; c < p.dp; c += 32) {
    float v[16];  // the 16 rows' loads first, then the stores
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      v[r] = c < p.d_in && r < nr ? __ldg(xr + r * p.d_in + c) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) st_op<kBf16>(img.p + ((wrow + r) * img.st + c) * p.esz, v[r]);
  }
}

// The backward's cache, `rows` rows (the backward's tiles times `tr`, its
// rows a tile). Planes of operands, each tile's block transposed ([hp][tr],
// so that the dW products read both operands by ldmatrix): a_1 .. a_{L-1}
// (a_k: plane k - 1), then matrix k's cotangent gz_{k+1} (L - 1 + k); then
// the density head's cotangents ([rows] operands, plane 2L - 1), a_L
// ([rows][hp] operands), each 16 rows' ReLU bits (L hp / 2 words, the mma
// layout), each row's heads' cotangents ([4] f32, unrounded) and, for a
// float32 backward with streamed weights, each matrix transposed ([in]
// [hidden] f32 at its packed offset: the slabs of g W then load by
// ldmatrix, as the forward's do).
struct Cache {
  char* p;  // nullptr: none
  long long rows;
  int tr;
  // Plane j's block of the tile whose first row is `row`.
  __host__ __device__ char* tile(const GPlan& g, int j, long long row) const {
    return p + (rows * j + row) * g.hp * g.esz;
  }
  // Plane j's column of `row` in its tile's block.
  __host__ __device__ char* col(const GPlan& g, int j, long long row) const {
    return tile(g, j, row / tr * tr) + row % tr * g.esz;
  }
  __host__ __device__ char* a_last(const GPlan& g, long long row) const {
    return p + (rows * (2 * g.n_layers - 1) * g.hp + rows + row * g.hp) * g.esz;
  }
  __host__ __device__ uint32_t* bits(const GPlan& g, long long row) const {
    return reinterpret_cast<uint32_t*>(p + rows * (2 * g.n_layers * g.hp + 1) * g.esz) +
           row / 16 * (g.n_layers * g.hp / 2);
  }
  __host__ __device__ float* cots(const GPlan& g, long long row) const {
    return reinterpret_cast<float*>(p + rows * (2 * g.n_layers * g.hp + 1) * g.esz +
                                    rows / 16 * g.n_layers * g.hp * 2) +
           row * 4;
  }
  __host__ __device__ float* wt(const GPlan& g) const { return cots(g, rows); }
};

// The warp's 16 rows of `img` (hp columns), transposed into their columns
// of a tile's block (`dst`: the first, a column `tr` long): a half-warp a
// column, a lane a row.
template <bool kBf16>
__device__ void put_cols(const GPlan& p, const Img& img, int wrow, char* dst, int tr) {
  const int lane = threadIdx.x & 31, r = lane & 15, es = p.esz;
  for (int c = lane >> 4; c < p.hp; c += 2) {
    st_op<kBf16>(dst + (c * tr + r) * es, ld_op<kBf16>(img.p + ((wrow + r) * img.st + c) * es));
  }
}

// The warp's 16 rows of `img` (hp columns) to `dst` ([16][hp]).
__device__ void put_rows(const GPlan& p, const Img& img, int wrow, char* dst) {
  const int lane = threadIdx.x & 31, n = p.hp * p.esz / 16;  // 16-byte pieces a row
  for (int i = lane; i < 16 * n; i += 32) {
    const int r = i / n, c = i - r * n;
    *reinterpret_cast<uint4*>(dst + i * 16) =
        *reinterpret_cast<const uint4*>(img.p + (wrow + r) * img.st * p.esz + c * 16);
  }
}

// A tile's block of a plane (`src`, [nr][rows]) into `img` ([nr][img.st]),
// by the block with cp.async (the caller commits).
__device__ void get_block(const GPlan& p, const Img& img, const char* src, int nr) {
  const int n = p.rows * p.esz / 16;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < nr * n; i += blockDim.x) {
    const int r = i / n, c = i - r * n;
    cp_async16(smem_u32(img.p + r * img.st * p.esz + c * 16), src + i * 16, 16);
  }
}

// x rows [row0, row0 + 16) transposed into the warp's columns of `img`
// ([dp][img.st]) as operands, zero past d_in and past the last row.
template <bool kBf16>
__device__ void load_xt(const GPlan& p, const Img& img, int wrow, const float* x,
                        long long row0, long long num_rows) {
  const int lane = threadIdx.x & 31;
  const float* xr = x + min(row0, num_rows - 1) * p.d_in;
  const int nr = static_cast<int>(min(16LL, num_rows - row0));
  for (int c = lane; c < p.dp; c += 32) {
    float v[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      v[r] = c < p.d_in && r < nr ? __ldg(xr + r * p.d_in + c) : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) st_op<kBf16>(img.p + (c * img.st + wrow + r) * p.esz, v[r]);
  }
}

// The head matrix on the warp's rows of `a`: lanes t == 0 get pre_d (col
// 0) or, with `colour`, pre_c (cols 1-3) of rows g and g + 8, biases added.
template <bool kBf16>
__device__ void heads(const GPlan& p, char* smem, const float* b, const Img& a, int wrow,
                      bool colour, float (&pre)[2][4]) {
  float acc[8][4];
  zero(acc);
  mma_pass<kBf16, false, false>(row_addr(a, wrow, p.esz), a.st, smem_u32(smem + p.heads_off),
                                p.hp + p.pad, p.hp, 2, acc);
  if (!colour) {
    pre[0][0] = acc[0][0] + b[p.bd_off];
    pre[1][0] = acc[0][2] + b[p.bd_off];
    return;
  }
  // Columns 2 and 3 sit in the next lane.
  float up[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) up[e] = __shfl_down_sync(0xffffffffu, acc[0][e], 1);
  const float* bc = b + p.bc_off;
  pre[0][1] = acc[0][1] + bc[0];
  pre[0][2] = up[0] + bc[1];
  pre[0][3] = up[1] + bc[2];
  pre[1][1] = acc[0][3] + bc[0];
  pre[1][2] = up[2] + bc[1];
  pre[1][3] = up[3] + bc[2];
}

// The forward of the warp's 16 rows (row0: the first; wrow: its row in the
// images) through layers k < k_stop: a_{k+1} into act[k + 1]. With `bits`
// (the warp's, hp / 2 words a layer), each layer's ReLU mask (the f32
// pre-activation > 0) as the lanes' ballots of the mma layout. With
// `with_heads` (k_stop = L), lanes t == 0 end with pre[h] = (pre_d, pre_c)
// of rows g + 8h (pre_c with a head only). kExact (float32): the layers as
// fma_pass, the twin's sums; else on the tensor cores (3xTF32 in float32).
// With a `keep` cache, a_1 .. a_L of the warp's rows go to it.
template <bool kBf16, bool kExact>
__device__ void chain(const GPlan& p, char* smem, const float* wg, const float* b,
                      const float* head_dir, const Img* act, int wrow, long long row0,
                      long long num_rows, int num_samples, uint32_t* bits, int k_stop,
                      bool with_heads, float (&pre)[2][4], const Cache& keep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int H = p.hidden, es = p.esz;
  constexpr bool kFma = !kBf16 && kExact;
  // A lane's rows: g + 8h on the tensor cores (the mma layout), rh + 2h in fma_pass.
  long long ray[8];
  const float* hdr[8];  // the rows' head_dir (W_bh's bias), a valid address either way
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    const long long row = row0 + (kFma ? (lane >> 4) + 2 * h : g + 8 * h);
    ray[h] = (!kFma && h > 1) || p.n_head == 0 || row >= num_rows ? -1 : ray_of(row, num_samples);
    hdr[h] = head_dir + (ray[h] >= 0 ? ray[h] * H : 0);
  }
  for (int k = 0; k < k_stop; ++k) {
    const Img in = act[k], out = act[k + 1];
    for (int c = 0; c * kCols < p.hp; ++c) {
      const View w = weights<kBf16>(p, smem, wg, k, false, c);
      const int nc = min(kCols, p.hp - c * kCols), nt = nc / 8;
      float acc[8][4], add[8][4];
      zero(acc);
      if constexpr (!kFma) {
        mma_pass<kBf16, false, false>(row_addr(in, wrow, es), in.st, w.a, w.st, p.kp[k], nt, acc);
        // Biases (head_dir for W_bh), all loaded before the stores, from
        // clamped columns so that no load needs a branch.
        if (k != p.n_base) {
          const float* bk = b + p.b_off[k];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = c * kCols + 8 * j + 2 * t + e;
              const float v = __ldg(bk + min(col, H - 1));
              add[j][e] = add[j][2 + e] = col < H ? v : 0.0f;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = c * kCols + 8 * j + 2 * t + (e & 1), h = e >> 1;
              const float v = __ldg(hdr[h] + min(col, H - 1));
              add[j][e] = col < H && ray[h] >= 0 ? v : 0.0f;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j >= nt) continue;
          const int n = c * kCols + 8 * j + 2 * t;
          const bool ok[2] = {n < H, n + 1 < H};  // past H the activation stays 0
          float z[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) z[e] = ok[e & 1] ? acc[j][e] + add[j][e] : 0.0f;
          if (bits != nullptr) {
            uint32_t m[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) m[e] = __ballot_sync(0xffffffffu, z[e] > 0.0f);
            if (lane < 4) bits[k * p.hp / 2 + (c * 8 + j) * 4 + lane] = m[lane];
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            char* o = out.p + ((wrow + g + 8 * h) * out.st + n) * es;
            if constexpr (kBf16) {  // ReLU after the rounding: the same bf16 values
              *reinterpret_cast<__nv_bfloat162*>(o) =
                  __hmax2_nan(__floats2bfloat162_rn(z[2 * h], z[2 * h + 1]),
                              __float2bfloat162_rn(0.0f));
            } else {
              *reinterpret_cast<float2*>(o) =
                  make_float2(nan_max(z[2 * h], 0.0f), nan_max(z[2 * h + 1], 0.0f));
            }
          }
        }
      } else {
        fma_pass(reinterpret_cast<const float*>(in.p) + wrow * in.st, in.st,
                 reinterpret_cast<const float*>(w.p), w.st, p.kp[k], nc, acc);
        const int cl = lane & 15;
        const bool hd = k == p.n_base;
        const float* bk = b + (hd ? 0 : p.b_off[k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c * kCols + 16 * j + cl, cc = min(col, H - 1);
          const bool ok = 16 * j < nc && col < H;
          const float bv = hd ? 0.0f : __ldg(bk + cc);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            add[i][j] = !ok ? 0.0f : !hd ? bv : ray[i] >= 0 ? __ldg(hdr[i] + cc) : 0.0f;
          }
        }
        float* o = reinterpret_cast<float*>(out.p) + (wrow + (lane >> 4)) * out.st;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (16 * j >= nc) continue;
          const int col = c * kCols + 16 * j + cl;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            o[2 * i * out.st + col] = col < H ? nan_max(acc[i][j] + add[i][j], 0.0f) : 0.0f;
          }
        }
        if (bits != nullptr) {  // the masks in the mma layout, from the stored a (= z where > 0)
          __syncwarp();
          const float* a = reinterpret_cast<const float*>(out.p) + wrow * out.st;
          for (int j = 0; j < nt; ++j) {
            const int n = c * kCols + 8 * j + 2 * t;
            uint32_t m[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v = a[(g + 8 * (e >> 1)) * out.st + n + (e & 1)];
              m[e] = __ballot_sync(0xffffffffu, v > 0.0f);
            }
            if (lane < 4) bits[k * p.hp / 2 + (c * 8 + j) * 4 + lane] = m[lane];
          }
        }
      }
    }
    __syncwarp();
    if (keep.p != nullptr && k + 1 < p.n_layers) {
      put_cols<kBf16>(p, out, wrow, keep.col(p, k, row0), keep.tr);
    } else if (keep.p != nullptr) {
      put_rows(p, out, wrow, keep.a_last(p, row0));
    }
    if (with_heads && k + 1 == p.n_base) heads<kBf16>(p, smem, b, out, wrow, false, pre);
  }
  if (with_heads && p.n_head > 0) heads<kBf16>(p, smem, b, act[p.n_layers], wrow, true, pre);
}

// The heads' cotangents of the lane's rows row0 + g + 8h, unrounded: lane
// t of a row's quad takes pre_d's (t = 0) or pre_c's channel t - 1, from
// lane t == 0's pre-activations (the incoming cotangents loaded first).
__device__ void head_cots(const GPlan& p, const float (&pre)[2][4], long long row0,
                          long long num_rows, const float* g_rgb, const float* g_dens,
                          float (&cot)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float pv[2], gi[2];
  bool valid[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long row = row0 + g + 8 * h;
    valid[h] = row < num_rows && (t == 0 || p.n_head > 0);
    gi[h] = !valid[h] ? 0.0f : t == 0 ? __ldg(g_dens + row) : __ldg(g_rgb + row * 3 + t - 1);
    pv[h] = pre[h][0];
#pragma unroll
    for (int q = 1; q < 4; ++q) {
      const float u = __shfl_sync(0xffffffffu, pre[h][q], lane & ~3);
      if (t == q) pv[h] = u;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float y = sigmoid(pv[h]);
    cot[h] = !valid[h] ? 0.0f : t == 0 ? gi[h] * y : gi[h] * y * (1.0f - y);
  }
}

// K4 and K5: the forward on the tensor cores (3xTF32 in float32: a flipped
// ReLU mask there moves an output by no more than the pre-activation's
// size, within f32 rounding of 0). kCache: the first kernel of a cached
// backward (K4b, K5b), at the forward's warps: the chain as the backward
// needs it (float32 as f32 FMAs, the twin's sums) over every row of
// `keep`, writing its a_1 .. a_L, ReLU bits and the heads' cotangents
// there in place of the outputs.
template <bool kBf16, bool kCache>
__global__ void __launch_bounds__((kCache ? kCacheWarps : kMaxWarps) * 32, 1) fwd_kernel(
    const __grid_constant__ GPlan p, const float* __restrict__ x,
    const float* __restrict__ head_dir, const float* __restrict__ wg,
    const float* __restrict__ b, float* __restrict__ rgb_out, float* __restrict__ dens_out,
    long long num_rows, int num_samples, const Cache keep, const float* __restrict__ g_rgb,
    const float* __restrict__ g_dens) {
  extern __shared__ __align__(128) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int R = p.rows, st = p.wp + p.pad, L = p.n_layers;
  stage_fixed<kBf16>(p, smem, wg);
  __syncthreads();
  Img act[kMaxLayers + 1];
  for (int k = 0; k <= L; ++k) act[k] = Img{smem + p.pp_off + (k & 1) * R * st * p.esz, st};
  const long long cover = kCache ? keep.rows : num_rows, tiles = (cover + R - 1) / R;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * R + 16 * warp;
    if (p.resident && row0 >= cover) continue;  // no barriers to keep
    load_x<kBf16>(p, act[0], 16 * warp, x, row0, num_rows);
    __syncwarp();
    float pre[2][4];
    const bool mine = kCache && row0 < cover;
    chain<kBf16, kCache>(p, smem, wg, b, head_dir, act, 16 * warp, row0, num_rows, num_samples,
                         mine ? keep.bits(p, row0) : nullptr, L, true, pre,
                         mine ? keep : Cache{nullptr, 0, 0});
    if constexpr (kCache) {
      float cot[2];
      head_cots(p, pre, row0, num_rows, g_rgb, g_dens, cot);
      if (mine) {
#pragma unroll
        for (int h = 0; h < 2; ++h) keep.cots(p, row0 + g + 8 * h)[t] = cot[h];
      }
      continue;
    }
    // Lane t of a row's quad writes output t: the density (t = 0, softplus)
    // or colour channel t - 1 (sigmoid), from lane t == 0's pre-activations.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = pre[h][0];
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        const float u = __shfl_sync(0xffffffffu, pre[h][q], lane & ~3);
        if (t == q) v = u;
      }
      const long long row = row0 + g + 8 * h;
      if (row >= num_rows || (t > 0 && p.n_head == 0)) continue;
      if (t == 0) {
        dens_out[row] = fmaxf(v, 0.0f) + log1pf(expf(-fabsf(v)));
      } else {
        rgb_out[row * 3 + t - 1] = sigmoid(v);
      }
    }
    __syncwarp();
  }
}

// A cotangent of a_l (l >= 1) in a pass's accumulators, unrounded (columns
// c kCols + 8j + 2t (+1), rows g and g + 8 of the warp): masked by a_l's
// ReLU bits; its column sums over the warp's rows go to the
// warp's `part` row (the bias of matrix l - 1), or for W_bh (l - 1 ==
// n_base with a head) into dhd per ray; then it is stored rounded.
template <bool kBf16>
__device__ void finish_gz(const GPlan& p, const uint32_t* bits, int l, int c, int nt,
                          float (&acc)[8][4], const Img& out, int wrow, float* part,
                          float* dhd, long long row0, long long num_rows, int num_samples) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  const int H = p.hidden, es = p.esz;
  const bool hd = p.n_head > 0 && l - 1 == p.n_base;
  const bool one_ray = hd && row0 + 15 < num_rows &&
                       ray_of(row0, num_samples) == ray_of(row0 + 15, num_samples);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= nt) continue;
    const int tile = c * 8 + j, n = 8 * tile + 2 * t;
    const uint32_t* mb = bits + (l - 1) * p.hp / 2 + tile * 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!((mb[e] >> lane) & 1u)) acc[j][e] = 0.0f;
    }
    {
      if (!hd || one_ray) {
        float s0 = acc[j][0] + acc[j][2], s1 = acc[j][1] + acc[j][3];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (g == 0) {
          if (!hd) {
            part[warp * p.hp + n] = s0;
            part[warp * p.hp + n + 1] = s1;
          } else {
            float* d = dhd + ray_of(row0, num_samples) * H;
            if (n < H) atomicAdd(d + n, s0);
            if (n + 1 < H) atomicAdd(d + n + 1, s1);
          }
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long row = row0 + g + 8 * h;
          if (row >= num_rows) continue;
          float* d = dhd + ray_of(row, num_samples) * H;
          if (n < H) atomicAdd(d + n, acc[j][2 * h]);
          if (n + 1 < H) atomicAdd(d + n + 1, acc[j][2 * h + 1]);
        }
      }
    }
    st_pair<kBf16>(out.p + ((wrow + g) * out.st + n) * es, acc[j][0], acc[j][1]);
    st_pair<kBf16>(out.p + ((wrow + g + 8) * out.st + n) * es, acc[j][2], acc[j][3]);
  }
}

// The heads' weight and bias gradients of the tile: with `colour` W_c and
// b_c from the rows' pre_c cotangents on a = a_L, else w_d and b_d from
// pre_d's on a = a_nb. The weights' as one product C[q][h] = sum over rows
// of hc[r][q] a[r][h] (hc: the cotangents as operands, q < 16) in units of
// kCols columns over the warps, each element added by one lane (without
// `with_w` none); the biases' from the warps' sums of the unrounded
// cotangents, in warp order.
template <bool kBf16>
__device__ void head_grads(const GPlan& p, const Img& hc, const float* hpart, const Img& a,
                           bool colour, bool with_w, float* headg, float* biasg) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  const int H = p.hidden, es = p.esz;
  for (int u = warp; with_w && u * kCols < p.hp; u += p.warps) {
    const int ns = u * kCols, nt = min(kCols, p.hp - ns) / 8;
    float acc[8][4];
    zero(acc);
    mma_pass<kBf16, true, true>(smem_u32(hc.p), hc.st, smem_u32(a.p + ns * es), a.st, p.rows,
                                nt, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= nt) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int q = g + 8 * (e >> 1), col = ns + 8 * j + 2 * t + (e & 1);
        if (col < H && (colour ? q >= 1 && q <= 3 : q == 0)) headg[q * p.hp + col] += acc[j][e];
      }
    }
  }
  for (int q = threadIdx.x; q < (colour ? 3 : 1); q += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < p.warps; ++w) s += hpart[w * 4 + (colour ? 1 + q : 0)];
    biasg[colour ? p.bc_off + q : p.bd_off] += s;
  }
}

// dW rows [m0, m1) of a matrix with `in` inputs (`kp` padded) += gz^T a
// over `rows` rows (gz: the cotangent image G, a: the input image A;
// kT: both transposed, [column][row]), into its chunk `dw` ([m1 -
// m0][dw_stride(in)]): units of 16 rows by up to kCols columns over the
// warps, each element added by one lane.
template <bool kBf16, bool kT>
__device__ void dw_step(const GPlan& p, const Img& G, const Img& A, int in, int kp, int m0,
                        int m1, int rows, float* dw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, warp = threadIdx.x >> 5;
  const int es = p.esz, mb = (m1 - m0 + 15) / 16, ds = dw_stride(in);
  // Units of 16 rows x uc columns, uc the widest of 64, 32 and 16 that
  // still gives every warp one.
  int uc = kCols;
  while (uc > 16 && mb * ((kp + uc - 1) / uc) < p.warps) uc /= 2;
  const int nch = (kp + uc - 1) / uc, units = mb * nch;
  for (int u = warp; u < units; u += p.warps) {
    const int ms = m0 + 16 * (u / nch), ns = uc * (u % nch);
    const int nt = min(uc, kp - ns) / 8;
    float acc[8][4];
    zero(acc);
    if constexpr (kT) {
      mma_pass<kBf16, false, false>(smem_u32(G.p + ms * G.st * es), G.st,
                                    smem_u32(A.p + ns * A.st * es), A.st, rows, nt, acc);
    } else {
      mma_pass<kBf16, true, true>(smem_u32(G.p + ms * es), G.st, smem_u32(A.p + ns * es), A.st,
                                  rows, nt, acc);
    }
    // Column pairs as float2: a pair's second column past `in` lands in
    // the row's pad.
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= nt) continue;
      const int col = ns + 8 * j + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = ms + g + 8 * h;
        if (m >= m1 || col >= in) continue;
        float2* d = reinterpret_cast<float2*>(dw + (m - m0) * ds + col);
        float2 v = *d;
        v.x += acc[j][2 * h];
        v.y += acc[j][2 * h + 1];
        *d = v;
      }
    }
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kMaxBwdWarps * 32, 1) bwd_kernel(
    const __grid_constant__ GPlan p, const float* __restrict__ x,
    const float* __restrict__ head_dir, const float* __restrict__ wg,
    const float* __restrict__ b, const float* __restrict__ g_rgb,
    const float* __restrict__ g_dens, float* __restrict__ dx, float* dhd, float* ws,
    int ws_stride, char* cache, long long num_rows, int num_samples) {
  extern __shared__ __align__(128) char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int H = p.hidden, L = p.n_layers, nb = p.n_base, R = p.rows, es = p.esz;
  const int wrow = 16 * warp, pst = p.wp + p.pad;
  // The warp's ReLU bits: hp / 2 words a layer.
  uint32_t* wbits = reinterpret_cast<uint32_t*>(smem + p.bits_off) + warp * p.n_layers * p.hp / 2;
  float* rowsv = reinterpret_cast<float*>(smem + p.rows_off);  // per row: g_pre_d, g_pre_c
  const Img hcot{smem + p.hcot_off, 16 + p.pad};  // the same as operands, cols 0-3
  float* hpart = reinterpret_cast<float*>(smem + p.hpart_off);
  float* part = reinterpret_cast<float*>(smem + p.part_off);
  float* biasg = reinterpret_cast<float*>(smem + p.bias_off);
  float* headg = reinterpret_cast<float*>(smem + p.headg_off);  // [4][hp]: w_d, W_c
  float* ws_row = ws + static_cast<long long>(blockIdx.x) * ws_stride;
  const Img pp[2] = {Img{smem + p.pp_off, pst}, Img{smem + p.pp_off + R * pst * es, pst}};
  const long long tiles = (num_rows + R - 1) / R;
  // One pass: every matrix's input image kept (act[k]) and its dW summed
  // here. Else the cache takes the inputs and cotangents for the phases.
  const bool fused = p.n_phases == 1;
  const Cache keep{fused ? nullptr : cache, tiles * R, R};
  // float32 W^T from the cache for the streamed slabs of g W (ldmatrix).
  const float* wt = !kBf16 && !fused && !p.resident ? keep.wt(p) : nullptr;
  stage_fixed<kBf16>(p, smem, wg);
  for (int i = threadIdx.x; i < p.n_b; i += blockDim.x) biasg[i] = 0.0f;
  for (int i = threadIdx.x; i < 4 * p.hp; i += blockDim.x) headg[i] = 0.0f;
  for (int i = threadIdx.x; i < R * (16 + p.pad) * es / 4; i += blockDim.x) {
    reinterpret_cast<float*>(hcot.p)[i] = 0.0f;
  }
  Img act[kMaxLayers + 1];
  int dw_off[kMaxLayers];
  {
    int off = p.phase_off;
    for (int k = 0; k <= L; ++k) {
      act[k] = fused && k < L ? Img{smem + off, p.kp[k] + p.pad} : pp[k & 1];
      if (fused && k < L) off += R * (p.kp[k] + p.pad) * es;
    }
    for (int k = 0; fused && k < L; ++k) {  // one chunk a matrix, in order
      dw_off[k] = off;
      off += (H + 15) / 16 * 16 * dw_stride(p.in_dim[k]) * 4;
      float* dw = reinterpret_cast<float*>(smem + dw_off[k]);
      for (int i = threadIdx.x; i < H * dw_stride(p.in_dim[k]); i += blockDim.x) dw[i] = 0.0f;
    }
  }
  __syncthreads();
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long row0 = tile * R + wrow;
    if (fused) {  // the forward again, its ReLU bits and the heads' cotangents
      load_x<kBf16>(p, act[0], wrow, x, row0, num_rows);
      __syncwarp();
      float pre[2][4], cot[2];
      chain<kBf16, true>(p, smem, wg, b, head_dir, act, wrow, row0, num_rows, num_samples,
                         wbits, L, true, pre, Cache{nullptr, 0, 0});
      head_cots(p, pre, row0, num_rows, g_rgb, g_dens, cot);
#pragma unroll
      for (int h = 0; h < 2; ++h) rowsv[(wrow + g + 8 * h) * 4 + t] = cot[h];
    } else {  // the same from the cache, with a_L for the head's gradients
      const int n = p.hp * es / 16;
      const char* src = keep.a_last(p, row0);
      for (int i = lane; i < 16 * n; i += 32) {
        cp_async16(smem_u32(act[L].p + ((wrow + i / n) * act[L].st) * es + i % n * 16),
                   src + i * 16, 16);
      }
      cp_async_commit();
      const uint32_t* cb = keep.bits(p, row0);
      for (int i = lane; i < L * p.hp / 2; i += 32) wbits[i] = cb[i];
      const float* cc = keep.cots(p, row0);
      for (int i = lane; i < 64; i += 32) rowsv[wrow * 4 + i] = cc[i];
      cp_async_wait_all();
    }
    __syncwarp();
    // The rows' cotangents as operands (cols 0-3 of hcot; the density
    // head's also to the cache), and the warp's sums of them over its rows
    // (lanes 0-15 a row each).
    {
      float sum[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float u = lane < 16 ? rowsv[(wrow + lane) * 4 + q] : 0.0f;
        if (lane < 16) st_op<kBf16>(hcot.p + ((wrow + lane) * hcot.st + q) * es, op<kBf16>(u));
        if (q == 0 && lane < 16 && keep.p != nullptr && p.n_head > 0) {
          st_op<kBf16>(keep.tile(p, 2 * L - 1, 0) + (row0 + lane) * es, op<kBf16>(u));
        }
        sum[q] = u;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], o);
      }
      if (lane == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) hpart[warp * 4 + q] = sum[q];
      }
    }
    // gz_L from the head on a_L (colour, or without a head density), into
    // pp[(L + 1) & 1]; a_L stays in act[L] = pp[L & 1] for the head grads.
    const char* hw = smem + p.heads_off;
    const int hst = p.hp + p.pad;
    // The heads' cotangents of the lane's rows g and g + 8, as operands:
    // the colour head's (rows 1-3 of the head matrix), or the density's.
    const int q0 = p.n_head > 0 ? 1 : 0, nq = p.n_head > 0 ? 3 : 1;
    float gr[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        gr[h][q] = q < nq ? op<kBf16>(rowsv[(wrow + g + 8 * h) * 4 + q0 + q]) : 0.0f;
      }
    }
    for (int c = 0; c * kCols < p.hp; ++c) {
      const int nt = min(kCols, p.hp - c * kCols) / 8;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= nt) continue;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int col = c * kCols + 8 * j + 2 * t + e2;
          float wq[3];
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            wq[q] = q < nq ? ld_op<kBf16>(hw + ((q0 + q) * hst + col) * es) : 0.0f;
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = gr[h][0] * wq[0];
            v = fmaf(gr[h][1], wq[1], v);
            acc[j][2 * h + e2] = fmaf(gr[h][2], wq[2], v);
          }
        }
      }
      finish_gz<kBf16>(p, wbits, L, c, nt, acc, pp[(L + 1) & 1], wrow,
                       part + (L & 1) * p.warps * p.hp, dhd, row0, num_rows, num_samples);
    }
    if (keep.p != nullptr) {
      __syncwarp();
      put_cols<kBf16>(p, pp[(L + 1) & 1], wrow, keep.col(p, 2 * L - 2, row0), R);
    }
    __syncthreads();
    head_grads<kBf16>(p, hcot, hpart, act[L], p.n_head > 0, true, headg, biasg);
    for (int k = L - 1; k >= 0; --k) {
      if (k < L - 1) __syncthreads();  // gz_{k+1} and its column sums are in
      const Img& G = pp[k & 1];       // gz_{k+1}
      if (fused) {
        dw_step<kBf16, false>(p, G, act[k], p.in_dim[k], p.kp[k], 0, H, R,
                              reinterpret_cast<float*>(smem + dw_off[k]));
      }
      if (p.n_head > 0 && k == nb) {  // w_d here, or in the phases from the cache
        head_grads<kBf16>(p, hcot, hpart, act[nb], false, fused, headg, biasg);
      } else {
        const float* pk = part + ((k + 1) & 1) * p.warps * p.hp;
        for (int n = threadIdx.x; n < H; n += blockDim.x) {
          float s = 0.0f;
          for (int w = 0; w < p.warps; ++w) s += pk[w * p.hp + n];
          biasg[p.b_off[k] + n] += s;
        }
      }
      if (k == L - 1) __syncthreads();  // the head grads have read a_L
      // g_{a_k} = gz_{k+1} W_k, then gz_k into pp[(k + 1) & 1], or dx.
      for (int c = 0; c * kCols < p.kp[k]; ++c) {
        const View w = weights<kBf16>(p, smem, wg, k, true, c, wt);
        const int nt = min(kCols, p.kp[k] - c * kCols) / 8;
        float acc[8][4];
        zero(acc);
        if (wt != nullptr) {
          mma_pass<kBf16, false, false>(row_addr(G, wrow, es), G.st, w.a, w.st, p.hp, nt, acc);
        } else {
          mma_pass<kBf16, false, true>(row_addr(G, wrow, es), G.st, w.a, w.st, p.hp, nt, acc);
        }
        if (p.n_head > 0 && k == nb) {  // the density head's share of g_{a_nb}
          const float gd[2] = {op<kBf16>(rowsv[(wrow + g) * 4]),
                               op<kBf16>(rowsv[(wrow + g + 8) * 4])};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j >= nt) continue;
#pragma unroll
            for (int e2 = 0; e2 < 2; ++e2) {
              const float wd = ld_op<kBf16>(hw + (c * kCols + 8 * j + 2 * t + e2) * es);
              acc[j][e2] = fmaf(gd[0], wd, acc[j][e2]);
              acc[j][2 + e2] = fmaf(gd[1], wd, acc[j][2 + e2]);
            }
          }
        }
        if (k == 0) {  // dx
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j >= nt) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = c * kCols + 8 * j + 2 * t + (e & 1);
              const long long row = row0 + g + 8 * (e >> 1);
              if (row < num_rows && col < p.d_in) dx[row * p.d_in + col] = acc[j][e];
            }
          }
        } else {
          finish_gz<kBf16>(p, wbits, k, c, nt, acc, pp[(k + 1) & 1], wrow,
                           part + (k & 1) * p.warps * p.hp, dhd, row0, num_rows, num_samples);
        }
      }
      if (k > 0 && keep.p != nullptr) {
        __syncwarp();
        put_cols<kBf16>(p, pp[(k + 1) & 1], wrow, keep.col(p, L + k - 2, row0), R);
      }
    }
    __syncthreads();  // before the next tile's images
  }
  for (int k = 0; fused && k < L; ++k) {
    const float* dw = reinterpret_cast<const float*>(smem + dw_off[k]);
    float* dst = ws_row + p.w_off[k];
    const int in = p.in_dim[k], ds = dw_stride(in);
    for (int i = threadIdx.x; i < H * in; i += blockDim.x) dst[i] = dw[i / in * ds + i % in];
  }
  for (int i = threadIdx.x; i < p.n_b; i += blockDim.x) ws_row[p.n_w + i] = biasg[i];
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    if (fused || p.n_head == 0) ws_row[p.wd_off + h] = headg[h];
    if (p.n_head > 0) {
#pragma unroll
      for (int q = 0; q < 3; ++q) ws_row[p.wc_off + q * H + h] = headg[(1 + q) * p.hp + h];
    }
  }
  if (fused) return;
  // The dW phases. A phase's chunks come in runs that share their sources:
  // cotangents G^T (a plane's [hp] rows; for w_d the density head's
  // cotangents in row 0) and inputs A^T ([kp] rows; x^T for matrix 0).
  // Per tile and run the images load by cp.async, then dW += G^T A over
  // the tile's rows for each chunk of the run. Each chunk's sums go to the
  // block's row once, at the phase's end.
  __syncthreads();  // the cache's rows and shared memory are free
  const int tst = R + p.pad;
  const Img G{smem, tst}, A{smem + p.hp * tst * es, tst};
  const int base = (p.hp + p.wp) * tst * es;
  for (int ph = 1; ph < p.n_phases; ++ph) {
    const int c0 = p.phase_first[ph], n = p.phase_first[ph + 1] - c0;
    int dwo[kMaxLayers + 1], run[kMaxLayers + 2], nruns = 0, off = base;
    for (int i = 0; i < n; ++i) {
      const int k = p.chunk_k[c0 + i], in = k == L ? H : p.in_dim[k];
      dwo[i] = off;
      off += (p.chunk_m1[c0 + i] - p.chunk_m0[c0 + i] + 15) / 16 * 16 * dw_stride(in) * 4;
      if (i == 0 || k != p.chunk_k[c0 + i - 1]) run[nruns++] = i;
    }
    run[nruns] = n;
    for (int i = base / 4 + threadIdx.x; i < off / 4; i += blockDim.x) {
      reinterpret_cast<float*>(smem)[i] = 0.0f;
    }
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long trow = tile * R;
      for (int j = 0; j < nruns; ++j) {
        const int k = p.chunk_k[c0 + run[j]], ak = k == L ? nb : k;
        __syncthreads();  // the last products are done with the images
        if (k == L) {
          const char* dc = keep.tile(p, 2 * L - 1, 0) + trow * es;
          for (int e = threadIdx.x; e < 16 * R; e += blockDim.x) {
            const int q = e / R, r = e - q * R;
            st_op<kBf16>(G.p + (q * tst + r) * es, q == 0 ? ld_op<kBf16>(dc + r * es) : 0.0f);
          }
        } else {
          get_block(p, G, keep.tile(p, L - 1 + k, trow), p.hp);
        }
        if (ak == 0) {
          load_xt<kBf16>(p, A, wrow, x, trow + wrow, num_rows);
        } else {
          get_block(p, A, keep.tile(p, ak - 1, trow), p.hp);
        }
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        for (int i = run[j]; i < run[j + 1]; ++i) {
          const int kc = p.chunk_k[c0 + i];
          dw_step<kBf16, true>(p, G, A, kc == L ? H : p.in_dim[kc], kc == L ? p.hp : p.kp[kc],
                               p.chunk_m0[c0 + i], p.chunk_m1[c0 + i], R,
                               reinterpret_cast<float*>(smem + dwo[i]));
        }
      }
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const int k = p.chunk_k[c0 + i], in = k == L ? H : p.in_dim[k];
      const int m0 = p.chunk_m0[c0 + i], m1 = p.chunk_m1[c0 + i];
      const float* dw = reinterpret_cast<const float*>(smem + dwo[i]);
      float* dst = ws_row + (k == L ? p.wd_off : p.w_off[k] + m0 * in);
      const int ds = dw_stride(in);
      for (int e = threadIdx.x; e < (m1 - m0) * in; e += blockDim.x) {
        dst[e] = dw[e / in * ds + e % in];
      }
    }
    __syncthreads();
  }
}

// Each matrix of `w` transposed into `wt` at its packed offset.
__global__ void transpose_kernel(const __grid_constant__ GPlan p, const float* w, float* wt) {
  for (int k = 0; k < p.n_layers; ++k) {
    const int in = p.in_dim[k], n = p.hidden * in;
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
      wt[p.w_off[k] + e % in * p.hidden + e / in] = w[p.w_off[k] + e];
    }
  }
}

template <bool kBf16, bool kCache = false>
cudaError_t launch_fwd(const GPlan& p, const float* x, const float* head_dir, const float* w,
                       const float* b, float* rgb, float* dens, long long num_rows,
                       int num_samples, int grid, cudaStream_t stream,
                       const Cache& keep = Cache{nullptr, 0, 0}, const float* g_rgb = nullptr,
                       const float* g_dens = nullptr) {
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<kBf16, kCache>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return err;
  fwd_kernel<kBf16, kCache><<<grid, p.warps * 32, p.smem_bytes, stream>>>(
      p, x, head_dir, w, b, rgb, dens, num_rows, num_samples, keep, g_rgb, g_dens);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_bwd(const GPlan& p, const float* x, const float* head_dir, const float* w,
                       const float* b, const float* g_rgb, const float* g_dens, float* dx,
                       float* dhd, float* ws, int ws_stride, float* aux, long long num_rows,
                       int num_samples, int grid, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel<kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return err;
  bwd_kernel<kBf16><<<grid, p.warps * 32, p.smem_bytes, stream>>>(
      p, x, head_dir, w, b, g_rgb, g_dens, dx, dhd, ws, ws_stride,
      reinterpret_cast<char*>(aux), num_rows, num_samples);
  return cudaGetLastError();
}

}  // namespace gen

// ---------------------------------------------------------------- the layered route
//
// K4, K4b, K5 and K5b for every stack neither route above takes: d_in or
// hidden above 256, or more than 8 hidden matrices, in float32 and bfloat16
// alike (ops/mlp.py `launch_plan`). Width and depth are runtime values with
// no cap: nothing of the stack has to fit shared memory at once.
//
// Precision, as the generic route's. bfloat16: every product takes bf16
// operands and sums in f32. float32 (JAX's Precision.HIGHEST): the layer
// chain, the forward's and the backward's recomputed one, as f32 FMAs in a
// plain GEMM's order (gen::fma_pass), so that the pre-activations and the
// ReLU masks that gate the cotangents are the f32 twin's; the backward's
// other products (g W and g^T a) as 3xTF32 (gen::mma_pass). Activations are
// stored as operands. A cotangent is stored as an operand too (rounded to
// bf16 in bfloat16, the value every product that reads it rounds it to);
// the bias, head and head_dir gradients are f32 sums of the unrounded
// values, taken where a cotangent is made, before it is rounded.
//
// What bounds it on the H100: at (d_in, hidden) = (64, 512) with 3 + 1
// layers a row is 821,248 MACs, and the train slice (4096 x 257 rows) 1.73
// TFLOP forward: 1.75 ms at the 989 TFLOP/s bf16 tensor peak, 25.8 ms at
// the 67 TFLOP/s f32 FMA peak; the backward has three times the products.
// The layer boundaries add HBM traffic: each writes an activation ([rows,
// 512] bf16, 1.08 GB at the train slice) and reads it back.
//
// Design. One tiled product kernel a layer, the activations crossing global
// memory between layers, rows in chunks of whole rays (the host's
// `rays_per_chunk`) so that the scratch stays bounded and a ray's sums close
// in its chunk. Three products:
//   0, a layer: a_{k+1}[n][j] = relu(sum_i a_k[n][i] W_k[j][i] + b_k[j]),
//      head_dir[ray(n)][j] in place of b_k at W_bh;
//   1, a cotangent one layer down: g[n][i] = sum_j gz_k[n][j] W_k[j][i],
//      plus the density head's gz_d[n] w_d[i] into a_nb, zero where a_k <= 0
//      (dx: no mask);
//   2, a weight gradient over a split of the rows: dW[j][i] = sum_n gz[n][j]
//      a[n][i], the block's tile in registers for its whole split, written
//      once into the split's row of a workspace; `reduce_kernel` adds the
//      rows in split order, and the chunks in chunk order: the same bits in
//      every launch, no float atomics.
// bfloat16 (`wg_kernel`): the call first casts the weights once to bf16
// copies in the scratch (W_k, and for the backward W_k^T, so that modes 0
// and 1 read both operands K-major), and each chunk's x to bf16. A block
// computes 128 x 128 tiles of the output with two warpgroups of `wgmma`
// m64n128k16, both operands from shared memory: a ring of three 64-deep
// stages filled by cp.async (16 bytes a thread) while the earlier stages'
// products run, in wgmma's 128-byte swizzle (the unswizzled core-matrix
// layout ran the same products at half the rate); mode 2 reads gz^T and a
// as MN-major operands through the descriptors, with no transposed copy.
// Two blocks an SM; in modes 0 and 1 each walks several tiles as one
// stream of stages, so that a tile's epilogue runs while the next tile's
// first stages load. Epilogues stage their 128 x 128 tiles (a ReLU mask,
// the output) in shared memory so that global memory is read and written
// 16 bytes a thread. The epilogue that makes a cotangent (mode 1, and
// `top_tile_kernel` for the first) stores it as bf16 operands and writes
// the tile's column sums of its unrounded values (the bias gradient) or
// its rays' sums (dhead_dir) as per-tile partials, summed in tile order
// after it (`reduce_kernel`, `ray_fix_kernel`). float32 (`prod_kernel`): a block
// computes a 128 x 64 tile, eight warps of 16 rows, a ring of three 32-deep
// stages by cp.async, f32 operands as they are in memory; the cotangents'
// column sums and ray sums are kernels of their own (`colsum_kernel`,
// `raysum_kernel`). The heads (density: 1 output, softplus; colour: 3,
// sigmoid) are a warp a row (`heads_kernel`); their weight and bias
// gradients one pass over a_nb and a_L in row splits (`head_grad_kernel`).
// The backward recomputes the chain, as JAX's does, then goes down the
// layers: dW_k (mode 2), the cotangent one layer down (mode 1).

namespace lay {

constexpr long long kWsFloats = 1 << 24;  // the backward's workspace, at least
constexpr int kStages = 3;                // the float32 products' ring of stages
// bfloat16 (wg_kernel): 128 x 128 outputs a block, a ring of three
// 64-deep stages of both operands, two blocks an SM.
constexpr int kWgStages = 3;
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kStageBytes = (kBM + kBN) * kBK * 2;
constexpr int kWgSmem = kWgStages * kStageBytes;
constexpr int kRedBytes = 8 * kBN * 4;  // the column sums' warp partials, past the ring
constexpr int kTileStride = kBN + 4;  // the epilogue's f32 tile for ray sums
static_assert((kBM * kTileStride + kBN) * 4 <= kWgSmem, "the ray sums' tile fits the ring");
// float32 (prod_kernel): 128 x 64 outputs a block, eight warps, 32-deep stages.
constexpr int kWarps = 8;
constexpr int kTM = 16 * kWarps, kTN = 64, kTK = 32;
constexpr int kF32StageBytes = (kTM + kTN) * (kTK + 4) * 4;  // mode 0's, the largest
constexpr int kF32Smem = kStages * kF32StageBytes;

// The packed weights' offsets (ops/mlp.py `_pack`, as pack_layout) computed
// per matrix, with no arrays: any depth.
struct Stack {
  int d_in, hidden, n_base, n_head, n_layers;
  int in_dim(int k) const { return k == 0 ? d_in : hidden; }
  long long mats(int k) const {  // floats of matrices 0 .. k-1
    return k == 0 ? 0 : static_cast<long long>(hidden) * (d_in + static_cast<long long>(hidden) * (k - 1));
  }
  long long w_off(int k) const { return mats(k) + (n_head > 0 && k >= n_base ? hidden : 0); }
  long long wd_off() const { return mats(n_base); }
  long long wc_off() const { return mats(n_layers) + hidden; }
  long long n_w() const { return mats(n_layers) + hidden + (n_head > 0 ? 3LL * hidden : 0); }
  int b_off(int k) const { return k < n_base ? k * hidden : (k - 1) * hidden + 1; }
  int bd_off() const { return n_base * hidden; }
  int bc_off() const { return (n_layers - 1) * hidden + 1; }
  int ldh() const { return align_up(hidden, 8); }  // an activation's row stride
  int ldx() const { return align_up(d_in, 8); }    // x's bf16 copy's
  int ld_in(int k) const { return k == 0 ? ldx() : ldh(); }
  // Scratch floats a row of a chunk. bfloat16: a_1 .. a_L and x as bf16
  // operands; backward: two bf16 cotangents and the heads' four (f32).
  // float32: a_1 .. a_L; backward: two f32 cotangents and the heads' four.
  long long row_floats(bool bf16, bool backward) const {
    if (bf16) {
      return (static_cast<long long>(n_layers) * ldh() + ldx() + (backward ? 2LL * ldh() : 0)) / 2 +
             (backward ? 4 : 0);
    }
    return static_cast<long long>(n_layers) * ldh() + (backward ? 2LL * ldh() + 4 : 0);
  }
  // The backward's workspace: kWsFloats, and at least one row of the
  // largest dW; as many row splits of a dW as it holds. It also holds the
  // heads' gradients' splits and a cotangent's per-tile partial sums.
  long long ws_floats(bool backward) const {
    if (!backward) return 0;
    return std::max(kWsFloats, static_cast<long long>(hidden) * std::max(std::max(d_in, hidden), 4) +
                                   hidden);
  }
  // bfloat16: the weights' bf16 copies, W_k [hidden][ld_in(k)] and for the
  // backward W_k^T [in_dim(k)][ldh] (floats; each a multiple of 4).
  long long wb_floats(int k) const { return static_cast<long long>(hidden) * ld_in(k) / 2; }
  long long wt_floats(int k) const { return static_cast<long long>(in_dim(k)) * ldh() / 2; }
  long long copy_floats(bool bf16, bool backward) const {
    long long n = 0;
    for (int k = 0; bf16 && k < n_layers; ++k) n += wb_floats(k) + (backward ? wt_floats(k) : 0);
    return n;
  }
  // Scratch floats beside the rows: the workspace, then the copies.
  long long fixed_floats(bool bf16, bool backward) const {
    return ws_floats(backward) + copy_floats(bf16, backward);
  }
};

// Dynamic shared memory of a product block.
int smem_bytes(bool bf16) { return bf16 ? kWgSmem + kRedBytes : kF32Smem; }

// ------------------------------------------------ bfloat16: wg_kernel

template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d[64] += A x B over k16, m64n128, A and B in shared memory: both K-major
// (kT = 0) or both MN-major (kT = 1).
template <int kT>
__device__ __forceinline__ void wgmma128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %66, %66;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "n"(kT), "r"(1));
}

// The operands' shared-memory layout: wgmma's 128-byte swizzle, in 1024-byte
// atoms of 8 rows of 128 bytes whose 16-byte chunks sit at chunk ^ (row &
// 7) (the address's bits 4-6 XOR its bits 7-9; stages are 1024-aligned).
constexpr uint64_t kSwizzle128 = 1ULL << 62;
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// A K-major stage: rows [r0, r0 + 128) by depth [k0, k0 + 64) of a
// row-major bf16 source (row stride ld), zero from row r_end and depth
// k_end (a multiple of 8) on, by cp.async: row r's 8 chunks of 8 elements
// in its 128-byte row of the swizzled layout. Eight neighbouring threads
// copy one row: 128 bytes read together, and no bank conflict.
__device__ __forceinline__ void load_kmajor(uint32_t dst, const __nv_bfloat16* src, long long ld,
                                            long long r0, long long r_end, long long k0,
                                            long long k_end) {
#pragma unroll
  for (int q = 0; q < kBM * kBK / 8 / 256; ++q) {
    const int e = threadIdx.x + 256 * q, r = e >> 3, c = e & 7;
    const long long gr = r0 + r, k = k0 + 8 * c;
    const bool ok = gr < r_end && k < k_end;
    cp_async16(dst + sw128(r, c), ok ? src + gr * ld + k : src, ok ? 16 : 0);
  }
}

// An MN-major stage: depth rows [k0, k0 + 64) by columns [c0, c0 + 128) of
// a row-major bf16 source, zero from row k_end and column c_end (a multiple
// of 8) on: two atom columns of 64 columns (8192 bytes apart), depth row k
// of each the 128-byte row k of the swizzled layout.
__device__ __forceinline__ void load_mnmajor(uint32_t dst, const __nv_bfloat16* src, long long ld,
                                             long long k0, long long k_end, long long c0,
                                             long long c_end) {
#pragma unroll
  for (int q = 0; q < kBK * kBN / 8 / 256; ++q) {
    const int e = threadIdx.x + 256 * q, half = e >> 9, k = (e >> 3) & 63, c = e & 7;
    const long long gk = k0 + k, col = c0 + 64 * half + 8 * c;
    const bool ok = gk < k_end && col < c_end;
    cp_async16(dst + half * 8192 + sw128(k, c), ok ? src + gk * ld + col : src, ok ? 16 : 0);
  }
}

// Where element i of a thread's m64n128 accumulator sits in the block's
// 128 x 128 tile: warpgroup w has rows 64 w .. 64 w + 63.
__device__ __forceinline__ int acc_row(int i) {
  return (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) +
         8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) { return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1); }

// One bf16 product (see the modes above): C[M][N] = sum over K of A B.
// Modes 0, 1: A = a[row][k] (the layer's input or gz), B[k][n] = b[n][k]
// (W_k or W_k^T), both K-major, K = `depth`; mode 2: A[j][n] = a[n][j] (gz),
// B[n][i] = b[n][i] (the layer's input), both MN-major, K = the split's rows.
struct WgProd {
  const __nv_bfloat16* a;
  const __nv_bfloat16* b;
  long long lda, ldb;
  long long m;  // rows of C (0, 1: the chunk's rows; 2: hidden)
  int n;        // columns of C with values (0: hidden; 1: the layer's input width; 2: its dW's)
  long long depth;  // 0, 1: the reduction depth (a multiple of 8, zero past the widths)
  int a_cols, b_cols;  // 2: the sources' padded widths (multiples of 8)
  long long rows, split_rows, split_stride;  // 2: reduction rows, rows a split, workspace row floats
  int col_tiles;     // tiles along C's columns (the fast index of a tile's number)
  long long tiles;   // tiles of C
  // Epilogues. 0: out = a_{k+1} as operands, [m][ldo], zero from column n
  // to ldo; 1: out = the masked cotangent (as 0), or dx (f32, [m][n]); 2:
  // ws, the workspace rows.
  void* out;
  long long ldo;
  const float* bias;   // 0: the bias (or null)
  const float* hd;     // 0: head_dir, a row a ray (or null)
  const __nv_bfloat16* mask;  // 1: the layer input whose ReLU gates the cotangent (null: dx)
  const float* gd;     // 1: the heads' cotangents [rows][4], gz_d at column 0 (null: none)
  const float* wd;     // 1: w_d
  float* part;         // 1: the cotangent's per-tile partial sums (see cot_epilogue)
  float* dhd;          // 1: the chunk's dhead_dir rows (ray sums)
  int num_samples;
};

// A 128 x 128 bf16 tile through shared memory, so that global memory is
// read and written 16 bytes a thread, a row's 256 bytes by 16 neighbouring
// threads: rows of 256 bytes whose 16-byte chunks sit at chunk ^ (row & 7),
// where neither those copies nor the accumulator layout's element pairs
// meet a bank conflict; 32 KB, one stage of the ring. tile_in: rows [row0,
// row0 + 128) and columns [col0, col0 + 128) of src (row stride ld), zero
// past m rows and ld columns; tile_out: the tile into dst's rows below m
// and columns below ld.
__device__ __forceinline__ int tile_off(int r, int chunk) { return r * 256 + ((chunk ^ (r & 7)) << 4); }
__device__ __forceinline__ void tile_in(char* t, const __nv_bfloat16* src, long long ld,
                                        long long m, long long row0, int col0) {
#pragma unroll
  for (int q = 0; q < kBM * kBN / 8 / 256; ++q) {
    const int e = threadIdx.x + 256 * q, r = e >> 4, ch = e & 15;
    const long long gr = row0 + r, gc = col0 + 8 * ch;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gr < m && gc < ld) v = *reinterpret_cast<const uint4*>(src + gr * ld + gc);
    *reinterpret_cast<uint4*>(t + tile_off(r, ch)) = v;
  }
}
__device__ __forceinline__ void tile_out(const char* t, __nv_bfloat16* dst, long long ld,
                                         long long m, long long row0, int col0) {
#pragma unroll
  for (int q = 0; q < kBM * kBN / 8 / 256; ++q) {
    const int e = threadIdx.x + 256 * q, r = e >> 4, ch = e & 15;
    const long long gr = row0 + r, gc = col0 + 8 * ch;
    if (gr < m && gc < ld) {
      *reinterpret_cast<uint4*>(dst + gr * ld + gc) = *reinterpret_cast<const uint4*>(t + tile_off(r, ch));
    }
  }
}
// Accumulator element i's pair (i even) in the tile.
__device__ __forceinline__ int pair_off(int i) {
  const int r = acc_row(i), c = acc_col(i);
  return tile_off(r, c >> 3) + (c & 7) * 2;
}
__device__ __forceinline__ float2 tile_pair(const char* t, int i) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t + pair_off(i)));
}

// A cotangent tile g (in the accumulator layout, 0 at rows past m and
// columns past n) into `out` as bf16 operands (row stride ldo), staged in
// shared memory at `t`, with (kSums 1) the tile's column sums of the
// unrounded values into row `tile` of part [tiles][ldo], summed over 16-row
// warps by shuffles, then over the 8 warps in order (in `red`); or (kSums 2)
// each ray's sum over the tile's rows in row order (an f32 tile at `t`,
// 66 KB, first): into dhd for a ray inside the tile, else into part
// [tiles][2][ldo], slot 0 for the ray of the tile's first row and 1 for
// that of its last (`ray_fix_kernel` adds a ray's slots in tile order).
// The block's threads are done with `t` and `red`.
template <int kSums>
__device__ __forceinline__ void cot_epilogue(float (&g)[64], __nv_bfloat16* out, long long ldo,
                                             long long m, int n, long long row0, int col0,
                                             float* part, float* dhd, int num_samples, char* t,
                                             float* red) {
  const long long tile = row0 / kBM;
  if constexpr (kSums == 2) {
    // Each half of the threads sums a column over one 64-row half of the
    // tile; the ray with rows in both halves (if any) is half 0's sum plus
    // half 1's, after a barrier.
    float* const ft = reinterpret_cast<float*>(t);
    float* const mid = ft + kBM * kTileStride;
#pragma unroll
    for (int i = 0; i < 64; ++i) ft[acc_row(i) * kTileStride + acc_col(i)] = g[i];
    __syncthreads();
    const int th = threadIdx.x & (kBN - 1), half = threadIdx.x / kBN, c = col0 + th;
    const long long end = min(m, row0 + kBM), S = num_samples, first = row0 / S;
    const long long h0 = row0 + 64 * half, h1 = min(end, h0 + 64);
    const long long both = row0 + 64 < end && (row0 + 63) / S == (row0 + 64) / S
                               ? (row0 + 64) / S : -1;
    auto put = [&](long long ray, float s) {
      if (ray * S >= row0 && (ray + 1) * S <= end) {
        dhd[ray * n + c] = s;
      } else {
        part[(tile * 2 + (ray == first ? 0 : 1)) * ldo + c] = s;
      }
    };
    float held = 0.0f;
    if (c < n && h0 < h1) {
      long long r = h0;
      for (long long ray = h0 / S; ray <= (h1 - 1) / S; ++ray) {
        const long long stop = min(h1, (ray + 1) * S);
        float s = 0.0f;
        for (; r < stop; ++r) s += ft[(r - row0) * kTileStride + th];
        if (ray != both) {
          put(ray, s);
        } else if (half == 0) {
          mid[th] = s;
        } else {
          held = s;
        }
      }
    }
    __syncthreads();
    if (half == 1 && both >= 0 && c < n) put(both, mid[th] + held);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    *reinterpret_cast<uint32_t*>(t + pair_off(i)) = pack_bf16(g[i], g[i + 1]);
  }
  if constexpr (kSums == 1) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = g[4 * q + e] + g[4 * q + 2 + e];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane < 4) red[warp * kBN + 8 * q + 2 * lane + e] = s;
      }
    }
  }
  __syncthreads();
  tile_out(t, out, ldo, m, row0, col0);
  if constexpr (kSums == 1) {
    const int th = threadIdx.x;
    if (th < kBN && col0 + th < ldo) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[w * kBN + th];
      part[tile * ldo + col0 + th] = s;
    }
  }
}

// 128 x 128 tiles of one product (kMode; kSums: mode 1's sums, as
// cot_epilogue's, 0 for dx). Two warpgroups, each a 64-row half of a tile
// on wgmma m64n128k16; the 256 threads fill a ring of kWgStages stages by
// cp.async, two ahead of the products. Modes 0 and 1 (but for the ray sums)
// walk tiles blockIdx.x, + gridDim.x, ... as one stream of stages, so that
// the next tile's first stages load while a tile's last products and its
// epilogue run, the epilogue staging its tiles in the ring's stage that its
// last products freed; mode 2 (a split of the rows a block) and the ray
// sums (whose f32 tile takes the whole ring) take one tile a block.
template <int kMode, int kSums>
__global__ void __launch_bounds__(256, 2) wg_kernel(const __grid_constant__ WgProd p) {
  extern __shared__ __align__(1024) char lay_smem[];
  const uint32_t s0 = smem_u32(lay_smem);
  const int wg = threadIdx.x >> 7;
  long long k_begin = 0, k_end = p.depth;
  if constexpr (kMode == 2) {
    k_begin = blockIdx.y * p.split_rows;
    k_end = min(p.rows, k_begin + p.split_rows);
  }
  const int nk = static_cast<int>((k_end - k_begin + kBK - 1) / kBK);
  const long long total =
      (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * static_cast<long long>(nk);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  // The block's stream of stages: tile blockIdx.x, + gridDim.x, ..., nk
  // depth steps each, in ring slots 0, 1, 2, 0, ...; the loads' position in
  // it and the products' (counters, no division).
  long long ld_tile = blockIdx.x, tile = blockIdx.x;
  int ld_kt = 0, ld_slot = 0, kt = 0, slot = 0;
  auto load_next = [&]() {
    const int col0 = static_cast<int>(ld_tile % p.col_tiles) * kBN;
    const long long row0 = ld_tile / p.col_tiles * kBM;
    const uint32_t sa = s0 + ld_slot * kStageBytes, sb = sa + kBM * kBK * 2;
    const long long k0 = k_begin + static_cast<long long>(ld_kt) * kBK;
    if constexpr (kMode == 2) {
      load_mnmajor(sa, p.a, p.lda, k0, k_end, row0, p.a_cols);
      load_mnmajor(sb, p.b, p.ldb, k0, k_end, col0, p.b_cols);
    } else {
      load_kmajor(sa, p.a, p.lda, row0, p.m, k0, k_end);
      load_kmajor(sb, p.b, p.ldb, col0, p.n, k0, k_end);
    }
    ld_slot = ld_slot + 1 == kWgStages ? 0 : ld_slot + 1;
    if (++ld_kt == nk) {
      ld_kt = 0;
      ld_tile += gridDim.x;
    }
  };
  constexpr int kAhead = kWgStages - 1;
#pragma unroll
  for (int t = 0; t < kAhead; ++t) {
    if (t < total) load_next();
    cp_async_commit();
  }
  fence_regs<64>(acc);
  for (long long q = 0; q < total; ++q) {
    cp_async_wait_n<kAhead - 1>();
    fence_async_smem();  // the copies, visible to wgmma's reads
    __syncthreads();     // every thread's copies of stage q; stage q - 1's products done
    if (q + kAhead < total) load_next();
    cp_async_commit();
    const uint32_t sa = s0 + slot * kStageBytes, sb = sa + kBM * kBK * 2;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      if constexpr (kMode == 2) {
        // MN-major atoms: 64 columns (8192 bytes apart) by 8 depth rows
        // (1024 bytes apart); a k16 step is two atoms down.
        wgmma128<1>(acc, make_desc(sa + wg * 8192 + kc * 2048, 8192, 1024) | kSwizzle128,
                    make_desc(sb + kc * 2048, 8192, 1024) | kSwizzle128);
      } else {
        // K-major atoms: 8 rows (1024 bytes apart) by the stage's 64 depth; a
        // k16 step is 32 bytes along the rows.
        wgmma128<0>(acc, make_desc(sa + wg * 8192 + kc * 32, 16, 1024) | kSwizzle128,
                    make_desc(sb + kc * 32, 16, 1024) | kSwizzle128);
      }
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs<64>(acc);
    const int done_slot = slot;
    slot = slot + 1 == kWgStages ? 0 : slot + 1;
    if (++kt != nk) continue;
    kt = 0;
    // The tile's epilogue, in the stage its last products read (the next
    // stage to load into it is q + kWgStages, after the next barrier).
    const int col0 = static_cast<int>(tile % p.col_tiles) * kBN;
    const long long row0 = tile / p.col_tiles * kBM;
    tile += gridDim.x;
    char* const t = lay_smem + done_slot * kStageBytes;
    if constexpr (kMode == 2) {
      float* ws = static_cast<float*>(p.out) + blockIdx.y * p.split_stride;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const long long j = row0 + acc_row(i);
        const int c = col0 + acc_col(i);
        if (j < p.m && c < p.n) ws[j * p.n + c] = acc[i];
      }
    } else if constexpr (kMode == 0) {
      // The tile's bias in shared memory (past the ring), or head_dir's row
      // of the ray of each of the thread's two rows.
      float* const sb = reinterpret_cast<float*>(lay_smem + kWgSmem);
      const float* hd_row[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = min(row0 + acc_row(2 * h), p.m - 1);
        hd_row[h] = p.hd != nullptr ? p.hd + gen::ray_of(r, p.num_samples) * p.n : nullptr;
      }
      if (p.hd == nullptr && threadIdx.x < kBN) {
        sb[threadIdx.x] = col0 + threadIdx.x < p.n ? __ldg(p.bias + col0 + threadIdx.x) : 0.0f;
      }
      __syncthreads();  // the bias in; both warpgroups' products done with the stage
      const bool one_ray = hd_row[0] == hd_row[1];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        // Columns c, c + 1 of the thread's two rows: elements 4q + 2h + e.
        const int c = col0 + acc_col(4 * q);
        float add[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ce = c + e;
          if (p.hd == nullptr) {
            add[0][e] = add[1][e] = sb[ce - col0];
          } else {
            add[0][e] = ce < p.n ? __ldg(hd_row[0] + ce) : 0.0f;
            add[1][e] = one_ray ? add[0][e] : ce < p.n ? __ldg(hd_row[1] + ce) : 0.0f;
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * q + 2 * h;
          const long long r = row0 + acc_row(i);
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            v[e] = r < p.m && c + e < p.n ? fmaxf(acc[i + e] + add[h][e], 0.0f) : 0.0f;
          }
          *reinterpret_cast<uint32_t*>(t + pair_off(i)) = pack_bf16(v[0], v[1]);
        }
      }
      __syncthreads();
      tile_out(t, static_cast<__nv_bfloat16*>(p.out), p.ldo, p.m, row0, col0);
    } else {
      char* const ring_t = kSums == 2 ? lay_smem : t;
      if constexpr (kSums == 2) cp_async_wait_n<0>();  // one tile a block: the ring is free
      __syncthreads();
      // The density head's cotangent of the thread's two rows, and the
      // tile's w_d (past the ring), where it joins a_nb's.
      float gd[2] = {0.0f, 0.0f};
      float* const swd = reinterpret_cast<float*>(lay_smem + kWgSmem);
      if (p.gd != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = row0 + acc_row(2 * h);
          gd[h] = r < p.m ? bfr(p.gd[r * 4]) : 0.0f;
        }
        if (threadIdx.x < kBN) {
          swd[threadIdx.x] = col0 + threadIdx.x < p.n ? bfr(__ldg(p.wd + col0 + threadIdx.x)) : 0.0f;
        }
      }
      if (p.mask != nullptr) tile_in(ring_t, p.mask, p.ldo, p.m, row0, col0);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const long long r = row0 + acc_row(i);
        const int c = col0 + acc_col(i);
        const float2 mk = p.mask != nullptr ? tile_pair(ring_t, i) : make_float2(1.0f, 1.0f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = acc[i + e];
          if (r >= p.m || c + e >= p.n) {
            v = 0.0f;
          } else {
            if (p.gd != nullptr) v += gd[(i >> 1) & 1] * swd[c + e - col0];
            if (!((e ? mk.y : mk.x) > 0.0f)) v = 0.0f;
          }
          acc[i + e] = v;
        }
      }
      if constexpr (kSums == 0) {  // dx, f32
        float* dx = static_cast<float*>(p.out);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const long long r = row0 + acc_row(i);
          const int c = col0 + acc_col(i);
          if (r < p.m && c < p.n) dx[r * p.n + c] = acc[i];
        }
      } else {
        __syncthreads();  // done with the mask's tile
        cot_epilogue<kSums>(acc, static_cast<__nv_bfloat16*>(p.out), p.ldo, p.m, p.n, row0, col0,
                            p.part, p.dhd, p.num_samples, ring_t,
                            reinterpret_cast<float*>(lay_smem + kWgSmem));
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    fence_regs<64>(acc);
  }
}

// The heads' cotangent into a_L as a bf16 cotangent, masked where a_L <=
// 0: the colour head's sum_c gz_c[n][c] W_c[c][j], or (no colour head: a_L
// is a_nb) the density head's gz_d[n] w_d[j]; a block a 128 x 128 tile in
// wg_kernel's accumulator layout (a_L's tile staged in shared memory),
// then cot_epilogue's sums.
template <int kSums>
__global__ void __launch_bounds__(256) top_tile_kernel(const float* g, const float* w, int colour,
                                                       const __nv_bfloat16* a_top, long long ld,
                                                       int hidden, long long rows, int col_tiles,
                                                       __nv_bfloat16* dz, float* part, float* dhd,
                                                       int num_samples) {
  extern __shared__ __align__(1024) char lay_smem[];
  const int col0 = static_cast<int>(blockIdx.x % col_tiles) * kBN;
  const long long row0 = static_cast<long long>(blockIdx.x / col_tiles) * kBM;
  char* const mt = lay_smem;
  tile_in(mt, a_top, ld, rows, row0, col0);
  // The tile's columns of W_c (or w_d) as operands, past the ring.
  float* const sw = reinterpret_cast<float*>(lay_smem + kWgSmem);
  if (threadIdx.x < kBN) {
    const int j = col0 + threadIdx.x;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sw[c * kBN + threadIdx.x] = j < hidden && (colour || c == 0) ? bfr(__ldg(w + c * hidden + j)) : 0.0f;
    }
  }
  // The thread's two rows (acc_row's two) and their heads' cotangents.
  long long n[2];
  float4 q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    n[h] = row0 + acc_row(2 * h);
    q[h] = n[h] < rows ? *reinterpret_cast<const float4*>(g + n[h] * 4)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    q[h] = make_float4(bfr(q[h].x), bfr(q[h].y), bfr(q[h].z), bfr(q[h].w));
  }
  __syncthreads();
  float v[64];
#pragma unroll
  for (int t = 0; t < 16; ++t) {
    const int jt = acc_col(4 * t);  // the tile's column, even
    float wj[2][3];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int c = 0; c < 3; ++c) wj[e][c] = sw[c * kBN + jt + e];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 a = tile_pair(mt, 4 * t + 2 * h);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = colour ? fmaf(q[h].w, wj[e][2], fmaf(q[h].z, wj[e][1], q[h].y * wj[e][0]))
                         : q[h].x * wj[e][0];
        if (n[h] >= rows || !((e ? a.y : a.x) > 0.0f)) s = 0.0f;
        v[4 * t + 2 * h + e] = s;
      }
    }
  }
  __syncthreads();  // done with a_L's tile
  cot_epilogue<kSums>(v, dz, ld, rows, hidden, row0, col0, part, dhd, num_samples, lay_smem,
                      reinterpret_cast<float*>(lay_smem + kWgSmem));
}

// dhead_dir of the rays that no one tile holds whole: the sum of each of
// their tiles' slots (cot_epilogue), in tile order.
__global__ void __launch_bounds__(256) ray_fix_kernel(const float* part, long long ldp, int hidden,
                                                      int rays, int num_samples, float* dhd) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= static_cast<long long>(rays) * hidden) return;
  const long long r = e / hidden;
  const int j = static_cast<int>(e - r * hidden);
  const long long S = num_samples, t0 = r * S / kBM, t1 = ((r + 1) * S - 1) / kBM;
  if (t0 == t1) return;
  float s = 0.0f;
  for (long long t = t0; t <= t1; ++t) s += part[(t * 2 + (t * kBM / S == r ? 0 : 1)) * ldp + j];
  dhd[e] = s;
}

// dst[r][c] = src[r][c] as bf16 for c < cols, 0 for cols <= c < ldd.
__global__ void __launch_bounds__(256) cast_kernel(const float* src, long long lds, int cols,
                                                   long long rows, int ldd, __nv_bfloat16* dst) {
  const long long n = rows * ldd;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n; e += 256LL * gridDim.x) {
    const long long r = e / ldd;
    const int c = static_cast<int>(e - r * ldd);
    dst[e] = __float2bfloat16(c < cols ? __ldg(src + r * lds + c) : 0.0f);
  }
}

// dst[c][r] = src[r][c] as bf16: a [rows][cols] f32 matrix into [cols][ldd]
// (0 for rows <= r < ldd).
__global__ void __launch_bounds__(256) transpose_cast_kernel(const float* src, int rows, int cols,
                                                             int ldd, __nv_bfloat16* dst) {
  const long long n = static_cast<long long>(cols) * ldd;
  for (long long e = blockIdx.x * 256LL + threadIdx.x; e < n; e += 256LL * gridDim.x) {
    const long long c = e / ldd;
    const int r = static_cast<int>(e - c * ldd);
    dst[e] = __float2bfloat16(r < rows ? __ldg(src + r * static_cast<long long>(cols) + c) : 0.0f);
  }
}

// ------------------------------------------------ float32: prod_kernel

// One f32 product and its epilogue (see the modes above). Element (n, c) of
// a row-major source is at p + n * ld + c.
struct Prod {
  const float* a;     // 0: the layer's input; 1, 2: the cotangent gz
  const float* b;     // 2: the layer's input
  const float* w;     // 0, 1: the weight matrix [m][k] (row stride k)
  const float* bias;  // 0: the bias (or null)
  const float* hd;    // 0: head_dir, a row a ray (or null)
  const float* mask;  // 1: the layer input whose ReLU gates the cotangent (null: none)
  const float* gd;    // 1: the heads' cotangents [rows][4], gz_d at column 0 (null: none)
  const float* wd;    // 1: w_d
  float* out;         // 0: a_{k+1}; 1: the cotangent (or dx); 2: the workspace
  long long rows;     // 0, 1: output rows; 2: reduction rows
  long long lda, ldb, ldo, ldm;
  int m, k;  // 0: out m, reduction k; 1: reduction m, out k; 2: out [m][k]
  int num_samples;
  int col_tiles;            // tiles along the output's columns (the 1-D grid's fast index)
  long long split_rows;     // 2: rows a split (a multiple of kTK)
  long long split_stride;   // 2: floats of a workspace row
};

// Rows [r0, r0 + R) and columns [c0, c0 + C) of a row-major f32 source
// into shared memory (row stride st floats) by cp.async, zero from row
// r_end and column c_end on: 16 bytes a copy where the source's rows are
// 16-byte aligned (`vec`) and the copy lies wholly inside or outside the
// columns, else 4.
template <int R, int C>
__device__ __forceinline__ void stage_f32(uint32_t dst, int st, const float* src, long long ld,
                                          long long r0, long long r_end, long long c0,
                                          long long c_end, bool vec) {
  constexpr int G = C / 4;
#pragma unroll
  for (int q = 0; q < R * G / (kWarps * 32); ++q) {
    const int e = threadIdx.x + kWarps * 32 * q;
    const int r = e / G, c = 4 * (e % G);
    const long long gr = r0 + r, gc = c0 + c;
    const uint32_t d = dst + (r * st + c) * 4;
    if (gr >= r_end || gc >= c_end || (vec && gc + 4 <= c_end)) {
      const bool ok = gr < r_end && gc < c_end;
      cp_async16(d, ok ? src + gr * ld + gc : src, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = gc + q < c_end;
        gen::cp_async4(d + 4 * q, ok ? src + gr * ld + gc + q : src, ok ? 4 : 0);
      }
    }
  }
}

template <int kMode>
__global__ void __launch_bounds__(kWarps * 32, 2) prod_kernel(const __grid_constant__ Prod p) {
  // A: [kTM][kTK] (modes 0, 1) or [kTK][kTM] (2, gz^T); B: W's [kTN][kTK]
  // (0), W's [kTK][kTN] (1) or the input's [kTK][kTN] (2); rows padded by
  // 16 bytes.
  constexpr int sa = kMode == 2 ? kTM + 4 : kTK + 4;
  constexpr int sb = kMode == 0 ? kTK + 4 : kTN + 4;
  constexpr int a_bytes = (kMode == 2 ? kTK * sa : kTM * sa) * 4;
  constexpr int stage_bytes = a_bytes + (kMode == 0 ? kTN * sb : kTK * sb) * 4;
  static_assert(stage_bytes <= kF32StageBytes, "a stage fits the ring");
  extern __shared__ __align__(1024) char lay_smem[];
  const uint32_t s0 = smem_u32(lay_smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long tile = blockIdx.x;
  const int col0 = static_cast<int>(tile % p.col_tiles) * kTN;
  const long long row0 = tile / p.col_tiles * kTM;  // modes 0, 1: rows; 2: rows of dW (j)
  const bool va = (p.lda & 3) == 0 && (reinterpret_cast<uintptr_t>(p.a) & 15) == 0;
  const bool vb = kMode == 2 ? (p.ldb & 3) == 0 && (reinterpret_cast<uintptr_t>(p.b) & 15) == 0
                             : (p.k & 3) == 0 && (reinterpret_cast<uintptr_t>(p.w) & 15) == 0;
  long long k_begin = 0, k_end = kMode == 0 ? p.k : p.m;
  if constexpr (kMode == 2) {
    k_begin = blockIdx.y * p.split_rows;
    k_end = min(p.rows, k_begin + p.split_rows);
  }
  const int nk = static_cast<int>((k_end - k_begin + kTK - 1) / kTK);
  auto load = [&](int t) {
    const uint32_t as = s0 + (t % kStages) * kF32StageBytes, bs = as + a_bytes;
    const long long k0 = k_begin + static_cast<long long>(t) * kTK;
    if constexpr (kMode == 2) {
      stage_f32<kTK, kTM>(as, sa, p.a, p.lda, k0, k_end, row0, p.m, va);
      stage_f32<kTK, kTN>(bs, sb, p.b, p.ldb, k0, k_end, col0, p.k, vb);
    } else {
      stage_f32<kTM, kTK>(as, sa, p.a, p.lda, row0, p.rows, k0, k_end, va);
      if constexpr (kMode == 0) {
        stage_f32<kTN, kTK>(bs, sb, p.w, p.k, col0, p.m, k0, k_end, vb);
      } else {
        stage_f32<kTK, kTN>(bs, sb, p.w, p.k, k0, k_end, col0, p.k, vb);
      }
    }
  };
  // Exact f32 chain: fma_pass's layout (rows rh + 2i, columns c + 16j); else
  // the mma layout (rows g + 8 (e >> 1), columns 8j + 2t + (e & 1)).
  constexpr bool kFma = kMode == 0;
  float acc[8][4];
  gen::zero(acc);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nk) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait_n<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < nk) load(t + kStages - 1);
    cp_async_commit();
    const uint32_t as = s0 + (t % kStages) * kF32StageBytes, bs = as + a_bytes;
    if constexpr (kMode == 2) {
      gen::mma_pass<false, true, true>(as + warp * 16 * 4, sa, bs, sb, kTK, 8, acc);
    } else if constexpr (kFma) {
      gen::fma_pass(reinterpret_cast<const float*>(lay_smem + (as - s0)) + warp * 16 * sa, sa,
                    reinterpret_cast<const float*>(lay_smem + (bs - s0)), sb, kTK, kTN, acc);
    } else {
      gen::mma_pass<false, false, true>(as + warp * 16 * sa * 4, sa, bs, sb, kTK, 8, acc);
    }
  }
  cp_async_wait_n<0>();
  if constexpr (kMode == 2) {
    float* ws = p.out + blockIdx.y * p.split_stride;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long r = row0 + warp * 16 + g + 8 * (e >> 1);
        const int c = col0 + 8 * j + 2 * t + (e & 1);
        if (r < p.m && c < p.k) ws[r * p.k + c] = acc[j][e];
      }
    }
    return;
  }
  const int out_cols = kMode == 0 ? p.m : p.k;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = kFma ? (lane >> 4) + 2 * j : (lane >> 2) + 8 * (e >> 1);
      const int c = col0 + (kFma ? (lane & 15) + 16 * e : 8 * j + 2 * (lane & 3) + (e & 1));
      const long long n = row0 + warp * 16 + r;
      if (n >= p.rows || c >= out_cols) continue;
      const float v = acc[j][e];
      if constexpr (kMode == 0) {
        const float add = p.hd != nullptr ? p.hd[gen::ray_of(n, p.num_samples) * p.m + c] : p.bias[c];
        p.out[n * p.ldo + c] = fmaxf(v + add, 0.0f);
      } else {
        float g = v;
        if (p.gd != nullptr) g += p.gd[n * 4] * p.wd[c];
        if (p.mask != nullptr && !(p.mask[n * p.ldm + c] > 0.0f)) g = 0.0f;
        p.out[n * p.ldo + c] = g;
      }
    }
  }
}

// The heads' cotangent into a_L (float32), masked where a_L <= 0: the
// colour head's sum_c gz_c[n][c] W_c[c][j], or (no colour head: a_L is
// a_nb) the density head's gz_d[n] w_d[j]. A thread an element.
__global__ void __launch_bounds__(256) top_kernel(const float* g, const float* w, int colour,
                                                  const float* a_top, long long ld, int hidden,
                                                  long long rows, float* dz) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= rows * hidden) return;
  const long long n = e / hidden;
  const int j = static_cast<int>(e - n * hidden);
  float v;
  if (colour) {
    v = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) v = fmaf(g[n * 4 + 1 + c], __ldg(w + c * hidden + j), v);
  } else {
    v = g[n * 4] * __ldg(w + j);
  }
  dz[n * ld + j] = a_top[n * ld + j] > 0.0f ? v : 0.0f;
}

// out[z][j] = sum over split z's rows of g[n][j], in row order: a float32
// cotangent's column sums (its bias gradient), a thread a column.
__global__ void __launch_bounds__(256) colsum_kernel(const float* g, long long ld, int cols,
                                                     long long rows, long long split_rows,
                                                     float* out) {
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= cols) return;
  const long long r0 = blockIdx.y * split_rows, r1 = min(rows, r0 + split_rows);
  float s = 0.0f;
#pragma unroll 4
  for (long long n = r0; n < r1; ++n) s += __ldg(g + n * ld + j);
  out[blockIdx.y * static_cast<long long>(cols) + j] = s;
}

// dhead_dir[r][j] = sum over ray r's samples of gz_bh[n][j], in sample
// order (float32).
__global__ void __launch_bounds__(256) raysum_kernel(const float* dz, long long ld, int hidden,
                                                     int rays, int num_samples, float* out) {
  const long long e = blockIdx.x * 256LL + threadIdx.x;
  if (e >= static_cast<long long>(rays) * hidden) return;
  const long long r = e / hidden;
  const int j = static_cast<int>(e - r * hidden);
  const float* src = dz + r * num_samples * ld + j;
  float s = 0.0f;
  for (int i = 0; i < num_samples; ++i) s += __ldg(src + i * ld);
  out[e] = s;
}

// ------------------------------------------------ both dtypes

// The heads on a warp a row. Forward: density (softplus of pre_d) and, with
// the colour head, rgb (sigmoid of pre_c). Backward: their cotangents g
// [rows][4]: gz_d = g_dens sigmoid(pre_d), gz_c = g_rgb rgb (1 - rgb).
struct Heads {
  const char* a_nb;   // a_nb rows (operands)
  const char* a_top;  // a_L rows (the colour head's input)
  long long ld, rows;
  int hidden;
  const float *wd, *bd, *wc, *bc;  // wc null: no colour head
  float *rgb, *dens;               // forward (null in the backward)
  const float *g_rgb, *g_dens;     // backward
  float* g;
};

// Two neighbouring operands of a row (p 4- or 8-byte aligned).
template <bool kBf16>
__device__ __forceinline__ void ld_pair(const char* p, float (&v)[2]) {
  if constexpr (kBf16) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x, v[1] = f.y;
  } else {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(256) heads_kernel(const __grid_constant__ Heads h) {
  constexpr int es = kBf16 ? 2 : 4;
  const long long n = blockIdx.x * 8LL + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31, H = h.hidden;
  if (n >= h.rows) return;
  const char* an = h.a_nb + n * h.ld * es;
  const char* at = h.a_top + n * h.ld * es;
  // Two columns a lane (j + 1 < ld: ld is a multiple of 8; past H, 0).
  float pd = 0.0f, pc[3] = {0.0f, 0.0f, 0.0f};
  for (int j = 2 * lane; j < H; j += 64) {
    float an2[2], wd2[2];
    ld_pair<kBf16>(an + j * es, an2);
    if (j + 1 >= H) an2[1] = 0.0f;
    wd2[0] = gen::op<kBf16>(__ldg(h.wd + j));
    wd2[1] = j + 1 < H ? gen::op<kBf16>(__ldg(h.wd + j + 1)) : 0.0f;
    pd = fmaf(an2[1], wd2[1], fmaf(an2[0], wd2[0], pd));
    if (h.wc != nullptr) {
      float at2[2];
      ld_pair<kBf16>(at + j * es, at2);
      if (j + 1 >= H) at2[1] = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float w0 = gen::op<kBf16>(__ldg(h.wc + c * H + j));
        const float w1 = j + 1 < H ? gen::op<kBf16>(__ldg(h.wc + c * H + j + 1)) : 0.0f;
        pc[c] = fmaf(at2[1], w1, fmaf(at2[0], w0, pc[c]));
      }
    }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    pd += __shfl_xor_sync(0xffffffffu, pd, s);
#pragma unroll
    for (int c = 0; c < 3; ++c) pc[c] += __shfl_xor_sync(0xffffffffu, pc[c], s);
  }
  if (lane != 0) return;
  const float pre_d = pd + h.bd[0];
  if (h.dens != nullptr) {
    h.dens[n] = fmaxf(pre_d, 0.0f) + log1pf(expf(-fabsf(pre_d)));
  } else {
    h.g[n * 4] = h.g_dens[n] * sigmoid(pre_d);
  }
  if (h.wc == nullptr) return;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float rgb = sigmoid(pc[c] + h.bc[c]);
    if (h.rgb != nullptr) {
      h.rgb[n * 3 + c] = rgb;
    } else {
      h.g[n * 4 + 1 + c] = h.g_rgb[n * 3 + c] * rgb * (1.0f - rgb);
    }
  }
}

// The heads' weight and bias gradients over split z of the chunk's rows:
// ws[z] = {dW_d [H], dW_c [3][H], db_d, db_c [3]} (no colour head: dW_d and
// db_d), dW = sum_n gz[n] a[n][j] with gz as an operand, db = sum_n gz[n]
// unrounded, in row order. A thread two columns of a_nb and a_L, each row
// read once over the grid.
template <bool kBf16>
__global__ void __launch_bounds__(128) head_grad_kernel(const float* g, const char* a_nb,
                                                        const char* a_top, long long ld,
                                                        int hidden, int colour, long long rows,
                                                        long long split_rows, float* ws,
                                                        long long stride) {
  constexpr int es = kBf16 ? 2 : 4;
  const long long r0 = blockIdx.y * split_rows, r1 = min(rows, r0 + split_rows);
  float* out = ws + blockIdx.y * stride;
  const int j = (blockIdx.x * 128 + threadIdx.x) * 2;  // j + 1 < ld: ld is a multiple of 8
  if (j < hidden) {
    float sd[2] = {0.0f, 0.0f}, sc[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll 4
    for (long long n = r0; n < r1; ++n) {
      const float4 q = *reinterpret_cast<const float4*>(g + n * 4);
      const char* an = a_nb + (n * ld + j) * es;
      const float d = gen::op<kBf16>(q.x);
#pragma unroll
      for (int e = 0; e < 2; ++e) sd[e] = fmaf(d, gen::ld_op<kBf16>(an + e * es), sd[e]);
      if (colour) {
        const char* at = a_top + (n * ld + j) * es;
        const float a0 = gen::ld_op<kBf16>(at), a1 = gen::ld_op<kBf16>(at + es);
        const float gc[3] = {gen::op<kBf16>(q.y), gen::op<kBf16>(q.z), gen::op<kBf16>(q.w)};
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          sc[c][0] = fmaf(gc[c], a0, sc[c][0]);
          sc[c][1] = fmaf(gc[c], a1, sc[c][1]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (j + e >= hidden) continue;
      out[j + e] = sd[e];
      if (colour) {
#pragma unroll
        for (int c = 0; c < 3; ++c) out[(1 + c) * hidden + j + e] = sc[c][e];
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < (colour ? 4 : 1)) {
    float s = 0.0f;
    for (long long n = r0; n < r1; ++n) s += g[n * 4 + threadIdx.x];
    out[4 * hidden + threadIdx.x] = s;
  }
}

// out[i] (+)= sum over splits z of ws[z * stride + i]: a block 32 entries,
// its warp w the splits w, w + 8, w + 16, ... in order, then the 8 warps'
// sums in warp order: the same bits in every launch. Block row y sums the
// splits [y group, (y + 1) group) into out + y n.
__global__ void __launch_bounds__(256) reduce_kernel(const float* ws, long long splits,
                                                     long long stride, long long n, float* out,
                                                     int accumulate, long long group) {
  __shared__ float part[8][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long i = blockIdx.x * 32LL + lane;
  const long long z0 = blockIdx.y * group, z1 = min(splits, z0 + group);
  float s = 0.0f;
  if (i < n) {
#pragma unroll 4
    for (long long z = z0 + w; z < z1; z += 8) s += __ldg(ws + z * stride + i);
  }
  part[w][lane] = s;
  __syncthreads();
  out += blockIdx.y * n;
  if (w == 0 && i < n) {
    float t = accumulate ? out[i] : 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) t += part[q][lane];
    out[i] = t;
  }
}

int blocks_of(long long n) { return static_cast<int>((n + 255) / 256); }

// More than kGroup splits: first each kGroup of them into a row of tmp
// ([groups][n]), then the rows, each pass in a fixed order.
constexpr long long kGroup = 64;
cudaError_t reduce(const float* ws, long long splits, long long stride, long long n, float* out,
                   bool accumulate, cudaStream_t stream, float* tmp) {
  if (n == 0) return cudaSuccess;
  const unsigned cols = static_cast<unsigned>((n + 31) / 32);
  if (splits > kGroup) {
    const long long groups = (splits + kGroup - 1) / kGroup;
    reduce_kernel<<<dim3(cols, static_cast<unsigned>(groups)), 256, 0, stream>>>(
        ws, splits, stride, n, tmp, 0, kGroup);
    ws = tmp, splits = groups, stride = n;
  }
  reduce_kernel<<<cols, 256, 0, stream>>>(ws, splits, stride, n, out, accumulate, splits);
  return cudaGetLastError();
}

// One call of the route: the stack, the row chunks and the scratch.
struct Call {
  Stack s;
  bool bf16;
  int num_samples, num_blocks;
  long long chunk_rows;  // rows_per_chunk x num_samples
  char* scratch;         // the chunk's rows, then the workspace, then the copies
  float* ws;
  __nv_bfloat16* copies;
  cudaStream_t stream;
  int es() const { return bf16 ? 2 : 4; }
  // a_k (1 <= k <= L) of the chunk, operands [chunk_rows][ldh].
  char* act(int k) const { return scratch + (k - 1) * chunk_rows * s.ldh() * es(); }
  // bfloat16: x as operands [chunk_rows][ldx].
  __nv_bfloat16* xb() const { return reinterpret_cast<__nv_bfloat16*>(act(s.n_layers + 1)); }
  // The backward's two cotangents, operands [chunk_rows][ldh].
  char* dz(int i) const {
    char* base = bf16 ? reinterpret_cast<char*>(xb()) + chunk_rows * s.ldx() * 2 : act(s.n_layers + 1);
    return base + i * chunk_rows * s.ldh() * es();
  }
  float* heads_g() const { return reinterpret_cast<float*>(dz(2)); }
  // bfloat16: W_k [hidden][ld_in(k)] and (backward) W_k^T [in_dim(k)][ldh].
  __nv_bfloat16* wb(int k) const {
    long long off = 0;
    for (int i = 0; i < k; ++i) off += s.wb_floats(i);
    return copies + 2 * off;
  }
  __nv_bfloat16* wt(int k) const {
    long long off = 0;
    for (int i = 0; i < s.n_layers; ++i) off += s.wb_floats(i);
    for (int i = 0; i < k; ++i) off += s.wt_floats(i);
    return copies + 2 * off;
  }
};

// Modes 0 and 1 but the ray sums: two blocks an SM, each walking its
// tiles; else a block a tile (and split).
template <int kMode, int kSums>
cudaError_t run_wg(const Call& c, WgProd p, long long out_rows, int out_cols, long long splits) {
  p.col_tiles = (out_cols + kBN - 1) / kBN;
  p.tiles = (out_rows + kBM - 1) / kBM * p.col_tiles;
  if (p.tiles == 0 || splits == 0) return cudaSuccess;
  const bool walk = kMode != 2 && kSums != 2;
  const long long grid = walk ? std::min(p.tiles, 2LL * c.num_blocks) : p.tiles;
  const cudaError_t err = cudaFuncSetAttribute(
      wg_kernel<kMode, kSums>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem + kRedBytes);
  if (err != cudaSuccess) return err;
  wg_kernel<kMode, kSums><<<dim3(static_cast<unsigned>(grid), static_cast<unsigned>(splits)), 256,
                            kWgSmem + kRedBytes, c.stream>>>(p);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t run_f32(Prod p, long long out_rows, int out_cols, long long splits,
                    cudaStream_t stream) {
  p.col_tiles = (out_cols + kTN - 1) / kTN;
  const long long tiles = (out_rows + kTM - 1) / kTM * p.col_tiles;
  if (tiles == 0 || splits == 0) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      prod_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Smem);
  if (err != cudaSuccess) return err;
  prod_kernel<kMode><<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(splits)),
                       kWarps * 32, kF32Smem, stream>>>(p);
  return cudaGetLastError();
}

// The weights' bf16 copies, once a call.
cudaError_t cast_weights(const Call& c, const float* w, bool transposed) {
  const Stack& s = c.s;
  for (int k = 0; k < s.n_layers; ++k) {
    const long long n = static_cast<long long>(s.hidden) * s.ld_in(k);
    cast_kernel<<<static_cast<unsigned>(std::min<long long>(blocks_of(n), 4096)), 256, 0,
                  c.stream>>>(w + s.w_off(k), s.in_dim(k), s.in_dim(k), s.hidden, s.ld_in(k),
                              c.wb(k));
    if (transposed) {
      const long long nt = static_cast<long long>(s.in_dim(k)) * s.ldh();
      transpose_cast_kernel<<<static_cast<unsigned>(std::min<long long>(blocks_of(nt), 4096)), 256,
                              0, c.stream>>>(w + s.w_off(k), s.hidden, s.in_dim(k), s.ldh(),
                                             c.wt(k));
    }
  }
  return cudaGetLastError();
}

// The chain of the chunk's rows: a_1 .. a_L (bfloat16: x cast first).
template <bool kBf16>
cudaError_t chain(const Call& c, const float* x, const float* hd, const float* w, const float* b,
                  long long rows) {
  const Stack& s = c.s;
  if constexpr (kBf16) {
    const long long n = rows * s.ldx();
    cast_kernel<<<static_cast<unsigned>(std::min<long long>(blocks_of(n), 65536)), 256, 0,
                  c.stream>>>(x, s.d_in, s.d_in, rows, s.ldx(), c.xb());
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  for (int k = 0; k < s.n_layers; ++k) {
    const bool bh = s.n_head > 0 && k == s.n_base;
    cudaError_t err;
    if constexpr (kBf16) {
      WgProd p{};
      p.a = k == 0 ? c.xb() : reinterpret_cast<const __nv_bfloat16*>(c.act(k));
      p.lda = s.ld_in(k);
      p.b = c.wb(k);
      p.ldb = s.ld_in(k);
      p.m = rows;
      p.n = s.hidden;
      p.depth = s.ld_in(k);
      p.bias = bh ? nullptr : b + s.b_off(k);
      p.hd = bh ? hd : nullptr;
      p.out = c.act(k + 1);
      p.ldo = s.ldh();
      p.num_samples = c.num_samples;
      err = run_wg<0, 0>(c, p, rows, s.ldh(), 1);
    } else {
      Prod p{};
      p.a = k == 0 ? x : reinterpret_cast<const float*>(c.act(k));
      p.lda = k == 0 ? s.d_in : s.ldh();
      p.w = w + s.w_off(k);
      p.bias = bh ? nullptr : b + s.b_off(k);
      p.hd = bh ? hd : nullptr;
      p.out = reinterpret_cast<float*>(c.act(k + 1));
      p.ldo = s.ldh();
      p.rows = rows;
      p.m = s.hidden;
      p.k = s.in_dim(k);
      p.num_samples = c.num_samples;
      err = run_f32<0>(p, rows, s.hidden, 1, c.stream);
    }
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <bool kBf16>
Heads heads_of(const Call& c, const float* w, const float* b, long long rows) {
  const Stack& s = c.s;
  Heads h{};
  h.a_nb = c.act(s.n_base);
  h.a_top = c.act(s.n_layers);
  h.ld = s.ldh();
  h.rows = rows;
  h.hidden = s.hidden;
  h.wd = w + s.wd_off();
  h.bd = b + s.bd_off();
  h.wc = s.n_head > 0 ? w + s.wc_off() : nullptr;
  h.bc = s.n_head > 0 ? b + s.bc_off() : nullptr;
  return h;
}

template <bool kBf16>
cudaError_t forward(const Call& c, const float* x, const float* head_dir, const float* w,
                    const float* b, float* rgb, float* dens, int num_rays) {
  const Stack& s = c.s;
  if (kBf16) {
    const cudaError_t err = cast_weights(c, w, false);
    if (err != cudaSuccess) return err;
  }
  const int rays_per_chunk = static_cast<int>(c.chunk_rows / c.num_samples);
  for (int r0 = 0; r0 < num_rays; r0 += rays_per_chunk) {
    const long long first = static_cast<long long>(r0) * c.num_samples;
    const long long rows = static_cast<long long>(std::min(rays_per_chunk, num_rays - r0)) *
                           c.num_samples;
    cudaError_t err = chain<kBf16>(c, x + first * s.d_in,
                                   head_dir ? head_dir + static_cast<long long>(r0) * s.hidden
                                            : nullptr,
                                   w, b, rows);
    if (err != cudaSuccess) return err;
    Heads h = heads_of<kBf16>(c, w, b, rows);
    h.dens = dens + first;
    h.rgb = s.n_head > 0 ? rgb + first * 3 : nullptr;
    heads_kernel<kBf16><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, c.stream>>>(h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The splits of a reduction over `rows` for `tiles` output tiles: as many
// blocks as `waves` a multiprocessor hold at once, and no more (a block
// past them would run in a wave of its own), as many as `stride`-float
// rows of the workspace hold, each a multiple of `align` rows.
long long split_rows_of(const Call& c, long long tiles, long long stride, long long rows,
                        int align, int waves = 2) {
  const long long want = std::max(1LL, static_cast<long long>(waves) * c.num_blocks / tiles);
  // Room for the splits and for reduce's rows of kGroup of them.
  const long long room = c.s.ws_floats(true) / stride * kGroup / (kGroup + 2);
  const long long most = std::max(1LL, std::min(room, (rows + align - 1) / align));
  const long long per = (rows + std::min(want, most) - 1) / std::min(want, most);
  return (per + align - 1) / align * align;
}

// dW_k (+)= gz^T a over the chunk's rows into grads at w_out: mode 2 over
// row splits into the workspace, then the sum over splits.
template <bool kBf16>
cudaError_t weight_grad(const Call& c, const char* gz, const char* a, long long lda, int a_cols,
                        int k, long long rows, float* w_out, bool accumulate) {
  const Stack& s = c.s;
  const int H = s.hidden, in = s.in_dim(k);
  const long long stride = static_cast<long long>(H) * in;
  long long splits;
  cudaError_t err;
  if constexpr (kBf16) {
    const long long tiles = (H + kBM - 1) / kBM * ((in + kBN - 1) / kBN);
    WgProd p{};
    p.a = reinterpret_cast<const __nv_bfloat16*>(gz);
    p.lda = s.ldh();
    p.a_cols = s.ldh();
    p.b = reinterpret_cast<const __nv_bfloat16*>(a);
    p.ldb = lda;
    p.b_cols = a_cols;
    p.m = H;
    p.n = in;
    p.rows = rows;
    p.split_rows = split_rows_of(c, tiles, stride, rows, kBK);
    p.split_stride = stride;
    p.out = c.ws;
    splits = (rows + p.split_rows - 1) / p.split_rows;
    err = run_wg<2, 0>(c, p, H, in, splits);
  } else {
    const long long tiles = (H + kTM - 1) / kTM * ((in + kTN - 1) / kTN);
    Prod p{};
    p.a = reinterpret_cast<const float*>(gz);
    p.lda = s.ldh();
    p.b = reinterpret_cast<const float*>(a);
    p.ldb = lda;
    p.out = c.ws;
    p.rows = rows;
    p.m = H;
    p.k = in;
    p.split_rows = split_rows_of(c, tiles, stride, rows, kTK);
    p.split_stride = stride;
    splits = (rows + p.split_rows - 1) / p.split_rows;
    err = run_f32<2>(p, H, in, splits, c.stream);
  }
  if (err != cudaSuccess) return err;
  return reduce(c.ws, splits, stride, stride, w_out, accumulate, c.stream, c.ws + splits * stride);
}

// float32: the bias gradient (column sums) or dhead_dir (ray sums) of the
// cotangent gz over the chunk's rows.
cudaError_t f32_sums(const Call& c, const float* gz, long long rows, int nr, float* b_out,
                     float* dhd, bool accumulate) {
  const int H = c.s.hidden;
  if (dhd != nullptr) {
    raysum_kernel<<<blocks_of(static_cast<long long>(nr) * H), 256, 0, c.stream>>>(
        gz, c.s.ldh(), H, nr, c.num_samples, dhd);
    return cudaGetLastError();
  }
  const long long col_blocks = (H + 255) / 256;
  const long long split = split_rows_of(c, col_blocks, H, rows, 1, 8);
  const long long splits = (rows + split - 1) / split;
  colsum_kernel<<<dim3(static_cast<unsigned>(col_blocks), static_cast<unsigned>(splits)), 256, 0,
                  c.stream>>>(gz, c.s.ldh(), H, rows, split, c.ws);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce(c.ws, splits, H, H, b_out, accumulate, c.stream, c.ws + splits * H);
}

// bfloat16: a cotangent's per-tile partial sums into the bias gradient, or
// the rays no one tile holds into dhead_dir.
cudaError_t bf16_sums(const Call& c, long long rows, int nr, float* b_out, float* dhd,
                      bool accumulate) {
  if (dhd != nullptr) {
    ray_fix_kernel<<<blocks_of(static_cast<long long>(nr) * c.s.hidden), 256, 0, c.stream>>>(
        c.ws, c.s.ldh(), c.s.hidden, nr, c.num_samples, dhd);
    return cudaGetLastError();
  }
  const long long tiles = (rows + kBM - 1) / kBM;
  return reduce(c.ws, tiles, c.s.ldh(), c.s.hidden, b_out, accumulate, c.stream,
                c.ws + 2 * tiles * c.s.ldh());
}

template <bool kBf16>
cudaError_t backward(const Call& c, const float* x, const float* head_dir, const float* w,
                     const float* b, const float* g_rgb, const float* g_dens, float* dx,
                     float* dhd, float* grads, int num_rays) {
  const Stack& s = c.s;
  const int L = s.n_layers, nb = s.n_base, H = s.hidden, ldh = s.ldh();
  const bool heads = s.n_head > 0;
  float* const gw = grads;             // matrices
  float* const gb = grads + s.n_w();   // biases
  const int rays_per_chunk = static_cast<int>(c.chunk_rows / c.num_samples);
  // The largest per-tile partial sums (and reduce's rows of them), which
  // share the workspace.
  const long long tiles = (c.chunk_rows + kBM - 1) / kBM;
  if (kBf16 && (2 * tiles + tiles / kGroup + 1) * ldh > s.ws_floats(true)) {
    return cudaErrorInvalidValue;
  }
  if (kBf16) {
    const cudaError_t err = cast_weights(c, w, true);
    if (err != cudaSuccess) return err;
  }
  for (int r0 = 0; r0 < num_rays; r0 += rays_per_chunk) {
    const bool acc = r0 > 0;
    const int nr = std::min(rays_per_chunk, num_rays - r0);
    const long long first = static_cast<long long>(r0) * c.num_samples;
    const long long rows = static_cast<long long>(nr) * c.num_samples;
    const float* xc = x + first * s.d_in;
    float* const dhd_c = heads ? dhd + static_cast<long long>(r0) * H : nullptr;
    cudaError_t err = chain<kBf16>(c, xc, heads ? head_dir + static_cast<long long>(r0) * H : nullptr,
                                   w, b, rows);
    if (err != cudaSuccess) return err;
    Heads h = heads_of<kBf16>(c, w, b, rows);
    h.g_dens = g_dens + first;
    h.g_rgb = heads ? g_rgb + first * 3 : nullptr;
    h.g = c.heads_g();
    heads_kernel<kBf16><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, c.stream>>>(h);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // The heads' weight and bias gradients: one pass over a_nb and a_L.
    {
      const long long col_blocks = (H + 255) / 256, stride = 4LL * H + 4;
      const long long split = split_rows_of(c, col_blocks, stride, rows, 1, 8);
      const long long splits = (rows + split - 1) / split;
      head_grad_kernel<kBf16><<<dim3(static_cast<unsigned>(col_blocks),
                                     static_cast<unsigned>(splits)), 128, 0, c.stream>>>(
          h.g, c.act(nb), c.act(L), ldh, H, heads, rows, split, c.ws, stride);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      float* const tmp = c.ws + splits * stride;
      if ((err = reduce(c.ws, splits, stride, H, gw + s.wd_off(), acc, c.stream, tmp)) !=
              cudaSuccess ||
          (err = reduce(c.ws + 4LL * H, splits, stride, 1, gb + s.bd_off(), acc, c.stream,
                        tmp)) != cudaSuccess) {
        return err;
      }
      if (heads &&
          ((err = reduce(c.ws + H, splits, stride, 3LL * H, gw + s.wc_off(), acc, c.stream,
                         tmp)) != cudaSuccess ||
           (err = reduce(c.ws + 4LL * H + 1, splits, stride, 3, gb + s.bc_off(), acc, c.stream,
                         tmp)) != cudaSuccess)) {
        return err;
      }
    }
    // Their cotangent into a_L, with its bias gradient (or, where a_L's
    // layer is W_bh, dhead_dir).
    const float* wtop = heads ? w + s.wc_off() : w + s.wd_off();
    const bool top_bh = heads && L - 1 == nb;
    if constexpr (kBf16) {
      const int col_tiles = (ldh + kBN - 1) / kBN;
      const unsigned grid = static_cast<unsigned>((rows + kBM - 1) / kBM * col_tiles);
      const auto* a_top = reinterpret_cast<const __nv_bfloat16*>(c.act(L));
      auto* dz0 = reinterpret_cast<__nv_bfloat16*>(c.dz(0));
      if (top_bh) {
        err = cudaFuncSetAttribute(top_tile_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kWgSmem + kRedBytes);
        if (err != cudaSuccess) return err;
        top_tile_kernel<2><<<grid, 256, kWgSmem + kRedBytes, c.stream>>>(h.g, wtop, heads, a_top, ldh, H, rows,
                                                             col_tiles, dz0, c.ws, dhd_c,
                                                             c.num_samples);
      } else {
        err = cudaFuncSetAttribute(top_tile_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kWgSmem + kRedBytes);
        if (err != cudaSuccess) return err;
        top_tile_kernel<1><<<grid, 256, kWgSmem + kRedBytes, c.stream>>>(h.g, wtop, heads, a_top, ldh, H, rows,
                                                             col_tiles, dz0, c.ws, nullptr,
                                                             c.num_samples);
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      err = bf16_sums(c, rows, nr, gb + s.b_off(L - 1), top_bh ? dhd_c : nullptr, acc);
    } else {
      top_kernel<<<blocks_of(rows * H), 256, 0, c.stream>>>(
          h.g, wtop, heads, reinterpret_cast<const float*>(c.act(L)), ldh, H, rows,
          reinterpret_cast<float*>(c.dz(0)));
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      err = f32_sums(c, reinterpret_cast<const float*>(c.dz(0)), rows, nr, gb + s.b_off(L - 1),
                     top_bh ? dhd_c : nullptr, acc);
    }
    if (err != cudaSuccess) return err;
    // Down the layers: dW_k, then the cotangent one layer down with its sums.
    int cur = 0;
    for (int k = L - 1; k >= 0; --k) {
      const bool bh = heads && k == nb;         // W_bh: the density head joins a_nb's cotangent
      const bool below_bh = heads && k - 1 == nb;  // the cotangent made is W_bh's: dhead_dir
      const char* gz = c.dz(cur);
      const char* a_in = k == 0 ? (kBf16 ? reinterpret_cast<const char*>(c.xb())
                                         : reinterpret_cast<const char*>(xc))
                                : c.act(k);
      const long long lda = k == 0 ? (kBf16 ? s.ldx() : s.d_in) : ldh;
      err = weight_grad<kBf16>(c, gz, a_in, lda, kBf16 ? s.ld_in(k) : s.in_dim(k), k, rows,
                               gw + s.w_off(k), acc);
      if (err != cudaSuccess) return err;
      if constexpr (kBf16) {
        WgProd p{};
        p.a = reinterpret_cast<const __nv_bfloat16*>(gz);
        p.lda = ldh;
        p.b = c.wt(k);
        p.ldb = ldh;
        p.m = rows;
        p.n = s.in_dim(k);
        p.depth = ldh;
        p.num_samples = c.num_samples;
        if (k == 0) {
          p.out = dx + first * s.d_in;
          err = run_wg<1, 0>(c, p, rows, s.d_in, 1);
        } else {
          p.mask = reinterpret_cast<const __nv_bfloat16*>(c.act(k));
          p.out = c.dz(1 - cur);
          p.ldo = ldh;
          p.part = c.ws;
          if (bh) {
            p.gd = h.g;
            p.wd = w + s.wd_off();
          }
          if (below_bh) {
            p.dhd = dhd_c;
            err = run_wg<1, 2>(c, p, rows, ldh, 1);
          } else {
            err = run_wg<1, 1>(c, p, rows, ldh, 1);
          }
          if (err == cudaSuccess) {
            err = bf16_sums(c, rows, nr, gb + s.b_off(k - 1), below_bh ? dhd_c : nullptr, acc);
          }
        }
      } else {
        Prod p{};
        p.a = reinterpret_cast<const float*>(gz);
        p.lda = ldh;
        p.w = w + s.w_off(k);
        p.rows = rows;
        p.m = H;
        p.k = s.in_dim(k);
        if (k > 0) {
          p.mask = reinterpret_cast<const float*>(c.act(k));
          p.ldm = ldh;
          p.out = reinterpret_cast<float*>(c.dz(1 - cur));
          p.ldo = ldh;
          if (bh) {
            p.gd = h.g;
            p.wd = w + s.wd_off();
          }
        } else {
          p.out = dx + first * s.d_in;
          p.ldo = s.d_in;
        }
        err = run_f32<1>(p, rows, p.k, 1, c.stream);
        if (err == cudaSuccess && k > 0) {
          err = f32_sums(c, reinterpret_cast<const float*>(c.dz(1 - cur)), rows, nr,
                         gb + s.b_off(k - 1), below_bh ? dhd_c : nullptr, acc);
        }
      }
      if (err != cudaSuccess) return err;
      cur = 1 - cur;
    }
  }
  return cudaSuccess;
}

}  // namespace lay

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

// The generic plan of a stack, for the host's mirror to be held against:
// out = {rows a tile, warps, resident, phases, cache words, shared memory};
// returns 0 where the kernels take no such stack.
extern "C" int tetranerf_fused_mlp_generic_plan(int d_in, int hidden, int n_base, int n_head,
                                                int bf16, int backward, int* out) {
  gen::GPlan plan;
  if (!gen::make_gplan(d_in, hidden, n_base, n_head, bf16 != 0, backward != 0, &plan)) return 0;
  const int v[6] = {plan.rows, plan.warps, plan.resident, backward ? plan.n_phases : 0,
                    plan.cache_words, plan.smem_bytes};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 1;
}

// The generic route's forward (K4, K5) and backward (K4b, K5b), arguments
// as above plus `bf16` (bf16 operands, rounded from the f32 weights as the
// kernel stages them) and the host plan's rows a tile, phases and cache
// words (backward) and shared memory, which must match this file's. The
// backward's `aux` is the cache (unused with one phase): [ceil(rows /
// rows_per_tile) * rows_per_tile / 16][cache_words] words, then ws_stride
// floats (the transposed weights); it writes every entry of each launched
// block's workspace row once.
extern "C" int tetranerf_fused_mlp_forward_generic(
    const float* x, const float* head_dir, const float* w, const float* b, float* rgb,
    float* dens, int num_rays, int num_samples, int d_in, int hidden, int n_base, int n_head,
    int bf16, int num_blocks, int rows_per_tile, int smem_bytes, cudaStream_t stream) {
  gen::GPlan plan;
  if (!gen::make_gplan(d_in, hidden, n_base, n_head, bf16 != 0, false, &plan) ||
      plan.rows != rows_per_tile || plan.smem_bytes != smem_bytes || num_blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long num_rows = static_cast<long long>(num_rays) * num_samples;
  if (num_rows == 0) return 0;
  const long long tiles = (num_rows + plan.rows - 1) / plan.rows;
  const int grid = static_cast<int>(std::min<long long>(num_blocks, tiles));
  const cudaError_t err =
      bf16 ? gen::launch_fwd<true>(plan, x, head_dir, w, b, rgb, dens, num_rows, num_samples,
                                   grid, stream)
           : gen::launch_fwd<false>(plan, x, head_dir, w, b, rgb, dens, num_rows, num_samples,
                                    grid, stream);
  return static_cast<int>(err);
}

extern "C" int tetranerf_fused_mlp_backward_generic(
    const float* x, const float* head_dir, const float* w, const float* b,
    const float* g_rgb, const float* g_dens, float* dx, float* dhd, float* ws, float* grads,
    float* aux, int num_rays, int num_samples, int d_in, int hidden, int n_base, int n_head,
    int bf16, int num_blocks, int ws_stride, int rows_per_tile, int phases, int cache_words,
    int smem_bytes, cudaStream_t stream) {
  gen::GPlan plan;
  if (!gen::make_gplan(d_in, hidden, n_base, n_head, bf16 != 0, true, &plan) ||
      plan.rows != rows_per_tile || plan.n_phases != phases ||
      cache_words != plan.cache_words ||
      plan.smem_bytes != smem_bytes || num_blocks < 1 || ws_stride < plan.n_w + plan.n_b) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long num_rows = static_cast<long long>(num_rays) * num_samples;
  const long long tiles = (num_rows + plan.rows - 1) / plan.rows;
  const int grid = static_cast<int>(std::min<long long>(num_blocks, tiles));
  if (grid > 0 && plan.n_phases > 1) {  // the chain into the cache, at the forward's warps
    gen::GPlan fplan;
    gen::make_gplan(d_in, hidden, n_base, n_head, bf16 != 0, false, &fplan);
    if (fplan.warps > gen::kCacheWarps) {  // the forward's layout at fewer warps
      fplan.smem_bytes -= (fplan.warps - gen::kCacheWarps) * (fplan.smem_bytes - fplan.pp_off) /
                          fplan.warps;
      fplan.warps = gen::kCacheWarps;
      fplan.rows = 16 * gen::kCacheWarps;
    }
    const gen::Cache keep{reinterpret_cast<char*>(aux), tiles * plan.rows, plan.rows};
    const long long ftiles = (keep.rows + fplan.rows - 1) / fplan.rows;
    const int fgrid = static_cast<int>(std::min<long long>(num_blocks, ftiles));
    const cudaError_t err =
        bf16 ? gen::launch_fwd<true, true>(fplan, x, head_dir, w, b, nullptr, nullptr, num_rows,
                                           num_samples, fgrid, stream, keep, g_rgb, g_dens)
             : gen::launch_fwd<false, true>(fplan, x, head_dir, w, b, nullptr, nullptr, num_rows,
                                            num_samples, fgrid, stream, keep, g_rgb, g_dens);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!bf16 && !plan.resident) {
      gen::transpose_kernel<<<64, 256, 0, stream>>>(plan, w, keep.wt(plan));
    }
  }
  if (grid > 0) {
    const cudaError_t err =
        bf16 ? gen::launch_bwd<true>(plan, x, head_dir, w, b, g_rgb, g_dens, dx, dhd, ws,
                                     ws_stride, aux, num_rows, num_samples, grid, stream)
             : gen::launch_bwd<false>(plan, x, head_dir, w, b, g_rgb, g_dens, dx, dhd, ws,
                                      ws_stride, aux, num_rows, num_samples, grid, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n = plan.n_w + plan.n_b;
  sum_rows_kernel<<<(n + 255) / 256, 256, 0, stream>>>(ws, grid, ws_stride, n, grads);
  return static_cast<int>(cudaGetLastError());
}

// The layered route's plan of a stack: out = {scratch floats a row of a
// chunk, scratch floats beside the rows (the backward's workspace, then in
// bfloat16 the weights' bf16 copies), dynamic shared memory of a product
// block, stages of its ring}; returns 0 where no such stack exists.
extern "C" int tetranerf_fused_mlp_layered_plan(int d_in, int hidden, int n_base, int n_head,
                                                int bf16, int backward, long long* out) {
  if (d_in < 1 || hidden < 1 || n_base < 1 || n_head < 0) return 0;
  const lay::Stack s{d_in, hidden, n_base, n_head, n_base + n_head};
  out[0] = s.row_floats(bf16 != 0, backward != 0);
  out[1] = s.fixed_floats(bf16 != 0, backward != 0);
  out[2] = lay::smem_bytes(bf16 != 0);
  out[3] = bf16 ? lay::kWgStages : lay::kStages;
  return 1;
}

// The layered route's forward (K4, K5) and backward (K4b, K5b), arguments
// as the generic route's, plus the rays of a chunk (the host's, from its
// scratch budget) and the scratch: rays_per_chunk x num_samples rows of the
// plan's floats a row, then the plan's floats beside them. The backward
// writes every entry of grads and of dhd.
extern "C" int tetranerf_fused_mlp_forward_layered(
    const float* x, const float* head_dir, const float* w, const float* b, float* rgb,
    float* dens, int num_rays, int num_samples, int d_in, int hidden, int n_base, int n_head,
    int bf16, int num_blocks, int rays_per_chunk, float* scratch, long long scratch_floats,
    cudaStream_t stream) {
  const lay::Stack s{d_in, hidden, n_base, n_head, n_base + n_head};
  const long long chunk_rows = static_cast<long long>(rays_per_chunk) * num_samples;
  const long long row_floats = chunk_rows * s.row_floats(bf16 != 0, false);
  if (d_in < 1 || hidden < 1 || n_base < 1 || n_head < 0 || num_blocks < 1 ||
      rays_per_chunk < 1 || scratch_floats < row_floats + s.fixed_floats(bf16 != 0, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(num_rays) * num_samples == 0) return 0;
  const lay::Call c{s, bf16 != 0, num_samples, num_blocks, chunk_rows,
                    reinterpret_cast<char*>(scratch), nullptr,
                    reinterpret_cast<__nv_bfloat16*>(scratch + row_floats), stream};
  const cudaError_t err =
      bf16 ? lay::forward<true>(c, x, head_dir, w, b, rgb, dens, num_rays)
           : lay::forward<false>(c, x, head_dir, w, b, rgb, dens, num_rays);
  return static_cast<int>(err);
}

extern "C" int tetranerf_fused_mlp_backward_layered(
    const float* x, const float* head_dir, const float* w, const float* b,
    const float* g_rgb, const float* g_dens, float* dx, float* dhd, float* grads,
    int num_rays, int num_samples, int d_in, int hidden, int n_base, int n_head, int bf16,
    int num_blocks, int rays_per_chunk, float* scratch, long long scratch_floats,
    cudaStream_t stream) {
  const lay::Stack s{d_in, hidden, n_base, n_head, n_base + n_head};
  const long long chunk_rows = static_cast<long long>(rays_per_chunk) * num_samples;
  const long long row_floats = chunk_rows * s.row_floats(bf16 != 0, true);
  if (d_in < 1 || hidden < 1 || n_base < 1 || n_head < 0 || num_blocks < 1 ||
      rays_per_chunk < 1 || scratch_floats < row_floats + s.fixed_floats(bf16 != 0, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(num_rays) * num_samples == 0) return 0;
  const lay::Call c{s, bf16 != 0, num_samples, num_blocks, chunk_rows,
                    reinterpret_cast<char*>(scratch), scratch + row_floats,
                    reinterpret_cast<__nv_bfloat16*>(scratch + row_floats + s.ws_floats(true)),
                    stream};
  const cudaError_t err =
      bf16 ? lay::backward<true>(c, x, head_dir, w, b, g_rgb, g_dens, dx, dhd, grads, num_rays)
           : lay::backward<false>(c, x, head_dir, w, b, g_rgb, g_dens, dx, dhd, grads, num_rays);
  return static_cast<int>(err);
}
