// Fused Mirage GEMM: out = bfp(x) @ bfp(w), both operands BFP(b_m, g)
// quantized along K inside the kernel, f32 accumulation.
//
// Replaces: src/repro/kernels/mirage_gemm.py:50 `mirage_gemm_pallas` (body
// `_kernel` :28, call :82), whose prologue is the quantizer of
// src/repro/kernels/bfp_quantize.py (`_quantize_block`, here bfp.cuh).
//
// The weight may be (K, N) row-major or (N, K) row-major (the tied head
// reads the embedding table in place). g divides 64 and every K range a
// block takes starts at a multiple of 64, so no group straddles two blocks.
// Ragged edges load as zeros, which never raise a group max. Two routes,
// chosen by the wrapper (repro_torch/kernels/ops.py `gemm_plan`):
//
// Decode route (M <= 16, and any M when b_m > 8): bound by bytes. Every
// weight is read once for M multiply-adds, so the card's 3.35 TB/s sets the
// time (the tied head alone is 544 MB per call). The design streams the
// weights from every SM: the wrapper splits K until the grid holds about
// two blocks per SM (a 896 -> 128 GEMM has only 56 tiles of 64 x 32), each
// thread keeps its own 16-byte cp.async copies kStages steps ahead (a ring
// of thread-private fragments in shared memory, so no barrier guards it),
// and quantizes its fragment in registers: in the (K, N) layout a thread
// holds 4 rows x 4 columns and a group's max runs over g/4 neighbouring
// lanes; in the (N, K) layout the 4 lanes of a row hold 64 consecutive k
// (lane kc the float4 at 16 r + 4 kc), so a group of 16 is four float4 of
// one row and each 16-byte copy of a warp reads 64 contiguous bytes per
// row. x (at most 16 rows) is quantized once per
// block over the block's K range into shared memory; where the column
// tiles outnumber four blocks per SM (the head's 4,748), a block walks
// several of them with its copies running on from one into the next, so
// that work is not repeated per tile. The partial sums of
// the K lanes meet in a fixed butterfly, and split-K partials go to a
// workspace that a second launch adds up in split order: no atomics, and
// the output is the same bits on every run.
//
// Prefill route (M > 16, b_m <= 8): bound by operations. A BFP(b_m <= 8)
// value is an integer of at most 8 bits times a power of two in
// [2^-126, 2^127], so it is exact in bf16, and so is every product in f32.
// Each 64-deep step stages x and w tiles with the decode route's copies and
// quantizer, writes them to shared memory as bf16 and runs
// mma.sync.m16n8k16 (bf16 in, f32 out). Each k16 MMA starts from a zero
// accumulator and its result is added to an f32 register accumulator with
// IEEE adds in k order: at g = 16 one k16 step is one group, whose sum of
// 16 products (|q| <= 2^b_m - 1) is exact, so the only rounding left is the
// f32 sum over groups, as in the plain version. The tensor core's own
// accumulation of C is not relied on. For b_m > 8 a bf16 operand would
// round, so such policies take the decode route's CUDA-core arithmetic at
// any M (in tiles of 16 rows).
//
// Training (repro_torch/core/gemm.py `MirageMatmul`) adds the backward
// shapes: dX = dO @ W^T reads the weight in the other layout (a (K, N)
// weight as (N, K), the tied head's table as (K, N)), and dW = X^T @ dO
// contracts over the tokens (the wrapper hands X^T over as one contiguous
// copy; a ragged token count is a ragged K). `quant_w` false takes the
// weight as it is (a weight already on its BFP grid along the forward K,
// read transposed by the weight-stationary dX GEMM, must not be regrouped
// along N): only the decode route takes it, whose f32 CUDA-core products
// are exact for any weight, where bf16 would round one off the grid.
//
// Batched over experts (the MoE layer's expert FFNs, which the JAX package
// runs as a vmap of this GEMM: one Pallas call with a batch grid axis):
// out[e] = bfp(x[e]) @ bfp(w[e]) for e < E in one launch, x (E, M, K), w
// (E, K, N) or (E, N, K), out (E, M, N). The expert is folded into the grid
// axis that walks M tiles (z on the decode route, y on the tensor-core
// route, whose z holds the K splits), so every block computes one expert's
// tile exactly as the unbatched kernel computes it: the same bits for the
// same split of K. The split-K workspace is (splits, E, M, N) and its
// reduction adds each element's partials in split order. A contiguous
// (E, K, N) stack at M <= 16 with N % 4 == 0 and an aligned base takes the
// stream route of mirage_gemm_stack.cu instead (ops.py `gemm_plan`).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "bfp.cuh"

namespace {

constexpr int kBK = 64;          // K rows per pipeline step
constexpr int kStages = 4;       // decode route: steps in flight per thread
constexpr int kDecodeBlocksPerSm = 4;  // decode route: resident blocks
constexpr int kSmShared = 228 * 1024;  // shared memory of an H100 SM
constexpr int kBlockReservedShared = 1024;  // reserved per resident block
constexpr int kMmaTile = 64;     // prefill route: 64 x 64 output tiles
constexpr int kMmaThreads = 256;
constexpr int kMmaStages = 2;
constexpr int kPitch = kBK + 8;  // bf16 tile row: 144 B, ldmatrix without
                                 // bank conflicts
constexpr unsigned kFull = 0xffffffffu;

// ---- asynchronous copies --------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive floats of a row-major matrix (leading dimension ld) at
// (row, col..col+3) into dst, zeros outside rows < row_end, cols < col_end.
// `vec` (16-byte rows and base) takes one 16-byte copy; else four 4-byte.
__device__ __forceinline__ void copy_quad(float4* dst, const float* src,
                                          int ld, int row, int col,
                                          int row_end, int col_end,
                                          bool vec) {
  const size_t off = static_cast<size_t>(row) * ld + col;
  if (vec) {
    const bool ok = row < row_end && col < col_end;
    cp_async16(dst, ok ? src + off : src, ok);
  } else {
    float* d = reinterpret_cast<float*>(dst);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok = row < row_end && col + c < col_end;
      cp_async4(d + c, ok ? src + off + c : src, ok);
    }
  }
}

// ---- BFP quantization of register fragments -------------------------------

__device__ __forceinline__ float& at(float4& f, int c) {
  return reinterpret_cast<float*>(&f)[c];
}

__device__ __forceinline__ float at(const float4& f, int c) {
  return reinterpret_cast<const float*>(&f)[c];
}

// K-major fragments ((N, K) weights, x): f[r] holds k 16 r + 4 kc .. +3 of
// one row, with kc = lane % 4, so the row's 4 lanes hold 64 consecutive k
// and each 16-byte copy of a warp covers 64 contiguous bytes per row.
// Groups of g along K: inside a float4 up to g = 4, then over lanes xor 1
// (g >= 8) and xor 2 (g >= 16), and over the r pairs (g = 32) or all four
// (g = 64).
__device__ __forceinline__ void quantize_kmajor(float4 (&f)[4], int g,
                                                int b_m, bool truncate) {
  if (g >= 8) {
    float m[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      m[r] = fmaxf(fmaxf(fabsf(f[r].x), fabsf(f[r].y)),
                   fmaxf(fabsf(f[r].z), fabsf(f[r].w)));
    if (g >= 32) {
      m[0] = m[1] = fmaxf(m[0], m[1]);
      m[2] = m[3] = fmaxf(m[2], m[3]);
    }
    if (g >= 64) m[0] = m[1] = m[2] = m[3] = fmaxf(m[0], m[2]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 1));
      if (g >= 16) m[r] = fmaxf(m[r], __shfl_xor_sync(kFull, m[r], 2));
      const BfpGrid grid = bfp_grid(m[r], b_m);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        at(f[r], c) = bfp_quantize_value(at(f[r], c), grid, truncate);
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float a[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = fabsf(at(f[r], c));
    if (g >= 2) {
      a[0] = a[1] = fmaxf(a[0], a[1]);
      a[2] = a[3] = fmaxf(a[2], a[3]);
    }
    if (g >= 4) a[0] = a[1] = a[2] = a[3] = fmaxf(a[0], a[2]);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      at(f[r], c) =
          bfp_quantize_value(at(f[r], c), bfp_grid(a[c], b_m), truncate);
  }
}

// (K, N) layout: f[r] holds row 4 kc + r at 4 consecutive columns, with
// kc = lane % 16. Groups run down the rows: inside the thread up to g = 4,
// then over lanes xor 1, 2, 4, 8 (g = 8 .. 64).
__device__ __forceinline__ void quantize_kn(float4 (&f)[4], int g, int b_m,
                                            bool truncate) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (g >= 4) {
      float m = fmaxf(fmaxf(fabsf(at(f[0], c)), fabsf(at(f[1], c))),
                      fmaxf(fabsf(at(f[2], c)), fabsf(at(f[3], c))));
      for (int off = 1; off < g / 4; off <<= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
      const BfpGrid grid = bfp_grid(m, b_m);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        at(f[r], c) = bfp_quantize_value(at(f[r], c), grid, truncate);
    } else {
      float a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = fabsf(at(f[r], c));
      if (g == 2) {
        a[0] = a[1] = fmaxf(a[0], a[1]);
        a[2] = a[3] = fmaxf(a[2], a[3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        at(f[r], c) =
            bfp_quantize_value(at(f[r], c), bfp_grid(a[r], b_m), truncate);
    }
  }
}

// x rows m0 .. m0 + rows - 1 over K columns [k_begin, k_end), quantized
// into xs (rows x kb floats, row-major) in K-major fragments: 4 lanes per
// 64 k of a row. Every thread runs the same number of rounds, so the
// shuffles see all lanes.
__device__ __forceinline__ void quantize_x_rows(
    const float* __restrict__ x, float* xs, int rows, int kb, int m0, int M,
    int K, int k_begin, int k_end, int g, int b_m, bool truncate, bool vec) {
  const int chunks_per_row = kb / 64;
  const int frags = rows * chunks_per_row * 4;
  for (int base = 0; base < frags; base += blockDim.x) {
    const int idx = base + threadIdx.x;
    const int kc = idx % 4;
    const int chunk = idx / 4 % chunks_per_row;
    const int row = idx / 4 / chunks_per_row;
    const int m = m0 + row;
    const bool live = idx < frags && m < M;
    float4 f[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = k_begin + 64 * chunk + 16 * r + 4 * kc;
      const float* src = x + static_cast<size_t>(m) * K + k;
      if (vec && live && k < k_end) {
        f[r] = *reinterpret_cast<const float4*>(src);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          at(f[r], c) = live && k + c < k_end ? src[c] : 0.0f;
      }
    }
    quantize_kmajor(f, g, b_m, truncate);
    if (idx < frags) {
      float* dst = xs + row * kb + 64 * chunk + 4 * kc;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(dst + 16 * r) = f[r];
    }
  }
}

// ---- decode route: CUDA cores, split K ------------------------------------

// grid: (blocks along N, K splits, E x M tiles of 16 rows). A block takes
// the N tiles of blockDim.x / 4 columns blockIdx.x, blockIdx.x + gridDim.x, ...
// over its K range, quantizing x once and keeping the copies in flight
// from one tile into the next. Dynamic shared memory: kStages x 4 x
// blockDim.x float4 (the copy ring), then MT x k_split floats (x).
template <int MT, bool kWeightNK>
__global__ void __launch_bounds__(128)
    gemm_decode_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ dst,
                       int E, int M, int N, int K, int g, int b_m,
                       bool truncate, bool quant_w, int k_split, bool x_vec,
                       bool w_vec) {
  extern __shared__ float4 smem4[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int bn = T / 4;
  const int n_tiles = (N + bn - 1) / bn;
  const int k_begin = blockIdx.y * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int m_tiles = (M + 15) / 16;
  const int e = blockIdx.z / m_tiles;
  const int m0 = blockIdx.z % m_tiles * 16;
  x += static_cast<size_t>(e) * M * K;
  w += static_cast<size_t>(e) * K * N;
  const int steps = max(1, (k_end - k_begin + kBK - 1) / kBK);
  const int jobs =
      (n_tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x *
      steps;
  float4* ring = smem4;
  float* xs = reinterpret_cast<float*>(smem4 + kStages * 4 * T);
  // (N, K): 4 lanes per weight row, 16 k each; (K, N): 16 lanes down the
  // rows, 4 each, and T / 16 quads of columns
  const int kc = kWeightNK ? tid % 4 : tid % 16;
  auto tile_n0 = [&](int job) {
    return (static_cast<int>(blockIdx.x) + job / steps * gridDim.x) * bn;
  };

  auto load = [&](int job) {
    float4* slot = ring + (job % kStages) * 4 * T + tid;
    const int n0 = tile_n0(job);
    const int kb = k_begin + job % steps * kBK;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (kWeightNK)
        copy_quad(slot + r * T, w, K, n0 + tid / 4, kb + 16 * r + 4 * kc, N,
                  k_end, w_vec);
      else
        copy_quad(slot + r * T, w, N, kb + 4 * kc + r, n0 + 4 * (tid / 16),
                  k_end, N, w_vec);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < jobs) load(s);
    cp_async_commit();
  }
  quantize_x_rows(x, xs, MT, k_split, m0, M, K, k_begin, k_end, g, b_m,
                  truncate, x_vec);
  __syncthreads();

  constexpr int kCols = kWeightNK ? 1 : 4;
  float acc[MT][kCols];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.0f;
  dst += (static_cast<size_t>(blockIdx.y) * E + e) * M * N;

  for (int job = 0; job < jobs; ++job) {
    if (job + kStages - 1 < jobs) load(job + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    const float4* slot = ring + (job % kStages) * 4 * T + tid;
    float4 f[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) f[r] = slot[r * T];
    const int kk = job % steps * kBK;
    if (kWeightNK) {
      if (quant_w) quantize_kmajor(f, g, b_m, truncate);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* xr = xs + m * k_split + kk + 4 * kc;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + 16 * r);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[m][0] = fmaf(at(xv, c), at(f[r], c), acc[m][0]);
        }
      }
    } else {
      if (quant_w) quantize_kn(f, g, b_m, truncate);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + m * k_split + kk + 4 * kc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float xr = at(xv, r);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[m][c] = fmaf(xr, at(f[r], c), acc[m][c]);
        }
      }
    }
    if (job % steps != steps - 1) continue;

    // the tile is done: the K lanes' partial sums meet in a fixed
    // butterfly (every lane of a group ends with the same bits, on every
    // run), then its K-lane 0 writes them
    const int k_lanes = kWeightNK ? 4 : 16;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        for (int off = 1; off < k_lanes; off <<= 1)
          acc[m][c] += __shfl_xor_sync(kFull, acc[m][c], off);
      }
    const int n = tile_n0(job) + (kWeightNK ? tid / 4 : 4 * (tid / 16));
    if (kc == 0) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m >= M) break;
        float* row = dst + static_cast<size_t>(m0 + m) * N;
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          if (n + c < N) row[n + c] = acc[m][c];
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[m][c] = 0.0f;
  }
}

// ---- prefill route: bf16 tensor cores -------------------------------------

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// d = a (16 x 16, row) . b (16 x 8, col), from a zero accumulator
__device__ __forceinline__ void mma_bf16_zero_c(float (&d)[4],
                                                const unsigned (&a)[4],
                                                unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// A K-major fragment (k 16 r + 4 kc .. +3 of one row) as bf16.
__device__ __forceinline__ void store_kmajor(__nv_bfloat16* row, int kc,
                                             const float4 (&f)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    *reinterpret_cast<uint2*>(row + 16 * r + 4 * kc) =
        make_uint2(pack_bf16(f[r].x, f[r].y), pack_bf16(f[r].z, f[r].w));
}

constexpr int kMmaRingBytes = kMmaStages * 2 * 4 * kMmaThreads * 16;
constexpr int kMmaSmemBytes =
    kMmaRingBytes + 2 * kMmaTile * kPitch * 2;  // + bf16 As and Bs

// grid: (N tiles of 64, E x M tiles of 64, K splits); 8 warps, each a
// 32 x 16 piece of the 64 x 64 output tile.
template <bool kWeightNK>
__global__ void __launch_bounds__(kMmaThreads)
    gemm_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ dst, int E, int M, int N, int K,
                    int g, int b_m, bool truncate, int k_split, bool x_vec,
                    bool w_vec) {
  extern __shared__ float4 smem4[];
  float4* ring = smem4;  // [stage][x, w][4][threads]
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<char*>(smem4) + kMmaRingBytes);  // [64 m][kPitch]
  __nv_bfloat16* Bs = As + kMmaTile * kPitch;             // [64 n][kPitch]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int m_tiles = (M + kMmaTile - 1) / kMmaTile;
  const int e = blockIdx.y / m_tiles;
  const int n0 = blockIdx.x * kMmaTile;
  const int m0 = blockIdx.y % m_tiles * kMmaTile;
  x += static_cast<size_t>(e) * M * K;
  w += static_cast<size_t>(e) * K * N;
  const int k_begin = blockIdx.z * k_split;
  const int k_end = min(K, k_begin + k_split);
  const int steps = (k_end - k_begin + kBK - 1) / kBK;
  // K-major fragments: row tid / 4, lane tid % 4 (x, and w in (N, K));
  // (K, N) w: rows 4 (tid % 16) + r, columns 4 (tid / 16) + c
  const int frag_row = tid / 4, frag_kc = tid % 4;
  const int kc = tid % 16, quad = tid / 16;

  auto load = [&](int step) {
    float4* slot = ring + (step % kMmaStages) * 2 * 4 * kMmaThreads + tid;
    const int kb = k_begin + step * kBK;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      copy_quad(slot + r * kMmaThreads, x, K, m0 + frag_row,
                kb + 16 * r + 4 * frag_kc, M, k_end, x_vec);
      if (kWeightNK)
        copy_quad(slot + (4 + r) * kMmaThreads, w, K, n0 + frag_row,
                  kb + 16 * r + 4 * frag_kc, N, k_end, w_vec);
      else
        copy_quad(slot + (4 + r) * kMmaThreads, w, N, kb + 4 * kc + r,
                  n0 + 4 * quad, k_end, N, w_vec);
    }
  };

  const int wm = (warp % 2) * 32, wn = (warp / 2) * 16;
  float acc[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  load(0);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load(step + 1);
    cp_async_commit();
    cp_async_wait<kMmaStages - 1>();
    const float4* slot =
        ring + (step % kMmaStages) * 2 * 4 * kMmaThreads + tid;
    float4 fx[4], fw[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      fx[r] = slot[r * kMmaThreads];
      fw[r] = slot[(4 + r) * kMmaThreads];
    }
    quantize_kmajor(fx, g, b_m, truncate);
    if (kWeightNK)
      quantize_kmajor(fw, g, b_m, truncate);
    else
      quantize_kn(fw, g, b_m, truncate);
    __syncthreads();  // the previous step's MMAs are done with As and Bs
    store_kmajor(As + frag_row * kPitch, frag_kc, fx);
    if (kWeightNK) {
      store_kmajor(Bs + frag_row * kPitch, frag_kc, fw);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint2*>(Bs + (4 * quad + c) * kPitch + 4 * kc) =
            make_uint2(pack_bf16(at(fw[0], c), at(fw[1], c)),
                       pack_bf16(at(fw[2], c), at(fw[3], c)));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned a[2][4], b[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(a[i], As + (wm + 16 * i + lane % 16) * kPitch + kk +
                              (lane / 16) * 8);
      ldmatrix_x4(b, Bs + (wn + (lane / 16) * 8 + lane % 8) * kPitch + kk +
                         ((lane / 8) % 2) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float d[4];
          mma_bf16_zero_c(d, a[i], b[2 * j], b[2 * j + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] = __fadd_rn(acc[i][j][e], d[e]);
        }
    }
  }

  dst += (static_cast<size_t>(blockIdx.z) * E + e) * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm + 16 * i + lane / 4 + (e / 2) * 8;
        const int n = n0 + wn + 8 * j + (lane % 4) * 2 + e % 2;
        if (m < M && n < N)
          dst[static_cast<size_t>(m) * N + n] = acc[i][j][e];
      }
}

// ---- split-K: the partials added in split order ---------------------------

__global__ void splitk_reduce_kernel(const float* __restrict__ ws,
                                     float* __restrict__ out, long long mn,
                                     int splits) {
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < mn; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = ws[i];
    for (int p = 1; p < splits; ++p) s = __fadd_rn(s, ws[p * mn + i]);
    out[i] = s;
  }
}

int sm_count() {
  int device = 0, n = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
  return n > 0 ? n : 1;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Opts the kernel into more than 48 KB of dynamic shared memory, once.
template <typename Kernel>
void allow_smem(Kernel kernel, bool& done) {
  if (!done) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         200 * 1024);
    done = true;
  }
}

template <int MT, bool kWeightNK>
void launch_decode(const float* x, const float* w, float* dst, int E, int M,
                   int N, int K, int g, int b_m, bool truncate, bool quant_w,
                   int threads, int splits, int k_split, bool x_vec,
                   bool w_vec, cudaStream_t stream) {
  static bool smem_set = false;
  auto kernel = gemm_decode_kernel<MT, kWeightNK>;
  allow_smem(kernel, smem_set);
  const int n_tiles = (N + threads / 4 - 1) / (threads / 4);
  const int m_tiles = (M + 15) / 16;
  const size_t smem = static_cast<size_t>(kStages) * 4 * threads * 16 +
                      static_cast<size_t>(MT) * k_split * sizeof(float);
  // a stack of experts: one wave of the blocks its shared memory lets
  // reside (a second, partial wave would leave most SMs idle)
  const int per_sm =
      E == 1 ? kDecodeBlocksPerSm
             : max(1, min(kDecodeBlocksPerSm,
                          kSmShared / (static_cast<int>(smem) +
                                       kBlockReservedShared)));
  const dim3 grid(
      min(n_tiles, max(1, per_sm * sm_count() / (splits * m_tiles * E))),
      splits, m_tiles * E);
  kernel<<<grid, threads, smem, stream>>>(x, w, dst, E, M, N, K, g, b_m,
                                          truncate, quant_w, k_split, x_vec,
                                          w_vec);
}

template <bool kWeightNK>
void launch_mma(const float* x, const float* w, float* dst, int E, int M,
                int N, int K, int g, int b_m, bool truncate, int splits,
                int k_split, bool x_vec, bool w_vec, cudaStream_t stream) {
  static bool smem_set = false;
  auto kernel = gemm_mma_kernel<kWeightNK>;
  allow_smem(kernel, smem_set);
  const dim3 grid((N + kMmaTile - 1) / kMmaTile,
                  (M + kMmaTile - 1) / kMmaTile * E, splits);
  kernel<<<grid, kMmaThreads, kMmaSmemBytes, stream>>>(
      x, w, dst, E, M, N, K, g, b_m, truncate, k_split, x_vec, w_vec);
}

}  // namespace

void launch_splitk_reduce(const float* ws, float* out, long long mn,
                          int splits, cudaStream_t stream);

// x: (E, M, K) row-major; w: (E, K, N) row-major, or (E, N, K) row-major
// when w_nk; out: (E, M, N) row-major; ws: (splits, E, M, N) when
// splits > 1 (E = 1: one GEMM). The wrapper checks E x M tiles fit the
// grid axis they are folded into. The wrapper
// checks g | 64, picks the route (mma needs b_m <= 8 and M > 16), the
// decode route's block size (32, 64 or 128 threads) and the split of K into
// `splits` ranges of k_split rows (a multiple of 64); `quant_w` false (the
// decode route only) skips the weight's quantization. One call enqueues the
// GEMM and, when K is split, the ordered reduction.
void launch_mirage_gemm(const float* x, const float* w, float* out,
                        float* ws, int E, int M, int N, int K, bool w_nk,
                        int g,
                        int b_m, bool truncate, bool quant_w, bool mma,
                        int threads, int splits, int k_split,
                        cudaStream_t stream) {
  if (E == 0 || M == 0 || N == 0) return;
  float* dst = splits > 1 ? ws : out;
  const bool x_vec = K % 4 == 0 && aligned16(x);
  const bool w_vec = (w_nk ? K : N) % 4 == 0 && aligned16(w);
  if (mma) {
    if (w_nk)
      launch_mma<true>(x, w, dst, E, M, N, K, g, b_m, truncate, splits,
                       k_split, x_vec, w_vec, stream);
    else
      launch_mma<false>(x, w, dst, E, M, N, K, g, b_m, truncate, splits,
                        k_split, x_vec, w_vec, stream);
  } else {
#define MIRAGE_DECODE(MT)                                                    \
  (w_nk ? launch_decode<MT, true>(x, w, dst, E, M, N, K, g, b_m, truncate,   \
                                  quant_w, threads, splits, k_split, x_vec,  \
                                  w_vec, stream)                             \
        : launch_decode<MT, false>(x, w, dst, E, M, N, K, g, b_m, truncate,  \
                                   quant_w, threads, splits, k_split, x_vec, \
                                   w_vec, stream))
    if (M <= 4)
      MIRAGE_DECODE(4);
    else if (M <= 8)
      MIRAGE_DECODE(8);
    else
      MIRAGE_DECODE(16);
#undef MIRAGE_DECODE
  }
  if (splits > 1)
    launch_splitk_reduce(ws, out, static_cast<long long>(E) * M * N, splits,
                         stream);
}

// out[i] = ws[0][i] + ws[1][i] + ... in split order, for i < mn (also the
// stream route's reduction, mirage_gemm_stack.cu).
void launch_splitk_reduce(const float* ws, float* out, long long mn,
                          int splits, cudaStream_t stream) {
  long long blocks = (mn + 255) / 256;
  if (blocks > 4LL * sm_count()) blocks = 4LL * sm_count();
  splitk_reduce_kernel<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
      ws, out, mn, splits);
}
