// Fused Mirage GEMM: out = bfp(x) @ bfp(w), both operands BFP(b_m, g)
// quantized along K inside the kernel, f32 accumulation.
//
// Replaces: src/repro/kernels/mirage_gemm.py:50 `mirage_gemm_pallas` (body
// `_kernel` :28, call :82), whose prologue is the quantizer of
// src/repro/kernels/bfp_quantize.py (`_quantize_block`, here bfp.cuh).
//
// Bound: at decode (M = serving slots <= 8) bytes, since every weight
// element is read once for a few operations (the tied head alone reads
// 896 x 151936 x 4 B = 544 MB per call); at prefill (M = batch x bucket)
// operations, 2*M*N*K f32 FMAs on the CUDA cores.
// Design: a block owns a BM x 64 output tile and walks K in 64-wide tiles.
// Each step stages an x tile (BM x 64) and a w tile (64 x 64) in shared
// memory, quantizes x in groups of g along each row and w in groups of g
// consecutive k down each column (the layout of bfp_quantize_contract) in
// place, with one thread per group, then accumulates the folded products
// in registers (TM x 4 outputs per thread). Groups never straddle a tile
// because 64 % g == 0 and tiles start at multiples of 64, so the K loop
// needs no cross-block reduction. Every folded product is exact in f32;
// only the order of the f32 sum differs from the plain version. Small M
// takes BM = 16 so decode does not spend 4x the FMAs on empty rows. The
// weight may be (K, N) row-major or (N, K) row-major (the tied head reads
// the embedding table in place, with no transposed copy). Ragged edges
// load as zeros, which never raise a group max.
// Not yet: wgmma/TMA, bf16 operands (BFP(b_m <= 6) values are exact in
// bf16), split-K for the narrow decode GEMMs, and weights quantized once.
#include "bfp.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kTN = 4;
constexpr int kThreads = 256;  // 16 row-threads x 16 column-threads

template <int TM, bool kWeightNK>
__global__ void __launch_bounds__(kThreads)
    mirage_gemm_kernel(const float* __restrict__ x,
                       const float* __restrict__ w, float* __restrict__ out,
                       int M, int N, int K, int g, int b_m, bool truncate) {
  constexpr int BM = 16 * TM;
  __shared__ float xs[BM][kBK + 1];
  __shared__ float ws[kBK][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx + 16 * j
  const int ty = tid / 16;  // output rows ty + 16 * i
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;
  const int groups_per_row = kBK / g;

  float acc[TM][kTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < M && gk < K) ? x[static_cast<size_t>(gm) * K + gk]
                                    : 0.0f;
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      int r, c;  // r: k within the tile, c: n within the tile
      if (kWeightNK) {
        r = e % kBK;  // consecutive threads read consecutive k of one row
        c = e / kBK;
      } else {
        r = e / kBN;  // consecutive threads read consecutive n of one row
        c = e % kBN;
      }
      const int gk = k0 + r, gn = n0 + c;
      float val = 0.0f;
      if (gk < K && gn < N)
        val = kWeightNK ? w[static_cast<size_t>(gn) * K + gk]
                        : w[static_cast<size_t>(gk) * N + gn];
      ws[r][c] = val;
    }
    __syncthreads();

    for (int e = tid; e < BM * groups_per_row; e += kThreads) {
      const int r = e % BM, j = e / BM;
      bfp_quantize_group(&xs[r][j * g], &xs[r][j * g], 1, g, b_m, truncate);
    }
    for (int e = tid; e < kBN * groups_per_row; e += kThreads) {
      const int c = e % kBN, j = e / kBN;
      bfp_quantize_group(&ws[j * g][c], &ws[j * g][c], kBN + 1, g, b_m,
                         truncate);
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], b[kTN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[static_cast<size_t>(gm) * N + gn] = acc[i][j];
    }
  }
}

template <int TM>
void launch_tm(const float* x, const float* w, float* out, int M, int N,
               int K, bool w_nk, int g, int b_m, bool truncate,
               cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + 16 * TM - 1) / (16 * TM));
  if (w_nk)
    mirage_gemm_kernel<TM, true><<<grid, kThreads, 0, stream>>>(
        x, w, out, M, N, K, g, b_m, truncate);
  else
    mirage_gemm_kernel<TM, false><<<grid, kThreads, 0, stream>>>(
        x, w, out, M, N, K, g, b_m, truncate);
}

}  // namespace

// x: (M, K) row-major; w: (K, N) row-major, or (N, K) row-major when w_nk;
// out: (M, N) row-major. g must divide 64 (checked by the caller).
void launch_mirage_gemm(const float* x, const float* w, float* out, int M,
                        int N, int K, bool w_nk, int g, int b_m,
                        bool truncate, cudaStream_t stream) {
  if (M == 0 || N == 0) return;
  if (M <= 16)
    launch_tm<1>(x, w, out, M, N, K, w_nk, g, b_m, truncate, stream);
  else
    launch_tm<4>(x, w, out, M, N, K, w_nk, g, b_m, truncate, stream);
}
