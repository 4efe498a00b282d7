// Standalone BFP fake quantization of a (rows, K) f32 matrix along K.
//
// Replaces: src/repro/kernels/bfp_quantize.py:55 `bfp_fake_quant_pallas`
// (body `_kernel` :49, call :89). On the serving path the same quantizer runs
// as the fused GEMM's prologue (mirage_gemm.cu); this launch exists so the
// quantizer can be held bit for bit against its plain version on the card.
//
// Bound: bytes. Each element is read once and written once (8 bytes) for a
// handful of integer and float operations, far below the card's
// operations-per-byte balance point.
// Design: one thread per group of g, so a group's max and its quantization
// stay in one thread with no reduction across threads. The group is read
// twice (max, then quantize); the second read hits L1. Neighbouring threads
// own neighbouring groups, so each warp walks a contiguous span of the row.
#include "bfp.cuh"

namespace {

__global__ void bfp_fake_quant_kernel(const float* __restrict__ x,
                                      float* __restrict__ out, int rows,
                                      int K, int g, int b_m, bool truncate) {
  const int groups = (K + g - 1) / g;
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= static_cast<long long>(rows) * groups) return;
  const int r = static_cast<int>(gid / groups);
  const int k0 = static_cast<int>(gid % groups) * g;
  const size_t base = static_cast<size_t>(r) * K + k0;
  bfp_quantize_group(x + base, out + base, 1, min(g, K - k0), b_m, truncate);
}

}  // namespace

void launch_bfp_fake_quant(const float* x, float* out, int rows, int K, int g,
                           int b_m, bool truncate, cudaStream_t stream) {
  const long long groups = static_cast<long long>(rows) * ((K + g - 1) / g);
  if (groups == 0) return;
  constexpr int kThreads = 256;
  const unsigned blocks =
      static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  bfp_fake_quant_kernel<<<blocks, kThreads, 0, stream>>>(x, out, rows, K, g,
                                                         b_m, truncate);
}
