// Standalone BFP fake quantization of a (rows, K) f32 matrix along K.
//
// Replaces: src/repro/kernels/bfp_quantize.py:55 `bfp_fake_quant_pallas`
// (body `_kernel` :49, call :89). On the serving path the same quantizer runs
// as the fused GEMM's prologue (mirage_gemm.cu); this launch quantizes whole
// matrices (weights before serving, gradients in training) and holds the
// quantizer bit for bit against its plain version on the card.
//
// Bound: bytes. Each element is read once and written once (8 bytes) for a
// handful of integer and float operations, far below the card's
// operations-per-byte balance point.
//
// Two routes, picked by the wrapper (repro_torch/kernels/ops.py
// `bfp_quant_plan`):
// * vector (g % 4 == 0, g <= 128, K % 4 == 0, 16-byte aligned operands):
//   each lane loads 4 consecutive floats as one float4, the g/4 lanes of a
//   group (padded to a power of two, GP lanes) take the group max with
//   __shfl_xor_sync, and each lane quantizes its 4 values in registers and
//   writes one float4. A warp's loads and stores cover 512 contiguous bytes
//   where K % g == 0 and GP == g/4 (the dense case: lane index = float4
//   index, no division). Otherwise a row's last group is partial or a group
//   has idle lanes, and the lane's row and column come from its index. A
//   grid-stride loop, the grid sized by the card's SM count.
// * scalar (every other shape): one thread per group of g, read twice (max,
//   then quantize); the second read hits L1.
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

// GP lanes per group (a power of two <= 32) over `lanes` = rows x groups x
// GP virtual lanes; lane li of a group holds floats 4 li .. 4 li + 3 of it
template <int GP, bool kDense>
__global__ void bfp_fake_quant_vec_kernel(const float4* __restrict__ x,
                                          float4* __restrict__ out, int K4,
                                          int g4, int groups, int b_m,
                                          bool truncate, long long lanes) {
  const int lane = threadIdx.x % 32;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long w0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      (threadIdx.x - lane);
       w0 < lanes; w0 += stride) {
    const long long vl = w0 + lane;
    long long idx = vl;  // float4 index into x and out
    bool ok = vl < lanes;
    if (!kDense) {
      const long long row_lanes = static_cast<long long>(groups) * GP;
      const long long r = vl / row_lanes;
      const int rem = static_cast<int>(vl - r * row_lanes);
      const int li = rem % GP, col4 = rem / GP * g4 + li;
      ok = ok && li < g4 && col4 < K4;
      idx = r * K4 + col4;
    }
    const float4 a = ok ? x[idx] : make_float4(0.f, 0.f, 0.f, 0.f);
    float m = fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)),
                    fmaxf(fabsf(a.z), fabsf(a.w)));
#pragma unroll
    for (int s = 1; s < GP; s <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, s));
    const BfpGrid grid = bfp_grid(m, b_m);
    if (ok)
      out[idx] = make_float4(bfp_quantize_value(a.x, grid, truncate),
                             bfp_quantize_value(a.y, grid, truncate),
                             bfp_quantize_value(a.z, grid, truncate),
                             bfp_quantize_value(a.w, grid, truncate));
  }
}

template <int GP>
void launch_vec(const float* x, float* out, int rows, int K, int g, int b_m,
                bool truncate, int blocks, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int K4 = K / 4, g4 = g / 4;
  const int groups = (K + g - 1) / g;
  const bool dense = g4 == GP && K % g == 0;
  const long long lanes = static_cast<long long>(rows) * groups * GP;
  const long long need = (lanes + kThreads - 1) / kThreads;
  const unsigned grid =
      static_cast<unsigned>(need < blocks ? need : blocks);
  const auto* x4 = reinterpret_cast<const float4*>(x);
  auto* o4 = reinterpret_cast<float4*>(out);
  if (dense)
    bfp_fake_quant_vec_kernel<GP, true><<<grid, kThreads, 0, stream>>>(
        x4, o4, K4, g4, groups, b_m, truncate, lanes);
  else
    bfp_fake_quant_vec_kernel<GP, false><<<grid, kThreads, 0, stream>>>(
        x4, o4, K4, g4, groups, b_m, truncate, lanes);
}

}  // namespace

// vector: the wrapper's route (it checked g % 4 == 0, g <= 128, K % 4 == 0
// and 16-byte alignment); blocks: the vector route's grid (SMs x 8)
void launch_bfp_fake_quant(const float* x, float* out, int rows, int K, int g,
                           int b_m, bool truncate, bool vector, int blocks,
                           cudaStream_t stream) {
  const long long groups = static_cast<long long>(rows) * ((K + g - 1) / g);
  if (groups == 0) return;
  if (vector) {
    const int g4 = g / 4;
    if (g4 <= 1)
      launch_vec<1>(x, out, rows, K, g, b_m, truncate, blocks, stream);
    else if (g4 <= 2)
      launch_vec<2>(x, out, rows, K, g, b_m, truncate, blocks, stream);
    else if (g4 <= 4)
      launch_vec<4>(x, out, rows, K, g, b_m, truncate, blocks, stream);
    else if (g4 <= 8)
      launch_vec<8>(x, out, rows, K, g, b_m, truncate, blocks, stream);
    else if (g4 <= 16)
      launch_vec<16>(x, out, rows, K, g, b_m, truncate, blocks, stream);
    else
      launch_vec<32>(x, out, rows, K, g, b_m, truncate, blocks, stream);
    return;
  }
  constexpr int kThreads = 256;
  const unsigned n_blocks =
      static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  bfp_fake_quant_kernel<<<n_blocks, kThreads, 0, stream>>>(x, out, rows, K, g,
                                                           b_m, truncate);
}
