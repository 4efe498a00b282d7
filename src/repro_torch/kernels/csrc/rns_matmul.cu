// Group-batched residue GEMM: for every (modulus, group) slot s,
// out[s] = (x[s] @ w[s]) mod m_s, with m_s = moduli[s / G]; optionally
// followed by the analog readout channel (detector noise + ADC re-grid).
//
// Replaces: src/repro/kernels/rns_matmul.py:52 `rns_matmul_pallas` (body
// `_kernel` :36) and :131 `rns_matmul_pallas_channel` (body
// `_kernel_channel` :102), as called by src/repro/kernels/ops.py:43
// `rns_group_matmul` and :65 `rns_group_matmul_channel` with the
// (modulus, group) axes flattened into one grid. One template serves both:
// kChannel switches the readout epilogue on.
//
// Bound: bytes. Each output residue costs 2g = 32 integer operations (at
// g = 16) against 4 bytes written (8 with the noise read), below the
// card's operations-per-byte balance; at decode the n_mod x G x M x N
// residue tensor (the tied head's alone is 5 x 56 x 4 x 151936 int32 =
// 681 MB) and the stationary weight residues dominate the traffic.
// Design: int32 arithmetic, not the TPU's f32: residues are below 2^10 and
// g <= 64, so a group dot is exact in int32 without the TPU's K-blocking
// under 2^24, and mod being a ring homomorphism any exact integer path
// gives the reference's residues. A block owns one slot, TM output rows and
// 128 output columns (one per thread); it stages the x tile (TM x g,
// zero-padded to kG) in shared memory, each thread keeps its weight column
// in registers, and writes one residue per row, so writes coalesce along N
// and the weight column is read once per TM rows. The readout epilogue runs
// in f32 in the reference's order: add, round half to even (rintf), wrap
// mod m, then IEEE division by the ADC step, rintf, multiply, rintf, clip;
// the __*_rn intrinsics keep nvcc from contracting it into FMAs. Where the
// caller passes counters, the epilogue also counts, per modulus, the
// residues the noise moved (the wrapped residue against the clean one,
// before the ADC, as src/repro/analog/channel.py:323-335 counts them): a
// warp's sum goes to the modulus's int64 counter with one atomic add, so
// the count is exact whatever the order.
// Not yet: uint8 residues, drawing the noise in-kernel (Philox) instead of
// reading a pre-sampled tensor, and fusing the decode and scale-accumulate
// so the residue tensor never reaches device memory.
#include <cuda_runtime.h>

#include <cstddef>

#include "rns.cuh"

namespace {

constexpr int kBN = 128;  // threads per block = output columns per block

template <int TM, int kG, bool kChannel>
__global__ void __launch_bounds__(kBN)
    rns_matmul_kernel(const int* __restrict__ x, const int* __restrict__ w,
                      const float* __restrict__ noise, int* __restrict__ out,
                      unsigned long long* __restrict__ flips, int G, int M,
                      int N, int g, RnsModuli mods) {
  __shared__ int xs[TM][kG];
  const int slot = blockIdx.z;
  const int mi = slot / G;
  // constant indices only: a runtime index into a by-value parameter would
  // make the compiler copy the struct to local memory
  int m = mods.m[0];
  float step = mods.step[0];
#pragma unroll
  for (int i = 1; i < kRnsMaxModuli; ++i) {
    if (mi == i) {
      m = mods.m[i];
      step = mods.step[i];
    }
  }
  const int n = blockIdx.x * kBN + threadIdx.x;
  const int m0 = blockIdx.y * TM;
  const int rows = min(TM, M - m0);

  const int* xb = x + (static_cast<size_t>(slot) * M + m0) * g;
  for (int e = threadIdx.x; e < TM * kG; e += kBN) {
    const int r = e / kG, k = e % kG;
    xs[r][k] = (r < rows && k < g) ? xb[static_cast<size_t>(r) * g + k] : 0;
  }
  int wc[kG];
  const int* wb = w + static_cast<size_t>(slot) * g * N;
#pragma unroll
  for (int k = 0; k < kG; ++k)
    wc[k] = (k < g && n < N) ? wb[static_cast<size_t>(k) * N + n] : 0;
  __syncthreads();
  const bool live = n < N;
  unsigned moved = 0;

  for (int r = 0; r < (live ? rows : 0); ++r) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < kG; ++k) acc += xs[r][k] * wc[k];
    const size_t idx = (static_cast<size_t>(slot) * M + m0 + r) * N + n;
    const int o = acc % m;  // acc >= 0, so o is in [0, m)
    if (!kChannel) {
      out[idx] = o;
      continue;
    }
    // o = mod(round(o + noise), m)  (rns_matmul.py:119)
    const float v = rintf(__fadd_rn(static_cast<float>(o), noise[idx]));
    int iv = static_cast<int>(v) % m;
    if (iv < 0) iv += m;  // jnp.mod takes the sign of the divisor
    moved += iv != o;
    float of = static_cast<float>(iv);
    if (step > 0.0f) {  // ADC re-grid (rns_matmul.py:120-123)
      const float q = rintf(__fmul_rn(rintf(__fdiv_rn(of, step)), step));
      of = fminf(fmaxf(q, 0.0f), static_cast<float>(m - 1));
    }
    out[idx] = static_cast<int>(of);
  }
  if (kChannel && flips != nullptr) {
    for (int off = 16; off > 0; off >>= 1)
      moved += __shfl_down_sync(0xffffffffu, moved, off);
    if (threadIdx.x % 32 == 0 && moved)
      atomicAdd(flips + mi, static_cast<unsigned long long>(moved));
  }
}

template <int TM, bool kChannel>
void launch_tm(const int* x, const int* w, const float* noise, int* out,
               unsigned long long* flips, int n_mod, int G, int M, int N,
               int g, const RnsModuli& mods, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + TM - 1) / TM, n_mod * G);
  if (g <= 16)
    rns_matmul_kernel<TM, 16, kChannel><<<grid, kBN, 0, stream>>>(
        x, w, noise, out, flips, G, M, N, g, mods);
  else if (g <= 32)
    rns_matmul_kernel<TM, 32, kChannel><<<grid, kBN, 0, stream>>>(
        x, w, noise, out, flips, G, M, N, g, mods);
  else
    rns_matmul_kernel<TM, 64, kChannel><<<grid, kBN, 0, stream>>>(
        x, w, noise, out, flips, G, M, N, g, mods);
}

template <bool kChannel>
void launch(const int* x, const int* w, const float* noise, int* out,
            unsigned long long* flips, int n_mod, int G, int M, int N, int g,
            const RnsModuli& mods, cudaStream_t stream) {
  if (M <= 16)
    launch_tm<16, kChannel>(x, w, noise, out, flips, n_mod, G, M, N, g, mods,
                            stream);
  else
    launch_tm<64, kChannel>(x, w, noise, out, flips, n_mod, G, M, N, g, mods,
                            stream);
}

}  // namespace

// x: (n_mod, G, M, g), w: (n_mod, G, g, N), out (and noise): (n_mod, G, M,
// N), all row-major; residues in [0, m). 1 <= g <= 64, n_mod <= kRnsMaxModuli
// and n_mod * G <= 65535 are checked by the caller.
void launch_rns_matmul(const int* x, const int* w, int* out, int n_mod,
                       int G, int M, int N, int g, const RnsModuli& mods,
                       cudaStream_t stream) {
  if (M == 0 || N == 0 || n_mod * G == 0) return;
  launch<false>(x, w, nullptr, out, nullptr, n_mod, G, M, N, g, mods,
                stream);
}

// flips: nullptr, or n_mod counters the epilogue adds the moved residues to.
void launch_rns_matmul_channel(const int* x, const int* w, const float* noise,
                               int* out, unsigned long long* flips, int n_mod,
                               int G, int M, int N, int g,
                               const RnsModuli& mods, cudaStream_t stream) {
  if (M == 0 || N == 0 || n_mod * G == 0) return;
  launch<true>(x, w, noise, out, flips, n_mod, G, M, N, g, mods, stream);
}
