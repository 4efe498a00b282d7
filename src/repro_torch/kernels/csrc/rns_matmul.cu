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
// Slots. Each modulus has S slots: the G groups of one GEMM, or the E x G
// (expert, group) slots of an expert stack (the JAX vmap over the MoE
// experts), expert-major. Contiguous operands of at most 65,535 slots
// (every dense GEMM) keep one slot a grid.z index; any other layout takes
// a second kernel with a one-dimensional grid over (slot, row tile,
// column tile), so any slot count fits (qwen3-moe's gate/up stack under
// RRNS has 5 x 128 x 128 = 81,920, past grid.z's 65,535). One kernel for
// both measured 3% (decode) to 27% (prefill) slower at the dense shapes
// on the H100, so the dense layout keeps its own. Each modulus's slots
// are contiguous, with the caller's stride between moduli, so a block of
// whole experts sliced from a larger stack runs in place. The readout
// noise has a group period P: slot s of a modulus reads noise[s mod P],
// so one draw at one expert's shape (P = G) serves every expert without
// being copied E times.
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
constexpr int kMaxGridZ = 65535;

// The modulus of residue channel mi and its ADC step. Constant indices
// only: a runtime index into a by-value parameter would make the compiler
// copy the struct to local memory.
__device__ __forceinline__ void modulus_of(const RnsModuli& mods, int mi,
                                           int& m, float& step) {
  m = mods.m[0];
  step = mods.step[0];
#pragma unroll
  for (int i = 1; i < kRnsMaxModuli; ++i) {
    if (mi == i) {
      m = mods.m[i];
      step = mods.step[i];
    }
  }
}

// The readout epilogue of one residue o in [0, m): mod(round(o + noise),
// m) (rns_matmul.py:119), counting a moved residue, then the ADC re-grid
// (rns_matmul.py:120-123).
__device__ __forceinline__ int readout(int o, float nz, int m, float step,
                                       unsigned& moved) {
  const float v = rintf(__fadd_rn(static_cast<float>(o), nz));
  int iv = static_cast<int>(v) % m;
  if (iv < 0) iv += m;  // jnp.mod takes the sign of the divisor
  moved += iv != o;
  float of = static_cast<float>(iv);
  if (step > 0.0f) {
    const float q = rintf(__fmul_rn(rintf(__fdiv_rn(of, step)), step));
    of = fminf(fmaxf(q, 0.0f), static_cast<float>(m - 1));
  }
  return static_cast<int>(of);
}

__device__ __forceinline__ void count_moved(unsigned moved,
                                            unsigned long long* flips,
                                            int mi) {
  for (int off = 16; off > 0; off >>= 1)
    moved += __shfl_down_sync(0xffffffffu, moved, off);
  if (threadIdx.x % 32 == 0 && moved)
    atomicAdd(flips + mi, static_cast<unsigned long long>(moved));
}

// Contiguous operands, one slot a grid.z index (n_mod x S <= 65,535), the
// noise shaped as the output.
template <int TM, int kG, bool kChannel>
__global__ void __launch_bounds__(kBN)
    rns_matmul_kernel(const int* __restrict__ x, const int* __restrict__ w,
                      const float* __restrict__ noise, int* __restrict__ out,
                      unsigned long long* __restrict__ flips, int G, int M,
                      int N, int g, RnsModuli mods) {
  __shared__ int xs[TM][kG];
  const int slot = blockIdx.z;
  const int mi = slot / G;
  int m;
  float step;
  modulus_of(mods, mi, m, step);
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
    out[idx] = kChannel ? readout(o, noise[idx], m, step, moved) : o;
  }
  if (kChannel && flips != nullptr) count_moved(moved, flips, mi);
}

// The general slot layout: any slot count (a one-dimensional grid over
// (slot, row tile, column tile), column tiles fastest), each modulus's
// slots contiguous with x_ms / w_ms / noise_ms elements between moduli,
// and the noise read at a group period: slot s of a modulus reads its
// noise at s mod period.
template <int TM, int kG, bool kChannel>
__global__ void __launch_bounds__(kBN)
    rns_matmul_slots_kernel(const int* __restrict__ x, long long x_ms,
                            const int* __restrict__ w, long long w_ms,
                            const float* __restrict__ noise,
                            long long noise_ms, int period,
                            int* __restrict__ out,
                            unsigned long long* __restrict__ flips, int S,
                            int M, int N, int g, int n_tiles, int m_tiles,
                            RnsModuli mods) {
  __shared__ int xs[TM][kG];
  const unsigned b = blockIdx.x;
  const unsigned rest = b / n_tiles;
  const int nt = static_cast<int>(b - rest * n_tiles);
  const unsigned slot = rest / m_tiles;  // in [0, n_mod * S)
  const int mt = static_cast<int>(rest - slot * m_tiles);
  const int mi = static_cast<int>(slot / S);
  const int s = static_cast<int>(slot) - mi * S;
  int m;
  float step;
  modulus_of(mods, mi, m, step);
  const int n = nt * kBN + threadIdx.x;
  const int m0 = mt * TM;
  const int rows = min(TM, M - m0);

  const int* xb = x + mi * x_ms + (static_cast<size_t>(s) * M + m0) * g;
  for (int e = threadIdx.x; e < TM * kG; e += kBN) {
    const int r = e / kG, k = e % kG;
    xs[r][k] = (r < rows && k < g) ? xb[static_cast<size_t>(r) * g + k] : 0;
  }
  int wc[kG];
  const int* wb = w + mi * w_ms + static_cast<size_t>(s) * g * N;
#pragma unroll
  for (int k = 0; k < kG; ++k)
    wc[k] = (k < g && n < N) ? wb[static_cast<size_t>(k) * N + n] : 0;
  __syncthreads();
  const bool live = n < N;
  unsigned moved = 0;
  const float* nb =
      kChannel ? noise + mi * noise_ms +
                     (static_cast<size_t>(s % period) * M + m0) * N
               : nullptr;

  for (int r = 0; r < (live ? rows : 0); ++r) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < kG; ++k) acc += xs[r][k] * wc[k];
    const size_t idx = (static_cast<size_t>(slot) * M + m0 + r) * N + n;
    const int o = acc % m;  // acc >= 0, so o is in [0, m)
    out[idx] = kChannel ? readout(o, nb[static_cast<size_t>(r) * N + n], m,
                                  step, moved)
                        : o;
  }
  if (kChannel && flips != nullptr) count_moved(moved, flips, mi);
}

struct RnsArgs {
  const int* x;
  long long x_ms;
  const int* w;
  long long w_ms;
  const float* noise;
  long long noise_ms;
  int period;
  int* out;
  unsigned long long* flips;
  int n_mod, S, M, N, g;
};

template <int TM, int kG, bool kChannel>
void launch_kg(const RnsArgs& a, const RnsModuli& mods, cudaStream_t stream) {
  const int n_tiles = (a.N + kBN - 1) / kBN;
  const int m_tiles = (a.M + TM - 1) / TM;
  const long long n_slots = static_cast<long long>(a.n_mod) * a.S;
  const long long plane = static_cast<long long>(a.S) * a.M;
  const bool dense =
      n_slots <= kMaxGridZ && a.x_ms == plane * a.g &&
      a.w_ms == static_cast<long long>(a.S) * a.g * a.N &&
      (!kChannel || (a.period == a.S && a.noise_ms == plane * a.N));
  if (dense) {
    const dim3 grid(n_tiles, m_tiles, static_cast<unsigned>(n_slots));
    rns_matmul_kernel<TM, kG, kChannel><<<grid, kBN, 0, stream>>>(
        a.x, a.w, a.noise, a.out, a.flips, a.S, a.M, a.N, a.g, mods);
  } else {
    const dim3 grid(static_cast<unsigned>(static_cast<long long>(n_tiles) *
                                          m_tiles * n_slots));
    rns_matmul_slots_kernel<TM, kG, kChannel><<<grid, kBN, 0, stream>>>(
        a.x, a.x_ms, a.w, a.w_ms, a.noise, a.noise_ms, a.period, a.out,
        a.flips, a.S, a.M, a.N, a.g, n_tiles, m_tiles, mods);
  }
}

template <int TM, bool kChannel>
void launch_tm(const RnsArgs& a, const RnsModuli& mods, cudaStream_t stream) {
  if (a.g <= 16)
    launch_kg<TM, 16, kChannel>(a, mods, stream);
  else if (a.g <= 32)
    launch_kg<TM, 32, kChannel>(a, mods, stream);
  else
    launch_kg<TM, 64, kChannel>(a, mods, stream);
}

template <bool kChannel>
void launch(const RnsArgs& a, const RnsModuli& mods, cudaStream_t stream) {
  if (a.M <= 16)
    launch_tm<16, kChannel>(a, mods, stream);
  else
    launch_tm<64, kChannel>(a, mods, stream);
}

}  // namespace

// x: (n_mod, S, M, g) and w: (n_mod, S, g, N), each modulus's slots
// contiguous and x_ms / w_ms elements from one modulus to the next; out:
// (n_mod, S, M, N) contiguous; residues in [0, m). 1 <= g <= 64, n_mod <=
// kRnsMaxModuli and n_mod * S * row tiles * column tiles <= 2^31 - 1 are
// checked by the caller. Contiguous operands of at most 65,535 slots (with
// the noise shaped as the output) take rns_matmul_kernel, all others
// rns_matmul_slots_kernel.
void launch_rns_matmul(const int* x, long long x_ms, const int* w,
                       long long w_ms, int* out, int n_mod, int S, int M,
                       int N, int g, const RnsModuli& mods,
                       cudaStream_t stream) {
  if (M == 0 || N == 0 || n_mod * S == 0) return;
  launch<false>({x, x_ms, w, w_ms, nullptr, 0, 1, out, nullptr, n_mod, S, M,
                 N, g},
                mods, stream);
}

// noise: (n_mod, period, M, N), each modulus's part contiguous, noise_ms
// elements apart; S is a multiple of period. flips: nullptr, or n_mod
// counters the epilogue adds the moved residues to.
void launch_rns_matmul_channel(const int* x, long long x_ms, const int* w,
                               long long w_ms, const float* noise,
                               long long noise_ms, int period, int* out,
                               unsigned long long* flips, int n_mod, int S,
                               int M, int N, int g, const RnsModuli& mods,
                               cudaStream_t stream) {
  if (M == 0 || N == 0 || n_mod * S == 0) return;
  launch<true>({x, x_ms, w, w_ms, noise, noise_ms, period, out, flips, n_mod,
                S, M, N, g},
               mods, stream);
}
