// Fused single-pass RRNS majority decode: per element, reconstruct X from
// every size-n_required subset of the residues (CRT, signed fold), count the
// moduli consistent with X, turn the count into the subset's vote
// (binom[count - n_required]), and keep the first legal maximum.
//
// Replaces: src/repro/kernels/rrns_decode.py:140 `rrns_decode_pallas`
// (`_decode_flat` :80, body `_decode_kernel` :35), mirrored operation by
// operation in f32. The outputs are the decoded value (int32, 0 where no
// subset is legal) and the winner's vote count (f32, -1 where none is
// legal); `corrected` and the health counts are computed from the votes
// outside, as rrns_decode.py:120-136 does.
//
// Bound: bytes, near the card's balance point. An element reads n_total
// int32 residues and writes 8 bytes (28 at the paper point) for S x
// (8 n_total + 12) f32 operations (520 at S = 10 subsets, n_total = 5).
// Design: one thread per element, coalesced along the element axis of each
// residue row, in a grid-stride loop over a grid of a few blocks per SM.
// The TPU kernel's subset-major grid (revisiting an output block once per
// subset) becomes a loop over the S subsets inside the thread, with the
// running winner in registers. The tables (rns.cuh, some 3 KB) live in a
// small device tensor the wrapper caches per moduli set; each block copies
// them to shared memory once, so one build serves any f32-exact moduli set.
// Every sum and product is an exact f32 integer below 2^24
// (tables.f32_exact); the __*_rn intrinsics keep nvcc from contracting
// a*b + c into an FMA, which the reference's double rounding in
// floor(acc * inv_M + 0.5) needs. Strict > keeps the first maximum (the
// oracle's dict insertion order).
#include <cuda_runtime.h>

#include "rns.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr int kSms = 132;

__global__ void __launch_bounds__(kThreads)
    rrns_decode_kernel(const int* __restrict__ res, int* __restrict__ decoded,
                       float* __restrict__ votes_out, long long E,
                       const RrnsTables* __restrict__ tables) {
  __shared__ RrnsTables t;
  const float* src = reinterpret_cast<const float*>(tables);
  float* dst = reinterpret_cast<float*>(&t);
  for (int j = threadIdx.x; j < kRrnsTableWords; j += kThreads) dst[j] = src[j];
  __syncthreads();
  const int n_total = static_cast<int>(t.n_total);
  const int n_required = static_cast<int>(t.n_required);
  const int n_subsets = static_cast<int>(t.n_subsets);

  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < E; e += static_cast<long long>(gridDim.x) * kThreads) {
    float r[kRrnsMaxTotal];
#pragma unroll
    for (int i = 0; i < kRrnsMaxTotal; ++i)
      r[i] = i < n_total ? static_cast<float>(res[i * E + e]) : 0.0f;

    float best_v = -2.0f, best_x = 0.0f;
    for (int s = 0; s < n_subsets; ++s) {
      // reconstruction over all positions (non-member weights are 0), in
      // position order as the reference's accumulation
      float acc = __fmul_rn(r[0], t.weight[s][0]);
#pragma unroll
      for (int i = 1; i < kRrnsMaxTotal; ++i)
        if (i < n_total) acc = __fadd_rn(acc, __fmul_rn(r[i], t.weight[s][i]));
      const float Ms = t.sub_M[s];
      // round-based signed fold into [psi_s + 1 - M_s, psi_s]
      const float q =
          floorf(__fadd_rn(__fmul_rn(acc, t.sub_inv_M[s]), 0.5f));
      float X = __fsub_rn(acc, __fmul_rn(q, Ms));
      if (X > t.sub_psi[s]) X = __fsub_rn(X, Ms);
      if (X < t.sub_lo[s]) X = __fadd_rn(X, Ms);
      // consistency count over all positions (members agree by CRT)
      int cons = 0;
#pragma unroll
      for (int i = 0; i < kRrnsMaxTotal; ++i) {
        if (i < n_total) {
          const float d = __fsub_rn(X, r[i]);
          const float k = rintf(__fmul_rn(d, t.inv_mod[i]));
          cons += __fsub_rn(d, __fmul_rn(k, t.mod[i])) == 0.0f;
        }
      }
      const int extra = cons - n_required;
      float v = t.binom[extra >= 1 ? extra : 0];
      if (!(fabsf(X) <= t.psi)) v = -1.0f;
      if (v > best_v) {
        best_v = v;
        best_x = X;
      }
    }
    decoded[e] = best_v >= 0.0f ? static_cast<int>(best_x) : 0;
    votes_out[e] = best_v;
  }
}

}  // namespace

// res: (n_total, E) int32 row-major; decoded: (E,) int32; votes: (E,) f32;
// tables: kRrnsTableWords floats on the device. The tables' bounds
// (n_total <= kRrnsMaxTotal, S <= kRrnsMaxSubsets, f32_exact) are checked by
// the caller.
void launch_rrns_decode(const int* res, int* decoded, float* votes,
                        long long E, const float* tables,
                        cudaStream_t stream) {
  if (E == 0) return;
  long long blocks = (E + kThreads - 1) / kThreads;
  if (blocks > kSms * kBlocksPerSm) blocks = kSms * kBlocksPerSm;
  rrns_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      res, decoded, votes, E, reinterpret_cast<const RrnsTables*>(tables));
}
