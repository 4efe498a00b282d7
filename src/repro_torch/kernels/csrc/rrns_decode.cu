// Fused single-pass RRNS majority decode: per element, reconstruct X from
// the size-n_required subsets of the residues in order (CRT, signed fold),
// count the moduli consistent with X, turn the count into the subset's vote
// (binom[count - n_required]), and keep the first legal maximum.
//
// Replaces: src/repro/kernels/rrns_decode.py:140 `rrns_decode_pallas`
// (`_decode_flat` :80, body `_decode_kernel` :35), mirrored operation by
// operation in f32. The outputs are the decoded value (int32, 0 where no
// subset is legal) and the winner's vote count (f32, -1 where none is
// legal); `corrected` and the health counts are computed from the votes
// outside, as rrns_decode.py:120-136 does.
//
// Bound: bytes. An element reads n_total int32 residues and writes 8 bytes
// (28 at the paper point). The work depends on the data: each subset costs
// about 8 n_total + 12 f32 operations, and an element stops at the first
// subset that reaches the largest vote binom[n_total - n_required], which
// only a subset whose X every residue agrees with (and |X| <= psi) gets. The
// votes rise with the count (the wrapper checks binom is strictly
// increasing), and the winner is the first strict maximum, so no later
// subset can displace it: stopping there gives the same outputs. An
// error-free element needs subset 0 alone; at 52 dB all but about one
// element in 10^6 are error-free, so the decode reads its residues at about
// 50 operations per element, well below the card's balance point.
// Design: each thread takes 4 consecutive elements with 16-byte loads and
// stores (scalar loads where E is not a multiple of 4), in a grid-stride
// loop over a grid of a few blocks per SM, and loops over the subsets while
// any of its elements is still open; a warp with a faulty element simply
// runs on. The tables (rns.cuh, 3.2 KB) are a `__grid_constant__` kernel
// parameter: the subset index is the same across the warp, so each table
// read is a broadcast from the constant bank, with no per-block copy.
// Every sum and product is an exact f32 integer below 2^24
// (tables.f32_exact); the __*_rn intrinsics keep nvcc from contracting
// a*b + c into an FMA, which the reference's double rounding in
// floor(acc * inv_M + 0.5) needs. Strict > keeps the first maximum (the
// oracle's dict insertion order).
#include <cuda_runtime.h>

#include <cstdint>

#include "rns.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
    rrns_decode_kernel(const int* __restrict__ res, int* __restrict__ decoded,
                       float* __restrict__ votes_out, long long E, bool vec,
                       const __grid_constant__ RrnsTables t) {
  const int n_total = static_cast<int>(t.n_total);
  const int n_required = static_cast<int>(t.n_required);
  const int n_subsets = static_cast<int>(t.n_subsets);
  const float v_max = t.binom[n_total - n_required];

  const long long stride =
      static_cast<long long>(gridDim.x) * kThreads * kPerThread;
  for (long long e0 = (static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x) * kPerThread;
       e0 < E; e0 += stride) {
    float r[kPerThread][kRrnsMaxTotal];
#pragma unroll
    for (int i = 0; i < kRrnsMaxTotal; ++i) {
      if (i < n_total) {
        const int* row = res + i * E + e0;
        if (vec) {
          const int4 q = *reinterpret_cast<const int4*>(row);
          r[0][i] = static_cast<float>(q.x);
          r[1][i] = static_cast<float>(q.y);
          r[2][i] = static_cast<float>(q.z);
          r[3][i] = static_cast<float>(q.w);
        } else {
#pragma unroll
          for (int j = 0; j < kPerThread; ++j)
            r[j][i] = e0 + j < E ? static_cast<float>(row[j]) : 0.0f;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j) r[j][i] = 0.0f;
      }
    }

    float best_v[kPerThread], best_x[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      // elements past E start closed
      best_v[j] = e0 + j < E ? -2.0f : v_max;
      best_x[j] = 0.0f;
    }
    for (int s = 0; s < n_subsets; ++s) {
      bool open = false;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) open |= best_v[j] < v_max;
      if (!open) break;
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (!(best_v[j] < v_max)) continue;
        // reconstruction over all positions (non-member weights are 0), in
        // position order as the reference's accumulation
        float acc = __fmul_rn(r[j][0], t.weight[s][0]);
#pragma unroll
        for (int i = 1; i < kRrnsMaxTotal; ++i)
          if (i < n_total)
            acc = __fadd_rn(acc, __fmul_rn(r[j][i], t.weight[s][i]));
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
            const float d = __fsub_rn(X, r[j][i]);
            const float k = rintf(__fmul_rn(d, t.inv_mod[i]));
            cons += __fsub_rn(d, __fmul_rn(k, t.mod[i])) == 0.0f;
          }
        }
        const int extra = cons - n_required;
        float v = t.binom[extra >= 1 ? extra : 0];
        if (!(fabsf(X) <= t.psi)) v = -1.0f;
        if (v > best_v[j]) {
          best_v[j] = v;
          best_x[j] = X;
        }
      }
    }

    int dec[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      dec[j] = best_v[j] >= 0.0f ? static_cast<int>(best_x[j]) : 0;
    if (vec) {
      *reinterpret_cast<int4*>(decoded + e0) =
          make_int4(dec[0], dec[1], dec[2], dec[3]);
      *reinterpret_cast<float4*>(votes_out + e0) =
          make_float4(best_v[0], best_v[1], best_v[2], best_v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        if (e0 + j < E) {
          decoded[e0 + j] = dec[j];
          votes_out[e0 + j] = best_v[j];
        }
      }
    }
  }
}

}  // namespace

// res: (n_total, E) int32 row-major; decoded: (E,) int32; votes: (E,) f32.
// The tables' bounds (n_total <= kRrnsMaxTotal, S <= kRrnsMaxSubsets,
// f32_exact, binom strictly increasing) are checked by the caller.
void launch_rrns_decode(const int* res, int* decoded, float* votes,
                        long long E, const RrnsTables& tables,
                        cudaStream_t stream) {
  if (E == 0) return;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const bool vec = E % kPerThread == 0 &&
                   ((reinterpret_cast<uintptr_t>(res) |
                     reinterpret_cast<uintptr_t>(decoded) |
                     reinterpret_cast<uintptr_t>(votes)) & 15) == 0;
  long long blocks =
      (E + kThreads * kPerThread - 1) / (kThreads * kPerThread);
  const long long cap = static_cast<long long>(sms > 0 ? sms : 1) *
                        kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  rrns_decode_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      res, decoded, votes, E, vec, tables);
}
