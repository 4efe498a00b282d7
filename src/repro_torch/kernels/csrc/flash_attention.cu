// GQA flash attention, forward: online softmax with causal, sliding-window
// and padding masks, f32.
//
// Replaces: src/repro/kernels/flash_attention.py:81 `flash_attention` (body
// `_kernel` :34, call :112). It is prefill attention on the serving path.
//
// Bound: operations at the prefill shapes (4 L^2 H D FLOPs for Q K^T and
// P V, halved by the causal mask, against (2 L H + 2 L Kv) D * 4 bytes of
// operands). The TPU kernel's point is kept: scores, probabilities and the
// running (m, l, acc) never reach device memory.
// Design: grid (B * H, ceil(Lq / 64)); one thread owns one query row, with
// the row's q and its output accumulator (64 floats each) in registers and
// its running max m and denominator l in registers. Each step stages a
// 32-key K tile and V tile in shared memory, which every thread of the
// block reads (broadcast), writes the row's 32 masked scores to shared
// memory, then rescales and accumulates. Key tiles wholly above the
// block's causal diagonal or wholly behind its window are skipped: a fully
// masked tile changes no row that has a valid key later, exactly as in
// the reference (alpha = exp(-1e30 - m) = 0 wipes it). The GQA map is the
// TPU kernel's index map (flash_attention.py:118-124): query head h of
// batch b reads kv head b * Kv + h / rep, so repeated KV is never
// materialized. Operands are read in place in the model's (B, L, heads, D)
// layout. NEG_INF = -1e30 and the denominator clamp 1e-30 are the
// reference's (:31, :73-74). Only head_dim 64 is built (the slice's case).
// Not yet: tensor cores (wgmma) for Q K^T and P V, more than one warp
// per 64 rows, a backward kernel.
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;   // query rows per block = threads per block
constexpr int kBKV = 32;  // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kBQ)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Lq, int S, int H, int Kv, bool causal, int window,
                     float sm_scale) {
  __shared__ float ks[kBKV][D];
  __shared__ float vs[kBKV][D];
  __shared__ float ss[kBQ][kBKV + 1];

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / Kv);  // kv head of query head h, within batch b
  const int q_lo = blockIdx.y * kBQ;
  const int qi = q_lo + tid;
  const bool q_valid = qi < Lq;

  float qr[D], acc[D];
  const float* qrow = q + (static_cast<size_t>(b) * Lq + qi) * H * D +
                      static_cast<size_t>(h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = q_valid ? qrow[d] : 0.0f;
    acc[d] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  const int q_hi = min(q_lo + kBQ, Lq) - 1;
  const int kv_end = causal ? min(S, q_hi + 1) : S;
  int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  kv_begin -= kv_begin % kBKV;

  const size_t kv_stride = static_cast<size_t>(Kv) * D;  // one position
  const size_t kv_off = (static_cast<size_t>(b) * S * Kv + kh) * D;
  const float* kbase = k + kv_off;
  const float* vbase = v + kv_off;

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBKV) {
    for (int e = tid; e < kBKV * D; e += kBQ) {
      const int r = e / D, c = e % D;
      const int s = kv0 + r;
      const bool in = s < S;
      ks[r][c] = in ? kbase[static_cast<size_t>(s) * kv_stride + c] : 0.0f;
      vs[r][c] = in ? vbase[static_cast<size_t>(s) * kv_stride + c] : 0.0f;
    }
    __syncthreads();

    float m_tile = kNegInf;
    for (int j = 0; j < kBKV; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], ks[j][d], s);
      s *= sm_scale;
      const int kp = kv0 + j;
      bool ok = kp < S;
      if (causal) ok = ok && qi >= kp;
      if (window > 0) ok = ok && qi - kp < window;
      s = ok ? s : kNegInf;
      ss[tid][j] = s;
      m_tile = fmaxf(m_tile, s);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    float p_sum = 0.0f;
    for (int j = 0; j < kBKV; ++j) {
      const float p = expf(ss[tid][j] - m_new);
      p_sum += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    l = l * alpha + p_sum;
    m = m_new;
    __syncthreads();
  }

  if (q_valid) {
    const float denom = fmaxf(l, 1e-30f);
    float* orow = o + (static_cast<size_t>(b) * Lq + qi) * H * D +
                  static_cast<size_t>(h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] / denom;
  }
}

}  // namespace

// q, o: (B, Lq, H, D); k, v: (B, S, Kv, D); all row-major f32. window <= 0
// means no sliding window. The caller checks D == 64 and H % Kv == 0.
void launch_flash_attention(const float* q, const float* k, const float* v,
                            float* o, int B, int Lq, int S, int H, int Kv,
                            int D, bool causal, int window, float sm_scale,
                            cudaStream_t stream) {
  if (B == 0 || Lq == 0 || H == 0) return;
  const dim3 grid(B * H, (Lq + kBQ - 1) / kBQ);
  if (D == 64)
    flash_fwd_kernel<64><<<grid, kBQ, 0, stream>>>(q, k, v, o, Lq, S, H, Kv,
                                                   causal, window, sm_scale);
}
