// GQA flash attention, forward: online softmax with causal, sliding-window
// and padding masks, f32 in and out, both products on the tensor cores.
//
// Replaces: src/repro/kernels/flash_attention.py:81 `flash_attention` (body
// `_kernel` :34, call :112). It is prefill attention on the serving path.
//
// Bound: at the serving shapes (L <= 128) the bytes of q, k, v and o; the
// work per launch is small, so what the design fights is latency: enough
// warps in flight, few dependent steps per warp, copies in flight while
// the tensor cores work. The TPU kernel's point is kept: scores,
// probabilities and the running (m, l, acc) never reach device memory.
//
// Numerics: S = Q K^T and O += P V run as warp-level
// mma.sync.m16n8k8 TF32 products with the 3xTF32 split: each operand is
// x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and
// lo*hi + hi*lo + hi*hi are accumulated into f32 fragments, small terms
// first (the lo*lo term is below 2^-22 of the product). In S the small
// terms have an accumulator of their own, added to hi*hi's at the end, so
// each dependent chain of MMAs is 8 or 16 long instead of 24; O keeps one
// accumulator per fragment across tiles (its chains are 12 long). Plain
// TF32 keeps 10 mantissa bits and misses the 2e-5 gate against the f32
// plain version; bf16 would need a three-way split and six products. The
// online-softmax
// state (m, l) and the rescale stay in f32 registers; a row's max and sum
// come from the accumulator fragment with two quad shuffles.
//
// Layouts (g = lane / 4, t = lane % 4; the m16n8k8 fragments of the PTX
// ISA): a contraction index may be permuted as long as both operands
// agree, and an output column as long as the store follows. So
//   * in S = Q K^T, k-step 2c + e (e = 0, 1) maps fragment columns t and
//     t + 4 to d = 16c + 4t + 2e and d + 1: a lane reads q and k as float4;
//   * in O += P V, the k-step over keys 8i..8i+7 maps fragment column t to
//     key 8i + 2t and t + 4 to key 8i + 2t + 1, which is where S's
//     accumulator already holds them (c0, c1 = columns 2t, 2t + 1): P goes
//     from the accumulator to the A operand in registers, with no shuffle
//     and no trip through shared memory;
//   * O's columns go in chunks of 32 (and one of 16 where D % 32 == 16):
//     n-tile 4c + j of chunk c maps fragment column n to d = 32c + 4n + j
//     (j < 4), so a lane reads each chunk of a V row as one float4 and
//     writes each chunk of its output rows as two float4; in the 16-wide
//     chunk, n-tile j (< 2) maps n to d = 2n + j, read as a float2 and
//     written as one float4.
// Shared rows are padded so every fragment load is free of bank conflicts:
// K rows are D floats where D % 32 == 16, else D + 16 (quarter-warp
// float4 reads of rows g and g + 1 land 16 banks apart), V rows D + 4
// (rows 2t, t = 0..3, start 8 banks apart).
//
// Head dims: the kernel is a template on D, instantiated at 16, 32, 64,
// 80, 96 and 128 (every D a multiple of 16, so S's k-steps pair up and
// O's n-tiles fill 32- and 16-wide chunks). The wrapper pads any other
// D <= 128 with zero columns up to the next instance: zero columns of q
// and k add nothing to Q K^T, and those of v give output columns that it
// slices off; the scale stays 1/sqrt(true D). Up to D = 64 each warp
// keeps its Q fragments split hi/lo in registers; above, it keeps Q as
// f32 and splits it per tile, since both splits and the D/2 accumulators
// of O would not fit in 255 registers. At D = 96 and 128 the two K/V tile
// buffers take 53 and 69 KB, above the 48 KB of static shared memory, so
// all instances take dynamic shared memory and the large ones raise
// their limit first.
//
// Parallelism: one warp owns 16 query rows of one head; a block of 4 warps
// holds units of one (batch, kv head), ordered position slab first and
// query head second, so the rep = H / Kv query heads that read one kv
// head share the block's K/V tiles (the TPU kernel's index map
// (bh // H) * Kv + (bh % H) // rep, flash_attention.py:118-124, becomes
// the block's (batch, kv head)). Blocks take (batch, kv head) fastest and
// query rows from the last down, so the longest causal rows start first.
// K/V tiles of 32 keys are staged with 16-byte cp.async, double-buffered,
// so the next tile's copy overlaps this tile's MMAs; rows past S are
// zero-filled by the copy. A warp skips tiles wholly above its
// causal diagonal or wholly behind its window: a fully masked tile after a
// valid key changes nothing (p = exp(-1e30 - m) = 0), and one before any
// valid key is wiped by the first valid tile (alpha = exp(-1e30 - m) = 0),
// exactly as in the reference. Scores are scaled by sm_scale before the
// mask; NEG_INF = -1e30 and the denominator clamp 1e-30 are the
// reference's (:31, :73-74).
//
// Not wgmma: its 64-row warpgroup tile is coarse for the 32-128-position
// prefill this kernel serves, and a TF32 wgmma needs its B operand
// K-major, which V in P V is not (a transposed copy of each V tile would
// be needed). Left for a later PR, with a backward kernel.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;      // warps per block
constexpr int kRows = 16;      // query rows per warp
constexpr int kBKV = 32;       // keys per shared-memory tile
constexpr int kStaticSmem = 48 * 1024;  // above it, opt in per kernel

// the layout of one head-dim instance
template <int D>
struct Dims {
  static_assert(D % 16 == 0 && D >= 16 && D <= 128,
                "head dims are multiples of 16 up to 128");
  static constexpr int kQSteps = D / 8;        // k-steps of S over D
  static constexpr int kC32 = D / 32;          // 32-wide chunks of O
  static constexpr bool kTail16 = D % 32 == 16;
  static constexpr int kNTiles = D / 8;        // n-tiles of O
  static constexpr int kKStride = D % 32 == 16 ? D : D + 16;
  static constexpr int kVStride = D + 4;
  static constexpr bool kSplitQ = D <= 64;     // Q kept split hi/lo
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (the 3xTF32 split)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: lo*hi + hi*lo first, then hi*hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split(b0, b0h, b0l);
  split(b1, b1h, b1l);
  mma_tf32(d, a_lo, b0h, b1h);
  mma_tf32(d, a_hi, b0l, b1l);
  mma_tf32(d, a_hi, b0h, b1h);
}

// the same product with the small terms in their own accumulator (shorter
// dependent chains); the caller adds small + big
__device__ __forceinline__ void mma_3xtf32_split(float (&small)[4],
                                                 float (&big)[4],
                                                 const uint32_t (&a_hi)[4],
                                                 const uint32_t (&a_lo)[4],
                                                 float b0, float b1) {
  uint32_t b0h, b0l, b1h, b1l;
  split(b0, b0h, b0l);
  split(b1, b1h, b1l);
  mma_tf32(small, a_lo, b0h, b1h);
  mma_tf32(small, a_hi, b0l, b1l);
  mma_tf32(big, a_hi, b0h, b1h);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;  // 0: zero-fill the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
struct Tiles {
  float k[2][kBKV][Dims<D>::kKStride];
  float v[2][kBKV][Dims<D>::kVStride];
};

// One output row from the accumulator: acc[j][E0], acc[j][E0 + 1] (E0 = 0
// for the fragment's row g, 2 for row g + 8) hold fragment columns 2t and
// 2t + 1: in chunk c, d = 32c + 8t + j and 32c + 8t + 4 + j; in the
// 16-wide chunk, d = 4t + j and 4t + 2 + j.
template <int D, int E0>
__device__ __forceinline__ void store_row(
    float* __restrict__ o, const float (&acc)[Dims<D>::kNTiles][4], float l,
    int b, int Lq, int row, size_t q_row, int h, int t) {
  using P = Dims<D>;
  const float dn = fmaxf(l, 1e-30f);
  float* orow = o + (static_cast<size_t>(b) * Lq + row) * q_row +
                static_cast<size_t>(h) * D;
#pragma unroll
  for (int c = 0; c < P::kC32; ++c) {
    *reinterpret_cast<float4*>(orow + 32 * c + 8 * t) = make_float4(
        acc[4 * c][E0] / dn, acc[4 * c + 1][E0] / dn, acc[4 * c + 2][E0] / dn,
        acc[4 * c + 3][E0] / dn);
    *reinterpret_cast<float4*>(orow + 32 * c + 8 * t + 4) = make_float4(
        acc[4 * c][E0 + 1] / dn, acc[4 * c + 1][E0 + 1] / dn,
        acc[4 * c + 2][E0 + 1] / dn, acc[4 * c + 3][E0 + 1] / dn);
  }
  if constexpr (P::kTail16) {
    constexpr int c0 = 32 * P::kC32, j0 = 4 * P::kC32;
    *reinterpret_cast<float4*>(orow + c0 + 4 * t) = make_float4(
        acc[j0][E0] / dn, acc[j0 + 1][E0] / dn, acc[j0][E0 + 1] / dn,
        acc[j0 + 1][E0 + 1] / dn);
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int Lq, int S, int H, int Kv, bool causal, int window,
                     float sm_scale) {
  using P = Dims<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  Tiles<D>& sm = *reinterpret_cast<Tiles<D>*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rep = H / Kv;
  const int units = (Lq + kRows - 1) / kRows * rep;
  // blocks walk (batch, kv head) fastest and query rows from the last (the
  // longest causal rows) down, so the longest blocks start first
  const int n_rank = (units + kWarps - 1) / kWarps;
  const int n_bk = gridDim.x / n_rank;
  const int bk = blockIdx.x % n_bk;
  const int b = bk / Kv, kh = bk % Kv;
  const int u0 = (n_rank - 1 - blockIdx.x / n_bk) * kWarps;
  const int u_last = min(u0 + kWarps, units) - 1;
  const int u = u0 + warp;
  const bool active = u < units;
  const int q0 = (active ? u / rep : u_last / rep) * kRows;
  const int h = kh * rep + (active ? u % rep : 0);

  // the block's key range, from its first and last query rows
  const int blk_q_lo = u0 / rep * kRows;
  const int blk_q_hi = min(Lq, (u_last / rep + 1) * kRows) - 1;
  const int kv_end = causal ? min(S, blk_q_hi + 1) : S;
  int kv_begin = window > 0 ? max(0, blk_q_lo - window + 1) : 0;
  kv_begin -= kv_begin % kBKV;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBKV - 1) / kBKV
                                        : 0;

  const size_t kv_row = static_cast<size_t>(Kv) * D;  // one position
  const float* kbase = k + (static_cast<size_t>(b) * S * Kv + kh) * D;
  const float* vbase = v + (static_cast<size_t>(b) * S * Kv + kh) * D;

  // 32 rows x D/4 chunks of 16 bytes, for K and for V
  auto stage = [&](int tile, int buf) {
    const int kv0 = kv_begin + tile * kBKV;
#pragma unroll
    for (int e = tid; e < kBKV * (D / 4); e += kWarps * 32) {
      const int r = e / (D / 4), c = e % (D / 4) * 4;
      const int s = kv0 + r;
      const bool in = s < S;
      const size_t off = in ? static_cast<size_t>(s) * kv_row + c : 0;
      cp_async16(&sm.k[buf][r][c], kbase + off, in);
      cp_async16(&sm.v[buf][r][c], vbase + off, in);
    }
  };

  if (n_tiles > 0) stage(0, 0);
  cp_async_commit();

  // this warp's 16 query rows as A fragments: rows q0 + g and q0 + g + 8,
  // k-step 2c + e holding d = 16c + 4t + 2e (+1); split hi/lo now (D <=
  // 64) or per tile (qf)
  const int ra = q0 + g, rb = q0 + g + 8;
  const size_t q_row = static_cast<size_t>(H) * D;
  const float* qa = q + (static_cast<size_t>(b) * Lq + ra) * q_row +
                    static_cast<size_t>(h) * D;
  const float* qb = qa + 8 * q_row;
  constexpr int kQH = P::kSplitQ ? P::kQSteps : 1;
  constexpr int kQF = P::kSplitQ ? 1 : P::kQSteps;
  uint32_t qh[kQH][4], ql[kQH][4];
  float qf[kQF][4];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const float4 za = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 xa = active && ra < Lq
        ? *reinterpret_cast<const float4*>(qa + 16 * c + 4 * t) : za;
    const float4 xb = active && rb < Lq
        ? *reinterpret_cast<const float4*>(qb + 16 * c + 4 * t) : za;
    if constexpr (P::kSplitQ) {
      split(xa.x, qh[2 * c][0], ql[2 * c][0]);
      split(xb.x, qh[2 * c][1], ql[2 * c][1]);
      split(xa.y, qh[2 * c][2], ql[2 * c][2]);
      split(xb.y, qh[2 * c][3], ql[2 * c][3]);
      split(xa.z, qh[2 * c + 1][0], ql[2 * c + 1][0]);
      split(xb.z, qh[2 * c + 1][1], ql[2 * c + 1][1]);
      split(xa.w, qh[2 * c + 1][2], ql[2 * c + 1][2]);
      split(xb.w, qh[2 * c + 1][3], ql[2 * c + 1][3]);
    } else {
      qf[2 * c][0] = xa.x;
      qf[2 * c][1] = xb.x;
      qf[2 * c][2] = xa.y;
      qf[2 * c][3] = xb.y;
      qf[2 * c + 1][0] = xa.z;
      qf[2 * c + 1][1] = xb.z;
      qf[2 * c + 1][2] = xa.w;
      qf[2 * c + 1][3] = xb.w;
    }
  }

  float acc[P::kNTiles][4];
#pragma unroll
  for (int j = 0; j < P::kNTiles; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

  const int w_q_hi = min(q0 + kRows, Lq) - 1;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const int buf = it & 1;
    const int kv0 = kv_begin + it * kBKV;
    const bool needed =
        active && (!causal || kv0 <= w_q_hi) &&
        (window <= 0 || kv0 + kBKV - 1 > q0 - window);
    if (needed) {
      // S = Q K^T over 4 n-tiles of 8 keys; lo*hi + hi*lo apart from hi*hi
      float s[4][4], sl[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = sl[i][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        uint32_t h0[4], l0[4], h1[4], l1[4];
        if constexpr (P::kSplitQ) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            h0[e] = qh[2 * c][e];
            l0[e] = ql[2 * c][e];
            h1[e] = qh[2 * c + 1][e];
            l1[e] = ql[2 * c + 1][e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            split(qf[2 * c][e], h0[e], l0[e]);
            split(qf[2 * c + 1][e], h1[e], l1[e]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 kf = *reinterpret_cast<const float4*>(
              &sm.k[buf][8 * i + g][16 * c + 4 * t]);
          mma_3xtf32_split(sl[i], s[i], h0, l0, kf.x, kf.y);
          mma_3xtf32_split(sl[i], s[i], h1, l1, kf.z, kf.w);
        }
      }
      // scale, mask, online softmax (rows ra: s[i][0..1], rb: s[i][2..3]);
      // a tile that every row of the warp sees whole needs no mask
      const bool whole = kv0 + kBKV <= S &&
                         (!causal || kv0 + kBKV - 1 <= q0) &&
                         (window <= 0 || w_q_hi - kv0 < window);
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = (sl[i][e] + s[i][e]) * sm_scale;
          if (whole) {
            s[i][e] = x;
          } else {
            const int kp = kv0 + 8 * i + 2 * t + (e & 1);
            const int qp = e < 2 ? ra : rb;
            bool ok = kp < S;
            if (causal) ok = ok && qp >= kp;
            if (window > 0) ok = ok && qp - kp < window;
            s[i][e] = ok ? x : kNegInf;
          }
        }
        mx_a = fmaxf(mx_a, fmaxf(s[i][0], s[i][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[i][2], s[i][3]));
      }
      const float mn_a = fmaxf(m_a, quad_max(mx_a));
      const float mn_b = fmaxf(m_b, quad_max(mx_b));
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
      float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = expf(s[i][0] - mn_a);
        s[i][1] = expf(s[i][1] - mn_a);
        s[i][2] = expf(s[i][2] - mn_b);
        s[i][3] = expf(s[i][3] - mn_b);
        ps_a += s[i][0] + s[i][1];
        ps_b += s[i][2] + s[i][3];
      }
      l_a = l_a * al_a + quad_sum(ps_a);
      l_b = l_b * al_b + quad_sum(ps_b);
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int j = 0; j < P::kNTiles; ++j) {
        acc[j][0] *= al_a;
        acc[j][1] *= al_a;
        acc[j][2] *= al_b;
        acc[j][3] *= al_b;
      }
      // O += P V: k-step i over keys 8i..8i+7; the A fragment is S's
      // accumulator of n-tile i (columns t, t+4 <-> keys 2t, 2t+1)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t ph[4], pl[4];
        split(s[i][0], ph[0], pl[0]);
        split(s[i][2], ph[1], pl[1]);
        split(s[i][1], ph[2], pl[2]);
        split(s[i][3], ph[3], pl[3]);
        const float* v0 = &sm.v[buf][8 * i + 2 * t][0];
        const float* v1 = v0 + P::kVStride;
        // chunk c, n-tile 4c + j, column n <-> d = 32c + 4n + j
#pragma unroll
        for (int c = 0; c < P::kC32; ++c) {
          const float4 va = *reinterpret_cast<const float4*>(v0 + 32 * c +
                                                             4 * g);
          const float4 vb = *reinterpret_cast<const float4*>(v1 + 32 * c +
                                                             4 * g);
          mma_3xtf32(acc[4 * c], ph, pl, va.x, vb.x);
          mma_3xtf32(acc[4 * c + 1], ph, pl, va.y, vb.y);
          mma_3xtf32(acc[4 * c + 2], ph, pl, va.z, vb.z);
          mma_3xtf32(acc[4 * c + 3], ph, pl, va.w, vb.w);
        }
        if constexpr (P::kTail16) {
          // the 16-wide chunk: n-tile j, column n <-> d = 32 kC32 + 2n + j
          constexpr int c0 = 32 * P::kC32, j0 = 4 * P::kC32;
          const float2 va = *reinterpret_cast<const float2*>(v0 + c0 + 2 * g);
          const float2 vb = *reinterpret_cast<const float2*>(v1 + c0 + 2 * g);
          mma_3xtf32(acc[j0], ph, pl, va.x, vb.x);
          mma_3xtf32(acc[j0 + 1], ph, pl, va.y, vb.y);
        }
      }
    }
    __syncthreads();  // the next stage() overwrites this buffer
  }

  if (!active) return;
  if (ra < Lq) store_row<D, 0>(o, acc, l_a, b, Lq, ra, q_row, h, t);
  if (rb < Lq) store_row<D, 2>(o, acc, l_b, b, Lq, rb, q_row, h, t);
}

template <int D>
cudaError_t launch_instance(const float* q, const float* k, const float* v,
                            float* o, int B, int Lq, int S, int H, int Kv,
                            bool causal, int window, float sm_scale,
                            cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(Tiles<D>));
  if constexpr (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  const int units = (Lq + kRows - 1) / kRows * (H / Kv);
  const unsigned blocks = (units + kWarps - 1) / kWarps * B * Kv;
  flash_fwd_kernel<D><<<blocks, kWarps * 32, smem, stream>>>(
      q, k, v, o, Lq, S, H, Kv, causal, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q, o: (B, Lq, H, D); k, v: (B, S, Kv, D); all row-major f32 with 16-byte
// aligned bases. window <= 0 means no sliding window. D must be one of the
// instances (16, 32, 64, 80, 96, 128): the caller pads other head dims and
// checks H % Kv == 0. Returns the launch's error (cudaErrorInvalidValue
// for a D with no instance).
cudaError_t launch_flash_attention(const float* q, const float* k,
                                   const float* v, float* o, int B, int Lq,
                                   int S, int H, int Kv, int D, bool causal,
                                   int window, float sm_scale,
                                   cudaStream_t stream) {
  if (B == 0 || Lq == 0 || H == 0) return cudaSuccess;
  switch (D) {
#define FLASH_INSTANCE(d)                                                   \
  case d:                                                                   \
    return launch_instance<d>(q, k, v, o, B, Lq, S, H, Kv, causal, window, \
                              sm_scale, stream);
    FLASH_INSTANCE(16)
    FLASH_INSTANCE(32)
    FLASH_INSTANCE(64)
    FLASH_INSTANCE(80)
    FLASH_INSTANCE(96)
    FLASH_INSTANCE(128)
#undef FLASH_INSTANCE
    default:
      return cudaErrorInvalidValue;
  }
}
