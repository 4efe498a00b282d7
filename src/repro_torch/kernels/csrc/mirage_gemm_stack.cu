// Kernel 1's stream route: a stack of E expert GEMMs at decode,
// out[e] = bfp(x[e]) @ bfp(w[e]) for e < E, x (E, M, K) with M <= 16,
// w (E, K, N) contiguous with N % 4 == 0 and a 16-byte aligned base, both
// operands BFP(b_m, g) quantized along K, f32 sums.
//
// Replaces: src/repro/kernels/mirage_gemm.py:50 `mirage_gemm_pallas` under
// the JAX package's vmap over the experts (src/repro/models/moe.py:50-66),
// at the MoE layer's decode shapes; mirage_gemm.cu keeps its decode and
// tensor-core routes for everything else (repro_torch/kernels/ops.py
// `gemm_plan` picks the route).
//
// Bound: bytes. Each weight is read once for M <= 16 multiply-adds, so the
// stack should stream at the card's copy rate (qwen3-moe's 805 MB stack
// is 0.24 ms at 3.35 TB/s). What the design does about what held the
// decode route back on (K, N) stacks:
//   1. Long row pieces: a work unit is (expert, 128-column tile, K range);
//      its weights arrive as Bk x 128 tiles (512 contiguous bytes a row) by
//      TMA, one 3-D copy (N, K, E) a stage. A captured graph replays the
//      tensor map by value; the host caches it per (pointer, shape).
//   2. No per-thread copies: one producer thread issues a TMA and a bulk
//      copy (the stage's x rows) a stage into a ring of full/empty mbarrier
//      pairs; four consumer warps compute. Several blocks an SM keep
//      ~100 KB or more in flight.
//   3. No shuffles: a consumer thread owns one column (neighbouring threads
//      read neighbouring words of a row: no bank conflicts) and walks the
//      stage's rows, so a group of g rows is its own loop: one pass for the
//      group max, one to quantize (bfp.cuh) and multiply. A thread a column
//      rather than a float4 of four: one warp's issue rate held a unit far
//      below its share of the card's read rate, too slow for the few
//      units of a routed tick.
//   4. A persistent grid: a few blocks an SM; each takes its first unit
//      by its index, then the next from a counter, over the live units only.
//   5. Empty experts skipped: a pre-pass (`stream_prep_kernel`, one block a
//      (split, expert)) quantizes x once into a k-major copy (E, Kp, MT),
//      flags the pairs with a nonzero quantized x, and writes +0.0 to the
//      output rows of the others (a zero x row gives +0.0 in the
//      arithmetic: the quantizer maps 0 to +-0 and the sums start at +0.0).
//      Every block compacts the flags in order; the producer streams only
//      live experts' weights.
//
// Each output is summed by one thread in k order over its unit's K range;
// K splits go to a (splits, E, M, N) workspace that mirage_gemm.cu's
// ordered reduction adds in split order. A unit's arithmetic depends only
// on (expert, tile, K range), never on E, the grid or the other experts,
// so a launch over a stack gives the same bits as single-expert launches
// of this route with the same split. No float atomics.
#include <cuda.h>  // CUtensorMap and its enums; no -lcuda: the encoder
                   // comes from cudaGetDriverEntryPoint
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include "bfp.cuh"

void launch_splitk_reduce(const float* ws, float* out, long long mn,
                          int splits, cudaStream_t stream);

namespace {

constexpr int kCols = 128;          // columns of a unit, 512 bytes a row
constexpr int kConsumers = 4;       // consumer warps: a thread a column
constexpr int kThreads = 32 * (kConsumers + 1);  // and a producer warp
constexpr int kPrepThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// ---- mbarriers and bulk copies ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// a (kCols, rows, 1) box of the (N, K, E) weight map at (n0, k, e)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int n0, int k, int e,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(n0), "r"(k), "r"(e),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- pre-pass: x quantized k-major, live flags, dead rows zeroed ---------

// grid (splits, E). xq (E, Kp, MT): xq[e][k][m] = bfp(x[e][m][.])[k], zero
// for m >= M and K <= k < Kp. live[e * splits + s] = 1 where a quantized
// value of the split's range is nonzero; else the pair's rows of dst
// (the output, or split s of the workspace) are written +0.0. Thread 0 of
// block (0, 0) zeroes the unit counter live[E * splits]. A thread takes a
// (row, group): at G = 16 its 16 values arrive as four float4 loads in
// flight together (`vec`: K % 4 == 0 and x 16-byte aligned), are
// quantized in registers and written k-major (neighbouring threads hold
// neighbouring rows m).
template <int G>
__global__ void __launch_bounds__(kPrepThreads)
    stream_prep_kernel(const float* __restrict__ x, float* __restrict__ xq,
                       int* __restrict__ live, float* __restrict__ dst, int E,
                       int M, int N, int K, int Kp, int MT, int g_rt, int b_m,
                       bool truncate, int k_split, bool vec) {
  const int g = G > 0 ? G : g_rt;
  const int s = blockIdx.x, e = blockIdx.y, splits = gridDim.x;
  const int k_begin = s * k_split;
  const int k_stop = min(Kp, k_begin + k_split);  // a multiple of 64
  const int groups = (k_stop - k_begin) / g;
  x += static_cast<size_t>(e) * M * K;
  xq += static_cast<size_t>(e) * Kp * MT;
  int nonzero = 0;
  for (int i = threadIdx.x; i < MT * groups; i += blockDim.x) {
    const int m = i % MT;
    const int k0 = k_begin + (i / MT) * g;
    const float* src = x + static_cast<size_t>(m) * K + k0;
    float* out = xq + static_cast<size_t>(k0) * MT + m;
    if constexpr (G > 0) {
      float v[G];
      if (vec && m < M && k0 + G <= K) {
#pragma unroll
        for (int j = 0; j < G; j += 4) {
          const float4 q = *reinterpret_cast<const float4*>(src + j);
          v[j] = q.x, v[j + 1] = q.y, v[j + 2] = q.z, v[j + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < G; ++j)
          v[j] = m < M && k0 + j < K ? src[j] : 0.0f;
      }
      float maxabs = 0.0f;
#pragma unroll
      for (int j = 0; j < G; ++j) maxabs = fmaxf(maxabs, fabsf(v[j]));
      const BfpGrid grid = bfp_grid(maxabs, b_m);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const float q = bfp_quantize_value(v[j], grid, truncate);
        nonzero |= q != 0.0f;
        out[j * MT] = q;
      }
    } else {
      float maxabs = 0.0f;
      if (m < M)
        for (int j = 0; j < g && k0 + j < K; ++j)
          maxabs = fmaxf(maxabs, fabsf(src[j]));
      const BfpGrid grid = bfp_grid(maxabs, b_m);
      for (int j = 0; j < g; ++j) {
        float q = 0.0f;
        if (m < M && k0 + j < K) q = bfp_quantize_value(src[j], grid, truncate);
        nonzero |= q != 0.0f;
        out[j * MT] = q;
      }
    }
  }
  const int any = __syncthreads_or(nonzero);
  if (threadIdx.x == 0) {
    live[e * splits + s] = any;
    if (s == 0 && e == 0) live[E * splits] = 0;
  }
  if (any) return;
  float4* rows = reinterpret_cast<float4*>(
      dst + (static_cast<size_t>(s) * E + e) * M * N);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = threadIdx.x; i < M * N / 4; i += blockDim.x) rows[i] = zero;
}

// ---- the stream kernel ------------------------------------------------------

// What the producer tells the consumers about a stage: the unit's expert,
// split and first column, and whether the stage opens (bit 0) or closes
// (bit 1) the unit; code -1 ends the walk.
struct StageMeta {
  int e, s, n0, code;
};

// One BFP value onto its group's grid, the rounding fixed at compile time
// (bfp.cuh's bfp_quantize_value with its `truncate` argument constant).
template <bool kTruncate>
__device__ __forceinline__ float quantize(float v, const BfpGrid& grid) {
  return bfp_quantize_value(v, grid, kTruncate);
}

// Dynamic shared memory, from a 128-byte aligned base: stages x Bk x kCols
// floats of weights, stages x Bk x MT floats of x, stages StageMeta,
// stages full and stages empty mbarriers, then E x splits ints (the live
// pairs in order) and their count. Warps 0 .. kConsumers - 1 compute
// (thread t owns column n0 + t of the unit), warp kConsumers produces.
template <int MT, int G, bool kTruncate>
__global__ void __launch_bounds__(kThreads)
    gemm_stream_kernel(const __grid_constant__ CUtensorMap wmap,
                       const float* __restrict__ xq, int* __restrict__ live,
                       float* __restrict__ dst, int E, int M, int N, int K,
                       int Kp, int g_rt, int b_m, int splits, int k_split,
                       int bk, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t{127});
  const int g = G > 0 ? G : g_rt;
  const uint32_t w_bytes = bk * kCols * 4, x_bytes = bk * MT * 4;
  float* ws = reinterpret_cast<float*>(base);
  float* xs = reinterpret_cast<float*>(base + stages * w_bytes);
  StageMeta* meta = reinterpret_cast<StageMeta*>(
      base + stages * (w_bytes + x_bytes));
  uint64_t* full = reinterpret_cast<uint64_t*>(meta + stages);
  uint64_t* empty = full + stages;
  int* list = reinterpret_cast<int*>(empty + stages);
  int* n_live = list + E * splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pairs = E * splits;

  // the live (expert, split) pairs in order, compacted by the producer warp
  for (int i = threadIdx.x; i < pairs; i += blockDim.x) list[i] = live[i];
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kConsumers) {
    int count = 0;
    for (int b = 0; b < pairs; b += 32) {
      const bool f = b + lane < pairs && list[b + lane] != 0;
      const unsigned mask = __ballot_sync(kFull, f);
      __syncwarp();
      if (f) list[count + __popc(mask & ((1u << lane) - 1))] = b + lane;
      count += __popc(mask);
      __syncwarp();
    }
    if (lane == 0) *n_live = count;
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer: lane 0 walks its units and fills the ring
    if (lane != 0) return;
    const int n_tiles = (N + kCols - 1) / kCols;
    const int units = *n_live * n_tiles;
    int* counter = live + pairs;
    uint32_t it = 0;
    auto next_slot = [&]() {
      const int slot = it % stages;
      if (it >= static_cast<uint32_t>(stages))
        mbar_wait(&empty[slot], ((it / stages) & 1) ^ 1);
      return slot;
    };
    for (int u = blockIdx.x; u < units;
         u = gridDim.x + atomicAdd(counter, 1)) {
      const int pair = list[u / n_tiles];
      const int e = pair / splits, s = pair % splits;
      const int n0 = (u % n_tiles) * kCols;
      const int k_begin = s * k_split;
      const int steps = (min(K, k_begin + k_split) - k_begin + bk - 1) / bk;
      for (int step = 0; step < steps; ++step, ++it) {
        const int slot = next_slot();
        const int k = k_begin + step * bk;
        meta[slot] = {e, s, n0, (step == 0) | (step == steps - 1) << 1};
        mbar_expect_tx(&full[slot], w_bytes + x_bytes);
        tma_load_3d(ws + slot * bk * kCols, &wmap, n0, k, e, &full[slot]);
        bulk_load(xs + slot * bk * MT,
                  xq + (static_cast<size_t>(e) * Kp + k) * MT, x_bytes,
                  &full[slot]);
      }
    }
    const int slot = next_slot();
    meta[slot].code = -1;
    mbar_arrive(&full[slot]);
    return;
  }

  // consumers: thread t owns column n0 + t; the group's g weights of the
  // column are its own loop (G > 0: held in registers between the max and
  // the products), x broadcast from the stage
  const int col = threadIdx.x;
  float acc[MT];
  for (uint32_t it = 0;; ++it) {
    const int slot = it % stages;
    mbar_wait(&full[slot], (it / stages) & 1);
    const StageMeta mt = meta[slot];
    if (mt.code < 0) break;
    if (mt.code & 1) {
#pragma unroll
      for (int m = 0; m < MT; ++m) acc[m] = 0.0f;
    }
    const float* wcol = ws + slot * bk * kCols + col;
    const float* xrow = xs + slot * bk * MT;
    // acc[m] += x[m][k] * w[k][col] in k order, for one row of the stage
    auto add_row = [&](int r, float q) {
      const float* xr = xrow + r * MT;
#pragma unroll
      for (int m4 = 0; m4 < MT / 4; ++m4) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * m4);
        acc[4 * m4 + 0] = fmaf(xv.x, q, acc[4 * m4 + 0]);
        acc[4 * m4 + 1] = fmaf(xv.y, q, acc[4 * m4 + 1]);
        acc[4 * m4 + 2] = fmaf(xv.z, q, acc[4 * m4 + 2]);
        acc[4 * m4 + 3] = fmaf(xv.w, q, acc[4 * m4 + 3]);
      }
    };
    for (int r0 = 0; r0 < bk; r0 += g) {
      float mx = 0.0f;
      if constexpr (G > 0) {
        float v[G];
#pragma unroll
        for (int r = 0; r < G; ++r) {
          v[r] = wcol[(r0 + r) * kCols];
          mx = fmaxf(mx, fabsf(v[r]));
        }
        const BfpGrid grid = bfp_grid(mx, b_m);
#pragma unroll
        for (int r = 0; r < G; ++r)
          add_row(r0 + r, quantize<kTruncate>(v[r], grid));
      } else {
        for (int r = 0; r < g; ++r)
          mx = fmaxf(mx, fabsf(wcol[(r0 + r) * kCols]));
        const BfpGrid grid = bfp_grid(mx, b_m);
        for (int r = 0; r < g; ++r)
          add_row(r0 + r, quantize<kTruncate>(wcol[(r0 + r) * kCols], grid));
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    const int n = mt.n0 + col;
    if ((mt.code & 2) && n < N) {
      float* out = dst + (static_cast<size_t>(mt.s) * E + mt.e) * M * N + n;
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m < M) out[static_cast<size_t>(m) * N] = acc[m];
    }
  }
}

// ---- host: the tensor map, cached per (pointer, shape, box) -----------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    return found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

using MapKey = std::tuple<const void*, int, int, int, int>;
constexpr size_t kMaxMaps = 512;

// The (N, K, E) map of w with a (kCols, bk, 1) box: rows past K and
// columns past N load as zeros. Returns 0, or the encoder's CUresult (-1:
// no encoder).
int weight_map(const float* w, int E, int K, int N, int bk,
               CUtensorMap* map) {
  static std::mutex lock;
  static std::map<MapKey, CUtensorMap> cache;
  const MapKey key{w, E, K, N, bk};
  const std::lock_guard<std::mutex> guard(lock);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return 0;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(N) * 4,
                                 static_cast<cuuint64_t>(K) * N * 4};
  const cuuint32_t box[3] = {kCols, static_cast<cuuint32_t>(bk), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(w), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  if (cache.size() >= kMaxMaps) cache.clear();
  cache.emplace(key, *map);
  return 0;
}

template <int MT, int G, bool kTruncate>
void launch_stream(const CUtensorMap& map, const float* xq, int* live,
                   float* dst, int E, int M, int N, int K, int Kp, int g,
                   int b_m, int splits, int k_split, int bk, int stages,
                   int blocks, size_t smem, cudaStream_t stream) {
  static bool smem_set = false;
  auto kernel = gemm_stream_kernel<MT, G, kTruncate>;
  if (!smem_set) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         227 * 1024);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    smem_set = true;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(map, xq, live, dst, E, M, N, K,
                                             Kp, g, b_m, splits, k_split, bk,
                                             stages);
}

template <int MT>
void launch_stream_mt(bool g16, bool truncate, const CUtensorMap& map,
                      const float* xq, int* live, float* dst, int E, int M,
                      int N, int K, int Kp, int g, int b_m, int splits,
                      int k_split, int bk, int stages, int blocks,
                      size_t smem, cudaStream_t stream) {
  auto run = g16 ? (truncate ? launch_stream<MT, 16, true>
                             : launch_stream<MT, 16, false>)
                 : (truncate ? launch_stream<MT, 0, true>
                             : launch_stream<MT, 0, false>);
  run(map, xq, live, dst, E, M, N, K, Kp, g, b_m, splits, k_split, bk,
      stages, blocks, smem, stream);
}

}  // namespace

// Dynamic shared memory of the stream kernel (ops.py `stream_smem_bytes`).
size_t stream_smem_bytes(int MT, int bk, int stages, int pairs) {
  return 128 + static_cast<size_t>(stages) *
                   (bk * (kCols + MT) * 4 + sizeof(StageMeta) + 16) +
         4 * (static_cast<size_t>(pairs) + 1);
}

// x: (E, M, K), M <= 16; w: (E, K, N) row-major, N % 4 == 0, 16-byte
// aligned; out: (E, M, N); ws: (splits, E, M, N) when splits > 1; xq:
// (E, Kp, MT) with Kp = K rounded up to 64 and MT = 4, 8 or 16 >= M; live:
// E x splits + 1 ints. The wrapper's plan (ops.py `gemm_plan`, route
// "stream") gives the split, the ring's stages and the grid; Bk is
// max(16, g) rows. Enqueues the pre-pass, the stream kernel and, when K is
// split, the ordered reduction. Returns 0, or the tensor map's error.
int launch_mirage_gemm_stream(const float* x, const float* w, float* out,
                              float* ws, float* xq, int* live, int E, int M,
                              int N, int K, int g, int b_m, bool truncate,
                              int splits, int k_split, int stages, int blocks,
                              cudaStream_t stream) {
  const int MT = M <= 4 ? 4 : M <= 8 ? 8 : 16;
  const int bk = g > 16 ? g : 16;
  const int Kp = (K + 63) / 64 * 64;
  float* dst = splits > 1 ? ws : out;
  CUtensorMap map;
  const int err = weight_map(w, E, K, N, bk, &map);
  if (err != 0) return err;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto prep = g == 16 ? stream_prep_kernel<16> : stream_prep_kernel<0>;
  prep<<<dim3(splits, E), kPrepThreads, 0, stream>>>(
      x, xq, live, dst, E, M, N, K, Kp, MT, g, b_m, truncate, k_split, vec);
  const size_t smem = stream_smem_bytes(MT, bk, stages, E * splits);
  auto run = MT == 4 ? launch_stream_mt<4>
                     : MT == 8 ? launch_stream_mt<8> : launch_stream_mt<16>;
  run(g == 16, truncate, map, xq, live, dst, E, M, N, K, Kp, g, b_m, splits,
      k_split, bk, stages, blocks, smem, stream);
  if (splits > 1)
    launch_splitk_reduce(ws, out, static_cast<long long>(E) * M * N, splits,
                         stream);
  return 0;
}
