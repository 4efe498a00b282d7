// PyTorch bindings of the hand-written kernels. The only source that
// includes PyTorch's headers: the .cu files expose plain C++ launchers, so
// nvcc never compiles torch's headers.
//
// Each binding checks what its kernel takes, launches on PyTorch's current
// stream, and checks the launch (C10_CUDA_KERNEL_LAUNCH_CHECK) right after:
// a launch the CUDA runtime refuses never runs, and a later synchronize would
// not report it.
#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <torch/extension.h>

#include <cstdint>
#include <cstring>
#include <vector>

#include "rns.cuh"

void launch_bfp_fake_quant(const float* x, float* out, int rows, int K, int g,
                           int b_m, bool truncate, bool vector, int blocks,
                           cudaStream_t stream);
void launch_mirage_gemm(const float* x, const float* w, float* out,
                        float* ws, int E, int M, int N, int K, bool w_nk,
                        int g,
                        int b_m, bool truncate, bool quant_w, bool mma,
                        int threads, int splits, int k_split,
                        cudaStream_t stream);
int launch_mirage_gemm_stream(const float* x, const float* w, float* out,
                              float* ws, float* xq, int* live, int E, int M,
                              int N, int K, int g, int b_m, bool truncate,
                              int splits, int k_split, int stages, int blocks,
                              cudaStream_t stream);
size_t stream_smem_bytes(int MT, int bk, int stages, int pairs);
cudaError_t launch_flash_attention(const float* q, const float* k,
                                   const float* v, float* o, int B, int Lq,
                                   int S, int H, int Kv, int D, bool causal,
                                   int window, float sm_scale,
                                   cudaStream_t stream);
void launch_rns_matmul(const int* x, long long x_ms, const int* w,
                       long long w_ms, int* out, int n_mod, int S, int M,
                       int N, int g, const RnsModuli& mods,
                       cudaStream_t stream);
void launch_rns_matmul_channel(const int* x, long long x_ms, const int* w,
                               long long w_ms, const float* noise,
                               long long noise_ms, int period, int* out,
                               unsigned long long* flips, int n_mod, int S,
                               int M, int N, int g, const RnsModuli& mods,
                               cudaStream_t stream);
void launch_rrns_decode(const int* res, int* decoded, float* votes,
                        long long E, const RrnsTables& tables,
                        cudaStream_t stream);

namespace {

void check_operand(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == torch::kFloat32, name, " must be float32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void check_int_operand(const torch::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == torch::kInt32, name, " must be int32");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void check_bfp(int64_t g, int64_t b_m) {
  TORCH_CHECK(g >= 1 && 64 % g == 0, "group size g must divide 64, got ", g);
  TORCH_CHECK(b_m >= 1 && b_m <= 23, "b_m must be in [1, 23], got ", b_m);
}

bool aligned16(const torch::Tensor& t) {
  return reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0;
}

// `vector` and `blocks` are the wrapper's plan (repro_torch/kernels/ops.py
// `bfp_quant_plan`, the grid from the card's SM count)
void bfp_fake_quant(const torch::Tensor& x, torch::Tensor& out, int64_t g,
                    int64_t b_m, bool truncate, bool vector, int64_t blocks) {
  check_operand(x, "x");
  check_operand(out, "out");
  TORCH_CHECK(x.dim() == 2 && out.sizes() == x.sizes(),
              "x and out must be (rows, K) of one shape");
  TORCH_CHECK(g >= 1, "group size g must be >= 1, got ", g);
  TORCH_CHECK(b_m >= 1 && b_m <= 23, "b_m must be in [1, 23], got ", b_m);
  TORCH_CHECK(!vector || (g % 4 == 0 && g <= 128 && x.size(1) % 4 == 0 &&
                          aligned16(x) && aligned16(out)),
              "the vector route needs g % 4 == 0, g <= 128, K % 4 == 0 and "
              "16-byte aligned operands");
  TORCH_CHECK(!vector || (blocks >= 1 && blocks <= 65535),
              "the vector route takes 1..65535 blocks, got ", blocks);
  const c10::cuda::CUDAGuard guard(x.device());
  launch_bfp_fake_quant(x.data_ptr<float>(), out.data_ptr<float>(),
                        static_cast<int>(x.size(0)),
                        static_cast<int>(x.size(1)), static_cast<int>(g),
                        static_cast<int>(b_m), truncate, vector,
                        static_cast<int>(blocks),
                        at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// `mma`, `threads`, `splits` and `k_split` are the wrapper's plan
// (repro_torch/kernels/ops.py `gemm_plan`); ws holds the split-K partials.
// `quant_w` false takes the weight as it is (the decode route only).
// Matrices, or stacks of E of them (x (E, M, K), w (E, K, N) or (E, N, K),
// out (E, M, N)) run in one launch over the leading axis.
void mirage_gemm(const torch::Tensor& x, const torch::Tensor& w,
                 torch::Tensor& out, torch::Tensor& ws, bool w_nk, int64_t g,
                 int64_t b_m, bool truncate, bool quant_w, bool mma,
                 int64_t threads, int64_t splits, int64_t k_split) {
  check_operand(x, "x");
  check_operand(w, "w");
  check_operand(out, "out");
  check_operand(ws, "ws");
  const int64_t rank = x.dim();
  TORCH_CHECK((rank == 2 || rank == 3) && w.dim() == rank &&
                  out.dim() == rank,
              "x, w and out must be matrices, or stacks of E matrices");
  const int64_t E = rank == 3 ? x.size(0) : 1;
  TORCH_CHECK(rank == 2 || (w.size(0) == E && out.size(0) == E),
              "x, w and out must stack the same E matrices");
  const int64_t M = x.size(rank - 2), K = x.size(rank - 1);
  const int64_t N = w_nk ? w.size(rank - 2) : w.size(rank - 1);
  TORCH_CHECK((w_nk ? w.size(rank - 1) : w.size(rank - 2)) == K,
              "w does not match x along K");
  TORCH_CHECK(out.size(rank - 2) == M && out.size(rank - 1) == N,
              "out must be (M, N) per matrix");
  TORCH_CHECK((M + (mma ? 63 : 15)) / (mma ? 64 : 16) * E <= 65535,
              "E x M tiles must fit one grid axis (65535)");
  check_bfp(g, b_m);
  TORCH_CHECK(!mma || b_m <= 8, "the tensor-core route needs b_m <= 8");
  TORCH_CHECK(!mma || quant_w,
              "the tensor-core route quantizes the weight; a weight taken "
              "as it is goes to the decode route");
  TORCH_CHECK(mma ? threads == 256
                  : threads == 32 || threads == 64 || threads == 128,
              "the tensor-core route takes 256 threads, the decode route "
              "32, 64 or 128; got ", threads);
  TORCH_CHECK(k_split >= 64 && k_split % 64 == 0 && splits >= 1 &&
                  splits * k_split >= K &&
                  (splits == 1 || (splits - 1) * k_split < K),
              "k_split must be a multiple of 64 and the splits must cover K");
  TORCH_CHECK(mma || (M <= 4 ? 4 : M <= 8 ? 8 : 16) * k_split <= 16384,
              "the decode route holds at most 16384 quantized x values");
  TORCH_CHECK(splits == 1 || ws.numel() >= splits * E * M * N,
              "ws must hold splits x E x M x N floats");
  const c10::cuda::CUDAGuard guard(x.device());
  launch_mirage_gemm(x.data_ptr<float>(), w.data_ptr<float>(),
                     out.data_ptr<float>(), ws.data_ptr<float>(),
                     static_cast<int>(E), static_cast<int>(M),
                     static_cast<int>(N),
                     static_cast<int>(K), w_nk, static_cast<int>(g),
                     static_cast<int>(b_m), truncate, quant_w, mma,
                     static_cast<int>(threads), static_cast<int>(splits),
                     static_cast<int>(k_split),
                     at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// The stream route of a stack of E expert GEMMs at decode: x (E, M, K) with
// M <= 16, w (E, K, N) contiguous with N % 4 == 0 and a 16-byte aligned
// base, out (E, M, N). `splits`, `k_split`, `stages` and `blocks` are the
// wrapper's plan (ops.py `gemm_plan`, route "stream"); ws holds the
// split-K partials, xq (E, Kp, MT) the quantized x and live E x splits + 1
// ints (the pre-pass's flags and the unit counter).
void mirage_gemm_stream(const torch::Tensor& x, const torch::Tensor& w,
                        torch::Tensor& out, torch::Tensor& ws,
                        torch::Tensor& xq, torch::Tensor& live, int64_t g,
                        int64_t b_m, bool truncate, int64_t splits,
                        int64_t k_split, int64_t stages, int64_t blocks) {
  check_operand(x, "x");
  check_operand(w, "w");
  check_operand(out, "out");
  check_operand(ws, "ws");
  check_operand(xq, "xq");
  check_int_operand(live, "live");
  TORCH_CHECK(x.dim() == 3 && w.dim() == 3 && out.dim() == 3,
              "the stream route takes stacks x (E, M, K), w (E, K, N) and "
              "out (E, M, N)");
  const int64_t E = x.size(0), M = x.size(1), K = x.size(2), N = w.size(2);
  TORCH_CHECK(w.size(0) == E && w.size(1) == K && out.size(0) == E &&
                  out.size(1) == M && out.size(2) == N,
              "x, w and out must stack E matrices of matching shapes");
  TORCH_CHECK(E >= 1 && M >= 1 && M <= 16 && K >= 1 && N >= 1,
              "the stream route takes 1 <= M <= 16 rows and a non-empty "
              "stack");
  TORCH_CHECK(N % 4 == 0 && aligned16(w) && aligned16(out) && aligned16(ws),
              "the stream route needs N % 4 == 0 and 16-byte aligned w, out "
              "and ws");
  check_bfp(g, b_m);
  TORCH_CHECK(k_split >= 64 && k_split % 64 == 0 && splits >= 1 &&
                  splits * k_split >= K &&
                  (splits == 1 || (splits - 1) * k_split < K),
              "k_split must be a multiple of 64 and the splits must cover K");
  TORCH_CHECK(splits <= 65535 && E <= 65535, "splits and E must be <= 65535");
  TORCH_CHECK(splits == 1 || ws.numel() >= splits * E * M * N,
              "ws must hold splits x E x M x N floats");
  const int64_t MT = M <= 4 ? 4 : M <= 8 ? 8 : 16;
  const int64_t Kp = (K + 63) / 64 * 64;
  TORCH_CHECK(xq.numel() == E * Kp * MT && aligned16(xq),
              "xq must hold E x Kp x MT floats (Kp = K rounded up to 64), "
              "16-byte aligned");
  TORCH_CHECK(live.numel() == E * splits + 1,
              "live must hold E x splits + 1 ints");
  const int64_t bk = g > 16 ? g : 16;
  TORCH_CHECK(stages >= 2 && stages <= 16 && blocks >= 1 &&
                  stream_smem_bytes(static_cast<int>(MT),
                                    static_cast<int>(bk),
                                    static_cast<int>(stages),
                                    static_cast<int>(E * splits)) <=
                      227 * 1024,
              "the stream route's ring and pair list must fit 227 KB of "
              "shared memory, with 2 to 16 stages and at least one block");
  const c10::cuda::CUDAGuard guard(x.device());
  const int err = launch_mirage_gemm_stream(
      x.data_ptr<float>(), w.data_ptr<float>(), out.data_ptr<float>(),
      ws.data_ptr<float>(), xq.data_ptr<float>(), live.data_ptr<int>(),
      static_cast<int>(E), static_cast<int>(M), static_cast<int>(N),
      static_cast<int>(K), static_cast<int>(g), static_cast<int>(b_m),
      truncate, static_cast<int>(splits), static_cast<int>(k_split),
      static_cast<int>(stages), static_cast<int>(blocks),
      at::cuda::getCurrentCUDAStream());
  TORCH_CHECK(err == 0, "encoding the weight's tensor map failed (",
              err == -1 ? "cuTensorMapEncodeTiled not found"
                        : "CUresult " + std::to_string(err),
              ")");
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

void flash_attention(const torch::Tensor& q, const torch::Tensor& k,
                     const torch::Tensor& v, torch::Tensor& out, bool causal,
                     int64_t window, double sm_scale) {
  check_operand(q, "q");
  check_operand(k, "k");
  check_operand(v, "v");
  check_operand(out, "out");
  TORCH_CHECK(q.dim() == 4 && k.dim() == 4 && k.sizes() == v.sizes() &&
                  out.sizes() == q.sizes(),
              "q/out must be (B, Lq, H, D) and k/v (B, S, Kv, D)");
  const int64_t B = q.size(0), Lq = q.size(1), H = q.size(2), D = q.size(3);
  const int64_t S = k.size(1), Kv = k.size(2);
  TORCH_CHECK(k.size(0) == B && k.size(3) == D, "k/v do not match q");
  TORCH_CHECK(Kv >= 1 && H % Kv == 0, "n_heads must be a multiple of n_kv");
  TORCH_CHECK(D == 16 || D == 32 || D == 64 || D == 80 || D == 96 || D == 128,
              "the flash kernel is instantiated at head_dim 16, 32, 64, 80, "
              "96 and 128 (the wrapper pads the others), got ", D);
  TORCH_CHECK(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out),
              "the flash kernel reads and writes 16-byte aligned tensors");
  const c10::cuda::CUDAGuard guard(q.device());
  C10_CUDA_CHECK(launch_flash_attention(
      q.data_ptr<float>(), k.data_ptr<float>(), v.data_ptr<float>(),
      out.data_ptr<float>(), static_cast<int>(B), static_cast<int>(Lq),
      static_cast<int>(S), static_cast<int>(H), static_cast<int>(Kv),
      static_cast<int>(D), causal, static_cast<int>(window),
      static_cast<float>(sm_scale), at::cuda::getCurrentCUDAStream()));
}

// A residue operand (n_mod, S, ., .): each modulus's part contiguous, any
// stride between moduli (a block of whole experts sliced from a stack).
void check_mod_major(const torch::Tensor& t, const char* name,
                     c10::ScalarType type) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.scalar_type() == type, name, " has the wrong dtype");
  TORCH_CHECK(t.dim() == 4, name, " must be (n_mod, S, ., .)");
  TORCH_CHECK(t.size(0) == 1 || t.select(0, 0).is_contiguous(), name,
              ": each modulus's part must be contiguous");
  TORCH_CHECK(t.stride(0) >= 0, name, " must not have a negative stride");
}

// Checks the residue GEMM's operands and packs its moduli (and ADC steps).
RnsModuli rns_args(const torch::Tensor& x, const torch::Tensor& w,
                   const torch::Tensor& out, const std::vector<int64_t>& m,
                   const std::vector<double>& steps) {
  check_mod_major(x, "x_res", torch::kInt32);
  check_mod_major(w, "w_res", torch::kInt32);
  check_int_operand(out, "out");
  TORCH_CHECK(out.dim() == 4, "out must be (n_mod, S, M, N)");
  const int64_t n_mod = x.size(0), S = x.size(1), M = x.size(2),
                g = x.size(3), N = w.size(3);
  TORCH_CHECK(w.size(0) == n_mod && w.size(1) == S && w.size(2) == g,
              "w_res must be (n_mod, S, g, N) matching x_res");
  TORCH_CHECK(out.size(0) == n_mod && out.size(1) == S && out.size(2) == M &&
                  out.size(3) == N,
              "out must be (n_mod, S, M, N)");
  TORCH_CHECK(g >= 1 && g <= 64, "group size g must be in [1, 64], got ", g);
  TORCH_CHECK(n_mod >= 1 && n_mod <= kRnsMaxModuli, "at most ",
              kRnsMaxModuli, " moduli, got ", n_mod);
  // the general layout's one-dimensional grid: 128 columns and 16 or 64
  // rows a block, over every slot
  const int64_t blocks = (N + 127) / 128 * ((M + (M <= 16 ? 15 : 63)) /
                                            (M <= 16 ? 16 : 64)) * n_mod * S;
  TORCH_CHECK(blocks <= 2147483647LL, "the residue GEMM takes at most "
              "2^31 - 1 blocks, got ", blocks);
  TORCH_CHECK(static_cast<int64_t>(m.size()) == n_mod &&
                  static_cast<int64_t>(steps.size()) == n_mod,
              "one modulus and one ADC step per residue channel");
  RnsModuli mods{};
  for (int64_t i = 0; i < n_mod; ++i) {
    TORCH_CHECK(m[i] >= 2 && m[i] <= 1024, "moduli must be in [2, 1024]");
    mods.m[i] = static_cast<int>(m[i]);
    mods.step[i] = static_cast<float>(steps[i]);
  }
  return mods;
}

void rns_matmul(const torch::Tensor& x, const torch::Tensor& w,
                torch::Tensor& out, const std::vector<int64_t>& moduli) {
  const RnsModuli mods =
      rns_args(x, w, out, moduli, std::vector<double>(moduli.size(), 0.0));
  const c10::cuda::CUDAGuard guard(x.device());
  launch_rns_matmul(x.data_ptr<int>(), x.stride(0), w.data_ptr<int>(),
                    w.stride(0), out.data_ptr<int>(),
                    static_cast<int>(x.size(0)), static_cast<int>(x.size(1)),
                    static_cast<int>(x.size(2)), static_cast<int>(w.size(3)),
                    static_cast<int>(x.size(3)), mods,
                    at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// noise: (n_mod, P, M, N) f32, each modulus's part contiguous, P dividing
// S: slot s reads noise[:, s mod P]. flips: empty, or n_mod int64 counters
// (zeroed by the caller) to which the kernel adds, per modulus, the
// residues the detector noise moved.
void rns_matmul_channel(const torch::Tensor& x, const torch::Tensor& w,
                        const torch::Tensor& noise, torch::Tensor& out,
                        torch::Tensor& flips,
                        const std::vector<int64_t>& moduli,
                        const std::vector<double>& steps) {
  const RnsModuli mods = rns_args(x, w, out, moduli, steps);
  check_mod_major(noise, "noise", torch::kFloat32);
  const int64_t P = noise.size(1);
  TORCH_CHECK(noise.size(0) == out.size(0) && P >= 1 &&
                  out.size(1) % P == 0 && noise.size(2) == out.size(2) &&
                  noise.size(3) == out.size(3),
              "noise must be (n_mod, P, M, N) with P dividing the slots");
  const bool count = flips.numel() > 0;
  TORCH_CHECK(!count || (flips.is_cuda() &&
                         flips.scalar_type() == torch::kInt64 &&
                         flips.is_contiguous() &&
                         flips.numel() == x.size(0)),
              "flips must be empty or n_mod contiguous int64 counters");
  const c10::cuda::CUDAGuard guard(x.device());
  launch_rns_matmul_channel(
      x.data_ptr<int>(), x.stride(0), w.data_ptr<int>(), w.stride(0),
      noise.data_ptr<float>(), noise.stride(0), static_cast<int>(P),
      out.data_ptr<int>(),
      count ? reinterpret_cast<unsigned long long*>(flips.data_ptr<int64_t>())
            : nullptr,
      static_cast<int>(x.size(0)), static_cast<int>(x.size(1)),
      static_cast<int>(x.size(2)), static_cast<int>(w.size(3)),
      static_cast<int>(x.size(3)), mods, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// tables: kRrnsTableWords float32 on the host (ops.py packs them once per
// moduli set); they reach the kernel by value, as its parameter.
void rrns_decode(const torch::Tensor& res, const torch::Tensor& tables,
                 torch::Tensor& decoded, torch::Tensor& votes) {
  check_int_operand(res, "residues");
  check_int_operand(decoded, "decoded");
  check_operand(votes, "votes");
  TORCH_CHECK(tables.device().is_cpu() &&
                  tables.scalar_type() == torch::kFloat32 &&
                  tables.is_contiguous() &&
                  tables.numel() == kRrnsTableWords,
              "tables must be ", kRrnsTableWords,
              " contiguous float32 words on the host");
  TORCH_CHECK(res.dim() == 2, "residues must be (n_total, E)");
  TORCH_CHECK(res.size(0) >= 1 && res.size(0) <= kRrnsMaxTotal, "at most ",
              kRrnsMaxTotal, " moduli");
  const int64_t E = res.size(1);
  TORCH_CHECK(decoded.numel() == E && votes.numel() == E,
              "decoded and votes must hold E elements");
  RrnsTables host;
  std::memcpy(&host, tables.data_ptr<float>(), sizeof(RrnsTables));
  TORCH_CHECK(static_cast<int64_t>(host.n_total) == res.size(0),
              "the tables are for ", host.n_total, " moduli, the residues "
              "have ", res.size(0), " rows");
  const c10::cuda::CUDAGuard guard(res.device());
  launch_rrns_decode(res.data_ptr<int>(), decoded.data_ptr<int>(),
                     votes.data_ptr<float>(), static_cast<long long>(E),
                     host, at::cuda::getCurrentCUDAStream());
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("bfp_fake_quant", &bfp_fake_quant,
        "BFP(b_m, g) fake quantization of a (rows, K) f32 matrix along K");
  m.def("mirage_gemm", &mirage_gemm,
        "out = bfp(x) @ bfp(w) with BFP(b_m, g) quantization along K, "
        "for one matrix or a stack of E in one launch");
  m.def("mirage_gemm_stream", &mirage_gemm_stream,
        "kernel 1's stream route over a stack of E expert GEMMs at decode "
        "(pre-pass, stream kernel, split-K reduction)");
  m.def("flash_attention", &flash_attention,
        "GQA flash-attention forward, (B, L, heads, 64) f32");
  m.def("rns_matmul", &rns_matmul,
        "per-slot residue GEMM (x @ w) mod m over (n_mod, S) slots, int32");
  m.def("rns_matmul_channel", &rns_matmul_channel,
        "residue GEMM + readout channel (detector noise, ADC) epilogue, "
        "optionally counting the residues the noise moved");
  m.def("rrns_decode", &rrns_decode,
        "fused RRNS majority decode of (n_total, E) int32 residues");
}
