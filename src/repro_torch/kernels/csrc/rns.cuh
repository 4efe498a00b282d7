// Arguments shared by the residue kernels and their binding.
#pragma once

constexpr int kRnsMaxModuli = 8;

// Moduli of the residue GEMM and, per modulus, the ADC grid step of the
// readout epilogue (0 marks the identity converter). Passed by value as a
// kernel parameter; read with constant indices only (rns_matmul.cu), so the
// compiler keeps it in the parameter bank.
struct RnsModuli {
  int m[kRnsMaxModuli];
  float step[kRnsMaxModuli];
};

constexpr int kRrnsMaxTotal = 8;
constexpr int kRrnsMaxSubsets = 64;

// The RRNS decode tables of src/repro/kernels/rrns_decode.py:88-96, all f32,
// in this field order (repro_torch/kernels/ops.py `_rrns_table_words` packs
// a float32 tensor of exactly kRrnsTableWords words in the same order; the
// decode kernel takes the struct by value, as a __grid_constant__
// parameter):
// per-subset CRT weights (0 for non-members), M_s, f32(1/M_s), psi_s and
// psi_s + 1 - M_s; per-modulus m and f32(1/m); the vote lookup binom[e] =
// C(n_required + e, n_required); the legal half-range psi; and the counts.
struct RrnsTables {
  float weight[kRrnsMaxSubsets][kRrnsMaxTotal];
  float sub_M[kRrnsMaxSubsets];
  float sub_inv_M[kRrnsMaxSubsets];
  float sub_psi[kRrnsMaxSubsets];
  float sub_lo[kRrnsMaxSubsets];
  float mod[kRrnsMaxTotal];
  float inv_mod[kRrnsMaxTotal];
  float binom[kRrnsMaxTotal + 1];
  float psi;
  float n_total;
  float n_required;
  float n_subsets;
};

constexpr int kRrnsTableWords =
    kRrnsMaxSubsets * kRrnsMaxTotal + 4 * kRrnsMaxSubsets +
    2 * kRrnsMaxTotal + (kRrnsMaxTotal + 1) + 4;
static_assert(sizeof(RrnsTables) == 4 * kRrnsTableWords,
              "RrnsTables must be kRrnsTableWords packed floats");
