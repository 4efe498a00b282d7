// BFP(b_m, g) quantization of one group of floats, as a device function.
//
// Replaces the TPU kernel's block quantizer: src/repro/kernels/bfp_quantize.py
// `_quantize_block` (:34), `_floor_log2` (:28) and `_exp2_int` (:21). The
// fused GEMM (mirage_gemm.cu) quantizes groups held in registers with
// bfp_grid + bfp_quantize_value; bfp_quantize.cu calls bfp_quantize_group
// on rows in device memory.
//
// Semantics are those of src/repro/core/bfp.py (the oracle of the plain
// version): the group exponent is floor(log2 max|x|) read from the f32
// exponent field after clamping the max to the smallest normal (bfp.py:58;
// the Pallas kernel's 1e-30 clamp differs only for maxima below 1e-30), a
// zero group takes exponent 0, the scale 2^(E - b_m + 1) is built in the
// exponent field with E - b_m + 1 clamped to [-126, 127], mantissas round
// half to even (rintf, as jnp.round; roundf would round half away from
// zero) or toward zero (truncf), and clamp to +-(2^b_m - 1).
//
// Bit-exactness needs IEEE arithmetic: build without --use_fast_math (it
// flushes subnormals and approximates division). x * (1/scale) equals
// x / scale exactly: 1/scale is a power of two, exactly representable (as
// a subnormal for scale 2^127), so both are the correctly rounded value of
// the same real number.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

__device__ __forceinline__ float bfp_exp2i(int e) {
  e = max(-126, min(127, e));
  return __int_as_float((e + 127) << 23);
}

// floor(log2 m) for a normal m > 0, from the exponent bit field.
__device__ __forceinline__ int bfp_floor_log2(float m) {
  return ((__float_as_int(m) >> 23) & 0xFF) - 127;
}

// The grid of one group from its max |x|: the scale 2^(E - b_m + 1), its
// reciprocal and the mantissa bound 2^b_m - 1.
struct BfpGrid {
  float scale, inv, qmax;
};

__device__ __forceinline__ BfpGrid bfp_grid(float maxabs, int b_m) {
  const int e = maxabs > 0.0f ? bfp_floor_log2(fmaxf(maxabs, FLT_MIN)) : 0;
  const int s = max(-126, min(127, e - (b_m - 1)));
  BfpGrid grid;
  grid.scale = __int_as_float((s + 127) << 23);
  // 1 / 2^s, exact: 2^-s is normal for s < 127 and the subnormal 2^-127
  // (bit 22 alone) for s = 127, the correctly rounded 1.0f / scale
  grid.inv = s < 127 ? __int_as_float((127 - s) << 23)
                     : __int_as_float(1 << 22);
  grid.qmax = static_cast<float>((1 << b_m) - 1);
  return grid;
}

// One element of a group onto the group's grid.
__device__ __forceinline__ float bfp_quantize_value(float x,
                                                    const BfpGrid& grid,
                                                    bool truncate) {
  const float v = x * grid.inv;
  float q = truncate ? truncf(v) : rintf(v);
  q = fminf(fmaxf(q, -grid.qmax), grid.qmax);
  return q * grid.scale;
}

// Fake-quantize n floats src[0], src[stride], ... into dst (same stride;
// dst may alias src). Elements past n are the zero padding of the group,
// which never raises its max, so callers pass only the real ones.
__device__ __forceinline__ void bfp_quantize_group(const float* src,
                                                   float* dst, int stride,
                                                   int n, int b_m,
                                                   bool truncate) {
  float maxabs = 0.0f;
  for (int i = 0; i < n; ++i) maxabs = fmaxf(maxabs, fabsf(src[i * stride]));
  const BfpGrid grid = bfp_grid(maxabs, b_m);
  for (int i = 0; i < n; ++i)
    dst[i * stride] = bfp_quantize_value(src[i * stride], grid, truncate);
}
