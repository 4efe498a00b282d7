// BFP(b_m, g) quantization of one group of floats, as a device function.
//
// Replaces the TPU kernel's block quantizer: src/repro/kernels/bfp_quantize.py
// `_quantize_block` (:34), `_floor_log2` (:28) and `_exp2_int` (:21). The
// fused GEMM (mirage_gemm.cu) calls it as its prologue on tiles in shared
// memory; bfp_quantize.cu calls it on rows in device memory.
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

// Fake-quantize n floats src[0], src[stride], ... into dst (same stride;
// dst may alias src). Elements past n are the zero padding of the group,
// which never raises its max, so callers pass only the real ones.
__device__ __forceinline__ void bfp_quantize_group(const float* src,
                                                   float* dst, int stride,
                                                   int n, int b_m,
                                                   bool truncate) {
  float maxabs = 0.0f;
  for (int i = 0; i < n; ++i) maxabs = fmaxf(maxabs, fabsf(src[i * stride]));
  const int e = maxabs > 0.0f ? bfp_floor_log2(fmaxf(maxabs, FLT_MIN)) : 0;
  const float scale = bfp_exp2i(e - (b_m - 1));
  const float inv = 1.0f / scale;
  const float qmax = static_cast<float>((1 << b_m) - 1);
  for (int i = 0; i < n; ++i) {
    const float v = src[i * stride] * inv;
    float q = truncate ? truncf(v) : rintf(v);
    q = fminf(fmaxf(q, -qmax), qmax);
    dst[i * stride] = q * scale;
  }
}
