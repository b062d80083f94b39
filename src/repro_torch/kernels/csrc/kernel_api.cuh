// Device functions shared by the per-client kernel API (quantize.cu,
// dequant.cu, roundtrip.cu, unpack_dequant.cu): the knob step, the
// eq. (8) stochastic rounding of a thread's coordinates and their sign.
//
// Every float operation is an explicitly rounded intrinsic in the plain
// version's order (kernels/ref.py), so nvcc cannot contract or
// reassociate it and each kernel equals its plain version bit for bit.
// The body of eq. (8) is quantize_pack.cu's, op for op.
#pragma once
#include <cstdint>

// The top knob index 2^bits - 1, as a float.
__device__ __forceinline__ float top_knob(int bits) {
  return (float)((1u << bits) - 1u);
}

// The knob step (gmax - gmin) / (2^bits - 1): an IEEE division.
__device__ __forceinline__ float knob_step(float lo, float hi, float nk) {
  return __fdiv_rn(__fsub_rn(hi, lo), nk);
}

// Eq. (8): the stochastic knob indices q[c] of |x[c]| in [0, nk], as
// floats, for a thread's C coordinates.  Every quotient comes first, so
// the IEEE divisions' rare slow paths rejoin before the compares.  A
// zero step (constant |g|) gives index 0.
template <int C>
__device__ __forceinline__ void stochastic_knobs(const float* x,
                                                 const float* r, float lo,
                                                 float step, float nk,
                                                 float* q) {
  const bool live = step > 0.0f;
  const float safe = live ? step : 1.0f;
  float u[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    u[c] = live ? __fdiv_rn(__fsub_rn(fabsf(x[c]), lo), safe) : 0.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float lower = fminf(fmaxf(floorf(u[c]), 0.0f), nk);
    const float frac = __fsub_rn(u[c], lower);
    const float up = r[c] < frac ? 1.0f : 0.0f;
    q[c] = fminf(fmaxf(__fadd_rn(lower, up), 0.0f), nk);
  }
}

// sign(x) in {-1, 0, +1}: 0 for x = 0 and x = -0.
__device__ __forceinline__ int sign_of(float x) {
  return (x > 0.0f) - (x < 0.0f);
}
