// Device functions shared by the per-client kernel API (quantize.cu,
// dequant.cu, roundtrip.cu, unpack_bits.cu, unpack_dequant.cu): the
// eq. (8) stochastic rounding, the eq. (15)-(16) compensated modulus and
// the bit-plane unpack of one value.
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

// Eq. (8): the stochastic knob index of |x| in [0, nk], as a float.  A
// zero step (constant |g|) gives index 0.
__device__ __forceinline__ float stochastic_knob(float x, float r, float lo,
                                                 float step, float nk) {
  const float safe = step > 0.0f ? step : 1.0f;
  const float u = step > 0.0f ? __fdiv_rn(__fsub_rn(fabsf(x), lo), safe)
                              : 0.0f;
  const float lower = fminf(fmaxf(floorf(u), 0.0f), nk);
  const float frac = __fsub_rn(u, lower);
  const float up = r < frac ? 1.0f : 0.0f;
  return fminf(fmaxf(__fadd_rn(lower, up), 0.0f), nk);
}

// Eq. (15)-(16): gmin + q * step when the modulus packet arrived
// (mod_ok > 0), else the compensation gbar (read only then).  The decode
// is computed before the select, so its operands' loads do not wait for
// mod_ok's.
__device__ __forceinline__ float decoded_modulus(float mod_ok, float lo,
                                                 float q, float step,
                                                 const float* gbar) {
  const float decoded = __fadd_rn(lo, __fmul_rn(q, step));
  return mod_ok > 0.0f ? decoded : *gbar;
}

// The value of lane `lane` of a group from its `bits` plane words.  The
// loop is not unrolled, so one trip is one plane in the SASS
// (kernels/sass.py MAIN_PATHS).
__device__ __forceinline__ uint32_t unpack_value(const uint32_t* planes,
                                                 int lane, int bits) {
  uint32_t v = 0u;
#pragma unroll 1
  for (int j = 0; j < bits; ++j) v |= ((planes[j] >> lane) & 1u) << j;
  return v;
}
