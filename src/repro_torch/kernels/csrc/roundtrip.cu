// Fused analytic round trip of one client: quantize (eq. (7)-(8)),
// dequantize, compensate and weight (eq. (15)-(17)) in one pass,
//
//   out[i] = (w * sign(g[i])) * (mod_ok ? gmin + Q(g[i]) * step : gbar[i]),
//
// with no int8 sign or int32 knob index in device memory.
//
// Replaces: src/repro/kernels/quantize_kernel.py:roundtrip_kernel (builder
// roundtrip_2d).
//
// Bound: device-memory bytes (12 B read and 4 B written per coordinate,
// against 17 float operations and three selects).
//
// Design: one thread per coordinate: quantize.cu's eq. (8), then
// dequant.cu's decode on the knob index held in a register, both from
// kernel_api.cuh.  The knob step is computed once per thread with an IEEE
// division and serves both halves, as in the plain version (quantize,
// then dequant), so the output equals it bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api.cuh"

__global__ void roundtrip_kernel(const float* __restrict__ g,
                                 const float* __restrict__ rand,
                                 const float* __restrict__ gbar,
                                 const float* __restrict__ gmin,
                                 const float* __restrict__ gmax,
                                 const float* __restrict__ mod_ok,
                                 const float* __restrict__ weight,
                                 float* __restrict__ out, int n, int bits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // both loads first, so they overlap the knob step's division
  const float x = g[i];
  const float r = rand[i];
  const float lo = gmin[0];
  const float nk = top_knob(bits);
  const float step = knob_step(lo, gmax[0], nk);
  const float q = stochastic_knob(x, r, lo, step, nk);
  const float modulus = decoded_modulus(mod_ok[0], lo, q, step, gbar + i);
  const float s = (float)((x > 0.0f) - (x < 0.0f));
  out[i] = __fmul_rn(__fmul_rn(weight[0], s), modulus);
}

extern "C" int spfl_roundtrip(const void* g, const void* rand,
                              const void* gbar, const void* gmin,
                              const void* gmax, const void* mod_ok,
                              const void* weight, void* out, int n, int bits,
                              void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = ((long long)n + threads - 1) / threads;
  roundtrip_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)rand, (const float*)gbar,
      (const float*)gmin, (const float*)gmax, (const float*)mod_ok,
      (const float*)weight, (float*)out, n, bits);
  return (int)cudaGetLastError();
}
