// Compensated dequantization of one client, eq. (15)-(17):
//
//   out[i] = (w * s[i]) * (mod_ok ? gmin + q[i] * step : gbar[i]),
//   step = (gmax - gmin) / (2^bits - 1)
//
// from the int8 sign and int32 knob index of quantize.cu.
//
// Replaces: src/repro/kernels/quantize_kernel.py:dequant_kernel (builder
// dequant_2d).
//
// Bound: device-memory bytes (9 B read and 4 B written per coordinate,
// against four float operations, a select and two conversions).
//
// Design: one thread per coordinate.  The knob step is computed in the
// kernel, as the TPU kernel does, with an IEEE division, so it equals the
// plain version's knob_step; the decode is kernel_api.cuh's.  The outer
// product (w * s) * m keeps the plain version's order, so the output
// equals it bit for bit.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api.cuh"

__global__ void dequant_kernel(const int8_t* __restrict__ sign,
                               const int32_t* __restrict__ qidx,
                               const float* __restrict__ gbar,
                               const float* __restrict__ gmin,
                               const float* __restrict__ gmax,
                               const float* __restrict__ mod_ok,
                               const float* __restrict__ weight,
                               float* __restrict__ out, int n, int bits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float lo = gmin[0];
  const float step = knob_step(lo, gmax[0], top_knob(bits));
  const float modulus =
      decoded_modulus(mod_ok[0], lo, (float)qidx[i], step, gbar + i);
  out[i] = __fmul_rn(__fmul_rn(weight[0], (float)sign[i]), modulus);
}

extern "C" int spfl_dequant(const void* sign, const void* qidx,
                            const void* gbar, const void* gmin,
                            const void* gmax, const void* mod_ok,
                            const void* weight, void* out, int n, int bits,
                            void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = ((long long)n + threads - 1) / threads;
  dequant_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)sign, (const int32_t*)qidx, (const float*)gbar,
      (const float*)gmin, (const float*)gmax, (const float*)mod_ok,
      (const float*)weight, (float*)out, n, bits);
  return (int)cudaGetLastError();
}
