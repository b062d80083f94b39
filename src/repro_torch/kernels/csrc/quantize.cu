// Stochastic quantization of one client's flat gradient, eq. (7)-(8):
// int8 sign in {-1, 0, +1} (g = 0 and g = -0 give 0) and int32 knob index.
//
// Replaces: src/repro/kernels/quantize_kernel.py:quantize_kernel (builder
// quantize_2d), whose arithmetic is quantize_body there.
//
// Bound: device-memory bytes (8 B read and 5 B written per coordinate,
// against 13 float operations, a subtraction and a conversion).
//
// Design: one thread per coordinate, neighbouring threads on neighbouring
// addresses.  The TPU kernel's (128, 512) tiles and zero padding are gone:
// the last block masks its tail.  Eq. (8) is kernel_api.cuh's, so the
// knob indices equal the plain version's.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api.cuh"

__global__ void quantize_kernel(const float* __restrict__ g,
                                const float* __restrict__ rand,
                                const float* __restrict__ gmin,
                                const float* __restrict__ gmax,
                                int8_t* __restrict__ sign,
                                int32_t* __restrict__ qidx, int n, int bits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // both loads first, so they overlap the knob step's division
  const float x = g[i];
  const float r = rand[i];
  const float lo = gmin[0];
  const float nk = top_knob(bits);
  const float step = knob_step(lo, gmax[0], nk);
  qidx[i] = (int32_t)stochastic_knob(x, r, lo, step, nk);
  sign[i] = (int8_t)((x > 0.0f) - (x < 0.0f));
}

extern "C" int spfl_quantize(const void* g, const void* rand,
                             const void* gmin, const void* gmax, void* sign,
                             void* qidx, int n, int bits, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = ((long long)n + threads - 1) / threads;
  quantize_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)rand, (const float*)gmin,
      (const float*)gmax, (int8_t*)sign, (int32_t*)qidx, n, bits);
  return (int)cudaGetLastError();
}
