// Fused PS decode of one client, eq. (15)-(17), straight from its packed
// sign and knob payload words:
//
//   out[c] = w * (s[c] * (mod_ok ? gmin + q[c] * step : gbar[c]))
//
// with the knob step precomputed by the wrapper (an IEEE division).
//
// Replaces: src/repro/wire/pack_kernel.py:unpack_dequant_kernel (builder
// unpack_dequant_2d, decode body _dequant_contrib).
//
// Bound: device-memory bytes ((1 + bits) / 8 B of words and 4 B of gbar
// read, 4 B written per coordinate, against a few integer operations per
// plane and four float operations).
//
// Design: one thread per coordinate: the single-client decode of
// spfl_accumulate.cu without the client loop and the votes, from
// kernel_api.cuh.  The 32 lanes of a warp share one group's sign and knob
// words, so each word load is a warp broadcast.  The products keep the
// plain version's order, w * (s * m), so the output equals it bit for
// bit, and a sum of these outputs over clients k = 0..K-1 equals
// spfl_accumulate.cu's sum.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api.cuh"

__global__ void unpack_dequant_kernel(const uint32_t* __restrict__ sign_words,
                                      const uint32_t* __restrict__ qidx_words,
                                      const float* __restrict__ gbar,
                                      const float* __restrict__ gmin,
                                      const float* __restrict__ step,
                                      const float* __restrict__ mod_ok,
                                      const float* __restrict__ weight,
                                      float* __restrict__ out, int n,
                                      int bits) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  // the scalars first, so their loads overlap the plane loop's
  const float ok = mod_ok[0], lo = gmin[0], st = step[0], w = weight[0];
  const long long grp = c >> 5;
  const int lane = (int)(c & 31);
  const uint32_t sbit = (sign_words[grp] >> lane) & 1u;
  const uint32_t q = unpack_value(qidx_words + grp * bits, lane, bits);
  const float modulus = decoded_modulus(ok, lo, (float)q, st, gbar + c);
  const float s = sbit ? 1.0f : -1.0f;
  out[c] = __fmul_rn(w, __fmul_rn(s, modulus));
}

extern "C" int spfl_unpack_dequant(const void* sign_words,
                                   const void* qidx_words, const void* gbar,
                                   const void* gmin, const void* step,
                                   const void* mod_ok, const void* weight,
                                   void* out, int n, int bits,
                                   void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = ((long long)n + threads - 1) / threads;
  unpack_dequant_kernel<<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)sign_words, (const uint32_t*)qidx_words,
      (const float*)gbar, (const float*)gmin, (const float*)step,
      (const float*)mod_ok, (const float*)weight, (float*)out, n, bits);
  return (int)cudaGetLastError();
}
