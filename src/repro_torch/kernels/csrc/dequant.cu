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
// Bound: device-memory bytes (5 B read and 4 B written per coordinate:
// the sign, and the knob index or gbar, whichever mod_ok picks; against
// four float operations, a select and two conversions).  At the API's
// sizes (62,006 coordinates, 0.56 MB) the bytes take 0.17 us, so a launch
// costs its set-up, one dependent DRAM round trip, its stores and its
// tail: the design keeps every load of a thread in one round trip and
// overlaps the set-up with the kernel before it.
//
// Design:
// - A thread takes CPT = 4 coordinates: their signs in one 4-byte load,
//   their knob indices and gbar in one 16-byte load each, their outputs
//   in one 16-byte store.  It issues its sign, knob and gbar loads
//   (both mod_ok cases' operands) and then the four per-client scalars
//   (one broadcast load per warp each) before any arithmetic, so one DRAM
//   round trip covers them all, and computes the knob step itself
//   (kernel_api.cuh's knob_step, the IEEE division of the plain version).
//   Timed on an H100 against edited copies of this source (kernel_ab.py),
//   scalars loaded once per block by one warp and shared after a barrier
//   ran 21-33% slower, gbar loaded only once mod_ok is known 24% slower
//   at mod_ok 0 (a second round trip) and 2% faster at mod_ok 1, and 8
//   or 16 coordinates per thread 16-17% slower than 4.
// - Vector loads need their addresses aligned: the host takes the first
//   `head` (< 4) coordinates up to the output's 16-byte boundary apart,
//   and uses vectors only when the sign, knob and gbar rows are then
//   aligned too.  The head and the ragged tail, or every coordinate when
//   the rows are not aligned alike (rows of a (K, n) tensor at an odd
//   offset), take one scalar thread each, coalesced across the warp.
// - The product keeps the plain version's order (w * s) * m, every float
//   operation an explicitly rounded intrinsic, so the output equals it
//   bit for bit.
// - Programmatic dependent launch (kernel_api_v2.cuh): the kernel waits
//   for the one before it before its first load, and lets the next one
//   be scheduled once its loads are issued.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api.cuh"
#include "kernel_api_v2.cuh"

constexpr int THREADS = 128;  // threads per block
constexpr int CPT = 4;        // coordinates per vector thread

// (w * s) * (ok ? lo + q * step : gbar), in the plain version's order
__device__ __forceinline__ float contribution(float w, int s, int q, float gb,
                                              float lo, float step,
                                              bool ok) {
  const float m = ok ? __fadd_rn(lo, __fmul_rn((float)q, step)) : gb;
  return __fmul_rn(__fmul_rn(w, (float)s), m);
}

__global__ void __launch_bounds__(THREADS)
    dequant_kernel(const int8_t* __restrict__ sign,
                   const int32_t* __restrict__ qidx,
                   const float* __restrict__ gbar,
                   const float* __restrict__ gmin,
                   const float* __restrict__ gmax,
                   const float* __restrict__ mod_ok,
                   const float* __restrict__ weight, float* __restrict__ out,
                   int n, int bits, int head, int n_vec) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  // a vector thread's first coordinate, or a scalar thread's coordinate:
  // the head's, then the tail's after the vectors
  const int lead = t - n_vec;
  const bool vec = t < n_vec;
  const int i = vec ? head + t * CPT
                    : (lead < head ? lead : lead + n_vec * CPT);
  if (!vec && i >= n) return;  // past the end: no memory touched
  grid_dependency_wait();
  uint32_t s4 = 0u;  // a vector thread's CPT signs, one byte each
  uint4 q4, g4;      // its knob indices and gbar
  int s1 = 0, q1 = 0;
  float g1 = 0.0f;
  if (vec) {
    s4 = load_streamed((const uint32_t*)(sign + i));
    q4 = load_streamed_v4(qidx + i);
    g4 = load_streamed_v4(gbar + i);
  } else {
    s1 = load_streamed_s8(sign + i);
    q1 = (int)load_streamed((const uint32_t*)qidx + i);
    g1 = __uint_as_float(load_streamed((const uint32_t*)gbar + i));
  }
  // the per-client scalars, in the same round trip: every lane of a warp
  // asks for the same word, so each is one broadcast load per warp
  const float lo = __uint_as_float(load_streamed((const uint32_t*)gmin));
  const float hi = __uint_as_float(load_streamed((const uint32_t*)gmax));
  const float okf = __uint_as_float(load_streamed((const uint32_t*)mod_ok));
  const float w = __uint_as_float(load_streamed((const uint32_t*)weight));
  launch_dependents();
  const float step = knob_step(lo, hi, top_knob(bits));
  const bool ok = okf > 0.0f;
  if (vec) {
    const int q[CPT] = {(int)q4.x, (int)q4.y, (int)q4.z, (int)q4.w};
    const float gb[CPT] = {__uint_as_float(g4.x), __uint_as_float(g4.y),
                           __uint_as_float(g4.z), __uint_as_float(g4.w)};
    float r[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      r[c] = contribution(w, (int)(int8_t)(s4 >> (8 * c)), q[c], gb[c], lo,
                          step, ok);
    *(float4*)(out + i) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    out[i] = contribution(w, s1, q1, g1, lo, step, ok);
  }
}

// The launch's split of [0, n): `head` scalar coordinates up to the
// output's 16-byte boundary, `n_vec` vectors of CPT when every row is
// then aligned for them (else none), the rest scalar.
static void split(const void* sign, const void* qidx, const void* gbar,
                  const void* out, int n, int* head, int* n_vec) {
  const uintptr_t o = (uintptr_t)out;
  const int h = (int)(((16 - (o & 15)) & 15) / 4);
  const bool aligned =
      (o & 3) == 0 && h <= n &&
      (((uintptr_t)qidx + 4 * h) & 15) == 0 &&
      (((uintptr_t)gbar + 4 * h) & 15) == 0 &&
      (((uintptr_t)sign + h) & (CPT - 1)) == 0;
  *head = aligned ? h : n;
  *n_vec = aligned ? (n - h) / CPT : 0;
}

extern "C" int spfl_dequant(const void* sign, const void* qidx,
                            const void* gbar, const void* gmin,
                            const void* gmax, const void* mod_ok,
                            const void* weight, void* out, int n, int bits,
                            void* stream) {
  if (n == 0) return 0;
  int head, n_vec;
  split(sign, qidx, gbar, out, n, &head, &n_vec);
  const long long threads = (long long)n_vec + (n - n_vec * CPT);
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  return launch_pdl(dequant_kernel, blocks, THREADS, (cudaStream_t)stream,
                    (const int8_t*)sign, (const int32_t*)qidx,
                    (const float*)gbar, (const float*)gmin,
                    (const float*)gmax, (const float*)mod_ok,
                    (const float*)weight, (float*)out, n, bits, head, n_vec);
}
