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
// Bound: device-memory bytes (8 B read and 4 B written per coordinate: g,
// and the uniform (mod_ok 1) or gbar (mod_ok 0), whichever mod_ok needs;
// against 17 float operations and three selects).  At the API's sizes
// (62,006 coordinates, 0.74 MB) the bytes take 0.22 us, so a launch costs
// its set-up, one dependent DRAM round trip, its stores and its tail:
// the design keeps every load of a thread in one round trip and overlaps
// the set-up with the kernel before it (quantize.cu's design).
//
// Design:
// - A thread takes CPT = 4 coordinates: their g, uniforms and gbar in one
//   16-byte load each (or two 8-byte loads, below), their
//   outputs in one 16-byte store.  It issues its g, uniform and gbar
//   loads (both mod_ok cases' operands) and then the four per-client
//   scalars (one broadcast load per warp each) before any arithmetic, so
//   one DRAM round trip covers them all; then the knob step's IEEE
//   division once for its CPT coordinates, every coordinate's quotient
//   before the compares (kernel_api.cuh's stochastic_knobs), and the
//   decode.
// - Alignment as in quantize.cu: a scalar head up to the output's 16-byte
//   boundary, vectors whose input loads take the widest width of 16 and 8
//   bytes that g, the uniforms and gbar all allow there (a template
//   argument, chosen per launch: 8 bytes on the rows of a (K, 62,006)
//   gradient that lie 8 mod 16), and a scalar tail; every coordinate
//   scalar when an input is only 4-byte aligned there.
// - The product keeps the plain version's order (w * s) * m, with m
//   decoded before the mod_ok select, every float operation an explicitly
//   rounded intrinsic, as dequant.cu computes it from the int8 sign and
//   int32 knob index, so the output equals the plain version and
//   dequant.cu's output on quantize.cu's results bit for bit.
// - Programmatic dependent launch (kernel_api_v2.cuh): the kernel waits
//   for the one before it before its first load, and lets the next one
//   be scheduled once its loads are issued.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api.cuh"
#include "kernel_api_v2.cuh"

constexpr int THREADS = 128;  // threads per block
constexpr int CPT = 4;        // coordinates per vector thread

// (w * sign(x)) * (ok ? lo + q * step : gb), in the plain version's order
__device__ __forceinline__ float contribution(float w, float x, float q,
                                              float gb, float lo,
                                              float step, bool ok) {
  const float m = ok ? __fadd_rn(lo, __fmul_rn(q, step)) : gb;
  return __fmul_rn(__fmul_rn(w, (float)sign_of(x)), m);
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    roundtrip_kernel(const float* __restrict__ g,
                     const float* __restrict__ rand,
                     const float* __restrict__ gbar,
                     const float* __restrict__ gmin,
                     const float* __restrict__ gmax,
                     const float* __restrict__ mod_ok,
                     const float* __restrict__ weight,
                     float* __restrict__ out, int n, int bits, int head,
                     int n_vec) {
  const int t = blockIdx.x * THREADS + threadIdx.x;
  // a vector thread's first coordinate, or a scalar thread's coordinate:
  // the head's, then the tail's after the vectors
  const int lead = t - n_vec;
  const bool vec = t < n_vec;
  const int i = vec ? head + t * CPT
                    : (lead < head ? lead : lead + n_vec * CPT);
  if (!vec && i >= n) return;  // past the end: no memory touched
  grid_dependency_wait();
  float x[CPT], r[CPT], gb[CPT];
  if (vec) {
    load_streamed_f32x4<VEC>(g + i, x);
    load_streamed_f32x4<VEC>(rand + i, r);
    load_streamed_f32x4<VEC>(gbar + i, gb);
  } else {
    x[0] = load_streamed_f32(g + i);
    r[0] = load_streamed_f32(rand + i);
    gb[0] = load_streamed_f32(gbar + i);
  }
  // the per-client scalars, in the same round trip: every lane of a warp
  // asks for the same word, so each is one broadcast load per warp
  const float lo = load_streamed_f32(gmin);
  const float hi = load_streamed_f32(gmax);
  const float okf = load_streamed_f32(mod_ok);
  const float w = load_streamed_f32(weight);
  launch_dependents();
  const float nk = top_knob(bits);
  const float step = knob_step(lo, hi, nk);
  const bool ok = okf > 0.0f;
  if (vec) {
    float q[CPT], o[CPT];
    stochastic_knobs<CPT>(x, r, lo, step, nk, q);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      o[c] = contribution(w, x[c], q[c], gb[c], lo, step, ok);
    *(float4*)(out + i) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    float q;
    stochastic_knobs<1>(x, r, lo, step, nk, &q);
    out[i] = contribution(w, x[0], q, gb[0], lo, step, ok);
  }
}

// The launch's split of [0, n): `head` scalar coordinates up to the
// output's 16-byte boundary, `n_vec` vectors of CPT when the output is
// 4-byte aligned and the inputs are then aligned for 8-byte loads (else
// none), the rest scalar; and the width (in floats) of the vectors'
// input loads.
static void split(const void* g, const void* rand, const void* gbar,
                  const void* out, int n, int* head, int* n_vec,
                  int* width) {
  const uintptr_t o = (uintptr_t)out;
  const int h = (int)(((16 - (o & 15)) & 15) / 4);
  *width = f32_vector_width(((uintptr_t)g + 4 * h) |
                            ((uintptr_t)rand + 4 * h) |
                            ((uintptr_t)gbar + 4 * h));
  const bool aligned = (o & 3) == 0 && h <= n && *width > 0;
  *head = aligned ? h : n;
  *n_vec = aligned ? (n - h) / CPT : 0;
}

extern "C" int spfl_roundtrip(const void* g, const void* rand,
                              const void* gbar, const void* gmin,
                              const void* gmax, const void* mod_ok,
                              const void* weight, void* out, int n, int bits,
                              void* stream) {
  if (n == 0) return 0;
  int head, n_vec, width;
  split(g, rand, gbar, out, n, &head, &n_vec, &width);
  const long long threads = (long long)n_vec + (n - n_vec * CPT);
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  const auto kernel = width == 2 ? roundtrip_kernel<2> : roundtrip_kernel<4>;
  return launch_pdl(kernel, blocks, THREADS, (cudaStream_t)stream,
                    (const float*)g, (const float*)rand, (const float*)gbar,
                    (const float*)gmin, (const float*)gmax,
                    (const float*)mod_ok, (const float*)weight, (float*)out,
                    n, bits, head, n_vec);
}
