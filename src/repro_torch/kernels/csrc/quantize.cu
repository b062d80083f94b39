// Stochastic quantization of one client's flat gradient, eq. (7)-(8):
// int8 sign in {-1, 0, +1} (g = 0 and g = -0 give 0) and int32 knob index.
//
// Replaces: src/repro/kernels/quantize_kernel.py:quantize_kernel (builder
// quantize_2d), whose arithmetic is quantize_body there.
//
// Bound: device-memory bytes (8 B read and 5 B written per coordinate,
// against 13 float operations, a subtraction and a conversion).  At the
// API's sizes (62,006 coordinates, 0.81 MB) the bytes take 0.24 us, so a
// launch costs its set-up, one dependent DRAM round trip, its stores and
// its tail: the design keeps every load of a thread in one round trip and
// overlaps the set-up with the kernel before it (dequant.cu's design).
//
// Design:
// - A thread takes CPT = 4 coordinates: their g and uniforms in one
//   16-byte load each (or two 8-byte loads, below), their
//   signs in one 4-byte store and their knob indices in one 16-byte
//   store.  It issues its g and uniform loads and then the two
//   per-client scalars (one broadcast load per warp each) before any
//   arithmetic, so one DRAM round trip covers them all; then the knob
//   step's IEEE division once for its CPT coordinates, and every
//   coordinate's quotient before the compares (kernel_api.cuh's
//   stochastic_knobs), so the divisions' rare slow paths rejoin early.
// - Alignment: the host takes the first `head` (< 4) coordinates up to
//   the knob output's 16-byte boundary apart, and uses vectors only when
//   the sign output is then 4-byte aligned too (the wrapper's fresh
//   outputs always are).  The inputs need not be aligned like the
//   outputs: the rows of a (K, n) gradient lie n * 4 B apart, 8 mod 16 at
//   n = 62,006, so a vector thread loads its inputs by 16-byte loads, or
//   by 8-byte loads where one of them is only 8-byte aligned there (a
//   template argument, chosen per launch).  The head, the ragged tail,
//   and every coordinate when the outputs are not aligned alike or an
//   input is only 4-byte aligned, take one scalar thread each, coalesced
//   across the warp.
// - Every float operation is an explicitly rounded intrinsic in
//   quantize_body's order, so the knob indices equal the plain version's.
// - Programmatic dependent launch (kernel_api_v2.cuh): the kernel waits
//   for the one before it before its first load, and lets the next one
//   be scheduled once its loads are issued.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api.cuh"
#include "kernel_api_v2.cuh"

constexpr int THREADS = 128;  // threads per block
constexpr int CPT = 4;        // coordinates per vector thread

template <int VEC>
__global__ void __launch_bounds__(THREADS)
    quantize_kernel(const float* __restrict__ g,
                    const float* __restrict__ rand,
                    const float* __restrict__ gmin,
                    const float* __restrict__ gmax,
                    int8_t* __restrict__ sign, int32_t* __restrict__ qidx,
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
  float x[CPT], r[CPT];
  if (vec) {
    load_streamed_f32x4<VEC>(g + i, x);
    load_streamed_f32x4<VEC>(rand + i, r);
  } else {
    x[0] = load_streamed_f32(g + i);
    r[0] = load_streamed_f32(rand + i);
  }
  // the per-client scalars, in the same round trip: every lane of a warp
  // asks for the same word, so each is one broadcast load per warp
  const float lo = load_streamed_f32(gmin);
  const float hi = load_streamed_f32(gmax);
  launch_dependents();
  const float nk = top_knob(bits);
  const float step = knob_step(lo, hi, nk);
  if (vec) {
    float q[CPT];
    stochastic_knobs<CPT>(x, r, lo, step, nk, q);
    uint32_t s4 = 0u;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      s4 |= (uint32_t)(uint8_t)sign_of(x[c]) << (8 * c);
    *(uint32_t*)(sign + i) = s4;
    *(int4*)(qidx + i) =
        make_int4((int)q[0], (int)q[1], (int)q[2], (int)q[3]);
  } else {
    float q;
    stochastic_knobs<1>(x, r, lo, step, nk, &q);
    sign[i] = (int8_t)sign_of(x[0]);
    qidx[i] = (int32_t)q;
  }
}

// The launch's split of [0, n): `head` scalar coordinates up to the knob
// output's 16-byte boundary, `n_vec` vectors of CPT when the sign output
// is then aligned for its 4-byte store and the inputs for 8-byte loads
// (else none), the rest scalar; and the width (in floats) of the
// vectors' input loads.
static void split(const void* g, const void* rand, const void* sign,
                  const void* qidx, int n, int* head, int* n_vec,
                  int* width) {
  const uintptr_t o = (uintptr_t)qidx;
  const int h = (int)(((16 - (o & 15)) & 15) / 4);
  *width = f32_vector_width(((uintptr_t)g + 4 * h) |
                            ((uintptr_t)rand + 4 * h));
  const bool aligned = (o & 3) == 0 && h <= n && *width > 0 &&
                       (((uintptr_t)sign + h) & (CPT - 1)) == 0;
  *head = aligned ? h : n;
  *n_vec = aligned ? (n - h) / CPT : 0;
}

extern "C" int spfl_quantize(const void* g, const void* rand,
                             const void* gmin, const void* gmax, void* sign,
                             void* qidx, int n, int bits, void* stream) {
  if (n == 0) return 0;
  int head, n_vec, width;
  split(g, rand, sign, qidx, n, &head, &n_vec, &width);
  const long long threads = (long long)n_vec + (n - n_vec * CPT);
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  const auto kernel = width == 2 ? quantize_kernel<2> : quantize_kernel<4>;
  return launch_pdl(kernel, blocks, THREADS, (cudaStream_t)stream,
                    (const float*)g, (const float*)rand, (const float*)gmin,
                    (const float*)gmax, (int8_t*)sign, (int32_t*)qidx, n,
                    bits, head, n_vec);
}
