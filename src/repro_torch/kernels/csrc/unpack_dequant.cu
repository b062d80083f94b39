// Fused PS decode of one client, eq. (15)-(17), straight from its packed
// sign and knob payload words:
//
//   out[c] = w * (s[c] * (mod_ok ? gmin + q[c] * step : gbar[c])),
//   step = (gmax - gmin) / (2^bits - 1)
//
// Replaces: src/repro/wire/pack_kernel.py:unpack_dequant_kernel (builder
// unpack_dequant_2d, decode body _dequant_contrib).
//
// Bound: device-memory bytes (1 / 8 B of sign words and, by mod_ok,
// bits / 8 B of knob words or 4 B of gbar read, 4 B written per
// coordinate, against a few integer operations per plane and four float
// operations).  At the API's sizes (62,006 coordinates, 0.28-0.50 MB) the
// bytes take 0.08-0.15 us, so a launch costs its set-up, one dependent
// DRAM round trip, its stores and its tail: the design keeps every load
// of a warp in one round trip and overlaps the set-up with the kernel
// before it.
//
// Design:
// - One C entry dispatches bits 1..16 to unpack_dequant_kernel<BITS>, so
//   the planes are straight-line code, and computes nothing on the host:
//   the kernel takes gmax and makes the knob step itself (kernel_api.cuh's
//   knob_step, the IEEE division of the plain version), so a wrapper call
//   is one device operation.
// - Warps of vectors: a lane takes one vector of 4 coordinates, so a
//   warp's 32 vectors span GPW groups.  The warp loads their sign words and then their knob
//   words as one coalesced run of 4-byte loads (word_run: any row start,
//   phase 6's odd clients read rows 8 mod 16), each lane gbar of its 4
//   coordinates by one 16-byte load (both mod_ok cases' operands), then
//   the four per-client scalars (one broadcast load per warp each), all
//   before any arithmetic, so one DRAM round trip covers them; it stages
//   the words in shared memory and reads each vector's sign bits and
//   knob planes off its group's words.  Outputs go as one 16-byte store
//   a vector.
// - Alignment: vectors need the output and gbar 16-byte aligned, which
//   the wrapper's fresh output and whole (n,) gbar always are; the
//   ragged tail, and every coordinate otherwise (the C entry's callers
//   only), take one scalar thread each after the vector warps.
// - The products keep the plain version's order, w * (s * m) (the Pallas
//   _dequant_contrib's; not dequant.cu's (w * s) * m), every float
//   operation an explicitly rounded intrinsic, so the output equals it
//   bit for bit, and a sum of these outputs over clients k = 0..K-1
//   equals spfl_accumulate.cu's sum.
// - Blocks of THREADS threads: one wave on the 132 SMs at the API's
//   sizes.  Timed on an H100 (700 W) against edited copies of this
//   source (kernel_ab.py; this one 1.81 us a wrapper call at bits 3, 1.64
//   us on a mod_ok 0 chain): 256-thread blocks within 0.5%, two vectors a
//   lane 1.4% faster alone but 13% slower on the chain and
//   even behind dequant, one value a lane (4-byte gbar loads and stores)
//   2-7% slower (10% on the chain), and unpack_bits.cu's one thread a
//   coordinate (every load before any arithmetic, PDL, the step in the
//   kernel) 17% slower (21% at mod_ok 0, 25% on the chain, 0.23 us
//   behind dequant, 1.8% on a queued phase 6 client).
// - Programmatic dependent launch (kernel_api_v2.cuh): the kernel waits
//   for the one before it before its first load, and lets the next one
//   be scheduled once its loads are issued.  Without it a call took
//   1.00 us more.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api.cuh"
#include "kernel_api_v2.cuh"

constexpr int THREADS = 128;  // threads per block
constexpr int GPW = 4;        // groups a warp's 32 vectors of 4 span

// w * (s * (ok ? lo + q * step : gb)), in the plain version's order
__device__ __forceinline__ float contribution(float w, uint32_t sbit,
                                              uint32_t q, float gb, float lo,
                                              float step, bool ok) {
  const float m = ok ? __fadd_rn(lo, __fmul_rn((float)q, step)) : gb;
  return __fmul_rn(w, __fmul_rn(sbit ? 1.0f : -1.0f, m));
}

// A warp's run of words, `na` from a and then `nb` from b: word i in lane
// i % 32 of trip i / 32, by one 4-byte streamed load per lane and trip
// (coalesced, any start), every trip's issued before any is used; 0 past
// the run.
template <int TRIPS>
__device__ __forceinline__ void word_run(const uint32_t* a, int na,
                                         const uint32_t* b, int nb, int lane,
                                         uint32_t (&w)[TRIPS]) {
#pragma unroll
  for (int k = 0; k < TRIPS; ++k) {
    const int i = lane + 32 * k;
    const uint32_t* p = i < na ? a + i : b + (i - na);
    w[k] = i < na + nb ? load_streamed(p) : 0u;
  }
}

// The values of the 4 coordinates from bit `off` (a multiple of 4) of
// group j, from the staged plane words st (plane b of group j at
// st[j * BITS + b]): v[c] = sum_b bit (off + c) of plane b << b.
template <int BITS>
__device__ __forceinline__ void vector_values(const uint32_t* st, int j,
                                              int off, uint32_t (&v)[4]) {
  uint32_t x[BITS];
#pragma unroll
  for (int b = 0; b < BITS; ++b) x[b] = st[j * BITS + b] >> off;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = 0u;
#pragma unroll
    for (int b = 0; b < BITS; ++b) v[c] |= ((x[b] >> c) & 1u) << b;
  }
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
    unpack_dequant_kernel(const uint32_t* __restrict__ sign_words,
                          const uint32_t* __restrict__ qidx_words,
                          const float* __restrict__ gbar,
                          const float* __restrict__ gmin,
                          const float* __restrict__ gmax,
                          const float* __restrict__ mod_ok,
                          const float* __restrict__ weight,
                          float* __restrict__ out, int n, int n_vec,
                          int vec_warps) {
  constexpr int SIZE = GPW * (1 + BITS);  // a warp's words
  constexpr int TRIPS = (SIZE + 31) / 32;
  __shared__ uint32_t staged[THREADS / 32][SIZE];
  const int t = blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = t >> 5;
  if (warp < vec_warps) {
    // the warp's first group, and its groups within the input
    const int g0 = GPW * warp;
    const int groups = min(GPW, ((n + 31) >> 5) - g0);
    grid_dependency_wait();
    uint32_t w[TRIPS];
    word_run(sign_words + g0, groups, qidx_words + (size_t)g0 * BITS,
             groups * BITS, lane, w);
    float gb[4];  // thread t's vector is coordinates 4t..4t+3
    if (t < n_vec) load_streamed_f32x4<4>(gbar + 4 * t, gb);
    // the per-client scalars, in the same round trip: every lane of a warp
    // asks for the same word, so each is one broadcast load per warp
    const float lo = load_streamed_f32(gmin);
    const float hi = load_streamed_f32(gmax);
    const float okf = load_streamed_f32(mod_ok);
    const float wt = load_streamed_f32(weight);
    launch_dependents();
    uint32_t* st = staged[threadIdx.x >> 5];
#pragma unroll
    for (int k = 0; k < TRIPS; ++k)
      if (lane + 32 * k < SIZE) st[lane + 32 * k] = w[k];
    __syncwarp();
    const float step = knob_step(lo, hi, top_knob(BITS));
    const bool ok = okf > 0.0f;
    if (t >= n_vec) return;
    const int j = lane >> 3, off = 4 * (lane & 7);
    const uint32_t s4 = st[j] >> off;
    uint32_t q[4];
    vector_values<BITS>(st + groups, j, off, q);
    float r[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      r[c] = contribution(wt, (s4 >> c) & 1u, q[c], gb[c], lo, step, ok);
    *(float4*)(out + 4 * t) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
    const int i = 4 * n_vec + t - 32 * vec_warps;
    if (i >= n) return;  // past the end: no memory touched
    grid_dependency_wait();
    const uint32_t s = load_streamed(sign_words + (i >> 5));
    uint32_t x[BITS];
    load_planes<BITS>(qidx_words + (size_t)(i >> 5) * BITS, x);
    const float g1 = load_streamed_f32(gbar + i);
    const float lo = load_streamed_f32(gmin);
    const float hi = load_streamed_f32(gmax);
    const float okf = load_streamed_f32(mod_ok);
    const float wt = load_streamed_f32(weight);
    launch_dependents();
    const float step = knob_step(lo, hi, top_knob(BITS));
    out[i] = contribution(wt, (s >> (i & 31)) & 1u,
                          lane_value<BITS>(x, i & 31), g1, lo, step,
                          okf > 0.0f);
  }
}

template <int BITS>
static int launch(const void* sign_words, const void* qidx_words,
                  const void* gbar, const void* gmin, const void* gmax,
                  const void* mod_ok, const void* weight, void* out, int n,
                  cudaStream_t stream) {
  // vectors only where the output and gbar are 16-byte aligned
  const bool aligned = (((uintptr_t)out | (uintptr_t)gbar) & 15) == 0;
  const int n_vec = aligned ? n / 4 : 0;
  const int vec_warps = (n_vec + 31) / 32;
  const long long threads = 32LL * vec_warps + (n - 4LL * n_vec);
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  return launch_pdl(unpack_dequant_kernel<BITS>, blocks, THREADS, stream,
                    (const uint32_t*)sign_words, (const uint32_t*)qidx_words,
                    (const float*)gbar, (const float*)gmin,
                    (const float*)gmax, (const float*)mod_ok,
                    (const float*)weight, (float*)out, n, n_vec, vec_warps);
}

extern "C" int spfl_unpack_dequant(const void* sign_words,
                                   const void* qidx_words, const void* gbar,
                                   const void* gmin, const void* gmax,
                                   const void* mod_ok, const void* weight,
                                   void* out, int n, int bits,
                                   void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define SPFL_UD_CASE(B)                                                   \
  case B:                                                                 \
    return launch<B>(sign_words, qidx_words, gbar, gmin, gmax, mod_ok,    \
                     weight, out, n, s);
  switch (bits) {
    SPFL_UD_CASE(1) SPFL_UD_CASE(2) SPFL_UD_CASE(3) SPFL_UD_CASE(4)
    SPFL_UD_CASE(5) SPFL_UD_CASE(6) SPFL_UD_CASE(7) SPFL_UD_CASE(8)
    SPFL_UD_CASE(9) SPFL_UD_CASE(10) SPFL_UD_CASE(11) SPFL_UD_CASE(12)
    SPFL_UD_CASE(13) SPFL_UD_CASE(14) SPFL_UD_CASE(15) SPFL_UD_CASE(16)
  }
#undef SPFL_UD_CASE
  return (int)cudaErrorInvalidValue;
}
