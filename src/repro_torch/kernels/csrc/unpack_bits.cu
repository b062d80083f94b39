// Bit-plane unpack of payload words back into one flat vector of b-bit
// values, the inverse of pack_bits.cu:
//
//   values[32 * grp + l] = sum_j ((words[grp * bits + j] >> l) & 1) << j
//
// Replaces: src/repro/wire/pack_kernel.py:unpack_bits_kernel (builder
// unpack_2d, body _unpack).
//
// Bound: device-memory bytes (bits / 8 B read and 4 B written per value,
// against a shift, a mask and a bit set per value and plane).  At the
// API's sizes (62,006 values: 0.27 MB at bits 3) the bytes take 0.08 us,
// so a launch costs its set-up, one dependent DRAM round trip, its
// stores and its tail: the design keeps every load of a thread in one
// round trip and overlaps the set-up with the kernel before it.
//
// Design:
// - One C entry dispatches bits 1..32 to unpack_bits_kernel<BITS>, so
//   the planes are straight-line code.
// - One thread a value in blocks of THREADS.  The 32 lanes of a warp
//   belong to one group, so each of the group's BITS word loads is a
//   warp broadcast (4-byte loads take any row start: phase 6's odd
//   clients read rows 8 mod 16); a thread issues all of them before it
//   uses any, and a warp's value stores are 128 B coalesced.  Threads past
//   n exit: the padding of the last group is never written.
// - Timed on an H100 (700 W) against unpack_dequant.cu's warp-staged
//   design (a warp loads its groups' words as one run, stages them in
//   shared memory and stores 4 values a lane by one 16-byte store;
//   kernel_ab.py, one call): this body 7.9% faster a wrapper call at
//   bits 3 (1.50 us against 1.62), 0.13 us faster behind pack_bits, but
//   6% slower on a dependent chain at bits 32 (1.76 us against 1.66),
//   which phase 6 does not run.
// - Programmatic dependent launch (kernel_api_v2.cuh): the kernel waits
//   for the one before it before its first load, and lets the next one
//   be scheduled once its loads are issued.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api_v2.cuh"

constexpr int THREADS = 256;  // threads per block

template <int BITS>
__global__ void __launch_bounds__(THREADS)
    unpack_bits_kernel(const uint32_t* __restrict__ words,
                       uint32_t* __restrict__ values, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;  // past the end: no memory touched
  grid_dependency_wait();
  uint32_t x[BITS];
  load_planes<BITS>(words + (size_t)(i >> 5) * BITS, x);
  launch_dependents();
  values[i] = lane_value<BITS>(x, i & 31);
}

template <int BITS>
static int launch(const void* words, void* values, int n,
                  cudaStream_t stream) {
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  return launch_pdl(unpack_bits_kernel<BITS>, blocks, THREADS, stream,
                    (const uint32_t*)words, (uint32_t*)values, n);
}

extern "C" int spfl_unpack_bits(const void* words, void* values, int n,
                                int bits, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define SPFL_UB_CASE(B) \
  case B:               \
    return launch<B>(words, values, n, s);
  switch (bits) {
    SPFL_UB_CASE(1) SPFL_UB_CASE(2) SPFL_UB_CASE(3) SPFL_UB_CASE(4)
    SPFL_UB_CASE(5) SPFL_UB_CASE(6) SPFL_UB_CASE(7) SPFL_UB_CASE(8)
    SPFL_UB_CASE(9) SPFL_UB_CASE(10) SPFL_UB_CASE(11) SPFL_UB_CASE(12)
    SPFL_UB_CASE(13) SPFL_UB_CASE(14) SPFL_UB_CASE(15) SPFL_UB_CASE(16)
    SPFL_UB_CASE(17) SPFL_UB_CASE(18) SPFL_UB_CASE(19) SPFL_UB_CASE(20)
    SPFL_UB_CASE(21) SPFL_UB_CASE(22) SPFL_UB_CASE(23) SPFL_UB_CASE(24)
    SPFL_UB_CASE(25) SPFL_UB_CASE(26) SPFL_UB_CASE(27) SPFL_UB_CASE(28)
    SPFL_UB_CASE(29) SPFL_UB_CASE(30) SPFL_UB_CASE(31) SPFL_UB_CASE(32)
  }
#undef SPFL_UB_CASE
  return (int)cudaErrorInvalidValue;
}
