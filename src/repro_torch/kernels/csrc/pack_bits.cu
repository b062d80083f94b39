// Bit-plane pack of one flat vector of b-bit values into payload words
// (the canonical wire layout of wire/format.py):
//
//   words[grp * bits + j] = sum_l bit_j(values[32 * grp + l]) << l
//
// Bits of a value at and above `bits` are dropped, as in the reference.
//
// Replaces: src/repro/wire/pack_kernel.py:pack_bits_kernel (builder
// pack_2d, body _pack).
//
// Bound: device-memory bytes (4 B read and bits / 8 B written per value,
// against a shift, a mask and an or per value and plane).  At the API's
// sizes (62,006 values: 0.27 MB at bits 3) the bytes take 0.08 us, so a
// launch costs its set-up, one dependent DRAM round trip, its stores and
// its tail: the design keeps every load of a warp in one round trip and
// overlaps the set-up with the kernel before it.
//
// Design:
// - One C entry dispatches bits 1..32 to pack_bits_kernel<BITS>, so each
//   group's BITS plane ballots are straight-line code.
// - Each warp owns GPW consecutive 32-value groups, one value per lane
//   and group, and issues all GPW of its 4-byte loads (coalesced, 128 B
//   per warp and load; L1 skipped, the 256 B around a miss fetched into
//   L2) before its first ballot.  4-byte loads take any row start: a row
//   of a (K, n) tensor need not be 16-byte aligned.
// - A ballot's word is the same in every lane: the warp writes it once
//   to shared memory.  Its GPW * BITS words are contiguous in the
//   output (words[grp * BITS + j]), so its lanes then store them as one
//   coalesced run.
// - Blocks of THREADS threads: one wave on the 132 SMs at the API's
//   sizes.  Warps past the last group exit at once.  Timed on an H100
//   against edited copies of this source (kernel_ab.py), 256-thread
//   blocks and 8 groups per warp ran 2-5% slower at bits 3 (8 groups 27%
//   at bits 1), 2 groups within 2%, and a store loop in place of the
//   unrolled store trips 3% slower (12% on a dependent chain).
// - Programmatic dependent launch (kernel_api_v2.cuh): the kernel waits
//   for the one before it before its first load, and lets the next one
//   be scheduled once its loads are issued.
// - Lanes past n (the ragged tail of the last group) vote 0, which is the
//   reference's zero padding.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api_v2.cuh"

constexpr int THREADS = 128;  // threads per block
constexpr int GPW = 4;        // 32-value groups per warp

template <int BITS>
__global__ void __launch_bounds__(THREADS)
    pack_bits_kernel(const uint32_t* __restrict__ values,
                     uint32_t* __restrict__ words, int n, int n_groups) {
  __shared__ uint32_t staged[THREADS / 32][GPW * BITS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp0 = (blockIdx.x * (THREADS / 32) + warp) * GPW;
  // uniform across the warp, so the ballots below see all 32 lanes
  if (grp0 >= n_groups) return;
  grid_dependency_wait();
  uint32_t v[GPW];
#pragma unroll
  for (int j = 0; j < GPW; ++j) {
    const int col = (grp0 + j) * 32 + lane;
    v[j] = col < n ? load_streamed(values + col) : 0u;
  }
  launch_dependents();
  uint32_t* st = staged[warp];
#pragma unroll
  for (int j = 0; j < GPW; ++j)
#pragma unroll
    for (int b = 0; b < BITS; ++b)
      st[j * BITS + b] = __ballot_sync(0xffffffffu, (v[j] >> b) & 1u);
  __syncwarp();
  // the warp's words, up to the last group's, as one run: a fixed
  // number of unrolled trips, each lane one word per trip
  const int live = min(GPW, n_groups - grp0) * BITS;
  uint32_t* out = words + (size_t)grp0 * BITS;
#pragma unroll
  for (int k = 0; k < (GPW * BITS + 31) / 32; ++k) {
    const int i = lane + 32 * k;
    if (i < live) out[i] = st[i];
  }
}

template <int BITS>
static int launch(const void* values, void* words, int n, int n_groups,
                  cudaStream_t stream) {
  constexpr int per_block = THREADS / 32 * GPW;
  const unsigned blocks = (unsigned)((n_groups + per_block - 1) / per_block);
  return launch_pdl(pack_bits_kernel<BITS>, blocks, THREADS, stream,
                    (const uint32_t*)values, (uint32_t*)words, n, n_groups);
}

extern "C" int spfl_pack_bits(const void* values, void* words, int n,
                              int bits, void* stream) {
  const int n_groups = (n + 31) / 32;
  if (n_groups == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define SPFL_PB_CASE(B) \
  case B:               \
    return launch<B>(values, words, n, n_groups, s);
  switch (bits) {
    SPFL_PB_CASE(1) SPFL_PB_CASE(2) SPFL_PB_CASE(3) SPFL_PB_CASE(4)
    SPFL_PB_CASE(5) SPFL_PB_CASE(6) SPFL_PB_CASE(7) SPFL_PB_CASE(8)
    SPFL_PB_CASE(9) SPFL_PB_CASE(10) SPFL_PB_CASE(11) SPFL_PB_CASE(12)
    SPFL_PB_CASE(13) SPFL_PB_CASE(14) SPFL_PB_CASE(15) SPFL_PB_CASE(16)
    SPFL_PB_CASE(17) SPFL_PB_CASE(18) SPFL_PB_CASE(19) SPFL_PB_CASE(20)
    SPFL_PB_CASE(21) SPFL_PB_CASE(22) SPFL_PB_CASE(23) SPFL_PB_CASE(24)
    SPFL_PB_CASE(25) SPFL_PB_CASE(26) SPFL_PB_CASE(27) SPFL_PB_CASE(28)
    SPFL_PB_CASE(29) SPFL_PB_CASE(30) SPFL_PB_CASE(31) SPFL_PB_CASE(32)
  }
#undef SPFL_PB_CASE
  return (int)cudaErrorInvalidValue;
}
