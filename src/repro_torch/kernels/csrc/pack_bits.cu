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
// against a shift, a mask and an or per value and plane).
//
// Design: one warp per 32-value group, one lane per value, so the loads
// are 128 B coalesced per warp and each bit plane is one __ballot_sync,
// as in quantize_pack.cu.  Lane j keeps plane j and the first `bits` lanes
// store the group's words.  Lanes past n (the ragged tail of the last
// group) vote 0, which is the reference's zero padding.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void pack_bits_kernel(const uint32_t* __restrict__ values,
                                 uint32_t* __restrict__ words, int n,
                                 int n_groups, int bits) {
  const int lane = threadIdx.x & 31;
  const long long grp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // uniform across the warp, so every ballot sees all 32 lanes
  if (grp >= n_groups) return;
  const long long col = grp * 32 + lane;
  const uint32_t v = col < n ? values[col] : 0u;
  uint32_t mine = 0u;
#pragma unroll 1
  for (int j = 0; j < bits; ++j) {
    const uint32_t plane = __ballot_sync(0xffffffffu, (v >> j) & 1u);
    if (lane == j) mine = plane;
  }
  if (lane < bits) words[grp * bits + lane] = mine;
}

extern "C" int spfl_pack_bits(const void* values, void* words, int n,
                              int bits, void* stream) {
  const int n_groups = (n + 31) / 32;
  if (n_groups == 0) return 0;
  const int threads = 256;
  const long long blocks = ((long long)n_groups * 32 + threads - 1) / threads;
  pack_bits_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)values, (uint32_t*)words, n, n_groups, bits);
  return (int)cudaGetLastError();
}
