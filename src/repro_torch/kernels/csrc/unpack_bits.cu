// Bit-plane unpack of payload words back into one flat vector of b-bit
// values, the inverse of pack_bits.cu:
//
//   values[32 * grp + l] = sum_j ((words[grp * bits + j] >> l) & 1) << j
//
// Replaces: src/repro/wire/pack_kernel.py:unpack_bits_kernel (builder
// unpack_2d, body _unpack).
//
// Bound: device-memory bytes (bits / 8 B read and 4 B written per value,
// against a shift, a mask and an or per value and plane).
//
// Design: one thread per value.  The 32 lanes of a warp belong to one
// group, so each of the group's `bits` word loads is a warp broadcast
// and the value stores are 128 B coalesced per warp.  Threads past n
// exit; the padding of the last group is never written.
#include <cstdint>
#include <cuda_runtime.h>

#include "kernel_api.cuh"

__global__ void unpack_bits_kernel(const uint32_t* __restrict__ words,
                                   uint32_t* __restrict__ values, int n,
                                   int bits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  values[i] = unpack_value(words + (i >> 5) * bits, (int)(i & 31), bits);
}

extern "C" int spfl_unpack_bits(const void* words, void* values, int n,
                                int bits, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = ((long long)n + threads - 1) / threads;
  unpack_bits_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint32_t*)values, n, bits);
  return (int)cudaGetLastError();
}
