// Per-client xor-fold of (K, W) uint32 word buffers: the PS-side CRC
// verify of the bit-level channel.
//
// Replaces: src/repro/wire/pack_kernel.py:fold_words_kernel (builder
// fold_words_2d).
//
// Bound: device-memory bytes (4 K W read, 4 K written; one xor per word).
//
// Design: one block per client row.  Threads stride over the row with
// neighbouring threads on neighbouring words (coalesced), fold in a
// register, reduce across the warp with shuffles and across the block's
// warps through 32 words of shared memory; thread 0 writes the row's
// fold once, so the output needs no zeroing and no atomics.  Rows may be
// strided.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void fold_words_kernel(const uint32_t* __restrict__ words,
                                  long long row_stride, int n_words,
                                  uint32_t* __restrict__ out) {
  __shared__ uint32_t partial[32];
  const uint32_t* row = words + blockIdx.x * row_stride;
  uint32_t f = 0u;
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) f ^= row[i];
  for (int off = 16; off > 0; off >>= 1)
    f ^= __shfl_xor_sync(0xffffffffu, f, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = f;
  __syncthreads();
  if (warp == 0) {
    f = lane < (int)(blockDim.x >> 5) ? partial[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      f ^= __shfl_xor_sync(0xffffffffu, f, off);
    if (lane == 0) out[blockIdx.x] = f;
  }
}

extern "C" int spfl_fold_words(const void* words, long long row_stride,
                               void* out, int n_clients, int n_words,
                               void* stream) {
  if (n_clients == 0) return 0;
  fold_words_kernel<<<n_clients, 512, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, row_stride, n_words, (uint32_t*)out);
  return (int)cudaGetLastError();
}
