// The bit channel: counter-PRF bit flips of (K, W) framed word buffers,
// with the flip mask's per-client xor-fold and popcount.
//
// Replaces: src/repro/wire/pack_kernel.py:corrupt_fold_kernel (builder
// corrupt_fold_2d); the PRF is hash_bits in src/repro/wire/corrupt.py.
//
// Bound: integer operations.  Each word draws 32 bits: one fmix32 of the
// word counter shared by all 32 planes, then per plane an xor, one fmix32
// (8 ops), a compare and the or into the mask — about 400 int32 ops per
// word against 8 B of traffic.
//
// Design: one thread per word, grid (column blocks, K).  The 32 planes are
// unrolled; the plane-independent first mix is hoisted out of the loop
// (the TPU kernel recomputes it per plane).  Columns >= n_words never
// flip, and the counter is k * n_words + col + word0 in uint32, as in the
// reference.  The per-client fold and flip count are reduced across the
// warp with shuffles and then combined with one atomicXor / atomicAdd per
// warp into the zeroed (K,) outputs: integer xor and add are order-free,
// so the atomics are exact and the result is deterministic.
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__global__ void corrupt_fold_kernel(const uint32_t* __restrict__ words,
                                    uint32_t* __restrict__ rx,
                                    const uint32_t* __restrict__ thresh,
                                    const int32_t* __restrict__ allflip,
                                    uint32_t* __restrict__ fold,
                                    int32_t* __restrict__ flips,
                                    int n_words, uint32_t seed0,
                                    uint32_t seed1, uint32_t word0) {
  const int k = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t mask = 0u;
  if (col < n_words) {
    const uint32_t base =
        (uint32_t)k * (uint32_t)n_words + (uint32_t)col + word0;
    const uint32_t h0 = fmix32((base + 0x9E3779B9u) ^ seed0) ^ seed1;
    const uint32_t t = thresh[k];
#pragma unroll
    for (int b = 0; b < 32; ++b) {
      const uint32_t h = fmix32(h0 ^ ((uint32_t)b * 0x9E3779B1u));
      mask |= (uint32_t)(h < t) << b;
    }
    if (allflip[k]) mask = 0xFFFFFFFFu;
    const long long i = (long long)k * n_words + col;
    rx[i] = words[i] ^ mask;
  }
  uint32_t f = mask;
  int cnt = __popc(mask);
  for (int off = 16; off > 0; off >>= 1) {
    f ^= __shfl_xor_sync(0xffffffffu, f, off);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if ((threadIdx.x & 31) == 0 && (f != 0u || cnt != 0)) {
    atomicXor(fold + k, f);
    atomicAdd(flips + k, cnt);
  }
}

extern "C" int spfl_corrupt_fold(const void* words, void* rx,
                                 const void* thresh, const void* allflip,
                                 void* fold, void* flips, int n_clients,
                                 int n_words, uint32_t seed0, uint32_t seed1,
                                 uint32_t word0, void* stream) {
  if (n_clients == 0 || n_words == 0) return 0;
  const int threads = 256;
  const dim3 grid((n_words + threads - 1) / threads, n_clients);
  corrupt_fold_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint32_t*)rx, (const uint32_t*)thresh,
      (const int32_t*)allflip, (uint32_t*)fold, (int32_t*)flips, n_words,
      seed0, seed1, word0);
  return (int)cudaGetLastError();
}
