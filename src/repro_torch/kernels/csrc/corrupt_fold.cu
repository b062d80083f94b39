// The bit channel: counter-PRF bit flips of (K, W) framed word buffers,
// with the flip mask's per-client xor-fold and popcount.
//
// Replaces: src/repro/wire/pack_kernel.py:corrupt_fold_kernel (builder
// corrupt_fold_2d); the PRF is hash_bits in src/repro/wire/corrupt.py.
//
// Bound: integer operations, ~300 per word against 8 B of traffic.  Each
// word draws 32 bits, each the murmur3 fmix32 of (h0 ^ c_b): h0 mixes the
// word counter once per word, c_b = b * 0x9E3779B1 salts plane b.  With
// shifts and bit sets split between the ALU and IMAD pipes they fill the
// issue slots.
//
// Design:
// - Plane-independent work once per word.  Since >> and ^ distribute
//   over ^, fmix32's first xor-shift of h0 ^ c_b is
//   (h0 ^ h0 >> 16) ^ (c_b ^ c_b >> 16): A = h0 ^ h0 >> 16 is hoisted and
//   the second half is a compile-time constant, so a plane starts with
//   one xor instead of three operations (32 planes unrolled).
// - Work spread evenly over the SMs, few blocks: a row of W words is
//   cut into B = min(MAX_BLOCKS, ceil(W / THREADS)) slices of equal
//   length, one block each, grid (B, K); a thread mixes one word of its
//   slice per trip, its load issued before its mix.  At the main shapes
//   the modulus packets (K = 20, W = 5,822) make 31 blocks of 192
//   threads per row: 620 blocks, 4 or 5 on each of the 132 SMs (the
//   busiest does 6% more than the mean; 256-thread blocks put 3 or 4 on
//   an SM, 15%).  Timed on an H100 against edited copies of this source
//   (kernel_ab.py), 96-, 128- and 256-thread blocks, each plane's last
//   shift as __umulhi and the compare-and-or bit set all ran within 5% of
//   this form, and computing all 32 plane hashes before the first compare
//   made no difference; 64-thread blocks of one word per thread (1,820
//   blocks) ran 8-10% slower, and both shifts of each plane as __umulhi
//   6-10%.  In-kernel, a launch without the plane mix takes three
//   quarters of the time (loads, stores, block launch, the reduction);
//   the mix adds what the loads' latency does not hide (8 planes hide
//   whole), and the block reduction and accumulators about a tenth.
// - Outputs written whole, no zero-fill, no fence: each block folds and
//   counts its slice (warp shuffles, then its warps through shared
//   memory) and adds both into its row's two 64-bit accumulators with
//   one atomic each: atomicXor of (fold << 32 | 1 << block) and atomicAdd
//   of (count << 32 | 1).  Each atomic returns the accumulator before it,
//   so the block whose xor completes the row's bitmap of B blocks holds
//   the row's fold, and the block whose add brings the ticket to B holds
//   its count: each writes its output and zeroes its accumulator for the
//   next launch (MAX_BLOCKS = 32 is the bitmap's width).  No block reads
//   another's memory, so no fence orders anything.  Xor and add are
//   order-free, so the result is deterministic.  A row of one block
//   writes its outputs directly.  Launches on one stream run in order, so
//   the wrapper keeps one set of accumulators per device and stream.
//
// The PRF is the reference's: the counter is k * n_words + col + word0
// in uint32 (wrapping), columns >= n_words never flip (no thread covers
// them), and an all-flip row is 0xFFFFFFFF.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int THREADS = 192;    // threads per block
constexpr int MAX_BLOCKS = 32;  // blocks per row: the accumulator bitmap

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// plane b's salt after fmix32's first xor-shift: c ^ c >> 16
__host__ __device__ constexpr uint32_t plane_const(int b) {
  return ((uint32_t)b * 0x9E3779B1u) ^ (((uint32_t)b * 0x9E3779B1u) >> 16);
}

// The flip mask of the word with counter `ctr` at threshold `t`.  For
// t > 0 the carry of h + (2^32 - t) is 1 exactly when h >= t; planes from
// 31 down shift it into `keep` with an add-with-carry (keep = 2 * keep +
// carry, an IMAD.X off the ALU), and the mask is ~keep.  t = 0 flips
// nothing.
__device__ __forceinline__ uint32_t flip_mask(uint32_t ctr, uint32_t t,
                                              uint32_t seed0,
                                              uint32_t seed1) {
  const uint32_t h0 = fmix32((ctr + 0x9E3779B9u) ^ seed0) ^ seed1;
  const uint32_t a = h0 ^ (h0 >> 16);
  const uint32_t neg_t = 0u - t;
  uint32_t keep = 0u;
#pragma unroll
  for (int b = 31; b >= 0; --b) {
    uint32_t x = a ^ plane_const(b);
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    asm("{\n.reg .u32 s;\nadd.cc.u32 s, %1, %2;\nmadc.lo.u32 %0, %0, 2, 0;\n}"
        : "+r"(keep)
        : "r"(x), "r"(neg_t));
  }
  return t ? ~keep : 0u;
}

// A load whose value nvcc does not reason about.
__device__ __forceinline__ uint32_t load_in_loop(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void warp_reduce(uint32_t& f, uint32_t& c) {
  for (int off = 16; off > 0; off >>= 1) {
    f ^= __shfl_xor_sync(0xffffffffu, f, off);
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
}

__global__ void __launch_bounds__(THREADS)
    corrupt_fold_kernel(const uint32_t* __restrict__ words,
                        uint32_t* __restrict__ rx,
                        const uint32_t* __restrict__ thresh,
                        const int32_t* __restrict__ allflip,
                        unsigned long long* __restrict__ acc,
                        uint32_t* __restrict__ fold,
                        int32_t* __restrict__ flips, int n_words,
                        int per_block, uint32_t seed0, uint32_t seed1,
                        uint32_t word0) {
  __shared__ uint2 warp_part[THREADS / 32];
  const int k = blockIdx.y;
  const int blocks = gridDim.x;
  const int lo = min(n_words, (int)blockIdx.x * per_block);
  const int hi = min(n_words, lo + per_block);
  const size_t row = (size_t)k * n_words;
  const uint32_t ctr0 = (uint32_t)k * (uint32_t)n_words + word0;
  uint32_t f = 0u, cnt = 0u;
  for (int col = lo + (int)threadIdx.x; col < hi; col += THREADS) {
    const uint32_t w = words[row + col];
    // read so that nvcc does not unswitch the loop on them (a separate
    // loop per all-flip and t = 0 case, entered only once both loads are
    // back): the flag and t = 0 become selects after the mix, which ran
    // 4% faster on an H100
    const uint32_t t = load_in_loop(thresh + k);
    const uint32_t all = load_in_loop((const uint32_t*)allflip + k);
    uint32_t mask = flip_mask(ctr0 + (uint32_t)col, t, seed0, seed1);
    if (all) mask = 0xFFFFFFFFu;
    rx[row + col] = w ^ mask;
    f ^= mask;
    cnt += __popc(mask);
  }
  warp_reduce(f, cnt);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_part[warp] = make_uint2(f, cnt);
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int j = 1; j < THREADS / 32; ++j) {
    f ^= warp_part[j].x;
    cnt += warp_part[j].y;
  }
  if (blocks == 1) {
    fold[k] = f;
    flips[k] = (int32_t)cnt;
    return;
  }
  unsigned long long* xa = acc + 2 * k;   // fold << 32 | block bitmap
  unsigned long long* ca = xa + 1;        // count << 32 | blocks in
  const unsigned long long all_in =
      blocks == 32 ? 0xFFFFFFFFull : (1ull << blocks) - 1ull;
  const unsigned long long xo = atomicXor(
      xa, (unsigned long long)f << 32 | 1ull << blockIdx.x);
  const unsigned long long co =
      atomicAdd(ca, (unsigned long long)cnt << 32 | 1ull);
  if (((xo & 0xFFFFFFFFull) | 1ull << blockIdx.x) == all_in) {
    fold[k] = (uint32_t)(xo >> 32) ^ f;
    *xa = 0ull;
  }
  if ((co & 0xFFFFFFFFull) == (unsigned long long)(blocks - 1)) {
    flips[k] = (int32_t)((uint32_t)(co >> 32) + cnt);
    *ca = 0ull;
  }
}

extern "C" int spfl_corrupt_fold(const void* words, void* rx,
                                 const void* thresh, const void* allflip,
                                 void* acc, void* fold, void* flips,
                                 int n_clients, int n_words, uint32_t seed0,
                                 uint32_t seed1, uint32_t word0,
                                 void* stream) {
  if (n_clients == 0) return 0;
  const int blocks =
      max(1, min(MAX_BLOCKS, (n_words + THREADS - 1) / THREADS));
  const int per_block = (n_words + blocks - 1) / blocks;
  corrupt_fold_kernel<<<dim3(blocks, n_clients), THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint32_t*)rx, (const uint32_t*)thresh,
      (const int32_t*)allflip, (unsigned long long*)acc, (uint32_t*)fold,
      (int32_t*)flips, n_words, per_block, seed0, seed1, word0);
  return (int)cudaGetLastError();
}
