// Per-client xor-fold of (K, W) uint32 word buffers: the PS-side CRC
// verify of the bit-level channel.
//
// Replaces: src/repro/wire/pack_kernel.py:fold_words_kernel (builder
// fold_words_2d).
//
// Bound: device-memory bytes (4 K W read, 4 K written; one xor per word).
//
// Design: a thread block cluster of CLUSTER = 8 blocks (the portable
// maximum) per client row, grid CLUSTER x K, so K = 20 rows keep 160
// blocks busy, not 20.  Each block folds a contiguous 1/CLUSTER slice of
// its row: each thread issues up to UNROLL independent 4-byte loads
// (neighbouring threads on neighbouring words) before it folds any, so
// all of its loads are in flight at once; then shuffles fold each warp
// and every warp folds the warp partials from shared memory.  Rows may be
// strided and need not be 16-byte aligned (the framed packets are 1,943
// and 5,822 words long), hence 4-byte loads.  128 threads x 8 loads keeps
// a main-path slice (<= 728 words) to one trip per thread; timed with
// kernel_ab.py against edited copies of this source on an H100 80GB HBM3
// at 700 W (K = 20, W = 5,822) it ran 2-4% faster than 256 x 4 and 6%
// faster than 128 x 4.
//
// The other blocks hand their folds to the cluster's leader through
// distributed shared memory: an asynchronous store into the leader's
// slot that completes its bytes on an mbarrier there, which the leader's
// first warp waits on; then it folds the CLUSTER words and writes the
// row's fold once.  No atomics, no zeroing of the output, no second
// launch, and no cluster-wide barrier at the end (cluster.sync() after a
// plain remote store ran 0.5 us slower on the same card: its release
// compiles to a GPU-wide memory barrier).  The one cluster barrier, which
// makes sure the leader has started and initialised its mbarrier before
// any store reaches it, is split: each thread arrives before its loads
// and waits after them.  Xor is associative and commutative, so any split
// is bit-exact.  Clusters need sm_90; a refused launch is returned to the
// wrapper, which raises.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int CLUSTER = 8;   // blocks per row (portable max 8)
constexpr int THREADS = 128; // threads per block
constexpr int UNROLL = 8;    // loads in flight per thread and trip

__device__ __forceinline__ uint32_t warp_fold(uint32_t f) {
  for (int off = 16; off > 0; off >>= 1)
    f ^= __shfl_xor_sync(0xffffffffu, f, off);
  return f;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
    fold_words_kernel(const uint32_t* __restrict__ words,
                      long long row_stride, int n_words,
                      uint32_t* __restrict__ out) {
  __shared__ uint32_t partial[THREADS / 32];
  __shared__ uint32_t slice_fold[CLUSTER];  // the leader's: one per block
  __shared__ __align__(8) uint64_t landed;  // the leader's: slice folds in
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  if (rank == 0 && threadIdx.x == 0) {
    asm volatile(
        "mbarrier.init.shared::cta.b64 [%0], 1;\n"
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
        "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(&landed)),
        "n"((CLUSTER - 1) * 4)
        : "memory");
  }
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const long long row = blockIdx.x / CLUSTER;
  const uint32_t* src = words + row * row_stride;
  const int per = (n_words + CLUSTER - 1) / CLUSTER;
  const int lo = min(n_words, (int)rank * per);
  const int hi = min(n_words, lo + per);
  uint32_t f = 0u;
  for (int base = lo + threadIdx.x; base < hi; base += UNROLL * THREADS) {
    uint32_t v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      v[u] = i < hi ? src[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) f ^= v[u];
  }
  f = warp_fold(f);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = f;
  __syncthreads();
  f = warp_fold(lane < THREADS / 32 ? partial[lane] : 0u);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  // each other block stores its fold into the leader's slot with an
  // asynchronous store that completes bytes on the leader's barrier
  if (rank != 0) {
    if (threadIdx.x == 0) {
      uint32_t slot, bar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                   : "=r"(slot)
                   : "r"(smem_addr(&slice_fold[rank])));
      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n"
                   : "=r"(bar)
                   : "r"(smem_addr(&landed)));
      asm volatile(
          "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], "
          "%1, [%2];\n" ::"r"(slot),
          "r"(f), "r"(bar)
          : "memory");
    }
    return;
  }
  if (warp == 0) {
    uint32_t done = 0u;
    while (!done)
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_addr(&landed))
          : "memory");
    f = warp_fold(lane == 0 ? f : lane < CLUSTER ? slice_fold[lane] : 0u);
    if (lane == 0) out[row] = f;
  }
}

extern "C" int spfl_fold_words(const void* words, long long row_stride,
                               void* out, int n_clients, int n_words,
                               void* stream) {
  if (n_clients == 0) return 0;
  fold_words_kernel<<<(unsigned)(CLUSTER * (long long)n_clients), THREADS,
                      0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, row_stride, n_words, (uint32_t*)out);
  return (int)cudaGetLastError();
}
