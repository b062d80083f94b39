// Fused client-side pass of the packed wire: eq. (7)-(8) stochastic
// rounding + sign bit + bit-plane pack, for all K clients in one launch.
//
// Replaces: src/repro/wire/pack_kernel.py:quantize_pack_kernel (builder
// quantize_pack_2d), whose arithmetic is quantize_body in
// src/repro/kernels/quantize_kernel.py.
//
// Bound: device-memory bytes.  Each coordinate reads 8 B (g, rand) and
// the packet words add (1 + bits) / 8 B; the function needs ~20
// operations per coordinate, far below what the card can issue in the
// time the bytes take.  So the kernel must issue little and keep many
// loads in flight.
//
// Design:
// - Grid (group chunks, K): blockIdx.y is the client, so no division
//   finds the work; lo, step and the safe divisor are computed once per
//   thread for its GPW groups.
// - Each warp owns GPW consecutive 32-coordinate groups of one client and
//   issues all 2 * GPW of its 4-byte loads of g and rand (coalesced, 128 B
//   per warp and load) before any arithmetic.  The loads skip L1 and ask
//   L2 for the 256 B around each miss.  Rows are n * 4 B apart (248,024 B
//   at the main width, not a multiple of 16), so 2-D TMA over (K, n) does
//   not apply and 16-byte vector loads would be misaligned on most rows:
//   plain loads.  Timed on an H100 against edited copies of this source
//   (kernel_ab.py), 4 groups per warp and 128-thread blocks ran 10%
//   faster than 8 and 256, 2 or 1 groups per warp slower, and the 256 B
//   L2 fetch a further 4-5% faster cold (7-8% slower warm).
// - Every coordinate's quotient comes first, then the ballots, so the
//   divisions' rare slow paths rejoin before the first ballot.  The
//   per-coordinate quotient stays the IEEE quotient __fdiv_rn, as does the
//   knob step, and every float op is an explicitly rounded intrinsic in
//   quantize_body's order, so nvcc cannot contract or reassociate it and
//   the knob indices are bit-exact.
// - The pack is templated on the knob width (1..16), so each group's sign
//   ballot and `bits` plane ballots are straight-line code.  A ballot's
//   word is the same in every lane, so the warp writes it once to shared
//   memory; the warp's GPW sign words and GPW * bits knob words are
//   contiguous in their rows, and its lanes then store them coalesced (no
//   per-lane select).
// - Lanes past n (the ragged tail of the last group) quantize g = 0,
//   rand = 0 like the TPU kernel's zero padding (knob 0) and vote 0 into
//   the sign word, which is what the reference's _mask_tail produces.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int THREADS = 128;  // threads per block
constexpr int GPW = 4;        // 32-coordinate groups per warp

// A read-once load: not kept in L1, and a miss fetches the 256 B around
// it into L2, so a warp's 128 B loads of a row share DRAM bursts.
__device__ __forceinline__ float load_streamed(const float* p) {
  float v;
  asm("ld.global.nc.L1::no_allocate.L2::256B.f32 %0, [%1];"
      : "=f"(v)
      : "l"(p));
  return v;
}

template <int BITS>
__global__ void __launch_bounds__(THREADS)
    quantize_pack_kernel(const float* __restrict__ g,
                         const float* __restrict__ rand,
                         const float* __restrict__ gmin,
                         const float* __restrict__ gmax,
                         uint32_t* __restrict__ sign_words,
                         uint32_t* __restrict__ qidx_words, int n,
                         int n_groups) {
  // each warp's sign words, then its knob words, as they are stored
  __shared__ uint32_t staged[THREADS / 32][GPW * (1 + BITS)];
  const int k = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp0 = (blockIdx.x * (THREADS / 32) + warp) * GPW;
  // uniform across the warp, so the ballots below see all 32 lanes
  if (grp0 >= n_groups) return;
  const float* gk = g + (size_t)k * n;
  const float* rk = rand + (size_t)k * n;
  float x[GPW], r[GPW];
#pragma unroll
  for (int j = 0; j < GPW; ++j) {
    const int col = (grp0 + j) * 32 + lane;
    x[j] = col < n ? load_streamed(gk + col) : 0.0f;
    r[j] = col < n ? load_streamed(rk + col) : 0.0f;
  }
  constexpr float NK = (float)((1u << BITS) - 1u);
  const float lo = gmin[k];
  const float step = __fdiv_rn(__fsub_rn(gmax[k], lo), NK);
  const bool live = step > 0.0f;
  const float safe = live ? step : 1.0f;
  // every quotient first, so the divisions' rare slow paths rejoin
  // before the first ballot
  uint32_t q[GPW];
  uint32_t positive = 0u;
#pragma unroll
  for (int j = 0; j < GPW; ++j) {
    const float u =
        live ? __fdiv_rn(__fsub_rn(fabsf(x[j]), lo), safe) : 0.0f;
    const float lower = fminf(fmaxf(floorf(u), 0.0f), NK);
    const float frac = __fsub_rn(u, lower);
    const float up = r[j] < frac ? 1.0f : 0.0f;
    q[j] = (uint32_t)fminf(fmaxf(__fadd_rn(lower, up), 0.0f), NK);
    positive |= (uint32_t)((grp0 + j) * 32 + lane < n && x[j] >= 0.0f) << j;
  }
  uint32_t* st = staged[warp];
#pragma unroll
  for (int j = 0; j < GPW; ++j) {
    st[j] = __ballot_sync(0xffffffffu, positive & (1u << j));
#pragma unroll
    for (int b = 0; b < BITS; ++b)
      st[GPW + j * BITS + b] = __ballot_sync(0xffffffffu, q[j] & (1u << b));
  }
  __syncwarp();
  // the warp's GPW sign words and GPW * BITS knob words are contiguous in
  // their rows: store them coalesced, up to the row's last group
  const int live_groups = min(GPW, n_groups - grp0);
  uint32_t* sw = sign_words + (size_t)k * n_groups + grp0;
  uint32_t* qw = qidx_words + ((size_t)k * n_groups + grp0) * BITS;
  for (int i = lane; i < live_groups * (1 + BITS); i += 32) {
    if (i < live_groups)
      sw[i] = st[i];
    else
      qw[i - live_groups] = st[GPW + i - live_groups];
  }
}

template <int BITS>
static int launch(const void* g, const void* rand, const void* gmin,
                  const void* gmax, void* sign_words, void* qidx_words,
                  int n_clients, int n, int n_groups, cudaStream_t stream) {
  constexpr int per_block = THREADS / 32 * GPW;
  const dim3 grid((n_groups + per_block - 1) / per_block, n_clients);
  quantize_pack_kernel<BITS><<<grid, THREADS, 0, stream>>>(
      (const float*)g, (const float*)rand, (const float*)gmin,
      (const float*)gmax, (uint32_t*)sign_words, (uint32_t*)qidx_words, n,
      n_groups);
  return (int)cudaGetLastError();
}

extern "C" int spfl_quantize_pack(const void* g, const void* rand,
                                  const void* gmin, const void* gmax,
                                  void* sign_words, void* qidx_words,
                                  int n_clients, int n, int bits,
                                  void* stream) {
  const int n_groups = (n + 31) / 32;
  if (n_clients == 0 || n_groups == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
#define SPFL_QP_CASE(B)                                                   \
  case B:                                                                 \
    return launch<B>(g, rand, gmin, gmax, sign_words, qidx_words,         \
                     n_clients, n, n_groups, s);
  switch (bits) {
    SPFL_QP_CASE(1) SPFL_QP_CASE(2) SPFL_QP_CASE(3) SPFL_QP_CASE(4)
    SPFL_QP_CASE(5) SPFL_QP_CASE(6) SPFL_QP_CASE(7) SPFL_QP_CASE(8)
    SPFL_QP_CASE(9) SPFL_QP_CASE(10) SPFL_QP_CASE(11) SPFL_QP_CASE(12)
    SPFL_QP_CASE(13) SPFL_QP_CASE(14) SPFL_QP_CASE(15) SPFL_QP_CASE(16)
  }
#undef SPFL_QP_CASE
  return (int)cudaErrorInvalidValue;
}
