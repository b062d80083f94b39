// Fused client-side pass of the packed wire: eq. (7)-(8) stochastic
// rounding + sign bit + bit-plane pack, for all K clients in one launch.
//
// Replaces: src/repro/wire/pack_kernel.py:quantize_pack_kernel (builder
// quantize_pack_2d), whose arithmetic is quantize_body in
// src/repro/kernels/quantize_kernel.py.
//
// Bound: device-memory bytes.  Each coordinate reads 8 B (g, rand) and
// the packet words add (1 + bits) / 8 B; there are ~20 flops per
// coordinate, far below the card's float rate.
//
// Design: one warp per 32-coordinate group, one thread per lane, so the
// g and rand loads are 128 B coalesced per warp and the pack is a
// register-level __ballot_sync per bit plane (the sign word and each of
// the `bits` knob words) with no shared memory and no atomics.  Lanes past
// n (the ragged tail of the last group) quantize g = 0, rand = 0 like the
// TPU kernel's zero padding (knob 0) and vote 0 into the sign word, which
// is what the reference's _mask_tail produces.  The arithmetic follows
// quantize_body op for op with explicitly rounded intrinsics, so nvcc
// cannot contract or reassociate it and the knob indices are bit-exact.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void quantize_pack_kernel(const float* __restrict__ g,
                                     const float* __restrict__ rand,
                                     const float* __restrict__ gmin,
                                     const float* __restrict__ gmax,
                                     uint32_t* __restrict__ sign_words,
                                     uint32_t* __restrict__ qidx_words,
                                     int n_clients, int n, int n_groups,
                                     int bits) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  // the condition is uniform across the warp, so the ballots below
  // always see all 32 lanes
  if (warp >= (long long)n_clients * n_groups) return;
  const int k = (int)(warp / n_groups);
  const int grp = (int)(warp - (long long)k * n_groups);
  const int col = grp * 32 + lane;
  const bool valid = col < n;
  const long long idx = (long long)k * n + col;
  const float x = valid ? g[idx] : 0.0f;
  const float r = valid ? rand[idx] : 0.0f;

  const float lo = gmin[k];
  const float nk = (float)((1u << bits) - 1u);
  const float step = __fdiv_rn(__fsub_rn(gmax[k], lo), nk);
  const float safe = step > 0.0f ? step : 1.0f;
  const float u = step > 0.0f ? __fdiv_rn(__fsub_rn(fabsf(x), lo), safe)
                              : 0.0f;
  const float lower = fminf(fmaxf(floorf(u), 0.0f), nk);
  const float frac = __fsub_rn(u, lower);
  const float up = r < frac ? 1.0f : 0.0f;
  const uint32_t q =
      (uint32_t)fminf(fmaxf(__fadd_rn(lower, up), 0.0f), nk);

  const long long row = (long long)k * n_groups + grp;
  const uint32_t sign = __ballot_sync(0xffffffffu, valid && x >= 0.0f);
  if (lane == 0) sign_words[row] = sign;
  uint32_t mine = 0;
  for (int j = 0; j < bits; ++j) {
    const uint32_t plane = __ballot_sync(0xffffffffu, (q >> j) & 1u);
    if (lane == j) mine = plane;
  }
  if (lane < bits) qidx_words[row * bits + lane] = mine;
}

extern "C" int spfl_quantize_pack(const void* g, const void* rand,
                                  const void* gmin, const void* gmax,
                                  void* sign_words, void* qidx_words,
                                  int n_clients, int n, int bits,
                                  void* stream) {
  const int n_groups = (n + 31) / 32;
  const long long warps = (long long)n_clients * n_groups;
  if (warps == 0) return 0;
  const int threads = 256;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  quantize_pack_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)g, (const float*)rand, (const float*)gmin,
      (const float*)gmax, (uint32_t*)sign_words, (uint32_t*)qidx_words,
      n_clients, n, n_groups, bits);
  return (int)cudaGetLastError();
}
