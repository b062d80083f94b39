// Decode-once PS aggregation, eq. (15)-(17): for every coordinate c,
//
//   acc[c] = sum_{k=0..K-1} w_k * s_k[c] * (mod_ok_k ? gmin_k + q_k[c] * step_k
//                                                    : gbar[c])
//
// straight from the packed sign and knob payload words, plus the per-
// coordinate count of +1 sign votes among clients whose sign packet was
// accepted (K <= 32 only).
//
// Replaces: src/repro/wire/pack_kernel.py:spfl_accumulate_kernel (builder
// spfl_accumulate_2d, decode body _dequant_contrib).
//
// Bound: device-memory bytes: 4 K G (1 + bits) bytes of payload words
// plus gbar, the f32 sum and the votes.  Per coordinate and client the
// work is a handful of integer and float operations.
//
// Design: one thread per coordinate with the client loop inside the
// thread.  The TPU kernel sums clients over a sequential grid axis; here
// the order k = 0..K-1 stays in one thread, so the f32 sum needs no
// atomics and is accumulated in the reference order (the order is part of
// the contract: transport._seq_client_sum).  The 32 lanes of a warp share
// one group's sign and knob words, so each word load is a warp broadcast.
// Every float operation is an explicitly rounded intrinsic: nvcc cannot
// contract gmin + q * step or acc + w * (s * m) into FMAs, and the kernel
// equals its plain PyTorch version bit for bit.  The knob step arrives
// precomputed by the wrapper (the division stays IEEE, as in the
// reference's host-side knob_step).  Payload rows may be strided (the
// payload region of framed packets), so no copy is needed.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void spfl_accumulate_kernel(
    const uint32_t* __restrict__ sign_words, long long sign_stride,
    const uint32_t* __restrict__ qidx_words, long long qidx_stride,
    const float* __restrict__ gbar, long long gbar_stride,
    const float* __restrict__ gmin, const float* __restrict__ step,
    const float* __restrict__ mod_ok, const float* __restrict__ weight,
    const int32_t* __restrict__ vote_gate, float* __restrict__ out,
    int32_t* __restrict__ votes, int n_clients, int n, int bits) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const long long grp = c >> 5;
  const int lane = (int)(c & 31);
  float acc = 0.0f;
  uint32_t vote_word = 0u;
  for (int k = 0; k < n_clients; ++k) {
    const uint32_t sbit = (sign_words[k * sign_stride + grp] >> lane) & 1u;
    const uint32_t* qw = qidx_words + k * qidx_stride + grp * bits;
    uint32_t q = 0u;
    for (int j = 0; j < bits; ++j) q |= ((qw[j] >> lane) & 1u) << j;
    float modulus = __fadd_rn(gmin[k], __fmul_rn((float)q, step[k]));
    if (!(mod_ok[k] > 0.0f)) modulus = gbar[k * gbar_stride + c];
    const float s = sbit ? 1.0f : -1.0f;
    const float contrib = __fmul_rn(weight[k], __fmul_rn(s, modulus));
    acc = k == 0 ? contrib : __fadd_rn(acc, contrib);
    if (votes) vote_word |= (sbit * (uint32_t)vote_gate[k]) << k;
  }
  out[c] = acc;
  if (votes) votes[c] = __popc(vote_word);
}

extern "C" int spfl_accumulate(const void* sign_words, long long sign_stride,
                               const void* qidx_words, long long qidx_stride,
                               const void* gbar, long long gbar_stride,
                               const void* gmin, const void* step,
                               const void* mod_ok, const void* weight,
                               const void* vote_gate, void* out, void* votes,
                               int n_clients, int n, int bits, void* stream) {
  if (n == 0) return 0;
  const int threads = 256;
  const long long blocks = ((long long)n + threads - 1) / threads;
  spfl_accumulate_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)sign_words, sign_stride, (const uint32_t*)qidx_words,
      qidx_stride, (const float*)gbar, gbar_stride, (const float*)gmin,
      (const float*)step, (const float*)mod_ok, (const float*)weight,
      (const int32_t*)vote_gate, (float*)out, (int32_t*)votes, n_clients, n,
      bits);
  return (int)cudaGetLastError();
}
