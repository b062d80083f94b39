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
// Design: a block owns a tile of TILE = 256 coordinates, two per thread
// (lanes s and s + 16 of one 32-coordinate group), so the sixteen threads
// of a half-warp share every payload word they read (a broadcast), and a
// thread's per-client loads and loop control serve two coordinates.  The
// clients come in chunks of CHUNK = 32: the block copies a chunk's sign
// and knob words of its tile (8 and 8 * bits words per client) and the
// chunk's five per-client scalars into shared memory with 4-byte
// cp.async, every copy in flight at once (the block's threads on
// consecutive words of the chunk), and waits once; the next chunk's
// copies fly while this one is summed (two buffers).  A thread waits
// through one memory round trip per chunk, not one per client.  TMA is no
// use here: the payload rows are strided views of framed packets (1,943
// and 5,822 words at the main shapes, starting at word 4 or 7), whose
// strides are no multiple of 16 bytes.  A shared (n,) gbar is read once
// per coordinate, before the wait; a per-client (K, n) gbar only for
// clients whose modulus packet was lost.
//
// Each thread then sums its clients k = 0..K-1 in order in one register
// per coordinate, so the f32 sum needs no atomics and keeps the reference
// order (the order is part of the contract: transport._seq_client_sum);
// the sum starts at -0.0f, the additive identity (-0 + x == x bit for
// bit), so after client 0 it holds that client's contribution exactly.
// Every float operation is an explicitly rounded intrinsic: nvcc cannot
// contract gmin + q * step or acc + w * (s * m) into FMAs, and the kernel
// equals its plain PyTorch version bit for bit.  The knob step arrives
// precomputed by the wrapper (the division stays IEEE, as in the
// reference's host-side knob_step).  The vote is a count of sign bit
// times gate, as the plain version sums it.  The client loop is not
// unrolled, so one trip is one client of both coordinates in the SASS
// (kernels/sass.py MAIN_PATHS); the knob planes are unrolled for each
// width 1..16 (a branch on bits, the same for every thread), so a plane
// costs a shared load, a rotate and one three-input logic op, and a
// client 56 instructions for two coordinates at bits 3 with a shared
// gbar.
//
// Launch shape, timed with kernel_ab.py against edited copies of this
// source at the main shapes (K = 20, l = 62,006, bits 3) on an H100 80GB
// HBM3 at 700 W: 243 blocks of 128 threads are one wave.  Two
// coordinates per thread ran 5% faster than one and 12% faster than four
// (121 registers); with two, a 512-coordinate tile ran 4% slower.  With
// one, tiles of 128 and 512 coordinates ran 1% and 11% slower than 256,
// and chunks of 16 and 8 clients (two and three stages at K = 20) 9% and
// 17% slower than one.
//
// Shared memory: the two stages take 2 KB of scalars (static) and
// 2,048 (1 + bits) bytes of words (dynamic).  From bits 23 on their sum
// passes the 48 KB a block gets by default, and the entry point opts in
// to more.
#include <cstdint>
#include <cuda_runtime.h>

constexpr int TILE = 256;              // coordinates per block
constexpr int CHUNK = 32;              // clients per shared-memory stage
constexpr int CPT = 2;                 // coordinates per thread
constexpr int THREADS = TILE / CPT;    // threads per block
constexpr int SPAN = 32 / CPT;         // threads per 32-coordinate group
constexpr int TG = TILE / 32;          // 32-coordinate groups per tile
constexpr int SCAL = 8;  // scalar words per client: gmin, step, mod_ok,
                         // weight, vote gate, padding
constexpr int SCAL_BYTES = 2 * CHUNK * SCAL * (int)sizeof(uint32_t);
static_assert(TILE % 32 == 0 && 32 % CPT == 0 && THREADS % 32 == 0 &&
                  THREADS <= 1024 && CHUNK <= THREADS,
              "whole warps, and a thread for each scalar row of a chunk");

// Copy one 4-byte word to shared memory, or (bytes = 0) fill it with zero
// without reading src.
__device__ __forceinline__ void copy_word(uint32_t* dst, const void* src,
                                          unsigned bytes = 4) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

struct Args {
  const uint32_t* sign_words;
  long long sign_stride;
  const uint32_t* qidx_words;
  long long qidx_stride;
  const float* gbar;
  long long gbar_stride;
  const void *gmin, *step, *mod_ok, *weight, *vote_gate;
  float* out;
  int32_t* votes;
  int n_clients, n, bits;
};

// Where one thread's copies start in a chunk of clients laid out as
// [client][wpc words]: client k, word w, and the step of THREADS words.
struct Walk {
  int k, w, dk, dw;
};

// Issue the copies of clients [k0, k0 + nk) of the tile at group g0 (tg
// valid groups) into one buffer: per client, its tile's sign words, then
// its knob words; thread t takes words t, t + THREADS, ... of the chunk
// (the words of groups past the last are zero-filled, so a copy has no
// branch), and threads t < nk also take client t's five scalars.  One
// commit group per chunk.
__device__ __forceinline__ void stage(const Args& a, uint32_t* words,
                                      uint32_t* scal, Walk at, int k0,
                                      int nk, long long g0, int tg,
                                      int wpc) {
  const int knob_end = TG + tg * a.bits;  // sign [0, tg), knobs [TG, end)
  for (int i = threadIdx.x; i < nk * wpc; i += THREADS) {
    const long long row = k0 + at.k;
    const bool sign = at.w < TG;
    const uint32_t* src =
        sign ? a.sign_words + row * a.sign_stride + g0 + at.w
             : a.qidx_words + row * a.qidx_stride + g0 * a.bits + (at.w - TG);
    const bool valid = sign ? at.w < tg : at.w < knob_end;
    copy_word(words + i, valid ? src : a.sign_words, valid ? 4u : 0u);
    at.k += at.dk;
    at.w += at.dw;
    if (at.w >= wpc) {
      at.w -= wpc;
      ++at.k;
    }
  }
  if ((int)threadIdx.x < nk) {
    const long long row = k0 + threadIdx.x;
    uint32_t* dst = scal + threadIdx.x * SCAL;
    copy_word(dst + 0, (const uint32_t*)a.gmin + row);
    copy_word(dst + 1, (const uint32_t*)a.step + row);
    copy_word(dst + 2, (const uint32_t*)a.mod_ok + row);
    copy_word(dst + 3, (const uint32_t*)a.weight + row);
    copy_word(dst + 4, (const uint32_t*)a.vote_gate + row);
  }
  copies_commit();
}

// The knob index of lane `lane` from its group's `bits` plane words: a
// rotate brings the lane's bit of plane j to bit j.  BITS > 0 unrolls the
// planes; BITS = 0 loops over `bits` of them.
template <int BITS>
__device__ __forceinline__ uint32_t knob_index(const uint32_t* planes,
                                               int lane, int bits) {
  uint32_t q = 0u;
  if (BITS > 0) {
#pragma unroll
    for (int j = 0; j < BITS; ++j)
      q |= __funnelshift_r(planes[j], planes[j], lane - j) & (1u << j);
  } else {
#pragma unroll 1
    for (int j = 0; j < bits; ++j)
      q |= __funnelshift_r(planes[j], planes[j], lane - j) & (1u << j);
  }
  return q;
}

// One thread's CPT coordinates c[i] (lanes lane[i] of one group) over the
// nk clients of a staged chunk (sign words sw, knob planes qw, scalars
// sc; wpc words per client), accumulated in order into acc and votes.
struct Sum {
  const uint32_t *sw, *qw, *sc;
  int wpc, nk, bits;
  int lane[CPT];
  bool live[CPT];
  float gb[CPT];             // the shared gbar (PER_CLIENT false)
  const float* gbar_k[CPT];  // gbar[k0][c[i]] (PER_CLIENT true)
  long long gbar_stride;
};

template <int BITS, bool PER_CLIENT>
__device__ __forceinline__ void sum_chunk(const Sum& x, float (&acc)[CPT],
                                          uint32_t (&votes)[CPT]) {
  const uint32_t *sw = x.sw, *qw = x.qw, *sc = x.sc;
  const float* gk[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) gk[i] = x.gbar_k[i];
#pragma unroll 1
  for (int k = 0; k < x.nk; ++k, sw += x.wpc, qw += x.wpc, sc += SCAL) {
    const uint4 s4 = *reinterpret_cast<const uint4*>(sc);
    const uint32_t gate = sc[4], sign_word = *sw;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      // the lane's sign bit, rotated to bit 31
      const uint32_t sbit31 =
          __funnelshift_r(sign_word, sign_word, x.lane[i] - 31);
      const uint32_t q = knob_index<BITS>(qw, x.lane[i], x.bits);
      float modulus = __fadd_rn(__uint_as_float(s4.x),
                                __fmul_rn((float)q, __uint_as_float(s4.y)));
      if (!(__uint_as_float(s4.z) > 0.0f))
        modulus = !PER_CLIENT ? x.gb[i] : x.live[i] ? *gk[i] : 0.0f;
      // +1.0f for sign bit 1, -1.0f for 0
      const float s = __uint_as_float((sbit31 & 0x80000000u) ^ 0xbf800000u);
      const float contrib =
          __fmul_rn(__uint_as_float(s4.w), __fmul_rn(s, modulus));
      acc[i] = __fadd_rn(acc[i], contrib);
      votes[i] += (sbit31 >> 31) * gate;
      if (PER_CLIENT) gk[i] += x.gbar_stride;
    }
  }
}

// sum_chunk with the plane loop unrolled for bits = B..16 (a branch that
// every thread takes alike), and rolled above 16.
template <int B, bool PER_CLIENT>
__device__ __forceinline__ void sum_chunk_bits(const Sum& x,
                                               float (&acc)[CPT],
                                               uint32_t (&votes)[CPT]) {
  if constexpr (B > 16) {
    sum_chunk<0, PER_CLIENT>(x, acc, votes);
  } else {
    if (x.bits == B)
      sum_chunk<B, PER_CLIENT>(x, acc, votes);
    else
      sum_chunk_bits<B + 1, PER_CLIENT>(x, acc, votes);
  }
}

__global__ void __launch_bounds__(THREADS)
    spfl_accumulate_kernel(const Args a) {
  extern __shared__ uint32_t smem[];  // [2][CHUNK][wpc] payload words
  __shared__ __align__(16) uint32_t scal[2][CHUNK * SCAL];
  const int wpc = TG * (1 + a.bits);  // words per client of one tile
  const long long g0 = (long long)blockIdx.x * TG;
  const int groups = (a.n + 31) >> 5;
  const int tg = (int)min((long long)TG, groups - g0);
  const int grp = threadIdx.x / SPAN, sub = threadIdx.x % SPAN;
  const long long c0 = (g0 + grp) * 32 + sub;  // lane sub of group grp
  const bool live = c0 < a.n;
  const bool shared_gbar = a.gbar_stride == 0;
  Sum x;
  x.wpc = wpc;
  x.bits = a.bits;
  x.gbar_stride = a.gbar_stride;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const long long c = c0 + i * SPAN;
    x.lane[i] = sub + i * SPAN;
    x.live[i] = c < a.n;
    // the shared gbar's load flies while the payload copies do
    x.gb[i] = x.live[i] && shared_gbar ? a.gbar[c] : 0.0f;
  }
  Walk at;  // this thread's first word of a chunk, and its step
  at.k = threadIdx.x / wpc;
  at.w = threadIdx.x - at.k * wpc;
  at.dk = THREADS / wpc;
  at.dw = THREADS - at.dk * wpc;
  float acc[CPT];
  uint32_t votes[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    acc[i] = -0.0f;
    votes[i] = 0u;
  }
  const int chunks = (a.n_clients + CHUNK - 1) / CHUNK;
  if (chunks > 0)
    stage(a, smem, scal[0], at, 0, min(CHUNK, a.n_clients), g0, tg, wpc);
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1, k0 = ch * CHUNK;
    if (ch + 1 < chunks) {
      const int k1 = k0 + CHUNK;
      stage(a, smem + (buf ^ 1) * CHUNK * wpc, scal[buf ^ 1], at, k1,
            min(CHUNK, a.n_clients - k1), g0, tg, wpc);
      copies_wait<1>();
    } else {
      copies_wait<0>();
    }
    __syncthreads();
    if (live) {
      const uint32_t* words = smem + buf * CHUNK * wpc;
      x.sw = words + grp;
      x.qw = words + TG + grp * a.bits;
      x.sc = scal[buf];
      x.nk = min(CHUNK, a.n_clients - k0);
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        x.gbar_k[i] = a.gbar + k0 * a.gbar_stride + c0 + i * SPAN;
      if (shared_gbar)
        sum_chunk_bits<1, false>(x, acc, votes);
      else
        sum_chunk_bits<1, true>(x, acc, votes);
    }
    if (ch + 1 < chunks) __syncthreads();  // buffer buf is restaged next
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    if (x.live[i]) {
      a.out[c0 + i * SPAN] = acc[i];
      if (a.votes) a.votes[c0 + i * SPAN] = (int32_t)votes[i];
    }
  }
}

extern "C" int spfl_accumulate(const void* sign_words, long long sign_stride,
                               const void* qidx_words, long long qidx_stride,
                               const void* gbar, long long gbar_stride,
                               const void* gmin, const void* step,
                               const void* mod_ok, const void* weight,
                               const void* vote_gate, void* out, void* votes,
                               int n_clients, int n, int bits, void* stream) {
  if (n == 0) return 0;
  const Args a{(const uint32_t*)sign_words,
               sign_stride,
               (const uint32_t*)qidx_words,
               qidx_stride,
               (const float*)gbar,
               gbar_stride,
               gmin,
               step,
               mod_ok,
               weight,
               vote_gate,
               (float*)out,
               (int32_t*)votes,
               n_clients,
               n,
               bits};
  const int smem_bytes = 2 * CHUNK * TG * (1 + bits) * (int)sizeof(uint32_t);
  // wide knobs: opt in when static and dynamic pass the default 48 KB
  if (SCAL_BYTES + smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spfl_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = ((long long)n + TILE - 1) / TILE;
  spfl_accumulate_kernel<<<(unsigned)blocks, THREADS, smem_bytes,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
