// The eq. (28) bandwidth/power allocation of a batch of problems, the
// whole Algorithm 1 in one launch: a thread block, or a cluster of
// blocks, per problem.
//
// Replaces: src/repro/core/allocation_jax.py:solve_traceable (the JAX
// engine's one jitted dispatch; XLA compiles its while and fori loops
// into one program).  It has no Pallas body; its plain version is
// repro_torch.core.allocation_jax.solve_plain, which this kernel repeats
// operation for operation: the same iterates, trip bounds and exits.
//
// Two instantiations of one body, templated on the scalar type T: float64
// (the host loop's 'jax' backend) and float32 (the fused rounds' in-round
// solve, the reference's alloc_f32), exported as alloc_solve and
// alloc_solve_f32.  The f32 one takes the f32 caps of
// allocation_jax._caps(torch.float32) in its constants; every literal of
// the body is written T(...), so the f32 instantiation rounds it to float
// as PyTorch rounds a Python scalar against a float32 tensor.
//
// Bound: latency.  A solve is a chain of dependent steps: ~70,000
// golden-section steps on the main path (K = 20; each two surrogate
// evaluations of two pow and up to four exp), each bisection step
// waiting for the sum over the clients of the golden section before it,
// and 40 dependent Newton steps a bracket.  The arithmetic is ~0.01 ms
// of the card's float64 rate; the time is the chain's length times the
// latency of a step.  The design shortens both and spends idle lanes
// and idle SMs to do it.  What is left of a dual search's chain is its
// rounds (spec_rounds: one 48-step golden section and one cluster
// barrier each): one a search on both main paths once a solve's walk
// repeats (the float32 solve's first search takes 5), so a solve's
// chain is ~16 rounds of golden sections beside optimize_alpha's Newton
// steps and the SCA's bookkeeping (objectives, surrogates, ordered sums
// and barriers).
//
// Design:
// - Layout (block_layout, alloc_solve_layout): blocks of BLOCK = 256
//   threads, launched with that bound, so ptxas may give a thread 255
//   registers.  A problem's clients take `parts` = ceil(K / 256) blocks
//   (thread t of part p is client 256 p + t) for everything outside the
//   golden sections (optimize_alpha, the SCA's bookkeeping, the barrier
//   method, the outputs), as the plain version's vector over the
//   clients; with parts > 1 the sums and votes over the clients go
//   through the first block of the parts (psum, vote) in distributed
//   shared memory.
// - c and d on two lanes: in a golden section a client takes two
//   adjacent lanes where 2K lanes fit the block (one evaluates the
//   surrogate at c, the other at d; they trade f through
//   __shfl_xor_sync and both update lo, hi, c and d with the same
//   operations), else one lane that evaluates c, then d.
// - Speculative dual search: a block's lanes form `groups` groups of
//   lanes x K lanes (one group of all the parts with parts > 1), each
//   of which runs one golden section of all K clients at a dual price
//   of its own; with the alternating method a problem runs on a cluster
//   of `replicas` x parts blocks (up to MAX_CLUSTER = 16, B x blocks <=
//   the card's SMs, all B clusters at once), the groups of all its
//   replicas together, `nodes` of them (at most MAX_NODES) taking a
//   price.  The first round takes
//   lam = 0 (whether the dual runs at all) and the grow loop's prices
//   (1, x10 by the same multiply) up to p_30, where its 30 steps end,
//   `nodes` at a time; the bisection evaluates midpoints below its
//   bracket, each made by the same mul(0.5, add(lo, hi)) at every node,
//   and then walks them as the sequential loop would, with its
//   tolerance exit at every level.  A round evaluates the midpoints
//   down a predicted walk (up to `nodes` levels; path rounds), or, once
//   the walk has left the prediction or where there is none, the full
//   subtree of `depth` levels.  The prediction is the walk of the
//   problem's previous dual search where that started from the same
//   bracket (Memo: the SCA rounds of a solve see nearly the same
//   sum(beta(lam)) near the cap of the grow loop), else, where the
//   bracket's top is infeasible, every midpoint infeasible.  The round
//   that prices the grow loop's last positions gives its spare groups
//   the predicted walk's first midpoints (ahead), from the bracket the
//   prediction starts at (the memo's, else the grow loop's last price),
//   and the bisection's first round is that one where the growth ends
//   there.  So with 92 groups (K = 20, one problem) the float64 main
//   path's duals (each 53 levels, all infeasible) take one round,
//   growth and bisection, where full subtrees take 10; the float32 ones
//   (24 levels that turn feasible at some midpoints: at float32(1e29)
//   lam beta dwarfs the surrogate's rounding) take 5 for the solve's
//   first dual search and one for each later one that walks as it did.
//   The bisection ends at the first level that leaves (lo, hi) as it
//   was (frozen): every later level would test the same midpoint, get
//   the same verdict and leave it so again, whether or not
//   sum(beta(lam)) is monotone (the plain version's _dual has the same
//   exit); a float32 bracket freezes after ~24 levels, a float64 one
//   after ~53.  Every price evaluated is the sequential loop's own
//   computation and the walk reads a superset of its path, so the
//   result is the sequential one whatever the prediction.  The
//   groups' sums and betas go to the cluster through distributed shared
//   memory (two buffers, one cluster barrier a round); the final
//   section at hi is the round's that evaluated hi where one did
//   (fetch), else it runs on group 0 of every replica.  Replica 0 alone
//   runs optimize_alpha (its scratch is per problem) and hands alpha to
//   the others, and alone writes the outputs.  Every replica takes the
//   same branches, since it computes the same values.
// - trips counts the sequential function's work (the bound counts what
//   the function needs; a final section fetched counts as the one the
//   sequential function runs; the bisection's levels are those up to
//   and including the frozen one, which the plain version's exit runs
//   too, and those after it, which no version runs, count nowhere) and,
//   apart, the dual search's rounds (T_ROUNDS) and the speculative
//   golden sections that its path did not need (T_SPEC).
// - Ordered sums: a group's clients write their terms to shared memory
//   and one lane adds them left to right (pads multiplied by the mask),
//   as the plain version's _ordered_sum does; the block reads the
//   result back, so every thread takes the same branches.  Votes over
//   the clients are per group (the golden section's tolerance exit) or
//   __syncthreads_and / _or (the barrier's), across parts by vote.
// - eq. (27)'s weights are written out (exponents, surrogate): a weight
//   of 1 takes no multiply, a weight of 0 keeps its 0 x H (NaN where H
//   is not finite), and a division two terms share is made once.
// - Rounding: every add, multiply and divide is a rounded intrinsic, so
//   no FMA is contracted that the plain version does not make; exp, pow
//   and sqrt are CUDA's functions of T (expf, powf, sqrtf for float),
//   which PyTorch's exp, pow and sqrt of that dtype call on the card.  The
//   arithmetic helpers and the math functions are overloads per type and
//   take two of the same type, so a double constant left in a float
//   expression does not compile.
// - Loops leave once their done flag is set: the plain version's frozen
//   trips change nothing, so this is the same function at any
//   early_exit; early_exit only switches the tolerance exits (inner_tol)
//   on, as there.
// - Scratch (global, per problem): the grid's G', the brackets' list,
//   their roots and values, and H_s, H_v of the clients.
#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int MAX_K = 1024;        // clients per problem: one thread each
constexpr int MAX_ITERS = 64;      // outer iterations of one solve
constexpr int BLOCK = 256;         // threads a block, clients a block
constexpr int MAX_CLUSTER = 16;    // blocks a problem (a non-portable size)
constexpr int MAX_DEPTH = 6;       // levels of a full subtree round
// groups that take a price: the grow loop's 32 positions and a predicted
// walk's 60 midpoints in one round (a full subtree takes 2^MAX_DEPTH - 1)
constexpr int MAX_NODES = 92;
constexpr int GROW_STEPS = 30;
constexpr int BISECT_STEPS = 60;
constexpr int GOLDEN_STEPS = 48;
constexpr int N_CONSTS = 16;
constexpr int N_TRIPS = 15;
constexpr int N_LAYOUT = 7;

enum { UNIFORM = 0, ALTERNATING = 1, BARRIER = 2 };
enum { EXIT_CONVERGED = 0, EXIT_ITER_CAP = 1, EXIT_NONFINITE = 2,
       EXIT_UNIFORM_FALLBACK = 3 };
// trip counters, per problem: the sequential function's, then the dual
// search's rounds (each a cluster barrier) and its speculative golden
// sections
enum { T_OUTER, T_ALPHA, T_CHAINS, T_NEWTON, T_SCA, T_DUAL, T_GROW,
       T_BISECT, T_GOLDEN, T_EVAL, T_BARRIER, T_BACKTRACK, T_OBJECTIVE,
       T_ROUNDS, T_SPEC };
// the solver's constants, in the order the wrapper passes them
enum { C_EXP_CAP, C_POW_CAP, C_H_FLOOR, C_LOG_FLOOR, C_NEWTON_EPS, C_A_EPS,
       C_ONE_M_A_EPS, C_BETA_MIN, C_BETA_MAX, C_GR, C_LN2, C_LN10, C_TOL,
       C_INNER_TOL, C_SCA_TOL, C_LR };

template <typename T>
struct Args {
  const T* coef;           // (B, 4, K) A, B, C, D
  const T* gains;          // (B, K)
  const T* p_w;            // (B, K)
  const T* mask;           // (B, K) 1 real, 0 pad
  const T* scal;           // (B, 6) sign bits, modulus bits, bandwidth,
                           //   noise PSD, latency, alpha_max
  const T* gate;           // (B,) or null: not > 0 -> the uniform point
  T* scratch;              // (B, scratch_doubles(K, G))
  int* brackets;           // (B, (G - 1) K)
  T* alpha;                // (B, K) outputs
  T* beta;
  T* q;
  T* p;
  T* objective;            // (B,)
  int* iters;              // (B,)
  T* objectives;           // (B, max_iters)
  int* exit_reason;        // (B,)
  int* trips;              // (B, N_TRIPS) or null
  T c[N_CONSTS];
  int k, method, max_iters, n_grid, newton_iters, early_exit;
  // the layout (Layout): lanes a client, groups a block, blocks a
  // replica of the problem, blocks a problem, groups that take a price,
  // levels of a full subtree round
  int lanes, groups, parts, cluster, nodes, depth;
};

// How a problem of k clients is laid out (alloc_solve_layout): parts
// blocks of BLOCK threads hold its clients, thread t of part p client
// p BLOCK + t; a cluster of replicas x parts blocks holds the problem
// `replicas` times over, each replica's groups taking prices of their
// own in the speculative dual search.
struct Layout {
  int threads, lanes, groups, parts, cluster, nodes, depth;
};

__host__ __device__ inline int tree_depth(int nodes) {
  int d = 1;
  while (d < MAX_DEPTH && (2 << d) - 1 <= nodes) ++d;
  return d;
}

__host__ __device__ inline Layout block_layout(int k, int replicas) {
  Layout l;
  l.threads = BLOCK;
  l.parts = (k + BLOCK - 1) / BLOCK;
  l.lanes = 2 * k <= BLOCK ? 2 : 1;
  int g = l.parts > 1 ? 1 : BLOCK / (l.lanes * k);
  l.groups = g < MAX_NODES ? g : MAX_NODES;
  l.cluster = replicas * l.parts;
  int n = l.groups * replicas;
  l.nodes = n < MAX_NODES ? n : MAX_NODES;
  l.depth = tree_depth(l.nodes);
  return l;
}

__host__ __device__ inline long long scratch_doubles(int k, int g) {
  return (long long)k * (3 * g) + 2LL * k;
}

__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dvd(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dvd(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double xexp(double x) { return exp(x); }
__device__ __forceinline__ float xexp(float x) { return expf(x); }
__device__ __forceinline__ double xpow(double b, double e) {
  return pow(b, e);
}
__device__ __forceinline__ float xpow(float b, float e) { return powf(b, e); }
__device__ __forceinline__ double xsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float xsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double xabs(double x) { return fabs(x); }
__device__ __forceinline__ float xabs(float x) { return fabsf(x); }
// torch.clamp(max=) / clamp(min=) / clamp(lo, hi) and torch.minimum:
// NaN passes through
template <typename T>
__device__ __forceinline__ T upto(T x, T hi) {
  return isnan(x) ? x : (x < hi ? x : hi);
}
template <typename T>
__device__ __forceinline__ T atleast(T x, T lo) {
  return isnan(x) ? x : (x > lo ? x : lo);
}
template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  return upto(atleast(x, lo), hi);
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return isnan(a) ? a : (isnan(b) ? b : (a < b ? a : b));
}

// What a thread knows of its problem and (if it has one) a client.
template <typename T>
struct Ctx {
  const T* c;              // constants
  T two_s, two_v;          // 2 l and 2 (l b + b0)
  T bw, noise, lat, amax;
  T cs[4];                 // the client's A, B, C, D
  T cap_c;                 // 4 p_w gain
  T m;                     // mask
  int kk;                  // the client (K: none)
  bool client;             // has a client
};

// problem pb's context for its client kk (none if kk >= K)
template <typename T>
__device__ Ctx<T> load_ctx(const Args<T>& a, const T* consts, int pb,
                           int kk) {
  Ctx<T> x;
  x.c = consts;
  const T* sc = a.scal + (long long)pb * 6;
  x.two_s = mul(T(2), sc[0]);
  x.two_v = mul(T(2), sc[1]);
  x.bw = sc[2];
  x.noise = sc[3];
  x.lat = sc[4];
  x.amax = sc[5];
  x.client = kk < a.k;
  x.kk = x.client ? kk : a.k;
  const long long row = (long long)pb * a.k;
  if (x.client) {
    const T* coef = a.coef + row * 4;
    for (int j = 0; j < 4; ++j) x.cs[j] = coef[(long long)j * a.k + kk];
    x.cap_c = mul(mul(T(4), a.p_w[row + kk]), a.gains[row + kk]);
    x.m = a.mask[row + kk];
  } else {
    for (int j = 0; j < 4; ++j) x.cs[j] = T(0);
    x.cap_c = T(1);
    x.m = T(0);
  }
  return x;
}

// H(beta) of eq. (12)/(14) (alloc_common.h_term)
template <typename T>
__device__ T h_term(const Ctx<T>& x, T beta, T two_bits) {
  T bb = mul(beta, x.bw);
  T expo = upto(dvd(two_bits, mul(bb, x.lat)), x.c[C_POW_CAP]);
  T h = mul(dvd(mul(bb, x.noise), x.cap_c), sub(T(1), xpow(T(2), expo)));
  return atleast(h, x.c[C_H_FLOOR]);
}

// dH/dbeta (alloc_common.h_term_prime)
template <typename T>
__device__ T h_prime(const Ctx<T>& x, T beta, T two_bits) {
  T c1 = dvd(mul(x.bw, x.noise), x.cap_c);
  T expo = upto(dvd(two_bits, mul(mul(beta, x.bw), x.lat)), x.c[C_POW_CAP]);
  T p2 = xpow(T(2), expo);
  return mul(c1, add(sub(T(1), p2), mul(mul(p2, x.c[C_LN2]), expo)));
}

// the four exponents of eq. (27) (alloc_common.g_exponents)
template <typename T>
__device__ void g_exponents(T alpha, T hs, T hv, T t[4]) {
  T a = clip(alpha, T(1e-12), T(1));
  T om = clip(sub(T(1), alpha), T(1e-12), T(1));
  T t1 = dvd(hv, om);
  T t4 = dvd(-hs, a);
  if (alpha >= T(1)) t1 = -INFINITY;
  if (alpha <= T(0)) t4 = INFINITY;
  t[0] = t1;
  t[1] = mul(T(2), t1);
  t[2] = add(t1, t4);
  t[3] = t4;
}

// eq. (27)'s exponents wv V / om - ws S / a for the weights (wv, ws) =
// (1, 0), (2, 0), (1, 1), (0, 1) (alloc_common.TERM_W), written out:
// V / om is shared by terms 0 and 2, (0 S) / a by 0 and 1, S / a by 2
// and 3
template <typename T>
__device__ __forceinline__ void exponents(T v, T s, T om, T a, T e[4]) {
  T v1 = dvd(v, om);
  T s0 = dvd(mul(T(0), s), a);
  T s1 = dvd(s, a);
  e[0] = sub(v1, s0);
  e[1] = sub(dvd(mul(T(2), v), om), s0);
  e[2] = sub(v1, s1);
  e[3] = sub(dvd(mul(T(0), v), om), s1);
}

// G(alpha, beta) with H_s, H_v at beta (alloc_common.g_value)
template <typename T>
__device__ T g_value(const Ctx<T>& x, const T cs[4], T alpha, T hs, T hv) {
  T t[4];
  g_exponents(alpha, hs, hv, t);
  T ecap = x.c[C_EXP_CAP];
  T r = add(mul(cs[0], xexp(upto(t[0], ecap))),
            mul(cs[1], xexp(upto(t[1], ecap))));
  r = add(r, mul(cs[2], xexp(upto(t[2], ecap))));
  return add(r, mul(cs[3], xexp(upto(t[3], ecap))));
}

// dG/dalpha, eq. (69) (alloc_common.g_prime_alpha)
template <typename T>
__device__ T g_prime(const Ctx<T>& x, const T cs[4], T alpha, T hs, T hv) {
  T a = clip(alpha, x.c[C_A_EPS], x.c[C_ONE_M_A_EPS]);
  T om = sub(T(1), a);
  T t[4];
  g_exponents(a, hs, hv, t);
  T dv = dvd(hv, mul(om, om));
  T ds = dvd(hs, mul(a, a));
  T ecap = x.c[C_EXP_CAP];
  T r = add(mul(mul(cs[0], xexp(upto(t[0], ecap))), dv),
            mul(mul(mul(cs[1], xexp(upto(t[1], ecap))), T(2)), dv));
  r = add(r, mul(mul(cs[2], xexp(upto(t[2], ecap))), add(dv, ds)));
  return add(r, mul(mul(cs[3], xexp(upto(t[3], ecap))), ds));
}

// The block's shared state.
template <typename T>
struct Shared {
  T terms[MAX_K];          // ordered sums' terms (a group's K in a row)
  T vec[BLOCK];            // a section's betas for the client threads
  T alpha[BLOCK];          // the SCA's alpha of each client
  T beta[BLOCK];           // the SCA round's beta of each client
  // each group's sum and evaluations: two buffers that the cluster reads
  // in turns, and one for a final section that no round evaluated
  T gsum[3][MAX_NODES];
  int gevals[3][MAX_NODES];
  T bres[2][BLOCK];        // a speculative round's betas, by group
  T all[MAX_NODES];        // a speculative round's sums, by group
  int all_evals[MAX_NODES];
  int vote[2][MAX_NODES];  // the golden sections' tolerance votes
  int flags[MAX_CLUSTER];  // votes of the blocks of a cluster
  T result;
  int n_brackets;
};

// The block's place in its problem's cluster.
template <typename T>
__device__ __forceinline__ int rank_of(const Args<T>& a) {
  return blockIdx.x % a.cluster;
}
template <typename T>
__device__ __forceinline__ int part_of(const Args<T>& a) {
  return rank_of(a) % a.parts;
}
// the first block of the block's replica
template <typename T>
__device__ __forceinline__ int head_of(const Args<T>& a) {
  return rank_of(a) / a.parts * a.parts;
}

// Left-to-right sum over the K clients of v (every thread calls it; the
// clients' v are already multiplied by the mask where the plain version
// masks).  Every thread gets the sum.
template <typename T>
__device__ T ordered_sum(Shared<T>& sh, T v, int k) {
  if (threadIdx.x < k) sh.terms[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T acc = sh.terms[0];
    for (int i = 1; i < k; ++i) acc = add(acc, sh.terms[i]);
    sh.result = acc;
  }
  __syncthreads();
  return sh.result;
}

// ordered_sum over the problem's clients, v of the thread's client: a
// problem on several blocks (parts > 1) adds in the first block of each
// replica, to whose terms the others write through distributed shared
// memory.
template <typename T>
__device__ T psum(Shared<T>& sh, const Args<T>& a, const Ctx<T>& x, T v) {
  if (a.parts == 1) return ordered_sum(sh, v, a.k);
  cg::cluster_group cl = cg::this_cluster();
  const unsigned head = head_of(a);
  if (x.client) *cl.map_shared_rank(&sh.terms[x.kk], head) = v;
  cl.sync();
  if (rank_of(a) == (int)head && threadIdx.x == 0) {
    T acc = sh.terms[0];
    for (int i = 1; i < a.k; ++i) acc = add(acc, sh.terms[i]);
    sh.result = acc;
  }
  cl.sync();
  return *cl.map_shared_rank(&sh.result, head);
}

// Whether pred holds on every thread (any: on some thread) of the
// block's replica of its problem, or with `whole` of its cluster (every
// thread calls it).
template <typename T>
__device__ bool vote(Shared<T>& sh, const Args<T>& a, bool pred, bool any,
                     bool whole = false) {
  int local = any ? __syncthreads_or(pred) : __syncthreads_and(pred);
  if (a.cluster == 1 || (!whole && a.parts == 1)) return local != 0;
  cg::cluster_group cl = cg::this_cluster();
  const unsigned head = whole ? 0 : head_of(a);
  const int n = whole ? a.cluster : a.parts;
  if (threadIdx.x == 0) {
    *cl.map_shared_rank(&sh.flags[whole ? rank_of(a) : part_of(a)], head)
        = local;
  }
  cl.sync();
  bool r = !any;
  for (int i = 0; i < n; ++i) {
    bool f = *cl.map_shared_rank(&sh.flags[i], head) != 0;
    r = any ? (r || f) : (r && f);
  }
  cl.sync();
  return r;
}

template <typename T>
__device__ __forceinline__ T msum(Shared<T>& sh, const Args<T>& a,
                                  const Ctx<T>& x, T v) {
  return psum(sh, a, x, mul(v, x.m));
}

// sum_k G(alpha_k, beta_k) over the real clients
template <typename T>
__device__ T objective(Shared<T>& sh, const Args<T>& a, const Ctx<T>& x,
                       T alpha, T beta, int* trips) {
  T g = T(0);
  if (x.client) {
    g = g_value(x, x.cs, alpha, h_term(x, beta, x.two_s),
                h_term(x, beta, x.two_v));
  }
  if (threadIdx.x == 0) ++trips[T_OBJECTIVE];
  return msum(sh, a, x, g);
}

// ---------------------------------------------------------------------------
// optimize_alpha: Lemma 3
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T grid_point(int i, int g, T step, T hi_a) {
  return i == g - 1 ? hi_a : add(T(1e-4), mul(T(i), step));
}

template <typename T>
__device__ T optimize_alpha(Shared<T>& sh, const Ctx<T>& x, const Args<T>& a,
                            int pb, T beta, T* scr, int* brackets,
                            int* trips) {
  const int k = a.k, g = a.n_grid, t = threadIdx.x, nt = blockDim.x;
  // this block's clients: k0 .. k0 + kb - 1; its brackets' list
  const int k0 = part_of(a) * BLOCK;
  const int kb = min(k - k0, BLOCK);
  int* list = brackets + (long long)(g - 1) * k0;
  T* gp = scr;                            // (K, G)
  T* roots = gp + (long long)k * g;       // (K, G - 1)
  T* vals = roots + (long long)k * (g - 1);
  T* hs_all = vals + (long long)k * (g - 1);
  T* hv_all = hs_all + k;
  const T* coef = a.coef + (long long)pb * 4 * k;
  T hs = T(0), hv = T(0);
  if (x.client) {
    hs = h_term(x, beta, x.two_s);
    hv = h_term(x, beta, x.two_v);
    hs_all[x.kk] = hs;
    hv_all[x.kk] = hv;
  }
  T a_max = clip(x.amax, T(1e-3), T(1));
  T hi_a = sub(a_max, T(1e-4));
  T step = dvd(sub(hi_a, T(1e-4)), T(g - 1));
  if (t == 0) {
    sh.n_brackets = 0;
    ++trips[T_ALPHA];
  }
  __syncthreads();
  // G' on the grid, every (point, client) pair
  for (long long idx = t; idx < (long long)g * kb; idx += nt) {
    int kk = k0 + (int)(idx % kb), i = (int)(idx / kb);
    T cs[4] = {coef[kk], coef[k + kk], coef[2 * k + kk], coef[3 * k + kk]};
    gp[(long long)kk * g + i] = g_prime(x, cs, grid_point(i, g, step, hi_a),
                                        hs_all[kk], hv_all[kk]);
  }
  __syncthreads();
  // the brackets where G' changes sign; the others are +inf
  for (long long idx = t; idx < (long long)(g - 1) * kb; idx += nt) {
    int kk = k0 + (int)(idx % kb), i = (int)(idx / kb);
    const T* row = gp + (long long)kk * g;
    if (signbit(row[i]) != signbit(row[i + 1])) {
      list[atomicAdd(&sh.n_brackets, 1)] = (int)idx;
    } else {
      vals[(long long)kk * (g - 1) + i] = INFINITY;
    }
  }
  __syncthreads();
  // safeguarded Newton in each bracket, one thread a bracket
  const int n = sh.n_brackets;
  const T eps = x.c[C_NEWTON_EPS];
  for (int j = t; j < n; j += nt) {
    int idx = list[j];
    int kk = k0 + idx % kb, i = idx / kb;
    T cs[4] = {coef[kk], coef[k + kk], coef[2 * k + kk], coef[3 * k + kk]};
    T hsk = hs_all[kk], hvk = hv_all[kk];
    T lo = grid_point(i, g, step, hi_a);
    T hi = grid_point(i + 1, g, step, hi_a);
    bool flo_neg = gp[(long long)kk * g + i] < T(0);
    T xr = mul(T(0.5), add(lo, hi));
    for (int s = 0; s < a.newton_iters; ++s) {
      T f = g_prime(x, cs, xr, hsk, hvk);
      T fp = dvd(sub(g_prime(x, cs, add(xr, eps), hsk, hvk), f), eps);
      bool same = flo_neg == (f < T(0));
      if (same) lo = xr; else hi = xr;
      T newton = sub(xr, dvd(f, fp));
      T mid = mul(T(0.5), add(lo, hi));
      bool good = isfinite(newton) && newton > lo && newton < hi;
      xr = good ? newton : mid;
    }
    T v = g_value(x, cs, xr, hsk, hvk);
    roots[(long long)kk * (g - 1) + i] = xr;
    vals[(long long)kk * (g - 1) + i] = isnan(v) ? T(INFINITY) : v;
  }
  if (t == 0) {
    // every part's chains count in its replica's first block
    int* tr = a.parts > 1
        ? cg::this_cluster().map_shared_rank(trips, (unsigned)head_of(a))
        : trips;
    atomicAdd(&tr[T_CHAINS], n);
    atomicAdd(&tr[T_NEWTON], n * a.newton_iters);
  }
  __syncthreads();
  // per client: the first-index argmin over the brackets, against the
  // boundary alpha_max
  T alpha = a_max;
  if (x.client) {
    T best_val = g_value(x, x.cs, a_max, hs, hv);
    const T* v = vals + (long long)x.kk * (g - 1);
    T bv = v[0];
    int bi = 0;
    for (int i = 1; i < g - 1; ++i) {
      if (v[i] < bv) {
        bv = v[i];
        bi = i;
      }
    }
    if (bv < best_val) alpha = roots[(long long)x.kk * (g - 1) + bi];
  }
  __syncthreads();   // the scratch is reused by the next call
  return alpha;
}

// ---------------------------------------------------------------------------
// bandwidth by SCA: golden section under dual bisection
// ---------------------------------------------------------------------------

// The surrogate of G(alpha, .) around beta0 (alloc_common.surrogate_value)
template <typename T>
struct Surrogate {
  T a, om, beta0, hs0, hv0, hs0p, hv0p;
  T e0[4], cbase[4];
  bool pos[4];
};

template <typename T>
__device__ Surrogate<T> make_surrogate(const Ctx<T>& x, T alpha, T beta0) {
  Surrogate<T> s;
  s.a = clip(alpha, x.c[C_A_EPS], x.c[C_ONE_M_A_EPS]);
  s.om = sub(T(1), s.a);
  s.beta0 = beta0;
  s.hs0 = h_term(x, beta0, x.two_s);
  s.hv0 = h_term(x, beta0, x.two_v);
  s.hs0p = h_prime(x, beta0, x.two_s);
  s.hv0p = h_prime(x, beta0, x.two_v);
  exponents(s.hv0, s.hs0, s.om, s.a, s.e0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s.cbase[j] = mul(x.cs[j], xexp(upto(s.e0[j], x.c[C_EXP_CAP])));
    s.pos[j] = x.cs[j] >= T(0);
  }
  return s;
}

// surrogate(beta) + lam * beta.  Term j's exponent takes H_v linearized
// and H_s exact where c_j >= 0, H_v exact and H_s linearized where not
// (its supporting line of exp at e0); a division two terms share is made
// once where both take the same side.
template <typename T>
__device__ T surrogate(const Ctx<T>& x, const Surrogate<T>& s, T beta, T lam) {
  T hs = h_term(x, beta, x.two_s);
  T hv = h_term(x, beta, x.two_v);
  T dlt = sub(beta, s.beta0);
  T hs_lin = add(s.hs0, mul(s.hs0p, dlt));
  T hv_lin = add(s.hv0, mul(s.hv0p, dlt));
  const bool p0 = s.pos[0], p1 = s.pos[1], p2 = s.pos[2], p3 = s.pos[3];
  // weights (wv, ws): (1, 0), (2, 0), (1, 1), (0, 1)
  T v0 = dvd(p0 ? hv_lin : hv, s.om);
  T v2 = p2 == p0 ? v0 : dvd(p2 ? hv_lin : hv, s.om);
  T v1 = dvd(mul(T(2), p1 ? hv_lin : hv), s.om);
  T v3 = dvd(mul(T(0), p3 ? hv_lin : hv), s.om);
  T s0 = dvd(mul(T(0), p0 ? hs : hs_lin), s.a);
  T s1 = p1 == p0 ? s0 : dvd(mul(T(0), p1 ? hs : hs_lin), s.a);
  T s2 = dvd(p2 ? hs : hs_lin, s.a);
  T s3 = p3 == p2 ? s2 : dvd(p3 ? hs : hs_lin, s.a);
  const T e[4] = {sub(v0, s0), sub(v1, s1), sub(v2, s2), sub(v3, s3)};
  T total = T(0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    T term = s.pos[j]
        ? mul(x.cs[j], xexp(upto(e[j], x.c[C_EXP_CAP])))
        : mul(s.cbase[j], sub(add(T(1), e[j]), s.e0[j]));
    // the plain version's 0 + term 0 differs only in a zero's sign,
    // which no comparison of the result sees
    total = j == 0 ? term : add(total, term);
  }
  return add(total, mul(lam, beta));
}

// A thread's place in the golden sections: lane `half` (0: c, 1: d) of
// the block's client kk in group g of its block (g < 0: none), gid in
// the cluster (< 0: a group that takes no price), r its index in the
// group; `has`: the lane has a client.  A problem on several blocks
// (parts > 1) has one group a replica, one lane a client.
struct Lane {
  int g, gid, kk, half, r;
  bool has;
};

// f at c and d of the lane's client, where `work`: two lanes trade their
// halves (every lane of the warp shuffles), one lane evaluates both.
template <typename T>
__device__ __forceinline__ void evaluate(const Ctx<T>& y,
                                         const Surrogate<T>& s,
                                         const Lane& ln, int lanes, T c, T d,
                                         T lam, bool work, T& fc, T& fd) {
  if (lanes == 2) {
    T f = T(0);
    if (work) f = surrogate(y, s, ln.half ? d : c, lam);
    T o = __shfl_xor_sync(0xffffffffu, f, 1);
    if (work) {
      fc = ln.half ? o : f;
      fd = ln.half ? f : o;
    }
  } else if (work) {
    fc = surrogate(y, s, c, lam);
    fd = surrogate(y, s, d, lam);
  }
}

// Golden section on [BETA_MIN, BETA_MAX] of the lane's client's
// surrogate at dual price lam, on every thread of the block at once:
// each group with `work` its own price, the others keep step.  With
// tol_exit a group leaves once its whole bracket is that narrow (its
// lanes vote through shared memory).  -> the lane's beta; *evals: the
// group's evaluations of the pair.
template <typename T>
__device__ T golden(Shared<T>& sh, const Args<T>& a, const Ctx<T>& y,
                    const Surrogate<T>& s, const Lane& ln, T lam, bool work,
                    bool tol_exit, int* evals) {
  const int lanes = a.lanes;
  const T gr = y.c[C_GR];
  T lo = y.c[C_BETA_MIN], hi = y.c[C_BETA_MAX];
  T w = mul(gr, sub(hi, lo));
  T c = sub(hi, w), d = add(lo, w);
  T fc = T(0), fd = T(0);
  evaluate(y, s, ln, lanes, c, d, lam, work && ln.has, fc, fd);
  int n = 1, p = 0;
  bool frozen = !work;
  const bool local = a.parts == 1;
  if (tol_exit && local) {
    if (ln.g >= 0 && ln.r == 0) sh.vote[0][ln.g] = sh.vote[1][ln.g] = 1;
    __syncthreads();
  }
  for (int it = 0; it < GOLDEN_STEPS; ++it) {
    if (tol_exit && !local) {
      // the group is the replica, its vote that of the replica's blocks
      bool leave = vote(sh, a, frozen || !ln.has
                                || sub(hi, lo) <= y.c[C_INNER_TOL], false)
                   && !frozen;
      frozen = frozen || leave;
      if (vote(sh, a, frozen, false, true)) break;
    } else if (tol_exit) {
      if (!frozen && !(sub(hi, lo) <= y.c[C_INNER_TOL])) sh.vote[p][ln.g] = 0;
      __syncthreads();
      bool leave = !frozen && sh.vote[p][ln.g] != 0;
      if (ln.g >= 0 && ln.r == 0) sh.vote[p ^ 1][ln.g] = 1;
      frozen = frozen || leave;
      if (__syncthreads_and(frozen)) break;
      p ^= 1;
    }
    if (!frozen) {
      if (fc < fd) hi = d; else lo = c;
      w = mul(gr, sub(hi, lo));
      c = sub(hi, w);
      d = add(lo, w);
    }
    // the last step's evaluations are never read
    if (it + 1 < GOLDEN_STEPS) {
      evaluate(y, s, ln, lanes, c, d, lam, !frozen && ln.has, fc, fd);
      if (!frozen) ++n;
    }
  }
  *evals = n;
  return mul(T(0.5), add(lo, hi));
}

// A golden section on every group with `work`, then each such group's
// ordered sum of mask x beta over its clients (sh.gsum[buf][g]; with
// parts > 1 in the replica's first block, group_sum) and its
// evaluations (sh.gevals[buf][g]).  buf 2 (a final section run on its
// own): group 0 hands its betas to the client threads (sh.vec); buf 0
// or 1 (a speculative round): every group keeps its betas in
// sh.bres[buf] for fetch.
template <typename T>
__device__ void section(Shared<T>& sh, const Ctx<T>& y, const Surrogate<T>& s,
                        const Lane& ln, const Args<T>& a, T lam, bool work,
                        int buf, bool tol_exit) {
  const int k = a.k;
  int evals = 0;
  T b = golden(sh, a, y, s, ln, lam, work, tol_exit, &evals);
  if (work && ln.half == 0 && ln.has) {
    if (buf == 2) {
      sh.vec[ln.kk] = b;
    } else {
      sh.bres[buf][a.parts == 1 ? ln.g * k + ln.kk : ln.kk] = b;
    }
  }
  if (a.parts == 1) {
    if (work && ln.half == 0) sh.terms[ln.g * k + ln.kk] = mul(b, y.m);
    __syncthreads();
    if (work && ln.r == 0) {
      const T* v = sh.terms + ln.g * k;
      T acc = v[0];
      for (int i = 1; i < k; ++i) acc = add(acc, v[i]);
      sh.gsum[buf][ln.g] = acc;
      sh.gevals[buf][ln.g] = evals;
    }
    __syncthreads();
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  const unsigned head = head_of(a);
  if (work && ln.has) {
    *cl.map_shared_rank(&sh.terms[y.kk], head) = mul(b, y.m);
  }
  cl.sync();
  if (work && rank_of(a) == (int)head && threadIdx.x == 0) {
    T acc = sh.terms[0];
    for (int i = 1; i < k; ++i) acc = add(acc, sh.terms[i]);
    sh.gsum[buf][0] = acc;
    sh.gevals[buf][0] = evals;
  }
  cl.sync();
}

// group 0's sum of a final section run on its own (buffer 2)
template <typename T>
__device__ __forceinline__ T group_sum(Shared<T>& sh, const Args<T>& a) {
  if (a.parts == 1) return sh.gsum[2][0];
  return *cg::this_cluster().map_shared_rank(&sh.gsum[2][0],
                                              (unsigned)head_of(a));
}

// One round of the speculative dual search: the groups gid < n each
// take their price lam; then every thread of the cluster holds every
// group's sum (sh.all) and evaluations (sh.all_evals).  The cluster
// reads a round's sums and betas from buffer `par` while the next round
// writes the other: one cluster barrier a round.  -> the round's buffer.
template <typename T>
__device__ int spec_round(Shared<T>& sh, const Ctx<T>& y,
                          const Surrogate<T>& s, const Lane& ln,
                          const Args<T>& a, T lam, int n, bool tol_exit,
                          int& par) {
  const int buf = par;
  section(sh, y, s, ln, a, lam, ln.gid >= 0 && ln.gid < n, buf, tol_exit);
  const int t = threadIdx.x;
  if (a.cluster > 1) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    if (t < n) {
      // group t: group t % groups of the first block of replica
      // t / groups
      unsigned r = t / a.groups * a.parts;
      int g = t % a.groups;
      sh.all[t] = *cl.map_shared_rank(&sh.gsum[buf][g], r);
      sh.all_evals[t] = *cl.map_shared_rank(&sh.gevals[buf][g], r);
    }
  } else if (t < n) {
    sh.all[t] = sh.gsum[buf][t];
    sh.all_evals[t] = sh.gevals[buf][t];
  }
  __syncthreads();
  par ^= 1;
  return buf;
}

// The betas of group gid's section of the speculative round that used
// buffer buf, into the client threads' sh.vec (each its own client's;
// read before the next round's cluster barrier, so before its owner
// writes the buffer again).
template <typename T>
__device__ void fetch(Shared<T>& sh, const Args<T>& a, const Ctx<T>& x,
                      int gid, int buf) {
  if (!x.client) return;
  const int t = threadIdx.x;
  const int i = a.parts == 1 ? gid % a.groups * a.k + t : t;
  if (a.cluster == 1) {
    sh.vec[t] = sh.bres[buf][i];
  } else {
    const unsigned r = gid / a.groups * a.parts + part_of(a);
    sh.vec[t] = *cg::this_cluster().map_shared_rank(&sh.bres[buf][i], r);
  }
}

// The midpoint g levels down a predicted walk from (l, h), level `step`
// of the bisection at (l, h): bit step + i of `path` set, the walk's
// level step + i infeasible (lo moves)
template <typename T>
__device__ __forceinline__ T path_mid(T l, T h, unsigned long long path,
                                      int step, int g) {
  for (int i = 0; i < g; ++i) {
    T m = mul(T(0.5), add(l, h));
    if ((path >> (step + i)) & 1ULL) l = m; else h = m;
  }
  return mul(T(0.5), add(l, h));
}

// The walk of a problem's last dual search (every thread of its cluster
// holds the same): the top of its bracket after the growth, and its
// verdicts, bit l set where level l's midpoint was infeasible (and for
// the levels it did not walk); valid once a search has bisected.
template <typename T>
struct Memo {
  T hi;
  unsigned long long path;
  bool valid;
};

template <typename T>
__device__ T sca(Shared<T>& sh, const Ctx<T>& x, const Ctx<T>& y,
                 const Lane& ln, const Args<T>& a, T alpha, T beta0,
                 int* trips, int& par, Memo<T>& memo) {
  const int t = threadIdx.x;
  const bool tol_exit = a.early_exit && x.c[C_INNER_TOL] > T(0);
  const T inner_tol = x.c[C_INNER_TOL];
  const bool counts = t == 0;
  T beta = beta0;
  T prev = objective(sh, a, x, alpha, beta, trips);
  if (x.client) sh.alpha[t] = alpha;
  for (int r = 0; r < 8; ++r) {
    if (counts) ++trips[T_SCA];
    if (x.client) sh.beta[t] = beta;
    __syncthreads();
    Surrogate<T> s;
    if (ln.g >= 0) s = make_surrogate(y, sh.alpha[ln.kk], sh.beta[ln.kk]);
    // The dual bracket (lo, hi).  have: sh.vec holds the client's beta
    // of golden(hi), whose sum is `total` and evaluations `hevals`, so
    // the sequential loop's final section is that one again; pending: it
    // was a price the sequential loop evaluates only there (not yet
    // counted as speculative).
    T hi = T(1), lo = T(0), total = T(0);
    bool have = false, pending = false, dual = true;
    int hevals = 0;
    // The prediction: the walk of the previous dual search from its
    // bracket, else every midpoint infeasible below the grow loop's last
    // price (where 30 infeasible steps, or 1e30, end it).  The round that
    // prices the grow loop's last positions gives its other groups the
    // first `ahead` midpoints of that walk (group base + i the i-th).
    T pred_hi = memo.hi;
    unsigned long long pred_path = memo.path;
    if (!memo.valid) {
      pred_hi = T(1);
      pred_path = ~0ULL;
      for (int j = 0; j < GROW_STEPS && pred_hi < T(1e30); ++j) {
        pred_hi = mul(pred_hi, T(10));
      }
    }
    int ahead = 0, ahead_base = 0, ahead_buf = 0;
    // Position 0 is lam = 0 (the section that decides whether the dual
    // runs), position 1 + i the grow loop's price p_i (1, x10 by the same
    // multiply; p_30, where 30 steps end, is evaluated only to be the
    // final section): `nodes` positions a round, group j the j-th.
    for (int pos = 0; pos <= GROW_STEPS + 1;) {
      const int n = min(a.nodes, GROW_STEPS + 2 - pos);
      const int extra = pos + n == GROW_STEPS + 2
          ? min(a.nodes - n, BISECT_STEPS) : 0;
      T lam = T(0);
      if (ln.gid >= n) {
        if (ln.gid < n + extra) {
          lam = path_mid(T(0), pred_hi, pred_path, 0, ln.gid - n);
        }
      } else if (ln.gid >= 0 && pos + ln.gid >= 1) {
        lam = T(1);
        for (int j = 1; j < pos + ln.gid; ++j) lam = mul(lam, T(10));
      }
      const int buf = spec_round(sh, y, s, ln, a, lam, n + extra, tol_exit,
                                 par);
      if (counts) ++trips[T_ROUNDS];
      if (extra > 0) {
        ahead = extra;
        ahead_base = n;
        ahead_buf = buf;
      }
      int j = 0, used = 0;
      bool stop = false;
      for (; j < n && !stop; ++j) {
        const int q = pos + j;
        if (q == 0) {
          ++used;
          if (counts) {
            ++trips[T_GOLDEN];
            trips[T_EVAL] += sh.all_evals[0];
          }
          if (!(sh.all[0] > T(1))) {
            dual = false;      // beta(0) meets the constraint
            fetch(sh, a, x, 0, buf);
            stop = true;
          } else if (counts) {
            ++trips[T_DUAL];
          }
          continue;
        }
        // hi is p_{q - 1} here
        if (q - 1 >= GROW_STEPS || !(hi < T(1e30))) {
          // the grow loop ends before pricing hi: golden(hi) is the
          // final section
          fetch(sh, a, x, j, buf);
          have = pending = stop = true;
          total = sh.all[j];
          hevals = sh.all_evals[j];
          ++used;
          break;
        }
        ++used;
        if (counts) {
          ++trips[T_GROW];
          ++trips[T_GOLDEN];
          trips[T_EVAL] += sh.all_evals[j];
        }
        if (!(sh.all[j] > T(1))) {
          fetch(sh, a, x, j, buf);    // hi = p_{q - 1} stays
          have = stop = true;
          total = sh.all[j];
          hevals = sh.all_evals[j];
          break;
        }
        hi = mul(hi, T(10));
      }
      if (counts) trips[T_SPEC] += n - used;
      pos += n;
      if (stop) break;
    }
    T b = T(0);
    if (!dual) {
      b = x.client ? sh.vec[t] : T(0);
      if (counts) trips[T_SPEC] += ahead;
    } else {
      // bisect on the sum constraint, a round evaluating the midpoints
      // below (lo, hi) that the walk may read next.  A path round
      // (follow): min(nodes, levels left) midpoints down the predicted
      // walk, group i the i-th; the prediction is the walk of the
      // solve's previous dual search where that started from the same
      // bracket (memo), else, where the bracket's top is infeasible,
      // every midpoint infeasible.  Once the walk leaves the prediction,
      // or with none: the full subtree of `depth` levels, group j node
      // j + 1 of the heap whose children 2n and 2n + 1 are the brackets
      // after an infeasible (lo = mid) and a feasible (hi = mid)
      // midpoint.  The search ends at the first level that leaves
      // (lo, hi) as it was: every later level would test that midpoint
      // again, get the same verdict and leave it so (_dual's frozen
      // exit), so it ends with the sequential bracket.  The first path
      // round is the growth's `ahead` where the prediction it took is
      // this search's.
      const T start = hi;
      unsigned long long path = ~0ULL, walked = ~0ULL;
      bool follow = have && total > T(1);
      if (memo.valid && memo.hi == hi) {
        path = memo.path;
        follow = true;
      }
      if (ahead > 0 && !(follow && hi == pred_hi && path == pred_path)) {
        if (counts) trips[T_SPEC] += ahead;
        ahead = 0;
      }
      for (int step = 0; step < BISECT_STEPS;) {
        if (tol_exit && sub(hi, lo) <= mul(inner_tol, hi)) break;
        const int rem = BISECT_STEPS - step;
        int levels, n, base = 0, buf;
        if (ahead > 0) {
          levels = n = ahead;
          base = ahead_base;
          buf = ahead_buf;
          ahead = 0;
        } else {
          levels = min(follow ? a.nodes : a.depth, rem);
          n = follow ? levels : (1 << levels) - 1;
          T l = lo, h = hi, lam = T(0);
          if (ln.gid >= 0 && ln.gid < n) {
            if (follow) {
              lam = path_mid(l, h, path, step, ln.gid);
            } else {
              int node = ln.gid + 1;
              for (int bit = 30 - __clz(node); bit >= 0; --bit) {
                T m = mul(T(0.5), add(l, h));
                if ((node >> bit) & 1) h = m; else l = m;
              }
              lam = mul(T(0.5), add(l, h));
            }
          }
          buf = spec_round(sh, y, s, ln, a, lam, n, tol_exit, par);
          if (counts) ++trips[T_ROUNDS];
        }
        int g = 0, lev = 0, last = -1;
        bool stop = false;
        while (lev < levels && g >= 0) {
          if (lev > 0 && tol_exit && sub(hi, lo) <= mul(inner_tol, hi)) {
            stop = true;
            break;
          }
          if (counts) {
            ++trips[T_BISECT];
            ++trips[T_GOLDEN];
            trips[T_EVAL] += sh.all_evals[base + g];
          }
          const T mid = mul(T(0.5), add(lo, hi));
          const T lo0 = lo, hi0 = hi;
          const bool infeasible = sh.all[base + g] > T(1);
          const bool predicted = (path >> (step + lev)) & 1ULL;
          if (infeasible) {
            lo = mid;
          } else {
            hi = mid;
            last = g;
            walked &= ~(1ULL << (step + lev));
          }
          ++lev;
          if (lo == lo0 && hi == hi0) {
            stop = true;       // frozen
          } else if (!follow) {
            g = 2 * g + (infeasible ? 1 : 2);
          } else if (infeasible == predicted) {
            ++g;
          } else {
            follow = false;    // off the prediction: a leaf
            g = -1;
          }
          if (stop) break;
        }
        if (last >= 0) {
          // hi moved to node last's price
          fetch(sh, a, x, base + last, buf);
          if (counts && pending) ++trips[T_SPEC];
          have = true;
          pending = false;
          total = sh.all[base + last];
          hevals = sh.all_evals[base + last];
        }
        if (counts) trips[T_SPEC] += n - lev;
        step += lev;
        if (stop) break;
      }
      if (counts) trips[T_SPEC] += ahead;   // the walk never came to it
      memo.hi = start;
      memo.path = walked;
      memo.valid = true;
      if (!have) {
        section(sh, y, s, ln, a, hi, ln.g == 0, 2, tol_exit);
        if (counts) ++trips[T_ROUNDS];
        total = group_sum(sh, a);
        hevals = sh.gevals[2][0];
      }
      if (counts) {
        ++trips[T_GOLDEN];
        trips[T_EVAL] += hevals;
      }
      b = x.client ? sh.vec[t] : T(0);
      b = mul(b, upto(dvd(T(1), atleast(total, T(1e-12))), T(1)));
    }
    // MM guarantee: only accept descent on the true objective
    T cur = objective(sh, a, x, alpha, b, trips);
    if (cur <= prev) beta = b;
    bool conv = xabs(sub(prev, cur))
                <= mul(x.c[C_SCA_TOL], add(T(1), xabs(prev)));
    prev = nan_min(prev, cur);
    if (conv) break;
  }
  return beta;
}

// ---------------------------------------------------------------------------
// §IV-D: log-barrier + projected gradient descent
// ---------------------------------------------------------------------------

template <typename T>
__device__ T g_dbeta(const Ctx<T>& x, T a, T om, T b) {
  T hs = h_term(x, b, x.two_s), hv = h_term(x, b, x.two_v);
  T hsp = h_prime(x, b, x.two_s), hvp = h_prime(x, b, x.two_v);
  T e[4], de[4];
  exponents(hv, hs, om, a, e);
  exponents(hvp, hsp, om, a, de);
  T out = T(0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out = add(out, mul(mul(x.cs[j], xexp(upto(e[j], x.c[C_EXP_CAP]))), de[j]));
  }
  return out;
}

template <typename T>
__device__ T barrier(Shared<T>& sh, const Ctx<T>& x, const Args<T>& args,
                     T alpha, T beta0, int* trips) {
  const T inner_tol = x.c[C_INNER_TOL];
  T beta = atleast(beta0, T(1e-4));
  T s = msum(sh, args, x, beta);
  if (s >= T(1)) beta = mul(dvd(beta, s), T(0.95));
  T a = clip(alpha, x.c[C_A_EPS], x.c[C_ONE_M_A_EPS]);
  T om = sub(T(1), a);
  T mu = T(10);
  for (int stage = 0; stage < 5; ++stage, mu = mul(mu, T(10))) {
    T inv = dvd(T(1), mul(mu, x.c[C_LN10]));
    for (int it = 0; it < 200; ++it) {
      if (threadIdx.x == 0) ++trips[T_BARRIER];
      T slack = sub(T(1), msum(sh, args, x, beta));
      T grad = T(0);
      if (x.client) {
        grad = sub(g_dbeta(x, a, om, beta),
                   mul(inv, sub(sub(dvd(T(1), beta),
                                    dvd(T(1), sub(T(1), beta))),
                                dvd(T(1), slack))));
        grad = mul(grad, x.m);        // pads hold their start point
      }
      T gn = xsqrt(psum(sh, args, x, mul(grad, grad)));
      T step = dvd(x.c[C_LR], add(T(1), gn));
      // feasibility backtracking: 27 halvings reach t <= 1e-8
      T t = T(1);
      T nw = sub(beta, mul(step, grad));
      for (int bt = 0; bt < 27; ++bt) {
        bool infeas = vote(sh, args,
                           x.client && (nw <= T(0) || nw >= T(1)), true);
        if (!infeas) infeas = msum(sh, args, x, nw) >= T(1);
        if (!(infeas && t > T(1e-8))) break;
        if (threadIdx.x == 0) ++trips[T_BACKTRACK];
        t = mul(T(0.5), t);
        nw = sub(beta, mul(mul(t, step), grad));
      }
      bool give_up = gn < T(1e-14) || t <= T(1e-8);
      // inner_tol = 0 stops only at an exact fixed point (absorbing)
      bool stalled = vote(sh, args,
                          !x.client || xabs(sub(nw, beta)) <= inner_tol,
                          false);
      if (!give_up) beta = nw;
      if (give_up || stalled) break;
    }
  }
  return beta;
}

// ---------------------------------------------------------------------------
// Algorithm 1
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BLOCK, 1)
    alloc_solve_kernel(const Args<T> a) {
  __shared__ Shared<T> sh;
  __shared__ int trip_sh[N_TRIPS];
  __shared__ T consts[N_CONSTS];
  const int cs = a.cluster;
  const int b = blockIdx.x / cs, rank = blockIdx.x % cs;
  const int part = rank % a.parts, rep = rank / a.parts;
  const int t = threadIdx.x, k = a.k;
  int* trips = trip_sh;
  if (t < N_TRIPS) trip_sh[t] = 0;
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < N_CONSTS; ++i) consts[i] = a.c[i];
  }
  // thread t of part p is client p BLOCK + t
  const Ctx<T> x = load_ctx(a, consts, b, part * BLOCK + t);
  // the golden sections' layout: groups of lanes x K lanes (one group,
  // one lane a client, with parts > 1)
  Lane ln;
  if (a.parts == 1) {
    const int span = a.lanes * k;
    ln.g = t / span < a.groups ? t / span : -1;
    ln.r = t % span;
    ln.kk = ln.r / a.lanes;
    ln.half = ln.r % a.lanes;
    ln.has = ln.g >= 0;
  } else {
    ln.g = 0;
    ln.r = ln.kk = t;
    ln.half = 0;
    ln.has = x.client;
  }
  ln.gid = ln.g >= 0 && rep * a.groups + ln.g < a.nodes
      ? rep * a.groups + ln.g : -1;
  // the lane's client's context (with parts > 1 the thread's own)
  const Ctx<T> y = load_ctx(a, consts, b, a.parts > 1 ? part * BLOCK + t
                                          : (ln.has ? ln.kk : k));
  const long long row = (long long)b * k;
  T* scr = a.scratch + (long long)b * scratch_doubles(k, a.n_grid);
  int* brackets = a.brackets + (long long)b * (a.n_grid - 1) * k;
  __syncthreads();

  int method = a.method;
  if (method != UNIFORM && a.gate != nullptr && !(a.gate[b] > T(0))) {
    method = UNIFORM;   // no compensation history yet (round 0)
  }
  // the uniform point: alpha 1/2, beta = mask / sum(mask)
  const T alpha_u = T(0.5);
  const T beta_u = dvd(x.m, psum(sh, a, x, x.m));
  const T uniform_obj = objective(sh, a, x, alpha_u, beta_u, trips);

  T alpha = alpha_u, beta = beta_u, prev = INFINITY;
  bool done = false, bad_seen = false;
  int iters = 0, ran = 0, par = 0;
  Memo<T> memo{T(0), ~0ULL, false};
  T* objs = a.objectives + (long long)b * a.max_iters;
  if (method != UNIFORM) {
    for (int i = 0; i < a.max_iters && !done; ++i, ++ran) {
      if (t == 0) ++trips[T_OUTER];
      T alpha_n = T(0);
      if (rep == 0) {
        alpha_n = optimize_alpha(sh, x, a, b, beta, scr, brackets, trips);
      }
      if (cs > a.parts) {
        // replica 0 hands alpha to the others
        cg::cluster_group cl = cg::this_cluster();
        if (rep == 0 && x.client) sh.alpha[t] = alpha_n;
        cl.sync();
        if (rep != 0 && x.client) {
          alpha_n = *cl.map_shared_rank(&sh.alpha[t], (unsigned)part);
        }
        cl.sync();
      }
      T beta_n = method == BARRIER
          ? barrier(sh, x, a, alpha_n, beta, trips)
          : sca(sh, x, y, ln, a, alpha_n, beta, trips, par, memo);
      T obj = objective(sh, a, x, alpha_n, beta_n, trips);
      // a non-finite iterate must not poison the carry
      bool bad = !isfinite(obj);
      bool conv = xabs(sub(prev, obj))
                  <= mul(x.c[C_TOL], add(T(1), xabs(obj)));
      if (!bad) {
        alpha = alpha_n;
        beta = beta_n;
        prev = obj;
        iters = i + 1;
      }
      if (t == 0 && rank == 0) objs[i] = bad ? T(NAN) : obj;
      done = conv || bad;
      bad_seen = bad_seen || bad;
    }
  }
  int reason = EXIT_CONVERGED;
  if (method != UNIFORM) {
    // never return anything worse than the uniform default (NaN-proof)
    bool worse = !(prev <= uniform_obj);
    if (worse) {
      alpha = alpha_u;
      beta = beta_u;
      prev = uniform_obj;
    }
    reason = worse ? EXIT_UNIFORM_FALLBACK
                   : (bad_seen ? EXIT_NONFINITE
                               : (done ? EXIT_CONVERGED : EXIT_ITER_CAP));
  } else {
    prev = uniform_obj;
  }
  if (rank == 0 && t == 0) {
    for (int i = ran; i < a.max_iters; ++i) objs[i] = T(NAN);
    a.objective[b] = prev;
    a.iters[b] = iters;
    a.exit_reason[b] = reason;
  }
  if (rep == 0 && x.client) {
    T hs = h_term(x, beta, x.two_s), hv = h_term(x, beta, x.two_v);
    T lf = x.c[C_LOG_FLOOR];
    a.alpha[row + x.kk] = alpha;
    a.beta[row + x.kk] = beta;
    a.q[row + x.kk] = alpha > T(0)
        ? xexp(atleast(dvd(hs, clip(alpha, T(1e-12), T(1))), lf)) : T(0);
    a.p[row + x.kk] = alpha < T(1)
        ? xexp(atleast(dvd(hv, clip(sub(T(1), alpha), T(1e-12), T(1))), lf))
        : T(0);
  }
  __syncthreads();
  if (rank == 0 && a.trips != nullptr && t < N_TRIPS) {
    a.trips[(long long)b * N_TRIPS + t] = trip_sh[t];
  }
  // no block leaves while another may still read its shared memory
  if (cs > 1) cg::this_cluster().sync();
}

static cudaLaunchConfig_t launch_config(int nb, int cluster,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nb * cluster);
  cfg.blockDim = dim3(BLOCK);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of c blocks card `dev` runs at once (asked once a
// card, size and instantiation; 0: none).
template <typename T>
static int cluster_capacity(int dev, int c) {
  constexpr int MAX_DEVICES = 16;
  static int known[MAX_DEVICES][MAX_CLUSTER + 1] = {};   // capacity + 1
  int* slot = dev < MAX_DEVICES ? &known[dev][c] : nullptr;
  if (slot != nullptr && *slot > 0) return *slot - 1;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, c, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, alloc_solve_kernel<T>, &cfg)
      != cudaSuccess) {
    n = 0;
  }
  cudaGetLastError();   // a refused query leaves no error behind
  if (slot != nullptr) *slot = n + 1;
  return n;
}

// The layout of a launch of nb problems of k clients: the alternating
// method holds a problem `replicas` times over while nb x blocks fits
// the card's SMs (up to MAX_CLUSTER blocks a problem) and all nb
// clusters run at once (a cluster lies within one GPC, so fewer than
// SMs / blocks of them may fit); the other methods, and a batch of more
// problems than SMs, take one replica.
template <typename T>
static Layout layout_of(int nb, int k, int method) {
  const int parts = (k + BLOCK - 1) / BLOCK;
  int replicas = 1;
  if (method == ALTERNATING) {
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // clusters above 8 blocks: Hopper runs 16 when the kernel allows it
    cudaFuncSetAttribute(alloc_solve_kernel<T>,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    replicas = sms / (nb * parts);
    if (replicas > MAX_CLUSTER / parts) replicas = MAX_CLUSTER / parts;
    while (replicas > 1 && cluster_capacity<T>(dev, replicas * parts) < nb) {
      --replicas;
    }
    if (replicas < 1) replicas = 1;
  }
  return block_layout(k, replicas);
}

template <typename T>
static int layout_entry(int nb, int k, int method, int* out) {
  if (nb <= 0 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  Layout l = layout_of<T>(nb, k, method);
  const int v[N_LAYOUT] = {l.threads, l.lanes, l.groups, l.parts,
                           l.cluster, l.nodes, l.depth};
  for (int i = 0; i < N_LAYOUT; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

// -> {threads, lanes, groups, parts, cluster, nodes, depth} of a launch
extern "C" int alloc_solve_layout(int nb, int k, int method, int* out) {
  return layout_entry<double>(nb, k, method, out);
}

extern "C" int alloc_solve_layout_f32(int nb, int k, int method, int* out) {
  return layout_entry<float>(nb, k, method, out);
}

template <typename T>
static int solve_entry(const T* coef, const T* gains, const T* p_w,
                       const T* mask, const T* scal, const T* gate,
                       T* scratch, int* brackets, T* alpha, T* beta, T* q,
                       T* p, T* objective, int* iters, T* objectives,
                       int* exit_reason, int* trips, const T* consts, int nb,
                       int k, int method, int max_iters, int n_grid,
                       int newton_iters, int early_exit,
                       cudaStream_t stream) {
  if (nb <= 0) return 0;
  if (k < 1 || k > MAX_K || n_grid < 2 || max_iters < 0
      || max_iters > MAX_ITERS || newton_iters < 0 || method < UNIFORM
      || method > BARRIER) {
    return (int)cudaErrorInvalidValue;
  }
  Args<T> a{coef, gains, p_w, mask, scal, gate, scratch, brackets, alpha,
            beta, q, p, objective, iters, objectives, exit_reason, trips};
  for (int i = 0; i < N_CONSTS; ++i) a.c[i] = consts[i];
  a.k = k;
  a.method = method;
  a.max_iters = max_iters;
  a.n_grid = n_grid;
  a.newton_iters = newton_iters;
  a.early_exit = early_exit;
  const Layout l = layout_of<T>(nb, k, method);
  a.lanes = l.lanes;
  a.groups = l.groups;
  a.parts = l.parts;
  a.cluster = l.cluster;
  a.nodes = l.nodes;
  a.depth = l.depth;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(nb, a.cluster, stream, attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, alloc_solve_kernel<T>, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

extern "C" int alloc_solve(const double* coef, const double* gains,
                           const double* p_w, const double* mask,
                           const double* scal, const double* gate,
                           double* scratch, int* brackets, double* alpha,
                           double* beta, double* q, double* p,
                           double* objective, int* iters, double* objectives,
                           int* exit_reason, int* trips,
                           const double* consts, int nb, int k, int method,
                           int max_iters, int n_grid, int newton_iters,
                           int early_exit, cudaStream_t stream) {
  return solve_entry<double>(coef, gains, p_w, mask, scal, gate, scratch,
                             brackets, alpha, beta, q, p, objective, iters,
                             objectives, exit_reason, trips, consts, nb, k,
                             method, max_iters, n_grid, newton_iters,
                             early_exit, stream);
}

// the float32 instantiation: every pointer float32 but brackets, iters,
// exit_reason and trips (int32), the constants the f32 caps
extern "C" int alloc_solve_f32(const float* coef, const float* gains,
                               const float* p_w, const float* mask,
                               const float* scal, const float* gate,
                               float* scratch, int* brackets, float* alpha,
                               float* beta, float* q, float* p,
                               float* objective, int* iters,
                               float* objectives, int* exit_reason,
                               int* trips, const float* consts, int nb, int k,
                               int method, int max_iters, int n_grid,
                               int newton_iters, int early_exit,
                               cudaStream_t stream) {
  return solve_entry<float>(coef, gains, p_w, mask, scal, gate, scratch,
                            brackets, alpha, beta, q, p, objective, iters,
                            objectives, exit_reason, trips, consts, nb, k,
                            method, max_iters, n_grid, newton_iters,
                            early_exit, stream);
}
