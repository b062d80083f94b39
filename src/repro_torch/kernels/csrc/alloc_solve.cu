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
// Bound: latency.  A solve is a chain of dependent float64 steps: ~70,000
// golden-section steps on the main path (K = 20; each two surrogate
// evaluations of two pow and up to four exp), each bisection step
// waiting for the sum over the clients of the golden section before it,
// and 40 dependent Newton steps a bracket.  The arithmetic is ~0.01 ms
// of the card's float64 rate; the time is the chain's length times the
// latency of a step.  The design shortens both and spends idle lanes
// and idle SMs to do it.
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
//   `nodes` at a time; the bisection evaluates a subtree of midpoints
//   below its bracket, each made by the same mul(0.5, add(lo, hi)) at
//   every node, and then walks it as the sequential loop would, with
//   its tolerance exit at every level.  The subtree is the full one of
//   `depth` levels, or, while the walk keeps to the infeasible side
//   (where the bracket's top is infeasible too), a spine of up to 32
//   nodes down that side with the other child of each: the main path's
//   60 levels, all infeasible, take 2 rounds instead of 10.
//   Every price evaluated is the sequential loop's own computation and
//   the walk reads a superset of its path, so the result is the
//   sequential one whether or not sum(beta(lam)) is monotone.  The
//   groups' sums and betas go to the cluster through distributed shared
//   memory (two buffers, one cluster barrier a round); the final
//   section at hi is the round's that evaluated hi where one did
//   (fetch), else it runs on group 0 of every replica.  Replica 0 alone
//   runs optimize_alpha (its scratch is per problem) and hands alpha to
//   the others, and alone writes the outputs.  Every replica takes the
//   same branches, since it computes the same values.
// - trips counts the sequential function's work (the bound counts what
//   the function needs; a final section fetched counts as the one the
//   sequential function runs) and, apart, the speculative golden
//   sections that its path did not need (T_SPEC).
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
//   and sqrt are CUDA's float64 functions, which PyTorch's float64 exp,
//   pow and sqrt call on the card.
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
constexpr int MAX_DEPTH = 6;       // bisection levels a speculative round
constexpr int MAX_NODES = 63;      // 2^MAX_DEPTH - 1 groups take a price
constexpr int GROW_STEPS = 30;
constexpr int BISECT_STEPS = 60;
constexpr int GOLDEN_STEPS = 48;
constexpr int N_CONSTS = 16;
constexpr int N_TRIPS = 14;
constexpr int N_LAYOUT = 7;

enum { UNIFORM = 0, ALTERNATING = 1, BARRIER = 2 };
enum { EXIT_CONVERGED = 0, EXIT_ITER_CAP = 1, EXIT_NONFINITE = 2,
       EXIT_UNIFORM_FALLBACK = 3 };
// trip counters, per problem: the sequential function's, then the
// speculative golden sections
enum { T_OUTER, T_ALPHA, T_CHAINS, T_NEWTON, T_SCA, T_DUAL, T_GROW,
       T_BISECT, T_GOLDEN, T_EVAL, T_BARRIER, T_BACKTRACK, T_OBJECTIVE,
       T_SPEC };
// the solver's constants, in the order the wrapper passes them
enum { C_EXP_CAP, C_POW_CAP, C_H_FLOOR, C_LOG_FLOOR, C_NEWTON_EPS, C_A_EPS,
       C_ONE_M_A_EPS, C_BETA_MIN, C_BETA_MAX, C_GR, C_LN2, C_LN10, C_TOL,
       C_INNER_TOL, C_SCA_TOL, C_LR };

struct Args {
  const double* coef;      // (B, 4, K) A, B, C, D
  const double* gains;     // (B, K)
  const double* p_w;       // (B, K)
  const double* mask;      // (B, K) 1 real, 0 pad
  const double* scal;      // (B, 6) sign bits, modulus bits, bandwidth,
                           //   noise PSD, latency, alpha_max
  const double* gate;      // (B,) or null: not > 0 -> the uniform point
  double* scratch;         // (B, scratch_doubles(K, G))
  int* brackets;           // (B, (G - 1) K)
  double* alpha;           // (B, K) outputs
  double* beta;
  double* q;
  double* p;
  double* objective;       // (B,)
  int* iters;              // (B,)
  double* objectives;      // (B, max_iters)
  int* exit_reason;        // (B,)
  int* trips;              // (B, N_TRIPS) or null
  double c[N_CONSTS];
  int k, method, max_iters, n_grid, newton_iters, early_exit;
  // the layout (Layout): lanes a client, groups a block, blocks a
  // replica of the problem, blocks a problem, groups that take a price,
  // bisection levels a round
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
// torch.clamp(max=) / clamp(min=) / clamp(lo, hi) and torch.minimum:
// NaN passes through
__device__ __forceinline__ double upto(double x, double hi) {
  return isnan(x) ? x : (x < hi ? x : hi);
}
__device__ __forceinline__ double atleast(double x, double lo) {
  return isnan(x) ? x : (x > lo ? x : lo);
}
__device__ __forceinline__ double clip(double x, double lo, double hi) {
  return upto(atleast(x, lo), hi);
}
__device__ __forceinline__ double nan_min(double a, double b) {
  return isnan(a) ? a : (isnan(b) ? b : (a < b ? a : b));
}

// What a thread knows of its problem and (if it has one) a client.
struct Ctx {
  const double* c;         // constants
  double two_s, two_v;     // 2 l and 2 (l b + b0)
  double bw, noise, lat, amax;
  double cs[4];            // the client's A, B, C, D
  double cap_c;            // 4 p_w gain
  double m;                // mask
  int kk;                  // the client (K: none)
  bool client;             // has a client
};

// problem pb's context for its client kk (none if kk >= K)
__device__ Ctx load_ctx(const Args& a, const double* consts, int pb,
                        int kk) {
  Ctx x;
  x.c = consts;
  const double* sc = a.scal + (long long)pb * 6;
  x.two_s = mul(2.0, sc[0]);
  x.two_v = mul(2.0, sc[1]);
  x.bw = sc[2];
  x.noise = sc[3];
  x.lat = sc[4];
  x.amax = sc[5];
  x.client = kk < a.k;
  x.kk = x.client ? kk : a.k;
  const long long row = (long long)pb * a.k;
  if (x.client) {
    const double* coef = a.coef + row * 4;
    for (int j = 0; j < 4; ++j) x.cs[j] = coef[(long long)j * a.k + kk];
    x.cap_c = mul(mul(4.0, a.p_w[row + kk]), a.gains[row + kk]);
    x.m = a.mask[row + kk];
  } else {
    for (int j = 0; j < 4; ++j) x.cs[j] = 0.0;
    x.cap_c = 1.0;
    x.m = 0.0;
  }
  return x;
}

// H(beta) of eq. (12)/(14) (alloc_common.h_term)
__device__ double h_term(const Ctx& x, double beta, double two_bits) {
  double bb = mul(beta, x.bw);
  double expo = upto(dvd(two_bits, mul(bb, x.lat)), x.c[C_POW_CAP]);
  double h = mul(dvd(mul(bb, x.noise), x.cap_c), sub(1.0, pow(2.0, expo)));
  return atleast(h, x.c[C_H_FLOOR]);
}

// dH/dbeta (alloc_common.h_term_prime)
__device__ double h_prime(const Ctx& x, double beta, double two_bits) {
  double c1 = dvd(mul(x.bw, x.noise), x.cap_c);
  double expo = upto(dvd(two_bits, mul(mul(beta, x.bw), x.lat)),
                     x.c[C_POW_CAP]);
  double p2 = pow(2.0, expo);
  return mul(c1, add(sub(1.0, p2), mul(mul(p2, x.c[C_LN2]), expo)));
}

// the four exponents of eq. (27) (alloc_common.g_exponents)
__device__ void g_exponents(double alpha, double hs, double hv, double t[4]) {
  double a = clip(alpha, 1e-12, 1.0);
  double om = clip(sub(1.0, alpha), 1e-12, 1.0);
  double t1 = dvd(hv, om);
  double t4 = dvd(-hs, a);
  if (alpha >= 1.0) t1 = -INFINITY;
  if (alpha <= 0.0) t4 = INFINITY;
  t[0] = t1;
  t[1] = mul(2.0, t1);
  t[2] = add(t1, t4);
  t[3] = t4;
}

// eq. (27)'s exponents wv V / om - ws S / a for the weights (wv, ws) =
// (1, 0), (2, 0), (1, 1), (0, 1) (alloc_common.TERM_W), written out:
// V / om is shared by terms 0 and 2, (0 S) / a by 0 and 1, S / a by 2
// and 3
__device__ __forceinline__ void exponents(double v, double s, double om,
                                          double a, double e[4]) {
  double v1 = dvd(v, om);
  double s0 = dvd(mul(0.0, s), a);
  double s1 = dvd(s, a);
  e[0] = sub(v1, s0);
  e[1] = sub(dvd(mul(2.0, v), om), s0);
  e[2] = sub(v1, s1);
  e[3] = sub(dvd(mul(0.0, v), om), s1);
}

// G(alpha, beta) with H_s, H_v at beta (alloc_common.g_value)
__device__ double g_value(const Ctx& x, const double cs[4], double alpha,
                          double hs, double hv) {
  double t[4];
  g_exponents(alpha, hs, hv, t);
  double ecap = x.c[C_EXP_CAP];
  double r = add(mul(cs[0], exp(upto(t[0], ecap))),
                 mul(cs[1], exp(upto(t[1], ecap))));
  r = add(r, mul(cs[2], exp(upto(t[2], ecap))));
  return add(r, mul(cs[3], exp(upto(t[3], ecap))));
}

// dG/dalpha, eq. (69) (alloc_common.g_prime_alpha)
__device__ double g_prime(const Ctx& x, const double cs[4], double alpha,
                          double hs, double hv) {
  double a = clip(alpha, x.c[C_A_EPS], x.c[C_ONE_M_A_EPS]);
  double om = sub(1.0, a);
  double t[4];
  g_exponents(a, hs, hv, t);
  double dv = dvd(hv, mul(om, om));
  double ds = dvd(hs, mul(a, a));
  double ecap = x.c[C_EXP_CAP];
  double r = add(mul(mul(cs[0], exp(upto(t[0], ecap))), dv),
                 mul(mul(mul(cs[1], exp(upto(t[1], ecap))), 2.0), dv));
  r = add(r, mul(mul(cs[2], exp(upto(t[2], ecap))), add(dv, ds)));
  return add(r, mul(mul(cs[3], exp(upto(t[3], ecap))), ds));
}

// The block's shared state.
struct Shared {
  double terms[MAX_K];     // ordered sums' terms (a group's K in a row)
  double vec[BLOCK];       // a section's betas for the client threads
  double alpha[BLOCK];     // the SCA's alpha of each client
  double beta[BLOCK];      // the SCA round's beta of each client
  // each group's sum and evaluations: two buffers that the cluster reads
  // in turns, and one for a final section that no round evaluated
  double gsum[3][MAX_NODES];
  int gevals[3][MAX_NODES];
  double bres[2][BLOCK];   // a speculative round's betas, by group
  double all[MAX_NODES];   // a speculative round's sums, by group
  int all_evals[MAX_NODES];
  int vote[2][MAX_NODES];  // the golden sections' tolerance votes
  int flags[MAX_CLUSTER];  // votes of the blocks of a cluster
  double result;
  int n_brackets;
};

// The block's place in its problem's cluster.
__device__ __forceinline__ int rank_of(const Args& a) {
  return blockIdx.x % a.cluster;
}
__device__ __forceinline__ int part_of(const Args& a) {
  return rank_of(a) % a.parts;
}
// the first block of the block's replica
__device__ __forceinline__ int head_of(const Args& a) {
  return rank_of(a) / a.parts * a.parts;
}

// Left-to-right sum over the K clients of v (every thread calls it; the
// clients' v are already multiplied by the mask where the plain version
// masks).  Every thread gets the sum.
__device__ double ordered_sum(Shared& sh, double v, int k) {
  if (threadIdx.x < k) sh.terms[threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double acc = sh.terms[0];
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
__device__ double psum(Shared& sh, const Args& a, const Ctx& x, double v) {
  if (a.parts == 1) return ordered_sum(sh, v, a.k);
  cg::cluster_group cl = cg::this_cluster();
  const unsigned head = head_of(a);
  if (x.client) *cl.map_shared_rank(&sh.terms[x.kk], head) = v;
  cl.sync();
  if (rank_of(a) == (int)head && threadIdx.x == 0) {
    double acc = sh.terms[0];
    for (int i = 1; i < a.k; ++i) acc = add(acc, sh.terms[i]);
    sh.result = acc;
  }
  cl.sync();
  return *cl.map_shared_rank(&sh.result, head);
}

// Whether pred holds on every thread (any: on some thread) of the
// block's replica of its problem, or with `whole` of its cluster (every
// thread calls it).
__device__ bool vote(Shared& sh, const Args& a, bool pred, bool any,
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

__device__ __forceinline__ double msum(Shared& sh, const Args& a,
                                       const Ctx& x, double v) {
  return psum(sh, a, x, mul(v, x.m));
}

// sum_k G(alpha_k, beta_k) over the real clients
__device__ double objective(Shared& sh, const Args& a, const Ctx& x,
                            double alpha, double beta, int* trips) {
  double g = 0.0;
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

__device__ __forceinline__ double grid_point(int i, int g, double step,
                                             double hi_a) {
  return i == g - 1 ? hi_a : add(1e-4, mul((double)i, step));
}

__device__ double optimize_alpha(Shared& sh, const Ctx& x, const Args& a,
                                 int pb, double beta, double* scr,
                                 int* brackets, int* trips) {
  const int k = a.k, g = a.n_grid, t = threadIdx.x, nt = blockDim.x;
  // this block's clients: k0 .. k0 + kb - 1; its brackets' list
  const int k0 = part_of(a) * BLOCK;
  const int kb = min(k - k0, BLOCK);
  int* list = brackets + (long long)(g - 1) * k0;
  double* gp = scr;                       // (K, G)
  double* roots = gp + (long long)k * g;  // (K, G - 1)
  double* vals = roots + (long long)k * (g - 1);
  double* hs_all = vals + (long long)k * (g - 1);
  double* hv_all = hs_all + k;
  const double* coef = a.coef + (long long)pb * 4 * k;
  double hs = 0.0, hv = 0.0;
  if (x.client) {
    hs = h_term(x, beta, x.two_s);
    hv = h_term(x, beta, x.two_v);
    hs_all[x.kk] = hs;
    hv_all[x.kk] = hv;
  }
  double a_max = clip(x.amax, 1e-3, 1.0);
  double hi_a = sub(a_max, 1e-4);
  double step = dvd(sub(hi_a, 1e-4), (double)(g - 1));
  if (t == 0) {
    sh.n_brackets = 0;
    ++trips[T_ALPHA];
  }
  __syncthreads();
  // G' on the grid, every (point, client) pair
  for (long long idx = t; idx < (long long)g * kb; idx += nt) {
    int kk = k0 + (int)(idx % kb), i = (int)(idx / kb);
    double cs[4] = {coef[kk], coef[k + kk], coef[2 * k + kk],
                    coef[3 * k + kk]};
    gp[(long long)kk * g + i] = g_prime(x, cs, grid_point(i, g, step, hi_a),
                                        hs_all[kk], hv_all[kk]);
  }
  __syncthreads();
  // the brackets where G' changes sign; the others are +inf
  for (long long idx = t; idx < (long long)(g - 1) * kb; idx += nt) {
    int kk = k0 + (int)(idx % kb), i = (int)(idx / kb);
    const double* row = gp + (long long)kk * g;
    if (signbit(row[i]) != signbit(row[i + 1])) {
      list[atomicAdd(&sh.n_brackets, 1)] = (int)idx;
    } else {
      vals[(long long)kk * (g - 1) + i] = INFINITY;
    }
  }
  __syncthreads();
  // safeguarded Newton in each bracket, one thread a bracket
  const int n = sh.n_brackets;
  const double eps = x.c[C_NEWTON_EPS];
  for (int j = t; j < n; j += nt) {
    int idx = list[j];
    int kk = k0 + idx % kb, i = idx / kb;
    double cs[4] = {coef[kk], coef[k + kk], coef[2 * k + kk],
                    coef[3 * k + kk]};
    double hsk = hs_all[kk], hvk = hv_all[kk];
    double lo = grid_point(i, g, step, hi_a);
    double hi = grid_point(i + 1, g, step, hi_a);
    bool flo_neg = gp[(long long)kk * g + i] < 0.0;
    double xr = mul(0.5, add(lo, hi));
    for (int s = 0; s < a.newton_iters; ++s) {
      double f = g_prime(x, cs, xr, hsk, hvk);
      double fp = dvd(sub(g_prime(x, cs, add(xr, eps), hsk, hvk), f), eps);
      bool same = flo_neg == (f < 0.0);
      if (same) lo = xr; else hi = xr;
      double newton = sub(xr, dvd(f, fp));
      double mid = mul(0.5, add(lo, hi));
      bool good = isfinite(newton) && newton > lo && newton < hi;
      xr = good ? newton : mid;
    }
    double v = g_value(x, cs, xr, hsk, hvk);
    roots[(long long)kk * (g - 1) + i] = xr;
    vals[(long long)kk * (g - 1) + i] = isnan(v) ? INFINITY : v;
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
  double alpha = a_max;
  if (x.client) {
    double best_val = g_value(x, x.cs, a_max, hs, hv);
    const double* v = vals + (long long)x.kk * (g - 1);
    double bv = v[0];
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
struct Surrogate {
  double a, om, beta0, hs0, hv0, hs0p, hv0p;
  double e0[4], cbase[4];
  bool pos[4];
};

__device__ Surrogate make_surrogate(const Ctx& x, double alpha,
                                    double beta0) {
  Surrogate s;
  s.a = clip(alpha, x.c[C_A_EPS], x.c[C_ONE_M_A_EPS]);
  s.om = sub(1.0, s.a);
  s.beta0 = beta0;
  s.hs0 = h_term(x, beta0, x.two_s);
  s.hv0 = h_term(x, beta0, x.two_v);
  s.hs0p = h_prime(x, beta0, x.two_s);
  s.hv0p = h_prime(x, beta0, x.two_v);
  exponents(s.hv0, s.hs0, s.om, s.a, s.e0);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s.cbase[j] = mul(x.cs[j], exp(upto(s.e0[j], x.c[C_EXP_CAP])));
    s.pos[j] = x.cs[j] >= 0.0;
  }
  return s;
}

// surrogate(beta) + lam * beta.  Term j's exponent takes H_v linearized
// and H_s exact where c_j >= 0, H_v exact and H_s linearized where not
// (its supporting line of exp at e0); a division two terms share is made
// once where both take the same side.
__device__ double surrogate(const Ctx& x, const Surrogate& s, double beta,
                            double lam) {
  double hs = h_term(x, beta, x.two_s);
  double hv = h_term(x, beta, x.two_v);
  double dlt = sub(beta, s.beta0);
  double hs_lin = add(s.hs0, mul(s.hs0p, dlt));
  double hv_lin = add(s.hv0, mul(s.hv0p, dlt));
  const bool p0 = s.pos[0], p1 = s.pos[1], p2 = s.pos[2], p3 = s.pos[3];
  // weights (wv, ws): (1, 0), (2, 0), (1, 1), (0, 1)
  double v0 = dvd(p0 ? hv_lin : hv, s.om);
  double v2 = p2 == p0 ? v0 : dvd(p2 ? hv_lin : hv, s.om);
  double v1 = dvd(mul(2.0, p1 ? hv_lin : hv), s.om);
  double v3 = dvd(mul(0.0, p3 ? hv_lin : hv), s.om);
  double s0 = dvd(mul(0.0, p0 ? hs : hs_lin), s.a);
  double s1 = p1 == p0 ? s0 : dvd(mul(0.0, p1 ? hs : hs_lin), s.a);
  double s2 = dvd(p2 ? hs : hs_lin, s.a);
  double s3 = p3 == p2 ? s2 : dvd(p3 ? hs : hs_lin, s.a);
  const double e[4] = {sub(v0, s0), sub(v1, s1), sub(v2, s2), sub(v3, s3)};
  double total = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    double term = s.pos[j]
        ? mul(x.cs[j], exp(upto(e[j], x.c[C_EXP_CAP])))
        : mul(s.cbase[j], sub(add(1.0, e[j]), s.e0[j]));
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
__device__ __forceinline__ void evaluate(const Ctx& y, const Surrogate& s,
                                         const Lane& ln, int lanes, double c,
                                         double d, double lam, bool work,
                                         double& fc, double& fd) {
  if (lanes == 2) {
    double f = 0.0;
    if (work) f = surrogate(y, s, ln.half ? d : c, lam);
    double o = __shfl_xor_sync(0xffffffffu, f, 1);
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
__device__ double golden(Shared& sh, const Args& a, const Ctx& y,
                         const Surrogate& s, const Lane& ln, double lam,
                         bool work, bool tol_exit, int* evals) {
  const int lanes = a.lanes;
  const double gr = y.c[C_GR];
  double lo = y.c[C_BETA_MIN], hi = y.c[C_BETA_MAX];
  double w = mul(gr, sub(hi, lo));
  double c = sub(hi, w), d = add(lo, w);
  double fc = 0.0, fd = 0.0;
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
  return mul(0.5, add(lo, hi));
}

// A golden section on every group with `work`, then each such group's
// ordered sum of mask x beta over its clients (sh.gsum[buf][g]; with
// parts > 1 in the replica's first block, group_sum) and its
// evaluations (sh.gevals[buf][g]).  buf 2 (a final section run on its
// own): group 0 hands its betas to the client threads (sh.vec); buf 0
// or 1 (a speculative round): every group keeps its betas in
// sh.bres[buf] for fetch.
__device__ void section(Shared& sh, const Ctx& y, const Surrogate& s,
                        const Lane& ln, const Args& a, double lam, bool work,
                        int buf, bool tol_exit) {
  const int k = a.k;
  int evals = 0;
  double b = golden(sh, a, y, s, ln, lam, work, tol_exit, &evals);
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
      const double* v = sh.terms + ln.g * k;
      double acc = v[0];
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
    double acc = sh.terms[0];
    for (int i = 1; i < k; ++i) acc = add(acc, sh.terms[i]);
    sh.gsum[buf][0] = acc;
    sh.gevals[buf][0] = evals;
  }
  cl.sync();
}

// group 0's sum of a final section run on its own (buffer 2)
__device__ __forceinline__ double group_sum(Shared& sh, const Args& a) {
  if (a.parts == 1) return sh.gsum[2][0];
  return *cg::this_cluster().map_shared_rank(&sh.gsum[2][0],
                                              (unsigned)head_of(a));
}

// One round of the speculative dual search: the groups gid < n each
// take their price lam; then every thread of the cluster holds every
// group's sum (sh.all) and evaluations (sh.all_evals).  The cluster
// reads a round's sums and betas from buffer `par` while the next round
// writes the other: one cluster barrier a round.  -> the round's buffer.
__device__ int spec_round(Shared& sh, const Ctx& y, const Surrogate& s,
                          const Lane& ln, const Args& a, double lam, int n,
                          bool tol_exit, int& par) {
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
__device__ void fetch(Shared& sh, const Args& a, const Ctx& x, int gid,
                      int buf) {
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

__device__ double sca(Shared& sh, const Ctx& x, const Ctx& y, const Lane& ln,
                      const Args& a, double alpha, double beta0, int* trips,
                      int& par) {
  const int t = threadIdx.x;
  const bool tol_exit = a.early_exit && x.c[C_INNER_TOL] > 0.0;
  const double inner_tol = x.c[C_INNER_TOL];
  const bool counts = t == 0;
  double beta = beta0;
  double prev = objective(sh, a, x, alpha, beta, trips);
  if (x.client) sh.alpha[t] = alpha;
  for (int r = 0; r < 8; ++r) {
    if (counts) ++trips[T_SCA];
    if (x.client) sh.beta[t] = beta;
    __syncthreads();
    Surrogate s;
    if (ln.g >= 0) s = make_surrogate(y, sh.alpha[ln.kk], sh.beta[ln.kk]);
    // The dual bracket (lo, hi).  have: sh.vec holds the client's beta
    // of golden(hi), whose sum is `total` and evaluations `hevals`, so
    // the sequential loop's final section is that one again; pending: it
    // was a price the sequential loop evaluates only there (not yet
    // counted as speculative).
    double hi = 1.0, lo = 0.0, total = 0.0;
    bool have = false, pending = false, dual = true;
    int hevals = 0;
    // Position 0 is lam = 0 (the section that decides whether the dual
    // runs), position 1 + i the grow loop's price p_i (1, x10 by the same
    // multiply; p_30, where 30 steps end, is evaluated only to be the
    // final section): `nodes` positions a round, group j the j-th.
    for (int pos = 0; pos <= GROW_STEPS + 1;) {
      const int n = min(a.nodes, GROW_STEPS + 2 - pos);
      double lam = 0.0;
      if (ln.gid >= 0 && pos + ln.gid >= 1) {
        lam = 1.0;
        for (int j = 1; j < pos + ln.gid; ++j) lam = mul(lam, 10.0);
      }
      const int buf = spec_round(sh, y, s, ln, a, lam, n, tol_exit, par);
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
          if (!(sh.all[0] > 1.0)) {
            dual = false;      // beta(0) meets the constraint
            fetch(sh, a, x, 0, buf);
            stop = true;
          } else if (counts) {
            ++trips[T_DUAL];
          }
          continue;
        }
        // hi is p_{q - 1} here
        if (q - 1 >= GROW_STEPS || !(hi < 1e30)) {
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
        if (!(sh.all[j] > 1.0)) {
          fetch(sh, a, x, j, buf);    // hi = p_{q - 1} stays
          have = stop = true;
          total = sh.all[j];
          hevals = sh.all_evals[j];
          break;
        }
        hi = mul(hi, 10.0);
      }
      if (counts) trips[T_SPEC] += n - used;
      pos += n;
      if (stop) break;
    }
    double b = 0.0;
    if (!dual) {
      b = x.client ? sh.vec[t] : 0.0;
    } else {
      // bisect on the sum constraint, a subtree of midpoints below (lo,
      // hi) a round.  Full: `depth` levels, group j node j + 1 of the
      // heap whose children 2n and 2n + 1 are the brackets after an
      // infeasible (lo = mid) and a feasible (hi = mid) midpoint.  Spine,
      // while the bracket's top is infeasible too and the walk keeps to
      // the infeasible side: L nodes down that side (group i the i-th)
      // and the feasible child of each but the last (group L + i that of
      // node i), 2L - 1 nodes, L levels if the walk keeps to it.
      bool spine = have && total > 1.0;
      for (int step = 0; step < BISECT_STEPS;) {
        if (tol_exit && sub(hi, lo) <= mul(inner_tol, hi)) break;
        const int rem = BISECT_STEPS - step;
        const int levels = spine ? min((a.nodes + 1) / 2, rem)
                                 : min(a.depth, rem);
        const int n = spine ? 2 * levels - 1 : (1 << levels) - 1;
        double l = lo, h = hi;
        if (ln.gid >= 0 && ln.gid < n) {
          if (spine) {
            const bool side = ln.gid >= levels;
            for (int i = side ? ln.gid - levels : ln.gid; i > 0; --i) {
              l = mul(0.5, add(l, h));
            }
            if (side) h = mul(0.5, add(l, h));
          } else {
            int node = ln.gid + 1;
            for (int bit = 30 - __clz(node); bit >= 0; --bit) {
              double m = mul(0.5, add(l, h));
              if ((node >> bit) & 1) h = m; else l = m;
            }
          }
        }
        const int buf = spec_round(sh, y, s, ln, a, mul(0.5, add(l, h)), n,
                                   tol_exit, par);
        int g = 0, lev = 0, last = -1;
        bool stop = false;
        for (; lev < levels && g >= 0; ++lev) {
          if (lev > 0 && tol_exit && sub(hi, lo) <= mul(inner_tol, hi)) {
            stop = true;
            break;
          }
          if (counts) {
            ++trips[T_BISECT];
            ++trips[T_GOLDEN];
            trips[T_EVAL] += sh.all_evals[g];
          }
          double mid = mul(0.5, add(lo, hi));
          const bool infeasible = sh.all[g] > 1.0;
          if (infeasible) lo = mid; else hi = mid;
          if (!infeasible) last = g;
          if (!spine) {
            g = 2 * g + (infeasible ? 1 : 2);
          } else if (g + 1 >= levels) {
            g = -1;      // a feasible child or the spine's end: a leaf
          } else {
            g = infeasible ? g + 1 : levels + g;
          }
        }
        if (last >= 0) {
          // hi moved to node last's price
          fetch(sh, a, x, last, buf);
          if (counts && pending) ++trips[T_SPEC];
          have = true;
          pending = false;
          total = sh.all[last];
          hevals = sh.all_evals[last];
        }
        if (counts) trips[T_SPEC] += n - lev;
        step += lev;
        if (stop) break;
        spine = last < 0 && lev == levels;
      }
      if (!have) {
        section(sh, y, s, ln, a, hi, ln.g == 0, 2, tol_exit);
        total = group_sum(sh, a);
        hevals = sh.gevals[2][0];
      }
      if (counts) {
        ++trips[T_GOLDEN];
        trips[T_EVAL] += hevals;
      }
      b = x.client ? sh.vec[t] : 0.0;
      b = mul(b, upto(dvd(1.0, atleast(total, 1e-12)), 1.0));
    }
    // MM guarantee: only accept descent on the true objective
    double cur = objective(sh, a, x, alpha, b, trips);
    if (cur <= prev) beta = b;
    bool conv = fabs(sub(prev, cur))
                <= mul(x.c[C_SCA_TOL], add(1.0, fabs(prev)));
    prev = nan_min(prev, cur);
    if (conv) break;
  }
  return beta;
}

// ---------------------------------------------------------------------------
// §IV-D: log-barrier + projected gradient descent
// ---------------------------------------------------------------------------

__device__ double g_dbeta(const Ctx& x, double a, double om, double b) {
  double hs = h_term(x, b, x.two_s), hv = h_term(x, b, x.two_v);
  double hsp = h_prime(x, b, x.two_s), hvp = h_prime(x, b, x.two_v);
  double e[4], de[4];
  exponents(hv, hs, om, a, e);
  exponents(hvp, hsp, om, a, de);
  double out = 0.0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out = add(out, mul(mul(x.cs[j], exp(upto(e[j], x.c[C_EXP_CAP]))), de[j]));
  }
  return out;
}

__device__ double barrier(Shared& sh, const Ctx& x, const Args& args,
                          double alpha, double beta0, int* trips) {
  const double inner_tol = x.c[C_INNER_TOL];
  double beta = atleast(beta0, 1e-4);
  double s = msum(sh, args, x, beta);
  if (s >= 1.0) beta = mul(dvd(beta, s), 0.95);
  double a = clip(alpha, x.c[C_A_EPS], x.c[C_ONE_M_A_EPS]);
  double om = sub(1.0, a);
  double mu = 10.0;
  for (int stage = 0; stage < 5; ++stage, mu = mul(mu, 10.0)) {
    double inv = dvd(1.0, mul(mu, x.c[C_LN10]));
    for (int it = 0; it < 200; ++it) {
      if (threadIdx.x == 0) ++trips[T_BARRIER];
      double slack = sub(1.0, msum(sh, args, x, beta));
      double grad = 0.0;
      if (x.client) {
        grad = sub(g_dbeta(x, a, om, beta),
                   mul(inv, sub(sub(dvd(1.0, beta), dvd(1.0, sub(1.0, beta))),
                                dvd(1.0, slack))));
        grad = mul(grad, x.m);        // pads hold their start point
      }
      double gn = sqrt(psum(sh, args, x, mul(grad, grad)));
      double step = dvd(x.c[C_LR], add(1.0, gn));
      // feasibility backtracking: 27 halvings reach t <= 1e-8
      double t = 1.0;
      double nw = sub(beta, mul(step, grad));
      for (int bt = 0; bt < 27; ++bt) {
        bool infeas = vote(sh, args, x.client && (nw <= 0.0 || nw >= 1.0),
                           true);
        if (!infeas) infeas = msum(sh, args, x, nw) >= 1.0;
        if (!(infeas && t > 1e-8)) break;
        if (threadIdx.x == 0) ++trips[T_BACKTRACK];
        t = mul(0.5, t);
        nw = sub(beta, mul(mul(t, step), grad));
      }
      bool give_up = gn < 1e-14 || t <= 1e-8;
      // inner_tol = 0 stops only at an exact fixed point (absorbing)
      bool stalled = vote(sh, args,
                          !x.client || fabs(sub(nw, beta)) <= inner_tol,
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

__global__ void __launch_bounds__(BLOCK, 1) alloc_solve_kernel(const Args a) {
  __shared__ Shared sh;
  __shared__ int trip_sh[N_TRIPS];
  __shared__ double consts[N_CONSTS];
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
  const Ctx x = load_ctx(a, consts, b, part * BLOCK + t);
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
  const Ctx y = load_ctx(a, consts, b, a.parts > 1 ? part * BLOCK + t
                                       : (ln.has ? ln.kk : k));
  const long long row = (long long)b * k;
  double* scr = a.scratch + (long long)b * scratch_doubles(k, a.n_grid);
  int* brackets = a.brackets + (long long)b * (a.n_grid - 1) * k;
  __syncthreads();

  int method = a.method;
  if (method != UNIFORM && a.gate != nullptr && !(a.gate[b] > 0.0)) {
    method = UNIFORM;   // no compensation history yet (round 0)
  }
  // the uniform point: alpha 1/2, beta = mask / sum(mask)
  const double alpha_u = 0.5;
  const double beta_u = dvd(x.m, psum(sh, a, x, x.m));
  const double uniform_obj = objective(sh, a, x, alpha_u, beta_u, trips);

  double alpha = alpha_u, beta = beta_u, prev = INFINITY;
  bool done = false, bad_seen = false;
  int iters = 0, ran = 0, par = 0;
  double* objs = a.objectives + (long long)b * a.max_iters;
  if (method != UNIFORM) {
    for (int i = 0; i < a.max_iters && !done; ++i, ++ran) {
      if (t == 0) ++trips[T_OUTER];
      double alpha_n = 0.0;
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
      double beta_n = method == BARRIER
          ? barrier(sh, x, a, alpha_n, beta, trips)
          : sca(sh, x, y, ln, a, alpha_n, beta, trips, par);
      double obj = objective(sh, a, x, alpha_n, beta_n, trips);
      // a non-finite iterate must not poison the carry
      bool bad = !isfinite(obj);
      bool conv = fabs(sub(prev, obj))
                  <= mul(x.c[C_TOL], add(1.0, fabs(obj)));
      if (!bad) {
        alpha = alpha_n;
        beta = beta_n;
        prev = obj;
        iters = i + 1;
      }
      if (t == 0 && rank == 0) objs[i] = bad ? NAN : obj;
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
    for (int i = ran; i < a.max_iters; ++i) objs[i] = NAN;
    a.objective[b] = prev;
    a.iters[b] = iters;
    a.exit_reason[b] = reason;
  }
  if (rep == 0 && x.client) {
    double hs = h_term(x, beta, x.two_s), hv = h_term(x, beta, x.two_v);
    double lf = x.c[C_LOG_FLOOR];
    a.alpha[row + x.kk] = alpha;
    a.beta[row + x.kk] = beta;
    a.q[row + x.kk] = alpha > 0.0
        ? exp(atleast(dvd(hs, clip(alpha, 1e-12, 1.0)), lf)) : 0.0;
    a.p[row + x.kk] = alpha < 1.0
        ? exp(atleast(dvd(hv, clip(sub(1.0, alpha), 1e-12, 1.0)), lf))
        : 0.0;
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
// card and size; 0: none).
static int cluster_capacity(int dev, int c) {
  constexpr int MAX_DEVICES = 16;
  static int known[MAX_DEVICES][MAX_CLUSTER + 1] = {};   // capacity + 1
  int* slot = dev < MAX_DEVICES ? &known[dev][c] : nullptr;
  if (slot != nullptr && *slot > 0) return *slot - 1;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(1, c, 0, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, alloc_solve_kernel, &cfg)
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
static Layout layout_of(int nb, int k, int method) {
  const int parts = (k + BLOCK - 1) / BLOCK;
  int replicas = 1;
  if (method == ALTERNATING) {
    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    // clusters above 8 blocks: Hopper runs 16 when the kernel allows it
    cudaFuncSetAttribute(alloc_solve_kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    replicas = sms / (nb * parts);
    if (replicas > MAX_CLUSTER / parts) replicas = MAX_CLUSTER / parts;
    while (replicas > 1 && cluster_capacity(dev, replicas * parts) < nb) {
      --replicas;
    }
    if (replicas < 1) replicas = 1;
  }
  return block_layout(k, replicas);
}

// -> {threads, lanes, groups, parts, cluster, nodes, depth} of a launch
extern "C" int alloc_solve_layout(int nb, int k, int method, int* out) {
  if (nb <= 0 || k < 1 || k > MAX_K) return (int)cudaErrorInvalidValue;
  Layout l = layout_of(nb, k, method);
  const int v[N_LAYOUT] = {l.threads, l.lanes, l.groups, l.parts,
                           l.cluster, l.nodes, l.depth};
  for (int i = 0; i < N_LAYOUT; ++i) out[i] = v[i];
  return (int)cudaSuccess;
}

static int launch(const Args& a, int nb, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(nb, a.cluster, stream, attr);
  cudaError_t err = cudaLaunchKernelEx(&cfg, alloc_solve_kernel, a);
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
  if (nb <= 0) return 0;
  if (k < 1 || k > MAX_K || n_grid < 2 || max_iters < 0
      || max_iters > MAX_ITERS || newton_iters < 0 || method < UNIFORM
      || method > BARRIER) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{coef, gains, p_w, mask, scal, gate, scratch, brackets, alpha, beta,
         q, p, objective, iters, objectives, exit_reason, trips};
  for (int i = 0; i < N_CONSTS; ++i) a.c[i] = consts[i];
  a.k = k;
  a.method = method;
  a.max_iters = max_iters;
  a.n_grid = n_grid;
  a.newton_iters = newton_iters;
  a.early_exit = early_exit;
  const Layout l = layout_of(nb, k, method);
  a.lanes = l.lanes;
  a.groups = l.groups;
  a.parts = l.parts;
  a.cluster = l.cluster;
  a.nodes = l.nodes;
  a.depth = l.depth;
  return launch(a, nb, stream);
}
