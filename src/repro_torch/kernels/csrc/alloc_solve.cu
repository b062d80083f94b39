// The eq. (28) bandwidth/power allocation of a batch of problems, the
// whole Algorithm 1 in one launch: one thread block per problem.
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
// latency of a step, and one warp's worth of clients leaves the rest of
// the card idle.
//
// Design (a simple kernel that is right; speed comes later):
// - One block per problem, so a batch equals a loop of single solves by
//   construction.  One thread per client (K <= MAX_K) runs the golden
//   section, the SCA and the barrier steps, c and d side by side in
//   registers; the block has at least MIN_THREADS threads, over which
//   optimize_alpha spreads the grid's G' values and the Newton chains of
//   the brackets where G' changes sign (the plain version runs every
//   bracket and masks the others to +inf afterwards; the first-index
//   argmin is the same).
// - Ordered sums: each client writes its term to shared memory and one
//   thread adds them left to right (pads multiplied by the mask), as the
//   plain version's _ordered_sum does; the block reads the result back,
//   so every thread takes the same branches.  Votes over the clients
//   (the tolerance exits, the barrier's feasibility) are
//   __syncthreads_and / _or.
// - Rounding: every add, multiply and divide is a rounded intrinsic, so
//   no FMA is contracted that the plain version does not make; exp, pow
//   and sqrt are CUDA's float64 functions, which PyTorch's float64 exp,
//   pow and sqrt call on the card.
// - Loops leave once their done flag is set: the plain version's frozen
//   trips change nothing, so this is the same function at any
//   early_exit; early_exit only switches the tolerance exits (inner_tol)
//   on, as there.
// - Scratch (global, per problem): the grid's G', the brackets' list,
//   their roots and values, and H_s, H_v of the clients.  trips (if not
//   null) counts the work done, for the bound.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

constexpr int MAX_K = 1024;        // clients per problem: one thread each
constexpr int MIN_THREADS = 256;   // threads per block at small K
constexpr int MAX_ITERS = 64;      // outer iterations of one solve
constexpr int N_CONSTS = 16;
constexpr int N_TRIPS = 13;

enum { UNIFORM = 0, ALTERNATING = 1, BARRIER = 2 };
enum { EXIT_CONVERGED = 0, EXIT_ITER_CAP = 1, EXIT_NONFINITE = 2,
       EXIT_UNIFORM_FALLBACK = 3 };
// trip counters, per problem
enum { T_OUTER, T_ALPHA, T_CHAINS, T_NEWTON, T_SCA, T_DUAL, T_GROW,
       T_BISECT, T_GOLDEN, T_EVAL, T_BARRIER, T_BACKTRACK, T_OBJECTIVE };
// the solver's constants, in the order the wrapper passes them
enum { C_EXP_CAP, C_POW_CAP, C_H_FLOOR, C_LOG_FLOOR, C_NEWTON_EPS, C_A_EPS,
       C_ONE_M_A_EPS, C_BETA_MIN, C_BETA_MAX, C_GR, C_LN2, C_LN10, C_TOL,
       C_INNER_TOL, C_SCA_TOL, C_LR };

// eq. (27)'s four terms: weight on H_v / (1 - a), weight on -H_s / a
__constant__ double W_V[4] = {1.0, 2.0, 1.0, 0.0};
__constant__ double W_S[4] = {0.0, 0.0, 1.0, 1.0};

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
};

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

// What a thread knows of its problem and (if it has one) its client.
struct Ctx {
  const double* c;         // constants
  double two_s, two_v;     // 2 l and 2 (l b + b0)
  double bw, noise, lat, amax;
  double cs[4];            // the client's A, B, C, D
  double cap_c;            // 4 p_w gain
  double m;                // mask
  bool client;             // threadIdx.x < K
};

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

// The block's shared state: the ordered sum's terms and its result.
struct Shared {
  double terms[MAX_K];
  double result;
  int n_brackets;
};

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

__device__ __forceinline__ double msum(Shared& sh, const Ctx& x, double v,
                                       int k) {
  return ordered_sum(sh, mul(v, x.m), k);
}

// sum_k G(alpha_k, beta_k) over the real clients
__device__ double objective(Shared& sh, const Ctx& x, double alpha,
                            double beta, int k, int* trips) {
  double g = 0.0;
  if (x.client) {
    g = g_value(x, x.cs, alpha, h_term(x, beta, x.two_s),
                h_term(x, beta, x.two_v));
  }
  if (threadIdx.x == 0) ++trips[T_OBJECTIVE];
  return msum(sh, x, g, k);
}

// ---------------------------------------------------------------------------
// optimize_alpha: Lemma 3
// ---------------------------------------------------------------------------

__device__ __forceinline__ double grid_point(int i, int g, double step,
                                             double hi_a) {
  return i == g - 1 ? hi_a : add(1e-4, mul((double)i, step));
}

__device__ double optimize_alpha(Shared& sh, const Ctx& x, const Args& a,
                                 double beta, double* scr, int* brackets,
                                 int* trips) {
  const int k = a.k, g = a.n_grid, t = threadIdx.x, nt = blockDim.x;
  double* gp = scr;                       // (K, G)
  double* roots = gp + (long long)k * g;  // (K, G - 1)
  double* vals = roots + (long long)k * (g - 1);
  double* hs_all = vals + (long long)k * (g - 1);
  double* hv_all = hs_all + k;
  const double* coef = a.coef + (long long)blockIdx.x * 4 * k;
  double hs = 0.0, hv = 0.0;
  if (x.client) {
    hs = h_term(x, beta, x.two_s);
    hv = h_term(x, beta, x.two_v);
    hs_all[t] = hs;
    hv_all[t] = hv;
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
  for (long long idx = t; idx < (long long)g * k; idx += nt) {
    int kk = (int)(idx % k), i = (int)(idx / k);
    double cs[4] = {coef[kk], coef[k + kk], coef[2 * k + kk],
                    coef[3 * k + kk]};
    gp[(long long)kk * g + i] = g_prime(x, cs, grid_point(i, g, step, hi_a),
                                        hs_all[kk], hv_all[kk]);
  }
  __syncthreads();
  // the brackets where G' changes sign; the others are +inf
  for (long long idx = t; idx < (long long)(g - 1) * k; idx += nt) {
    int kk = (int)(idx % k), i = (int)(idx / k);
    const double* row = gp + (long long)kk * g;
    if (signbit(row[i]) != signbit(row[i + 1])) {
      brackets[atomicAdd(&sh.n_brackets, 1)] = (int)idx;
    } else {
      vals[(long long)kk * (g - 1) + i] = INFINITY;
    }
  }
  __syncthreads();
  // safeguarded Newton in each bracket, one thread a bracket
  const int n = sh.n_brackets;
  const double eps = x.c[C_NEWTON_EPS];
  for (int j = t; j < n; j += nt) {
    int idx = brackets[j];
    int kk = idx % k, i = idx / k;
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
    trips[T_CHAINS] += n;
    trips[T_NEWTON] += n * a.newton_iters;
  }
  __syncthreads();
  // per client: the first-index argmin over the brackets, against the
  // boundary alpha_max
  double alpha = a_max;
  if (x.client) {
    double best_val = g_value(x, x.cs, a_max, hs, hv);
    const double* v = vals + (long long)t * (g - 1);
    double bv = v[0];
    int bi = 0;
    for (int i = 1; i < g - 1; ++i) {
      if (v[i] < bv) {
        bv = v[i];
        bi = i;
      }
    }
    if (bv < best_val) alpha = roots[(long long)t * (g - 1) + bi];
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
  for (int j = 0; j < 4; ++j) {
    s.e0[j] = sub(dvd(mul(W_V[j], s.hv0), s.om), dvd(mul(W_S[j], s.hs0), s.a));
    s.cbase[j] = mul(x.cs[j], exp(upto(s.e0[j], x.c[C_EXP_CAP])));
    s.pos[j] = x.cs[j] >= 0.0;
  }
  return s;
}

// surrogate(beta) + lam * beta
__device__ double surrogate(const Ctx& x, const Surrogate& s, double beta,
                            double lam) {
  double hs = h_term(x, beta, x.two_s);
  double hv = h_term(x, beta, x.two_v);
  double dlt = sub(beta, s.beta0);
  double hs_lin = add(s.hs0, mul(s.hs0p, dlt));
  double hv_lin = add(s.hv0, mul(s.hv0p, dlt));
  double total = 0.0;
  for (int j = 0; j < 4; ++j) {
    double term;
    if (s.pos[j]) {
      double e = sub(dvd(mul(W_V[j], hv_lin), s.om),
                     dvd(mul(W_S[j], hs), s.a));
      term = mul(x.cs[j], exp(upto(e, x.c[C_EXP_CAP])));
    } else {
      double e = sub(dvd(mul(W_V[j], hv), s.om),
                     dvd(mul(W_S[j], hs_lin), s.a));
      term = mul(s.cbase[j], sub(add(1.0, e), s.e0[j]));
    }
    total = add(total, term);
  }
  return add(total, mul(lam, beta));
}

// Golden section on [BETA_MIN, BETA_MAX] of the client's surrogate at
// dual price lam (every thread calls it; the clients compute).
__device__ double golden(const Ctx& x, const Surrogate& s, double lam,
                         bool tol_exit, int k, int* trips) {
  const double gr = x.c[C_GR];
  double lo = x.c[C_BETA_MIN], hi = x.c[C_BETA_MAX];
  double w = mul(gr, sub(hi, lo));
  double c = sub(hi, w), d = add(lo, w);
  double fc = 0.0, fd = 0.0;
  if (x.client) {
    fc = surrogate(x, s, c, lam);
    fd = surrogate(x, s, d, lam);
  }
  int evals = 1;
  for (int it = 0; it < 48; ++it) {
    if (tol_exit && __syncthreads_and(!x.client
                                      || sub(hi, lo) <= x.c[C_INNER_TOL])) {
      break;
    }
    if (fc < fd) hi = d; else lo = c;
    w = mul(gr, sub(hi, lo));
    c = sub(hi, w);
    d = add(lo, w);
    // the last step's evaluations are never read
    if (it + 1 < 48) {
      if (x.client) {
        fc = surrogate(x, s, c, lam);
        fd = surrogate(x, s, d, lam);
      }
      ++evals;
    }
  }
  if (threadIdx.x == 0) {
    ++trips[T_GOLDEN];
    trips[T_EVAL] += evals;
  }
  return mul(0.5, add(lo, hi));
}

__device__ double sca(Shared& sh, const Ctx& x, const Args& a, double alpha,
                      double beta0, int* trips) {
  const int k = a.k;
  const bool tol_exit = a.early_exit && x.c[C_INNER_TOL] > 0.0;
  double beta = beta0;
  double prev = objective(sh, x, alpha, beta, k, trips);
  for (int r = 0; r < 8; ++r) {
    if (threadIdx.x == 0) ++trips[T_SCA];
    Surrogate s;
    if (x.client) s = make_surrogate(x, alpha, beta);
    double b = golden(x, s, 0.0, tol_exit, k, trips);
    if (msum(sh, x, b, k) > 1.0) {
      if (threadIdx.x == 0) ++trips[T_DUAL];
      // grow the upper price x10 from 1 (30 steps reach 1e30) ...
      double hi = 1.0;
      for (int t = 0; t < 30; ++t) {
        if (!(hi < 1e30)) break;
        if (threadIdx.x == 0) ++trips[T_GROW];
        if (!(msum(sh, x, golden(x, s, hi, tol_exit, k, trips), k) > 1.0)) {
          break;
        }
        hi = mul(hi, 10.0);
      }
      // ... then bisect on the sum constraint
      double lo = 0.0;
      for (int t = 0; t < 60; ++t) {
        if (tol_exit && sub(hi, lo) <= mul(x.c[C_INNER_TOL], hi)) break;
        if (threadIdx.x == 0) ++trips[T_BISECT];
        double mid = mul(0.5, add(lo, hi));
        if (msum(sh, x, golden(x, s, mid, tol_exit, k, trips), k) > 1.0) {
          lo = mid;
        } else {
          hi = mid;
        }
      }
      b = golden(x, s, hi, tol_exit, k, trips);
      double total = msum(sh, x, b, k);
      b = mul(b, upto(dvd(1.0, atleast(total, 1e-12)), 1.0));
    }
    // MM guarantee: only accept descent on the true objective
    double cur = objective(sh, x, alpha, b, k, trips);
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
  double out = 0.0;
  for (int j = 0; j < 4; ++j) {
    double e = sub(dvd(mul(W_V[j], hv), om), dvd(mul(W_S[j], hs), a));
    double de = sub(dvd(mul(W_V[j], hvp), om), dvd(mul(W_S[j], hsp), a));
    out = add(out, mul(mul(x.cs[j], exp(upto(e, x.c[C_EXP_CAP]))), de));
  }
  return out;
}

__device__ double barrier(Shared& sh, const Ctx& x, const Args& args,
                          double alpha, double beta0, int* trips) {
  const int k = args.k;
  const double inner_tol = x.c[C_INNER_TOL];
  double beta = atleast(beta0, 1e-4);
  double s = msum(sh, x, beta, k);
  if (s >= 1.0) beta = mul(dvd(beta, s), 0.95);
  double a = clip(alpha, x.c[C_A_EPS], x.c[C_ONE_M_A_EPS]);
  double om = sub(1.0, a);
  double mu = 10.0;
  for (int stage = 0; stage < 5; ++stage, mu = mul(mu, 10.0)) {
    double inv = dvd(1.0, mul(mu, x.c[C_LN10]));
    for (int it = 0; it < 200; ++it) {
      if (threadIdx.x == 0) ++trips[T_BARRIER];
      double slack = sub(1.0, msum(sh, x, beta, k));
      double grad = 0.0;
      if (x.client) {
        grad = sub(g_dbeta(x, a, om, beta),
                   mul(inv, sub(sub(dvd(1.0, beta), dvd(1.0, sub(1.0, beta))),
                                dvd(1.0, slack))));
        grad = mul(grad, x.m);        // pads hold their start point
      }
      double gn = sqrt(ordered_sum(sh, mul(grad, grad), k));
      double step = dvd(x.c[C_LR], add(1.0, gn));
      // feasibility backtracking: 27 halvings reach t <= 1e-8
      double t = 1.0;
      double nw = sub(beta, mul(step, grad));
      for (int bt = 0; bt < 27; ++bt) {
        bool infeas = __syncthreads_or(x.client && (nw <= 0.0 || nw >= 1.0));
        if (!infeas) infeas = msum(sh, x, nw, k) >= 1.0;
        if (!(infeas && t > 1e-8)) break;
        if (threadIdx.x == 0) ++trips[T_BACKTRACK];
        t = mul(0.5, t);
        nw = sub(beta, mul(mul(t, step), grad));
      }
      bool give_up = gn < 1e-14 || t <= 1e-8;
      // inner_tol = 0 stops only at an exact fixed point (absorbing)
      bool stalled = __syncthreads_and(!x.client
                                       || fabs(sub(nw, beta)) <= inner_tol);
      if (!give_up) beta = nw;
      if (give_up || stalled) break;
    }
  }
  return beta;
}

// ---------------------------------------------------------------------------
// Algorithm 1
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(1024) alloc_solve_kernel(const Args a) {
  __shared__ Shared sh;
  __shared__ int trip_sh[N_TRIPS];
  __shared__ double consts[N_CONSTS];
  const int b = blockIdx.x, t = threadIdx.x, k = a.k;
  int* trips = trip_sh;
  if (t < N_TRIPS) trip_sh[t] = 0;
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < N_CONSTS; ++i) consts[i] = a.c[i];
  }

  Ctx x;
  x.c = consts;
  const double* sc = a.scal + (long long)b * 6;
  x.two_s = mul(2.0, sc[0]);
  x.two_v = mul(2.0, sc[1]);
  x.bw = sc[2];
  x.noise = sc[3];
  x.lat = sc[4];
  x.amax = sc[5];
  x.client = t < k;
  const long long row = (long long)b * k;
  if (x.client) {
    const double* coef = a.coef + row * 4;
    for (int j = 0; j < 4; ++j) x.cs[j] = coef[(long long)j * k + t];
    x.cap_c = mul(mul(4.0, a.p_w[row + t]), a.gains[row + t]);
    x.m = a.mask[row + t];
  } else {
    for (int j = 0; j < 4; ++j) x.cs[j] = 0.0;
    x.cap_c = 1.0;
    x.m = 0.0;
  }
  double* scr = a.scratch + (long long)b * scratch_doubles(k, a.n_grid);
  int* brackets = a.brackets + (long long)b * (a.n_grid - 1) * k;
  __syncthreads();

  int method = a.method;
  if (method != UNIFORM && a.gate != nullptr && !(a.gate[b] > 0.0)) {
    method = UNIFORM;   // no compensation history yet (round 0)
  }
  // the uniform point: alpha 1/2, beta = mask / sum(mask)
  const double alpha_u = 0.5;
  const double beta_u = dvd(x.m, ordered_sum(sh, x.m, k));
  const double uniform_obj = objective(sh, x, alpha_u, beta_u, k, trips);

  double alpha = alpha_u, beta = beta_u, prev = INFINITY;
  bool done = false, bad_seen = false;
  int iters = 0, ran = 0;
  double* objs = a.objectives + (long long)b * a.max_iters;
  if (method != UNIFORM) {
    for (int i = 0; i < a.max_iters && !done; ++i, ++ran) {
      if (t == 0) ++trips[T_OUTER];
      double alpha_n = optimize_alpha(sh, x, a, beta, scr, brackets, trips);
      double beta_n = method == BARRIER
          ? barrier(sh, x, a, alpha_n, beta, trips)
          : sca(sh, x, a, alpha_n, beta, trips);
      double obj = objective(sh, x, alpha_n, beta_n, k, trips);
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
      if (t == 0) objs[i] = bad ? NAN : obj;
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
  if (t == 0) {
    for (int i = ran; i < a.max_iters; ++i) objs[i] = NAN;
    a.objective[b] = prev;
    a.iters[b] = iters;
    a.exit_reason[b] = reason;
  }
  if (x.client) {
    double hs = h_term(x, beta, x.two_s), hv = h_term(x, beta, x.two_v);
    double lf = x.c[C_LOG_FLOOR];
    a.alpha[row + t] = alpha;
    a.beta[row + t] = beta;
    a.q[row + t] = alpha > 0.0
        ? exp(atleast(dvd(hs, clip(alpha, 1e-12, 1.0)), lf)) : 0.0;
    a.p[row + t] = alpha < 1.0
        ? exp(atleast(dvd(hv, clip(sub(1.0, alpha), 1e-12, 1.0)), lf)) : 0.0;
  }
  __syncthreads();
  if (a.trips != nullptr && t < N_TRIPS) {
    a.trips[(long long)b * N_TRIPS + t] = trip_sh[t];
  }
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
  int threads = k <= MIN_THREADS ? MIN_THREADS : (k + 31) / 32 * 32;
  alloc_solve_kernel<<<nb, threads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
