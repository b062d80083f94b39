"""Hierarchical resource allocation — paper §IV (Algorithm 1) + §IV-D
(the port's own NumPy float64 copy of ``repro.core.allocation``).

Per round the PS solves eq. (28):

    minimize_{alpha, beta}  sum_k G(alpha_k, beta_k)
    s.t.  0 <= alpha_k <= 1,  0 <= beta_k < 1,  sum_k beta_k <= 1

by alternating optimization:

* **Power split alpha** (Lemma 3): the per-client scalars decouple; we
  bracket every root of G'(alpha) = 0 on (0, 1) by a sign-change scan,
  polish with safeguarded Newton–Raphson (the paper's method), and pick the
  argmin among the stationary points and the boundary alpha = 1.
* **Bandwidth beta** (§IV-B): the paper's SCA with auxiliary variables and
  a CVX call is realized here as an equivalent majorize–minimize scheme —
  every positive-coefficient term keeps its exact convex structure with the
  concave H_v linearized (paper eq. (41)/(43)), every negative-coefficient
  term is upper-bounded by the supporting line of exp (the t/y/z-variable
  relaxations (45)/(47) collapse to exactly this once the aux variables are
  eliminated at their optima).  The resulting separable convex surrogate is
  solved to optimality by dual bisection on the sum-bandwidth constraint
  with per-client golden-section minimization — no external solver needed
  (DESIGN.md §5 deviation 2).
* **Low-complexity variant** (§IV-D, eq. (49)): log-barrier (interior
  penalty) + projected gradient descent with analytic dG/dbeta, O(K m).

All host-side float64 NumPy (it runs between jitted training rounds on
per-client scalars, K ~ tens).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple, Tuple

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.core import alloc_common as AC
from repro_torch.core.convergence import (
    EXP_CAP, GCoefficients, g_prime_alpha, g_value,
)

# closed-form constants live in alloc_common (shared with the JAX engine);
# re-exported here for existing importers
BETA_MIN = AC.BETA_MIN
BETA_MAX = AC.BETA_MAX
_TERM_W = AC.TERM_W


# ---------------------------------------------------------------------------
# H terms and derivatives (float64, overflow-guarded) — thin np wrappers
# around the backend-agnostic closed forms in alloc_common
# ---------------------------------------------------------------------------

def _h(beta, p_w, gain, n_bits, fl: FLConfig):
    return AC.h_term(np, np.asarray(beta, np.float64), p_w, gain, n_bits,
                     fl.bandwidth_hz, fl.noise_psd_w, fl.latency_s)


def _h_prime(beta, p_w, gain, n_bits, fl: FLConfig):
    """dH/dbeta, cf. paper eq. (42)/(46)."""
    return AC.h_term_prime(np, np.asarray(beta, np.float64), p_w, gain,
                           n_bits, fl.bandwidth_hz, fl.noise_psd_w,
                           fl.latency_s)


@dataclass(frozen=True)
class AllocationProblem:
    coef: GCoefficients          # per-client A, B, C, D
    gains: np.ndarray            # (K,) large-scale channel gains d^-zeta
    p_w: np.ndarray              # (K,) power budgets
    dim: int                     # gradient dimension l
    fl: FLConfig

    @property
    def n(self) -> int:
        return len(self.gains)

    # packet sizes as cached_property, not property: h_s/h_v sit inside
    # the SCA surrogate's golden-section inner loop (~2 evals/iteration
    # x 48 iterations x K clients x dual-bisection steps), so the bit
    # counts are computed once per problem instead of once per eval
    # (cached_property writes the instance __dict__ directly, which a
    # frozen dataclass permits)
    @cached_property
    def sign_bits(self) -> float:
        return float(self.dim)

    @cached_property
    def mod_bits(self) -> float:
        return float(self.dim * self.fl.quant_bits + self.fl.b0_bits)

    def h_s(self, beta):
        return _h(beta, self.p_w, self.gains, self.sign_bits, self.fl)

    def h_v(self, beta):
        return _h(beta, self.p_w, self.gains, self.mod_bits, self.fl)

    def h_s_prime(self, beta):
        return _h_prime(beta, self.p_w, self.gains, self.sign_bits, self.fl)

    def h_v_prime(self, beta):
        return _h_prime(beta, self.p_w, self.gains, self.mod_bits, self.fl)

    def g(self, alpha, beta):
        return g_value(self.coef, alpha, self.h_s(beta), self.h_v(beta))

    def objective(self, alpha, beta) -> float:
        return float(np.sum(self.g(alpha, beta)))


class Allocation(NamedTuple):
    alpha: np.ndarray
    beta: np.ndarray
    q: np.ndarray                # sign-packet success probs
    p: np.ndarray                # modulus-packet success probs
    objective: float
    info: dict


def success_probs_np(prob: AllocationProblem, alpha, beta):
    a = np.asarray(alpha, np.float64)
    return AC.success_probs(np, a, prob.h_s(beta), prob.h_v(beta))


# ---------------------------------------------------------------------------
# power split (Lemma 3): per-client 1-D stationary points + boundary
# ---------------------------------------------------------------------------

def optimize_alpha(prob: AllocationProblem, beta: np.ndarray,
                   n_grid: int = 256, newton_iters: int = 40) -> np.ndarray:
    h_s, h_v = prob.h_s(beta), prob.h_v(beta)
    K = prob.n
    a_max = min(max(prob.fl.alpha_max, 1e-3), 1.0)
    grid = np.linspace(1e-4, a_max - 1e-4, n_grid)

    # evaluate G' on the grid: (n_grid, K)
    gp_grid = np.stack([
        g_prime_alpha(prob.coef, np.full(K, a), h_s, h_v) for a in grid])
    best_alpha = np.full(K, a_max)
    best_val = g_value(prob.coef, best_alpha, h_s, h_v)

    # collect every sign-change bracket across all clients, solve them with
    # one vectorized safeguarded Newton–Raphson (the paper's Lemma 3 roots)
    sign_change = np.signbit(gp_grid[:-1]) != np.signbit(gp_grid[1:])
    idx_i, idx_k = np.nonzero(sign_change)
    if idx_k.size:
        lo = grid[idx_i].copy()
        hi = grid[idx_i + 1].copy()
        coef_b = GCoefficients(*(c[idx_k] for c in prob.coef))
        hs_b, hv_b = h_s[idx_k], h_v[idx_k]
        flo = gp_grid[idx_i, idx_k]
        x = 0.5 * (lo + hi)
        eps = 1e-8
        for _ in range(newton_iters):
            f = g_prime_alpha(coef_b, x, hs_b, hv_b)
            fp = (g_prime_alpha(coef_b, x + eps, hs_b, hv_b) - f) / eps
            same = (flo < 0) == (f < 0)
            lo = np.where(same, x, lo)
            hi = np.where(same, hi, x)
            with np.errstate(divide='ignore', invalid='ignore'):
                newton = x - f / fp
            mid = 0.5 * (lo + hi)
            good = np.isfinite(newton) & (newton > lo) & (newton < hi)
            x = np.where(good, newton, mid)
        vals = g_value(coef_b, x, hs_b, hv_b)
        for j in range(idx_k.size):      # keep best stationary point per k
            k = idx_k[j]
            if vals[j] < best_val[k]:
                best_val[k] = vals[j]
                best_alpha[k] = x[j]
    return best_alpha


# ---------------------------------------------------------------------------
# bandwidth via SCA / majorize-minimize + dual bisection
# ---------------------------------------------------------------------------

def _surrogate_factory(prob: AllocationProblem, alpha: np.ndarray,
                       beta0: np.ndarray):
    """Build per-client convex majorants of G(alpha_k, ·) around beta0.

    Returns a VECTORIZED callable: surrogate(beta (K,)) -> values (K,).
    """
    a = np.clip(alpha, 1e-12, 1 - 1e-12)
    om = 1.0 - a
    hs0, hv0 = prob.h_s(beta0), prob.h_v(beta0)
    hs0p, hv0p = prob.h_s_prime(beta0), prob.h_v_prime(beta0)
    coef = prob.coef
    cs = (coef.A, coef.B, coef.C, coef.D)
    # exponents at beta0
    e0 = [wv * hv0 / om - ws * hs0 / a for wv, ws in _TERM_W]

    def surrogate(beta: np.ndarray) -> np.ndarray:
        hs = prob.h_s(beta)
        hv = prob.h_v(beta)
        hs_lin = hs0 + hs0p * (beta - beta0)
        hv_lin = hv0 + hv0p * (beta - beta0)
        return AC.surrogate_value(np, cs, a, om, hs, hv, hs_lin, hv_lin, e0)

    return surrogate


def _golden_vec(f, lo: float, hi: float, k: int, iters: int = 48
                ) -> np.ndarray:
    """Vectorized golden-section: f maps (K,) -> (K,) elementwise-convex."""
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    lo = np.full(k, lo)
    hi = np.full(k, hi)
    c = hi - gr * (hi - lo)
    d = lo + gr * (hi - lo)
    fc, fd = f(c), f(d)
    for _ in range(iters):
        left = fc < fd
        hi = np.where(left, d, hi)
        lo = np.where(left, lo, c)
        c_new = hi - gr * (hi - lo)
        d_new = lo + gr * (hi - lo)
        c, d = c_new, d_new
        fc, fd = f(c), f(d)
    return 0.5 * (lo + hi)


def optimize_beta_sca(prob: AllocationProblem, alpha: np.ndarray,
                      beta0: np.ndarray, sca_rounds: int = 8,
                      tol: float = 1e-6) -> np.ndarray:
    K = prob.n
    beta = beta0.copy()
    prev = prob.objective(alpha, beta)
    for _ in range(sca_rounds):
        surrogate = _surrogate_factory(prob, alpha, beta)

        def beta_of_lambda(lam: float) -> np.ndarray:
            return _golden_vec(lambda b: surrogate(b) + lam * b,
                               BETA_MIN, BETA_MAX, K)

        b = beta_of_lambda(0.0)
        if b.sum() > 1.0:
            lo, hi = 0.0, 1.0
            while beta_of_lambda(hi).sum() > 1.0 and hi < 1e30:
                hi *= 10.0
            for _ in range(60):
                mid = 0.5 * (lo + hi)
                if beta_of_lambda(mid).sum() > 1.0:
                    lo = mid
                else:
                    hi = mid
            b = beta_of_lambda(hi)
            b *= min(1.0, 1.0 / max(b.sum(), 1e-12))
        # MM guarantee: only accept descent on the true objective
        cur = prob.objective(alpha, b)
        if cur <= prev:
            beta = b
        if abs(prev - cur) <= tol * (1.0 + abs(prev)):
            prev = min(prev, cur)
            break
        prev = min(prev, cur)
    return beta


# ---------------------------------------------------------------------------
# low-complexity §IV-D: log-barrier + gradient descent, eq. (49)
# ---------------------------------------------------------------------------

def _g_dbeta(prob: AllocationProblem, alpha, beta):
    """Analytic dG/dbeta for all clients."""
    a = np.clip(np.asarray(alpha, np.float64), 1e-12, 1 - 1e-12)
    om = 1.0 - a
    hs, hv = prob.h_s(beta), prob.h_v(beta)
    hsp, hvp = prob.h_s_prime(beta), prob.h_v_prime(beta)
    cs = (prob.coef.A, prob.coef.B, prob.coef.C, prob.coef.D)
    return AC.g_dbeta(np, cs, a, om, hs, hv, hsp, hvp)


def optimize_beta_barrier(prob: AllocationProblem, alpha: np.ndarray,
                          beta0: np.ndarray, mu0: float = 10.0,
                          mu_growth: float = 10.0, outer: int = 5,
                          inner: int = 200, lr: float = 1e-3) -> np.ndarray:
    """Interior-penalty gradient descent on eq. (49); O(K·m)."""
    beta = np.clip(beta0.copy(), 1e-4, None)
    if beta.sum() >= 1.0:
        beta = beta / beta.sum() * 0.95
    ln10 = np.log(10.0)
    mu = mu0
    for _ in range(outer):
        for _ in range(inner):
            slack = 1.0 - beta.sum()
            grad = (_g_dbeta(prob, alpha, beta)
                    - (1.0 / (mu * ln10))
                    * (1.0 / beta - 1.0 / (1.0 - beta) - 1.0 / slack))
            # normalized step + feasibility backtracking
            gn = np.linalg.norm(grad)
            if gn < 1e-14:
                break
            step = lr / (1.0 + gn)
            new = beta - step * grad
            t = 1.0
            while (np.any(new <= 0) or np.any(new >= 1)
                   or new.sum() >= 1.0) and t > 1e-8:
                t *= 0.5
                new = beta - t * step * grad
            if t <= 1e-8:
                break
            beta = new
        mu *= mu_growth
    return beta


# ---------------------------------------------------------------------------
# Algorithm 1: alternating optimization
# ---------------------------------------------------------------------------

def solve(prob: AllocationProblem, method: str = 'alternating',
          max_iters: int = 6, tol: float = 1e-5) -> Allocation:
    K = prob.n
    beta = np.full(K, 1.0 / K)
    if method == 'uniform':
        alpha = np.full(K, 0.5)
        q, p = success_probs_np(prob, alpha, beta)
        return Allocation(alpha, beta, q, p, prob.objective(alpha, beta),
                          {'iters': 0, 'iters_used': 0, 'exit_reason': 0,
                           'method': method})

    use_barrier = method == 'barrier'
    alpha = np.full(K, 0.5)
    uniform_obj = prob.objective(alpha, beta)
    prev = np.inf
    iters = 0
    converged = False
    objs = []          # per-outer-iteration objective (pre-safeguard)
    for it in range(max_iters):
        iters = it + 1
        alpha = optimize_alpha(prob, beta)
        if use_barrier:
            beta = optimize_beta_barrier(prob, alpha, beta)
        else:
            beta = optimize_beta_sca(prob, alpha, beta)
        obj = prob.objective(alpha, beta)
        objs.append(obj)
        if abs(prev - obj) <= tol * (1.0 + abs(obj)):
            prev = obj
            converged = True
            break
        prev = obj
    # safeguard: never return anything worse than the uniform default
    # (the barrier method's strictly-interior start can lose to uniform
    # in degenerate regimes)
    fell_back = prev > uniform_obj
    if fell_back:
        alpha = np.full(K, 0.5)
        beta = np.full(K, 1.0 / K)
        prev = uniform_obj
    q, p = success_probs_np(prob, alpha, beta)
    # exit_reason mirrors allocation_jax's EXIT_* codes so both
    # backends feed the same telemetry schema
    reason = 3 if fell_back else (0 if converged else 1)
    return Allocation(alpha, beta, q, p, prev,
                      {'iters': iters, 'iters_used': iters,
                       'exit_reason': reason, 'method': method,
                       'objectives': objs})


def problem_from_stats(g2, gb2, v, d2, gains, p_w, dim: int,
                       fl: FLConfig) -> AllocationProblem:
    from repro_torch.core.convergence import g_coefficients
    coef = g_coefficients(g2, gb2, v, d2, fl.lipschitz_const,
                          fl.learning_rate)
    return AllocationProblem(coef, np.asarray(gains, np.float64),
                             np.asarray(p_w, np.float64), dim, fl)
