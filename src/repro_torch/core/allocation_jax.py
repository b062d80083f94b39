"""The on-device eq. (28) engine: the PyTorch port of
``repro.core.allocation_jax`` (the knob keeps its name,
``allocation_backend='jax'``; nothing here imports JAX).

The reference's host allocator (``core.allocation``) solves the
hierarchical bandwidth/power problem in float64 NumPy, between the
gradients and the transport of every round.  This module is the same
Algorithm 1 — grid-bracketed, safeguarded-Newton ``optimize_alpha``
(Lemma 3), SCA / majorize-minimize ``optimize_beta_sca`` with per-client
golden section under dual bisection on the sum-bandwidth constraint, and
the §IV-D log-barrier fallback — on a :class:`JaxAllocationProblem` of
tensors, with the reference engine's control flow: every early ``break``
of the host solver is a frozen carry under a ``done`` flag with the same
trip bounds, so the engines walk the same iterates.

Two versions compute it:

* on a CUDA card, :func:`solve_traceable`, :func:`solve_batched` and the
  other entry points launch one hand-written kernel per call
  (``kernels/csrc/alloc_solve.cu`` through ``kernels.ops.alloc_solve``),
  one thread block per problem: the whole solve, loops and all, in one
  launch, with no host synchronization;
* :func:`solve_plain` is the plain PyTorch version of the same function,
  in the same order of floating-point operations.  The wrappers take it
  for tensors on the CPU; ``chip_smoke.py`` holds the kernel against it
  on the card.

``early_exit`` (default) leaves a loop at the trip where every element's
``done`` flag is set instead of running frozen trips; as in the
reference this is bit-identical to the fixed-trip form.  ``inner_tol >
0`` additionally stops the golden-section, dual-bisection and barrier
loops at a tolerance (no longer bit-identical; the reference's contract
of ``src/repro/core/README.md`` bounds the drift).

Ragged cohorts batch through zero padding (``stack_problems``): padded
clients carry zero eq. (27) coefficients and a zero ``mask``, so they
add exactly ``+0.0`` to every ordered sum and the real clients' solve is
bit-identical to the unpadded one.  Every client-axis sum is a strict
left-to-right add chain (``_ordered_sum``), so a batched solve equals a
loop of single solves bit for bit.

Precision: the closed forms (``core.alloc_common``) need float64 — the
guards ``EXP_CAP=600``, ``POW_CAP=500`` and ``H_FLOOR=-1e150`` overflow
float32 — so the problems are float64 by default.  A float32 problem
takes the reference's f32-safe caps (``_caps``); only the plain version
runs it (the kernel is float64).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import alloc_common as AC
from repro_torch.core.allocation import Allocation, AllocationProblem
from repro_torch.core.quantize import true_div
from repro_torch.device import DeviceLike, resolve

Tensor = torch.Tensor
XP = AC.TORCH

METHODS = ('uniform', 'alternating', 'barrier')


class JaxAllocationProblem(NamedTuple):
    """An eq. (28) instance as tensors; a leading batch axis is allowed
    (the trailing axis of the per-client fields is K)."""
    A: Tensor                    # (..., K) eq. (27) coefficients
    B: Tensor
    C: Tensor
    D: Tensor
    gains: Tensor                # (..., K) large-scale channel gains
    p_w: Tensor                  # (..., K) power budgets
    sign_bits: Tensor            # (...,)  l
    mod_bits: Tensor             # (...,)  l*b + b0
    bandwidth_hz: Tensor         # (...,)  B
    noise_psd_w: Tensor          # (...,)  N0 (W/Hz)
    latency_s: Tensor            # (...,)  tau
    alpha_max: Tensor            # (...,)  cap on the sign power share
    mask: Optional[Tensor] = None  # (..., K) 1.0 real / 0.0 zero pad


PER_CLIENT = ('A', 'B', 'C', 'D', 'gains', 'p_w')
SCALARS = ('sign_bits', 'mod_bits', 'bandwidth_hz', 'noise_psd_w',
           'latency_s', 'alpha_max')

# exit reasons (JaxAllocation.exit_reason, RoundTelemetry.alloc_exit_reason)
EXIT_CONVERGED = 0   # relative-objective criterion fired before the cap
EXIT_ITER_CAP = 1    # burned the full max_iters budget without converging
EXIT_NONFINITE = 2   # iterate went non-finite; froze on the last good point
EXIT_UNIFORM_FALLBACK = 3  # solver lost to the uniform default (safeguard)


class JaxAllocation(NamedTuple):
    alpha: Tensor                # (..., K)
    beta: Tensor                 # (..., K)
    q: Tensor                    # (..., K) sign-packet success probs
    p: Tensor                    # (..., K) modulus-packet success probs
    objective: Tensor            # (...,)
    iters: Tensor                # (...,) int32 outer iterations used
    objectives: Tensor           # (..., max_iters) per outer iteration
    #                              (NaN beyond ``iters``)
    exit_reason: Tensor          # (...,) int32 EXIT_* code


class _Caps(NamedTuple):
    """Dtype-bound numerical guards (see the module docstring)."""
    exp_cap: float
    pow_cap: float
    h_floor: float
    log_floor: float
    newton_eps: float
    a_eps: float


def _caps(dtype) -> _Caps:
    if dtype == torch.float64:
        return _Caps(AC.EXP_CAP, AC.POW_CAP, AC.H_FLOOR, AC.LOG_FLOOR,
                     1e-8, 1e-12)
    # f32: exp(80) ~ 5.5e34 and 2^120 ~ 1.3e36 stay finite; the H floor
    # saturates just inside -FLT_MAX; 1 - 1e-12 rounds to 1.0 in f32, so
    # the alpha clip is 1e-6 (f32 spacing at 1.0 is ~6e-8)
    return _Caps(80.0, 120.0, -3e38, -85.0, 1e-4, 1e-6)


# the SCA and barrier settings the reference engine fixes
SCA_ROUNDS, SCA_TOL = 8, 1e-6
GOLDEN_ITERS, GROW_STEPS, BISECT_STEPS = 48, 30, 60
BARRIER_MU0, BARRIER_GROWTH, BARRIER_OUTER, BARRIER_INNER = 10.0, 10.0, 5, 200
BARRIER_LR, BACKTRACKS = 1e-3, 27
GOLDEN_RATIO = (math.sqrt(5.0) - 1.0) / 2.0
LN10 = math.log(10.0)


# ---------------------------------------------------------------------------
# problem constructors
# ---------------------------------------------------------------------------

def problem_from_stats(g2, gb2, v, d2, gains, p_w, dim: int, fl: FLConfig,
                       dtype=torch.float64,
                       device: DeviceLike = None) -> JaxAllocationProblem:
    """The problem of one round from the per-client scalars (tensors stay
    on their device; anything else goes to ``device``).  The configuration's
    numbers become tensors by a fill on the device, not a copy from the
    host, which would wait for the work queued before it."""
    if isinstance(g2, Tensor):
        dev = g2.device
    else:
        dev = resolve(device)

    def cast(x):
        if isinstance(x, (int, float)):
            return torch.full((), float(x), dtype=dtype, device=dev)
        return torch.as_tensor(x, dtype=dtype, device=dev)

    A, B, C, D = AC.g_coefficients(XP, cast(g2), cast(gb2), cast(v),
                                   cast(d2), fl.lipschitz_const,
                                   fl.learning_rate)
    return JaxAllocationProblem(
        A, B, C, D, cast(gains), cast(p_w), cast(float(dim)),
        cast(float(dim * fl.quant_bits + fl.b0_bits)),
        cast(fl.bandwidth_hz), cast(fl.noise_psd_w), cast(fl.latency_s),
        cast(fl.alpha_max))


def from_reference(prob: AllocationProblem, dtype=torch.float64,
                   pad_to: Optional[int] = None,
                   device: DeviceLike = None) -> JaxAllocationProblem:
    """The host (NumPy) problem as tensors on ``device``.

    ``pad_to`` widens the client axis to that many entries with
    zero-coefficient pads (A=B=C=D=0, gains=p_w=1) and sets ``mask``;
    the pads add exactly ``+0.0`` to every masked ordered sum."""
    dev = resolve(device)
    k = prob.n
    n_pad = 0 if pad_to is None else pad_to - k
    if n_pad < 0:
        raise ValueError(f'pad_to={pad_to} < K={k}')

    def cast(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype,
                               device=dev)

    def padded(x, fill):
        x = cast(x)
        if n_pad:
            x = torch.cat([x, torch.full((n_pad,), fill, dtype=dtype,
                                         device=dev)])
        return x

    mask = None
    if pad_to is not None:
        mask = torch.cat([torch.ones((k,), dtype=dtype, device=dev),
                          torch.zeros((n_pad,), dtype=dtype, device=dev)])
    fl = prob.fl
    return JaxAllocationProblem(
        padded(prob.coef.A, 0.0), padded(prob.coef.B, 0.0),
        padded(prob.coef.C, 0.0), padded(prob.coef.D, 0.0),
        padded(prob.gains, 1.0), padded(prob.p_w, 1.0),
        cast(prob.sign_bits), cast(prob.mod_bits), cast(fl.bandwidth_hz),
        cast(fl.noise_psd_w), cast(fl.latency_s), cast(fl.alpha_max), mask)


def stack_problems(probs: Sequence[AllocationProblem], dtype=torch.float64,
                   device: DeviceLike = None) -> JaxAllocationProblem:
    """Host problems as one batch (every field gains a leading axis).
    Cohorts of several sizes are zero-padded to the widest K with a
    ``mask``; a batch of one size keeps ``mask=None``."""
    ks = {p.n for p in probs}
    pad_to = max(ks) if len(ks) > 1 else None
    parts = [from_reference(p, dtype, pad_to=pad_to, device=device)
             for p in probs]
    return JaxAllocationProblem(*(
        None if fields[0] is None else torch.stack(fields)
        for fields in zip(*parts)))


def batch_over_gains(prob: JaxAllocationProblem,
                     gains_b) -> JaxAllocationProblem:
    """One problem repeated over a (B, K) trajectory of gains: one
    ``solve_batched`` call then solves every draw."""
    gains_b = torch.as_tensor(gains_b, dtype=prob.gains.dtype,
                              device=prob.gains.device)
    b = gains_b.shape[0]

    def rep(x):
        return None if x is None else x.expand((b,) + x.shape).contiguous()

    return JaxAllocationProblem(*map(rep, prob))._replace(gains=gains_b)


def is_batched(prob: JaxAllocationProblem) -> bool:
    return prob.A.dim() == 2


# ---------------------------------------------------------------------------
# the plain version, on batches: per-client fields (B, K), scalars (B, 1)
# ---------------------------------------------------------------------------

def _lift(prob: JaxAllocationProblem) -> JaxAllocationProblem:
    """Per-client fields (B, K) and scalars (B, 1), so that scalars
    broadcast against any stack of (B, K) tensors."""
    if not is_batched(prob):
        return _lift(JaxAllocationProblem(*(
            None if x is None else x.unsqueeze(0) for x in prob)))
    return prob._replace(**{name: getattr(prob, name).reshape(-1, 1)
                            for name in SCALARS})


def _ordered_sum(x: Tensor) -> Tensor:
    """Strict left-to-right sum over the last axis: the order is pinned,
    so a batched solve equals the single solves bit for bit."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _msum(P: JaxAllocationProblem, x: Tensor) -> Tensor:
    """Client-axis ordered sum with zero pads (exact +0.0) left out."""
    return _ordered_sum(x if P.mask is None else x * P.mask)


def _expand(flag: Tensor, like: Tensor) -> Tensor:
    """A per-problem (B,) flag against a (..., B, ...) tensor whose batch
    axis is ``like``'s first."""
    return flag.reshape(flag.shape + (1,) * (like.dim() - 1))


def _bounded_fori(n: int, body: Callable, init: tuple, stop: Callable,
                  early_exit: bool) -> tuple:
    """``for i in range(n): carry = body(i, carry)`` with a convergence
    exit.  ``stop(carry)`` is a (B,) flag; with ``early_exit`` the loop
    leaves once every problem stops, and a problem that stops earlier
    keeps its carry (the reference's batched ``while_loop``).  Bodies that
    freeze their own carry once ``done`` make the two forms equal."""
    carry = init
    for i in range(n):
        if early_exit:
            halt = stop(carry)
            if bool(halt.all()):
                break
            new = body(i, carry)
            carry = tuple(torch.where(_expand(halt, old), old, nw)
                          for old, nw in zip(carry, new))
        else:
            carry = body(i, carry)
    return carry


def _cs(P):
    return (P.A, P.B, P.C, P.D)


def _h(P, caps, beta, n_bits):
    return AC.h_term(XP, beta, P.p_w, P.gains, n_bits, P.bandwidth_hz,
                     P.noise_psd_w, P.latency_s, pow_cap=caps.pow_cap,
                     h_floor=caps.h_floor)


def _h_prime(P, caps, beta, n_bits):
    return AC.h_term_prime(XP, beta, P.p_w, P.gains, n_bits, P.bandwidth_hz,
                           P.noise_psd_w, P.latency_s, pow_cap=caps.pow_cap)


def _h_both(P, caps, beta, fn=_h):
    """(H_s, H_v) at ``beta`` (any stack of (B, K)), in one pass over the
    two packet sizes."""
    bits = torch.stack([P.sign_bits, P.mod_bits]).reshape(
        (2,) + (1,) * (beta.dim() - 2) + P.sign_bits.shape)
    both = fn(P, caps, beta, bits)
    return both[0], both[1]


def _objective(P, caps, alpha, beta) -> Tensor:
    h_s, h_v = _h_both(P, caps, beta)
    return _msum(P, AC.g_value(XP, _cs(P), alpha, h_s, h_v,
                               exp_cap=caps.exp_cap))


def _success_probs(P, caps, alpha, beta):
    h_s, h_v = _h_both(P, caps, beta)
    return AC.success_probs(XP, alpha, h_s, h_v, log_floor=caps.log_floor)


def optimize_alpha(P: JaxAllocationProblem, beta: Tensor, n_grid: int = 256,
                   newton_iters: int = 40, caps: _Caps = None) -> Tensor:
    """Lemma 3 on every client of a lifted problem: G' on a grid of
    ``n_grid`` points, a safeguarded Newton polish of every interval,
    and the first-index argmin of G over the intervals where G' changes
    sign, against the boundary alpha_max."""
    caps = caps or _caps(beta.dtype)
    cs = _cs(P)
    h_s, h_v = _h_both(P, caps, beta)
    a_max = P.alpha_max.clamp(1e-3, 1.0)                       # (B, 1)
    # np.linspace spelled out elementwise: lo + i * step, endpoint pinned
    lo_a, hi_a = 1e-4, a_max - 1e-4
    step = true_div(hi_a - lo_a, float(n_grid - 1))
    idx = torch.arange(n_grid, dtype=beta.dtype, device=beta.device)
    grid = lo_a + idx.reshape(-1, 1, 1) * step                 # (G, B, 1)
    grid[-1] = hi_a
    gp = AC.g_prime_alpha(XP, cs, grid, h_s, h_v, exp_cap=caps.exp_cap,
                          a_eps=caps.a_eps)                     # (G, B, K)
    best_alpha = torch.full_like(h_s, 1.0) * a_max
    best_val = AC.g_value(XP, cs, best_alpha, h_s, h_v, exp_cap=caps.exp_cap)

    sign_change = torch.signbit(gp[:-1]) != torch.signbit(gp[1:])
    shape = sign_change.shape
    lo = grid[:-1].expand(shape)
    hi = grid[1:].expand(shape)
    flo_neg = gp[:-1] < 0
    eps = caps.newton_eps
    x = 0.5 * (lo + hi)
    for _ in range(newton_iters):
        f = AC.g_prime_alpha(XP, cs, x, h_s, h_v, exp_cap=caps.exp_cap,
                             a_eps=caps.a_eps)
        fp = true_div(AC.g_prime_alpha(XP, cs, x + eps, h_s, h_v,
                                       exp_cap=caps.exp_cap,
                                       a_eps=caps.a_eps) - f, eps)
        same = flo_neg == (f < 0)
        lo = torch.where(same, x, lo)
        hi = torch.where(same, hi, x)
        newton = x - f / fp
        mid = 0.5 * (lo + hi)
        good = torch.isfinite(newton) & (newton > lo) & (newton < hi)
        x = torch.where(good, newton, mid)
    vals = AC.g_value(XP, cs, x, h_s, h_v, exp_cap=caps.exp_cap)
    vals = torch.where(sign_change & ~torch.isnan(vals), vals, math.inf)
    j = torch.argmin(vals, dim=0, keepdim=True)
    cand_val = torch.gather(vals, 0, j)[0]
    cand_x = torch.gather(x, 0, j)[0]
    return torch.where(cand_val < best_val, cand_x, best_alpha)


def _surrogate(P, caps, alpha, beta0):
    """The SCA majorant of G(alpha, .) around ``beta0`` plus ``lam *
    beta``, as a function of a (2, B, K) stack of betas and the (B, 1)
    dual prices: ``AC.h_term`` and ``AC.surrogate_value`` op for op, with
    what depends only on ``beta0`` made once, and the two packet sizes
    and the four terms each taken side by side."""
    a = alpha.clamp(caps.a_eps, 1.0 - caps.a_eps)
    om = 1.0 - a
    hs0, hv0 = _h_both(P, caps, beta0)
    hs0p, hv0p = _h_both(P, caps, beta0, _h_prime)
    dt, dev = beta0.dtype, beta0.device
    wv = torch.tensor([w for w, _ in AC.TERM_W], dtype=dt,
                      device=dev).reshape(4, 1, 1, 1)
    ws = torch.tensor([w for _, w in AC.TERM_W], dtype=dt,
                      device=dev).reshape(4, 1, 1, 1)
    cs = torch.stack(_cs(P))                                   # (4, B, K)
    e0 = wv[..., 0] * hv0 / om - ws[..., 0] * hs0 / a          # (4, B, K)
    cbase = (cs * XP.exp(XP.minimum(e0, caps.exp_cap))).unsqueeze(1)
    cs, e0, pos = cs.unsqueeze(1), e0.unsqueeze(1), (cs >= 0).unsqueeze(1)
    # h_term's factors that do not depend on beta
    two_bits = 2.0 * torch.stack([P.sign_bits, P.mod_bits]).reshape(
        2, 1, -1, 1)                                           # (2,1,B,1)
    cap_c = 4.0 * P.p_w * P.gains

    def surrogate(beta, lam):
        bb = beta * P.bandwidth_hz
        expo = XP.minimum(two_bits / (bb * P.latency_s), caps.pow_cap)
        h = XP.maximum((bb * P.noise_psd_w / cap_c)
                       * (1.0 - XP.power(2.0, expo)), caps.h_floor)
        hs, hv = h[0], h[1]
        dlt = beta - beta0
        hs_lin = hs0 + hs0p * dlt
        hv_lin = hv0 + hv0p * dlt
        # c >= 0 keeps -H_s exact with H_v linearized; c < 0 takes the
        # supporting line of exp at e0
        t_pos = cs * XP.exp(XP.minimum(wv * hv_lin / om - ws * hs / a,
                                       caps.exp_cap))
        t_neg = cbase * ((1.0 + (wv * hv / om - ws * hs_lin / a)) - e0)
        terms = torch.where(pos, t_pos, t_neg)
        total = torch.zeros_like(hs)
        for j in range(4):
            total = total + terms[j]
        return total + lam * beta

    return surrogate


def _golden_vec(f, like: Tensor, iters: int = GOLDEN_ITERS,
                early_exit: bool = True, width_tol: float = 0.0) -> Tensor:
    """Golden section on [BETA_MIN, BETA_MAX] for every client, ``f``
    taking a (2, B, K) stack of the two interior points.  ``width_tol >
    0`` (with ``early_exit``) stops once a problem's widest bracket is
    that narrow."""
    gr = GOLDEN_RATIO
    lo = torch.full_like(like, AC.BETA_MIN)
    hi = torch.full_like(like, AC.BETA_MAX)
    c = hi - gr * (hi - lo)
    d = lo + gr * (hi - lo)
    fcd = f(torch.stack([c, d]))

    def body(_, carry):
        lo, hi, c, d, fc, fd = carry
        left = fc < fd
        hi = torch.where(left, d, hi)
        lo = torch.where(left, lo, c)
        w = gr * (hi - lo)
        c, d = hi - w, lo + w
        fcd = f(torch.stack([c, d]))
        return lo, hi, c, d, fcd[0], fcd[1]

    def stop(carry):
        return (carry[1] - carry[0]).amax(-1) <= width_tol

    carry = _bounded_fori(iters, body, (lo, hi, c, d, fcd[0], fcd[1]), stop,
                          early_exit and width_tol > 0.0)
    return 0.5 * (carry[0] + carry[1])


def _dual(P, beta_of_lambda, like: Tensor, early_exit: bool,
          inner_tol: float) -> Tensor:
    """The bandwidth at the dual price that meets sum(beta) <= 1: the
    upper bracket grows x10 from 1.0 (at most 30 steps, up to 1e30), 60
    bisection steps follow, and the result is rescaled onto the
    simplex."""
    def grow(_, carry):
        hi, cont = carry
        need = (cont & (_msum(P, beta_of_lambda(hi)) > 1.0) & (hi < 1e30))
        return torch.where(need, hi * 10.0, hi), need

    one = torch.ones_like(like)
    hi, _ = _bounded_fori(GROW_STEPS, grow,
                          (one, torch.ones_like(one, dtype=torch.bool)),
                          lambda c: ~c[1], early_exit)

    def bis(_, lh):
        lo, hi = lh
        mid = 0.5 * (lo + hi)
        infeas = _msum(P, beta_of_lambda(mid)) > 1.0
        return torch.where(infeas, mid, lo), torch.where(infeas, hi, mid)

    def bis_stop(lh):
        return (lh[1] - lh[0]) <= inner_tol * lh[1]

    _, hi = _bounded_fori(BISECT_STEPS, bis, (torch.zeros_like(one), hi),
                          bis_stop, early_exit and inner_tol > 0.0)
    b = beta_of_lambda(hi)
    scale = (1.0 / _msum(P, b).clamp(min=1e-12)).clamp(max=1.0)
    return b * scale.reshape(-1, 1)


def optimize_beta_sca(P: JaxAllocationProblem, alpha: Tensor, beta0: Tensor,
                      sca_rounds: int = SCA_ROUNDS, tol: float = SCA_TOL,
                      caps: _Caps = None, early_exit: bool = True,
                      inner_tol: float = 0.0) -> Tensor:
    """Bandwidth by SCA: per round, golden section on the convex
    surrogate under dual bisection on sum(beta) <= 1, accepted only on
    descent of the true objective."""
    caps = caps or _caps(beta0.dtype)

    def sca_body(_, carry):
        beta, prev, done = carry
        surrogate = _surrogate(P, caps, alpha, beta)

        def beta_of_lambda(lam):
            lam = lam.reshape(-1, 1)
            return _golden_vec(lambda b: surrogate(b, lam), beta,
                               early_exit=early_exit, width_tol=inner_tol)

        b = beta_of_lambda(torch.zeros_like(prev))
        dual_on = _msum(P, b) > 1.0
        if bool(dual_on.any()):
            b = torch.where(dual_on.reshape(-1, 1),
                            _dual(P, beta_of_lambda, prev, early_exit,
                                  inner_tol), b)
        # MM guarantee: only accept descent on the true objective
        cur = _objective(P, caps, alpha, b)
        accept = (cur <= prev) & ~done
        conv = torch.abs(prev - cur) <= tol * (1.0 + torch.abs(prev))
        beta2 = torch.where(accept.reshape(-1, 1), b, beta)
        prev2 = torch.where(done, prev, torch.minimum(prev, cur))
        return beta2, prev2, done | conv

    prev0 = _objective(P, caps, alpha, beta0)
    done0 = torch.zeros_like(prev0, dtype=torch.bool)
    beta, _, _ = _bounded_fori(sca_rounds, sca_body, (beta0, prev0, done0),
                               lambda c: c[2], early_exit)
    return beta


# ---------------------------------------------------------------------------
# low-complexity §IV-D: log-barrier + projected gradient descent
# ---------------------------------------------------------------------------

def optimize_beta_barrier(P: JaxAllocationProblem, alpha: Tensor,
                          beta0: Tensor, caps: _Caps = None,
                          early_exit: bool = True,
                          inner_tol: float = 0.0) -> Tensor:
    """Interior-penalty gradient descent on eq. (49): 5 stages of mu (10
    to 1e5), 200 normalized steps each, 27 feasibility halvings a step."""
    caps = caps or _caps(beta0.dtype)
    beta = beta0.clamp(min=1e-4)
    s = _msum(P, beta).reshape(-1, 1)
    beta = torch.where(s >= 1.0, beta / s * 0.95, beta)
    a = alpha.clamp(caps.a_eps, 1.0 - caps.a_eps)
    om = 1.0 - a
    cs = _cs(P)

    def gdbeta(b):
        hs, hv = _h_both(P, caps, b)
        hsp, hvp = _h_both(P, caps, b, _h_prime)
        return AC.g_dbeta(XP, cs, a, om, hs, hv, hsp, hvp,
                          exp_cap=caps.exp_cap)

    for oi in range(BARRIER_OUTER):
        mu = torch.full_like(s, BARRIER_MU0 * BARRIER_GROWTH ** oi)
        inv = 1.0 / (mu * LN10)

        def inner_body(_, carry):
            beta, done = carry
            slack = (1.0 - _msum(P, beta)).reshape(-1, 1)
            grad = gdbeta(beta) - inv * (1.0 / beta - 1.0 / (1.0 - beta)
                                         - 1.0 / slack)
            if P.mask is not None:
                grad = grad * P.mask          # pads hold their start point
            gn = torch.sqrt(_ordered_sum(grad * grad)).reshape(-1, 1)
            # a number over a tensor is the reciprocal times the number in
            # PyTorch: a tensor numerator keeps the IEEE quotient
            step = torch.full_like(gn, BARRIER_LR) / (1.0 + gn)
            # feasibility backtracking: 27 halvings reach t <= 1e-8
            t = torch.ones_like(gn)
            new = beta - step * grad
            for _ in range(BACKTRACKS):
                infeas = (((new <= 0) | (new >= 1)).any(-1, keepdim=True)
                          | (_msum(P, new) >= 1.0).reshape(-1, 1))
                cont = infeas & (t > 1e-8)
                if not bool(cont.any()):
                    break
                t = torch.where(cont, 0.5 * t, t)
                new = torch.where(cont, beta - t * step * grad, new)
            give_up = ((gn < 1e-14) | (t <= 1e-8)).reshape(-1)
            # the displacement exit: inner_tol = 0 stops only at an exact
            # fixed point, which is absorbing (bit-identical)
            stalled = (new - beta).abs().amax(-1) <= inner_tol
            beta2 = torch.where((~done & ~give_up).reshape(-1, 1), new, beta)
            return beta2, done | give_up | stalled

        beta, _ = _bounded_fori(
            BARRIER_INNER, inner_body,
            (beta, torch.zeros((beta.shape[0],), dtype=torch.bool,
                               device=beta.device)),
            lambda c: c[1], early_exit)
    return beta


# ---------------------------------------------------------------------------
# Algorithm 1: alternating optimization
# ---------------------------------------------------------------------------

def _uniform_point(P: JaxAllocationProblem):
    nb, k = P.gains.shape
    dt, dev = P.gains.dtype, P.gains.device
    if P.mask is None:
        beta_u = torch.full((nb, k), 1.0 / k, dtype=dt, device=dev)
    else:
        beta_u = P.mask / _ordered_sum(P.mask).reshape(-1, 1)
    return torch.full((nb, k), 0.5, dtype=dt, device=dev), beta_u


def _solve_lifted(P: JaxAllocationProblem, method: str, max_iters: int,
                  tol: float, n_grid: int, newton_iters: int,
                  early_exit: bool, inner_tol: float) -> JaxAllocation:
    caps = _caps(P.A.dtype)
    nb = P.A.shape[0]
    dt, dev = P.A.dtype, P.A.device
    alpha_u, beta_u = _uniform_point(P)
    nan_objs = torch.full((nb, max_iters), math.nan, dtype=dt, device=dev)
    uniform_obj = _objective(P, caps, alpha_u, beta_u)
    if method == 'uniform':
        q, p = _success_probs(P, caps, alpha_u, beta_u)
        return JaxAllocation(
            alpha_u, beta_u, q, p, uniform_obj,
            torch.zeros((nb,), dtype=torch.int32, device=dev), nan_objs,
            torch.full((nb,), EXIT_CONVERGED, dtype=torch.int32,
                       device=dev))
    use_barrier = method == 'barrier'

    def body(i, carry):
        alpha, beta, prev, done, bad_seen, iters, objs = carry
        alpha_n = optimize_alpha(P, beta, n_grid, newton_iters, caps)
        if use_barrier:
            beta_n = optimize_beta_barrier(P, alpha_n, beta, caps=caps,
                                           early_exit=early_exit,
                                           inner_tol=inner_tol)
        else:
            beta_n = optimize_beta_sca(P, alpha_n, beta, caps=caps,
                                       early_exit=early_exit,
                                       inner_tol=inner_tol)
        obj = _objective(P, caps, alpha_n, beta_n)
        # a non-finite iterate must not poison the carry: freeze on the
        # last good point instead of accepting it
        bad = ~torch.isfinite(obj)
        conv = torch.abs(prev - obj) <= tol * (1.0 + torch.abs(obj))
        keep = done | bad
        k2 = keep.reshape(-1, 1)
        objs2 = objs.clone()
        objs2[:, i] = torch.where(keep, math.nan, obj)
        return (torch.where(k2, alpha, alpha_n), torch.where(k2, beta, beta_n),
                torch.where(keep, prev, obj), done | conv | bad,
                bad_seen | (bad & ~done),
                torch.where(keep, iters, torch.full_like(iters, i + 1)),
                objs2)

    false = torch.zeros((nb,), dtype=torch.bool, device=dev)
    init = (alpha_u, beta_u, torch.full((nb,), math.inf, dtype=dt,
                                        device=dev),
            false, false, torch.zeros((nb,), dtype=torch.int32, device=dev),
            nan_objs)
    alpha, beta, prev, done, bad_seen, iters, objs = _bounded_fori(
        max_iters, body, init, lambda c: c[3], early_exit)
    # safeguard: never return anything worse than the uniform default,
    # NaN-proof (a non-finite objective falls back too)
    worse = ~(prev <= uniform_obj)
    w2 = worse.reshape(-1, 1)
    alpha = torch.where(w2, alpha_u, alpha)
    beta = torch.where(w2, beta_u, beta)
    prev = torch.where(worse, uniform_obj, prev)

    def code(c):
        return torch.full((nb,), c, dtype=torch.int32, device=dev)

    reason = torch.where(worse, code(EXIT_UNIFORM_FALLBACK),
                         torch.where(bad_seen, code(EXIT_NONFINITE),
                                     torch.where(done, code(EXIT_CONVERGED),
                                                 code(EXIT_ITER_CAP))))
    q, p = _success_probs(P, caps, alpha, beta)
    return JaxAllocation(alpha, beta, q, p, prev, iters, objs, reason)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f'method must be one of {METHODS}, got {method!r}')


def solve_plain(prob: JaxAllocationProblem, method: str = 'alternating',
                max_iters: int = 6, tol: float = 1e-5, n_grid: int = 256,
                newton_iters: int = 40, early_exit: bool = True,
                inner_tol: float = 0.0,
                gate: Optional[Tensor] = None) -> JaxAllocation:
    """The plain PyTorch version of the solver, on any device: the
    function the ``alloc_solve`` kernel computes, in its order of
    floating-point operations.  ``prob`` may be one problem or a batch.
    ``gate`` (one value per problem, or one for all) solves the problems
    whose gate is not > 0 with the 'uniform' method instead (the round-0
    guard of the training loop: no compensation history yet)."""
    _check_method(method)
    with torch.inference_mode():
        return _solve_plain(prob, method, max_iters, tol, n_grid,
                            newton_iters, early_exit, inner_tol, gate)


def _solve_plain(prob, method, max_iters, tol, n_grid, newton_iters,
                 early_exit, inner_tol, gate) -> JaxAllocation:
    P = _lift(prob)
    args = (max_iters, tol, n_grid, newton_iters, early_exit, inner_tol)
    if gate is None or method == 'uniform':
        sol = _solve_lifted(P, method, *args)
    else:
        on = (torch.as_tensor(gate, device=P.A.device) > 0).reshape(-1)
        on = on.expand(P.A.shape[0])
        if bool(on.all()):
            sol = _solve_lifted(P, method, *args)
        else:
            uni = _solve_lifted(P, 'uniform', *args)
            if not bool(on.any()):
                sol = uni
            else:
                got = _solve_lifted(P, method, *args)
                sol = JaxAllocation(*(
                    torch.where(on.reshape(on.shape + (1,) * (u.dim() - 1)),
                                g, u) for g, u in zip(got, uni)))
    if is_batched(prob):
        return sol
    return JaxAllocation(*(x[0] for x in sol))


# ---------------------------------------------------------------------------
# the solver API: the kernel on the card, the plain version on the CPU
# ---------------------------------------------------------------------------

def solve_traceable(prob: JaxAllocationProblem, method: str = 'alternating',
                    max_iters: int = 6, tol: float = 1e-5,
                    n_grid: int = 256, newton_iters: int = 40,
                    early_exit: bool = True,
                    inner_tol: float = 0.0) -> JaxAllocation:
    """Solve one problem (or a batch) where its tensors lie: one launch of
    the ``alloc_solve`` kernel on the card, the plain version on the
    CPU.  Nothing is read back to the host."""
    from repro_torch.kernels import ops
    return ops.alloc_solve(prob, method, max_iters=max_iters, tol=tol,
                           n_grid=n_grid, newton_iters=newton_iters,
                           early_exit=early_exit, inner_tol=inner_tol)


def solve_batched(prob: JaxAllocationProblem, method: str = 'alternating',
                  max_iters: int = 6, tol: float = 1e-5, n_grid: int = 256,
                  newton_iters: int = 40, early_exit: bool = True,
                  inner_tol: float = 0.0) -> JaxAllocation:
    """One call over a batch of problems (every field with a leading
    batch axis: ``stack_problems`` / ``batch_over_gains``); bit-identical
    to a loop of single solves."""
    if not is_batched(prob):
        raise ValueError('solve_batched takes a batch: every per-client '
                         'field (B, K)')
    return solve_traceable(prob, method, max_iters, tol, n_grid,
                           newton_iters, early_exit, inner_tol)


def solve_from_stats(g2, gb2, v, d2, gains, p_w, dim: int, fl: FLConfig,
                     method: str = 'alternating', max_iters: int = 6,
                     tol: float = 1e-5, early_exit: bool = True,
                     device: DeviceLike = None) -> JaxAllocation:
    """From the clients' scalar report to the round's allocation in one
    solver call (the ``allocation_backend='jax'`` path of the training
    loop: no host NumPy between the stats and (q, p))."""
    prob = problem_from_stats(g2, gb2, v, d2, gains, p_w, dim, fl,
                              device=device)
    return solve_traceable(prob, method, max_iters, tol,
                           early_exit=early_exit)


def solve(prob, method: str = 'alternating', max_iters: int = 6,
          tol: float = 1e-5, early_exit: bool = True,
          inner_tol: float = 0.0, device: DeviceLike = None) -> Allocation:
    """Drop-in for ``allocation.solve``: takes the host problem (or a
    :class:`JaxAllocationProblem`), solves on ``device`` (the card by
    default) and returns the host :class:`Allocation` with
    ``info['iters_used']``, ``info['exit_reason']``, ``info['backend']``
    and ``info['objectives']``."""
    jp = (from_reference(prob, device=device)
          if isinstance(prob, AllocationProblem) else prob)
    sol = solve_traceable(jp, method, max_iters=max_iters, tol=tol,
                          early_exit=early_exit, inner_tol=inner_tol)
    host = JaxAllocation(*(x.detach().cpu().numpy() for x in sol))
    iters_used = int(host.iters)
    objs = host.objectives
    return Allocation(host.alpha.astype(np.float64),
                      host.beta.astype(np.float64),
                      host.q.astype(np.float64), host.p.astype(np.float64),
                      float(host.objective),
                      {'iters': iters_used, 'iters_used': iters_used,
                       'exit_reason': int(host.exit_reason),
                       'method': method, 'backend': 'jax',
                       'objectives': [float(o) for o in
                                      objs[~np.isnan(objs)]]})
