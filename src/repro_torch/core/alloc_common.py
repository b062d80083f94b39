"""Closed forms of the eq. (27)/(28) allocation problem (the port's own
copy of ``repro.core.alloc_common``).

Every function takes the array namespace ``xp`` as its first argument and
is pure elementwise algebra.  The port's host allocator (``allocation``)
calls it with ``numpy`` in float64, as the reference's 'numpy' backend
does; the on-device engine (``allocation_jax``) calls it with
:data:`TORCH`, the same namespace on torch tensors.
"""
from __future__ import annotations

import math

import torch

# exponent clamp: beyond this exp() overflows the bound to +inf — we
# saturate instead (f64 value; convergence.py re-exports it)
EXP_CAP = 600.0
POW_CAP = 500.0        # cap on the 2^x exponent inside H
H_FLOOR = -1e150
BETA_MIN = 1e-6
BETA_MAX = 1.0 - 1e-9
LOG_FLOOR = -745.0     # exp() underflow floor for success probabilities

# (weight on H_v/(1-a), weight on -H_s/a) for the four terms of eq. (27)
TERM_W = ((1.0, 0.0), (2.0, 0.0), (1.0, 1.0), (0.0, 1.0))

_INF = float('inf')
LN2 = math.log(2.0)


def lane_stable(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise transcendental ``fn``, with every
    element computed as it is in a problem of one row.

    On the CPU PyTorch computes exp and pow with SLEEF on the vector part
    of a contiguous run and with libm on its tail; the two differ by an
    ulp now and then, so an element's result would depend on where it
    lands in the flattened tensor, and a batch of problems would drift
    from the same problems solved one by one.  Here the last axis (the
    client axis) is copied into rows one element wider than itself, which
    PyTorch cannot merge into one run, so each row is split into its
    vector part and tail the same way whatever the batch; rows go in
    chunks below PyTorch's parallel grain, which would otherwise cut a
    row.  On a card every element takes the same path anyway."""
    if x.device.type != 'cpu' or x.dim() == 0:
        return fn(x)
    k = x.shape[-1]
    rows = x.reshape(-1, k)
    padded = rows.new_empty((rows.shape[0], k + 1))[:, :k]
    padded.copy_(rows)
    step = max(1, 16384 // (k + 1))
    if rows.shape[0] <= step:
        return fn(padded).reshape(x.shape)
    return torch.cat([fn(padded[i:i + step])
                      for i in range(0, rows.shape[0], step)]).reshape(
                          x.shape)


class _TorchNamespace:
    """The NumPy functions the closed forms call, on torch tensors.  A
    bound given as a Python float clamps; exp and power are
    :func:`lane_stable`.  Every operation is one PyTorch elementwise op in
    the closed form's order, so a kernel that repeats the order with
    rounded intrinsics gets the same bits."""

    @staticmethod
    def minimum(x, y):
        return x.clamp(max=y) if isinstance(y, float) else torch.minimum(x, y)

    @staticmethod
    def maximum(x, y):
        return x.clamp(min=y) if isinstance(y, float) else torch.maximum(x, y)

    @staticmethod
    def clip(x, lo, hi):
        return x.clamp(lo, hi)

    @staticmethod
    def exp(x):
        return lane_stable(torch.exp, x)

    @staticmethod
    def power(base, x):
        return lane_stable(lambda t: torch.pow(base, t), x)

    where = staticmethod(torch.where)
    zeros_like = staticmethod(torch.zeros_like)


TORCH = _TorchNamespace()


# ---------------------------------------------------------------------------
# H terms (12)/(14) and derivatives (42)/(46)
# ---------------------------------------------------------------------------

def h_term(xp, beta, p_w, gain, n_bits, bandwidth_hz, noise_psd_w,
           latency_s, *, pow_cap=POW_CAP, h_floor=H_FLOOR):
    """H(beta) = beta B N0 / (4 P g) (1 - 2^{2 R / (beta B tau)}), <= 0."""
    bb = beta * bandwidth_hz
    expo = xp.minimum(2.0 * n_bits / (bb * latency_s), pow_cap)
    h = ((bb * noise_psd_w / (4.0 * p_w * gain))
         * (1.0 - xp.power(2.0, expo)))
    return xp.maximum(h, h_floor)


def h_term_prime(xp, beta, p_w, gain, n_bits, bandwidth_hz, noise_psd_w,
                 latency_s, *, pow_cap=POW_CAP):
    """dH/dbeta, cf. paper eq. (42)/(46)."""
    c1 = bandwidth_hz * noise_psd_w / (4.0 * p_w * gain)
    expo = xp.minimum(2.0 * n_bits / (beta * bandwidth_hz * latency_s),
                      pow_cap)
    pow2 = xp.power(2.0, expo)
    return c1 * ((1.0 - pow2) + pow2 * LN2 * expo)


def success_probs(xp, alpha, h_s, h_v, *, log_floor=LOG_FLOOR):
    """(q, p) of eq. (11)/(13) with the exact alpha in {0, 1} boundaries."""
    q = xp.where(alpha > 0,
                 xp.exp(xp.maximum(h_s / xp.clip(alpha, 1e-12, 1.0),
                                   log_floor)), 0.0)
    p = xp.where(alpha < 1,
                 xp.exp(xp.maximum(h_v / xp.clip(1.0 - alpha, 1e-12, 1.0),
                                   log_floor)), 0.0)
    return q, p


# ---------------------------------------------------------------------------
# G(alpha, beta) of eq. (27): coefficients, exponents, value, derivatives
# ---------------------------------------------------------------------------

def g_coefficients(xp, g2, gb2, v, d2, lipschitz, eta):
    """A, B, C, D of eq. (27) as a plain (A, B, C, D) tuple."""
    le = lipschitz * eta
    A = 2.0 * (-2.0 * g2 - gb2 + 3.0 * v)
    B = g2 + gb2 - 2.0 * v
    C = le * (g2 - gb2 + d2)
    D = le * gb2 + xp.zeros_like(g2)
    return A, B, C, D


def g_exponents(xp, alpha, h_s, h_v):
    """The four exponents of eq. (27) with boundary-safe alpha in [0, 1]."""
    a = xp.clip(alpha, 1e-12, 1.0)
    om = xp.clip(1.0 - alpha, 1e-12, 1.0)
    t1 = h_v / om                       # log p
    t4 = -h_s / a                       # -log q
    # exact boundaries: alpha=1 -> p=0 (t1 = -inf); alpha=0 -> q=0 (t4=+inf)
    t1 = xp.where(alpha >= 1.0, -_INF, t1)
    t4 = xp.where(alpha <= 0.0, _INF, t4)
    return t1, 2.0 * t1, t1 + t4, t4


def g_value(xp, cs, alpha, h_s, h_v, *, exp_cap=EXP_CAP):
    """G(alpha, beta) of eq. (27); ``cs = (A, B, C, D)`` arrays."""
    t1, t2, t3, t4 = g_exponents(xp, alpha, h_s, h_v)
    return (cs[0] * xp.exp(xp.minimum(t1, exp_cap))
            + cs[1] * xp.exp(xp.minimum(t2, exp_cap))
            + cs[2] * xp.exp(xp.minimum(t3, exp_cap))
            + cs[3] * xp.exp(xp.minimum(t4, exp_cap)))


def g_prime_alpha(xp, cs, alpha, h_s, h_v, *, exp_cap=EXP_CAP,
                  a_eps=1e-12):
    """dG/dalpha, eq. (69) — the Newton–Raphson target of Lemma 3.

    ``a_eps`` is the boundary clip for alpha and must be representable
    away from 1 in the working dtype: ``1 - 1e-12`` rounds to exactly
    1.0 in float32, which makes ``om = 0`` and turns the 0*inf products
    below into NaN — f32 callers pass a wider epsilon (see
    ``allocation_jax._caps``).
    """
    a = xp.clip(alpha, a_eps, 1.0 - a_eps)
    om = 1.0 - a
    t1, t2, t3, t4 = g_exponents(xp, a, h_s, h_v)
    dv = h_v / om ** 2                  # d/dalpha [H_v/(1-a)]
    ds = h_s / a ** 2                   # d/dalpha [-H_s/a] = +H_s/a^2
    return (cs[0] * xp.exp(xp.minimum(t1, exp_cap)) * dv
            + cs[1] * xp.exp(xp.minimum(t2, exp_cap)) * 2.0 * dv
            + cs[2] * xp.exp(xp.minimum(t3, exp_cap)) * (dv + ds)
            + cs[3] * xp.exp(xp.minimum(t4, exp_cap)) * ds)


def g_dbeta(xp, cs, a, om, hs, hv, hsp, hvp, *, exp_cap=EXP_CAP):
    """Analytic dG/dbeta (the §IV-D barrier gradient); ``a`` pre-clipped."""
    out = xp.zeros_like(hs)
    for j, (wv, ws) in enumerate(TERM_W):
        e = wv * hv / om - ws * hs / a
        de = wv * hvp / om - ws * hsp / a
        out = out + cs[j] * xp.exp(xp.minimum(e, exp_cap)) * de
    return out


def surrogate_value(xp, cs, a, om, hs, hv, hs_lin, hv_lin, e0,
                    *, exp_cap=EXP_CAP):
    """The SCA convex majorant of G(alpha, ·) around an expansion point.

    ``hs``/``hv`` are the exact H terms at the query beta, ``hs_lin``/
    ``hv_lin`` their tangent linearizations at the expansion point, and
    ``e0`` the four term exponents at the expansion point.  Positive
    coefficients keep the exact convex structure with H_v linearized
    (eq. (41)/(43)); negative coefficients take the supporting line of
    exp with the concave +H_s piece tangent-linearized — the t/y/z
    relaxations (45)/(47) with the aux variables eliminated at their
    optima.
    """
    total = xp.zeros_like(hs)
    for j, (wv, ws) in enumerate(TERM_W):
        c = cs[j]
        pos = c >= 0
        # c >= 0: exact -H_s (convex), linearized H_v -> convex majorant
        expo = wv * hv_lin / om - ws * hs / a
        t_pos = c * xp.exp(xp.minimum(expo, exp_cap))
        # c < 0: supporting line of exp at the expansion point, with the
        # concave +H_s piece tangent-linearized -> convex majorant
        e = wv * hv / om - ws * hs_lin / a
        base = xp.exp(xp.minimum(e0[j], exp_cap))
        t_neg = c * base * (1.0 + e - e0[j])
        total = total + xp.where(pos, t_pos, t_neg)
    return total
