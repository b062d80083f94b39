"""One-step convergence analysis of SP-FL — paper §III, Theorem 1 (the
port's own NumPy copy of ``repro.core.convergence``).

Everything here is closed-form algebra over per-client scalars:

  g2_k   = ||g_k||^2        local gradient energy
  gb2_k  = ||gbar||^2       compensation-vector energy (per client if the
                            compensation is client-specific)
  v_k    = <g_k, s(g_k) ⊙ gbar>  >= 0   similarity term (Remark 3)
  d2_k   = delta_k^2        quantization error bound (Lemma 2)
  e2_k   = eps_k^2          local/global gradient divergence (Assumption 2)

The surrogate G(alpha, beta) of eq. (27) is what the resource allocator
minimizes; ``one_step_bound`` is the full right-hand side of eq. (26) used
to validate Theorem 1 against the measured loss decrement (paper Fig. 2).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core import alloc_common as AC

# exponent clamp: beyond this the success probability underflows to 0 and
# the bound is numerically +inf — we saturate instead of overflowing.
# (defined in alloc_common so the JAX engine shares it; re-exported here
# for the existing importers)
EXP_CAP = AC.EXP_CAP


class GCoefficients(NamedTuple):
    """A, B, C, D of eq. (27) (arrays over clients)."""
    A: np.ndarray
    B: np.ndarray
    C: np.ndarray
    D: np.ndarray


def g_coefficients(g2, gb2, v, d2, lipschitz: float,
                   eta: float) -> GCoefficients:
    g2, gb2, v, d2 = map(np.asarray, (g2, gb2, v, d2))
    return GCoefficients(*AC.g_coefficients(np, g2, gb2, v, d2,
                                            lipschitz, eta))


def g_exponents(alpha, h_s, h_v):
    """The four exponents of eq. (27) with boundary-safe alpha in [0, 1]."""
    return AC.g_exponents(np, np.asarray(alpha, np.float64), h_s, h_v)


def g_value(coef: GCoefficients, alpha, h_s, h_v):
    """G(alpha, beta) of eq. (27) (h_s, h_v already encode beta)."""
    return AC.g_value(np, tuple(coef), np.asarray(alpha, np.float64),
                      h_s, h_v)


def g_value_from_probs(coef: GCoefficients, p, q):
    """First line of eq. (27): G expressed through (p, q) directly.

    Uses the same saturation as the exp-form (q floored at e^-EXP_CAP) so
    the two forms agree numerically even in deep outage.
    """
    p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
    qs = np.maximum(q, np.exp(-EXP_CAP))
    # A p + B p^2 + C p/q + D / q  (regrouped form)
    return coef.A * p + coef.B * p * p + coef.C * p / qs + coef.D / qs


def g_prime_alpha(coef: GCoefficients, alpha, h_s, h_v):
    """dG/dalpha, eq. (69) — the Newton–Raphson target of Lemma 3."""
    return AC.g_prime_alpha(np, tuple(coef),
                            np.asarray(alpha, np.float64), h_s, h_v)


def one_step_bound(eta: float, n_clients: int, g_global2: float,
                   gb2, g2, e2, v, g_sum) -> float:
    """Right-hand side of eq. (26): the Theorem-1 upper bound on
    E[F(w_{n+1})] - F(w_n).

    gb2 may be scalar or per-client; g_sum = sum_k G(alpha_k, beta_k).
    """
    gb2 = np.asarray(gb2, np.float64)
    mean_gb2 = float(np.mean(gb2))
    term = (-eta / 2.0 * g_global2
            + eta / 2.0 * mean_gb2
            + eta / n_clients * float(np.sum(
                np.asarray(g2) + np.asarray(e2) - 2.0 * np.asarray(v)))
            + eta / (2.0 * n_clients) * float(np.sum(g_sum)))
    return term


def bound_inputs_from_grads(grads: np.ndarray, gbar: np.ndarray):
    """Convenience: per-client scalars from stacked grads (K, l) and the
    compensation modulus vector gbar (l,) or (K, l)."""
    grads = np.asarray(grads, np.float64)
    gbar = np.asarray(gbar, np.float64)
    g_global = grads.mean(axis=0)
    g2 = np.sum(grads ** 2, axis=1)
    if gbar.ndim == 1:
        gbar_k = np.broadcast_to(gbar, grads.shape)
    else:
        gbar_k = gbar
    gb2 = np.sum(gbar_k ** 2, axis=1)
    v = np.sum(np.abs(grads) * gbar_k, axis=1)   # <g, s(g) ⊙ gbar>
    e2 = np.sum((grads - g_global) ** 2, axis=1)
    g_global2 = float(np.sum(g_global ** 2))
    return dict(g2=g2, gb2=gb2, v=v, e2=e2, g_global2=g_global2)
