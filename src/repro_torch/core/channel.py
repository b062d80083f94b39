"""Wireless uplink channel model — paper §II-C1, eq. (9)-(14) (the port
of ``repro.core.channel``): the static geometry, the AR(1) log-normal
shadowing of ``allocation_cadence='per_round'``, the capacities, the
paper's H terms and success probabilities, and the outcome simulators.

Randomness is explicit: geometry draws take a ``torch.Generator``; the
shadowing takes its standard normals and the outcome simulators their
uniforms or Exp(1) draws as tensors, so the simulator can draw them from
its generators and parity tests can pass the reference's draws.

The shadowing keeps the reference's float32 arithmetic bit for bit where
it can: the reference's AR(1) step ``rho z + c e`` runs inside
``lax.scan``, where XLA contracts it into one fused multiply-add,
fma(rho, z, f32(c e)), which :func:`_fma_step` emulates (the exact
product in float64, one rounding to float32); and ``10 ** x`` is taken in
float64 and rounded once, which equals XLA's float32 power on all but
~0.1% of arguments and is never more than 1 ulp from it.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.quantize import true_div

Tensor = torch.Tensor

CHANNEL_KINDS = ('bernoulli', 'bitlevel')


def sqrt_rounded(x: Tensor) -> Tensor:
    """The correctly rounded square root in ``x``'s dtype: a float32 root
    is taken in float64 and rounded once (PyTorch's CPU float32 ``sqrt``
    is an ulp off on ~0.7% of arguments; XLA's is correctly rounded)."""
    if x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def annulus_radius(u, radius_m: float, min_m: float = 10.0):
    """Inverse CDF of the uniform-in-annulus radial density."""
    return sqrt_rounded(min_m ** 2 + (radius_m ** 2 - min_m ** 2)
                        * torch.as_tensor(u))


def sample_distances(generator: torch.Generator, k: int, radius_m: float,
                     min_m: float = 10.0) -> np.ndarray:
    """Uniform-in-annulus device placement around the PS (float32)."""
    u = torch.rand((k,), generator=generator, dtype=torch.float32)
    return annulus_radius(u, radius_m, min_m).numpy()


def path_gain(distance_m: np.ndarray, zeta: float) -> np.ndarray:
    """Large-scale gain d^{-zeta}."""
    return distance_m ** (-zeta)


def _pow(base: float, x: Tensor) -> Tensor:
    """``base ** x``; in float32 taken in float64 and rounded once (within
    1 ulp of XLA's float32 power, equal on ~99.9% of arguments)."""
    if x.dtype == torch.float32:
        return torch.pow(base, x.to(torch.float64)).to(torch.float32)
    return torch.pow(base, x)


def _over(numerator: float, t: Tensor) -> Tensor:
    """``numerator / t`` as the IEEE quotient (PyTorch computes a Python
    number over a tensor as the number times the tensor's reciprocal)."""
    return torch.full_like(t, numerator) / t


# ---------------------------------------------------------------------------
# block fading: AR(1) log-normal shadowing over the static geometry
# ---------------------------------------------------------------------------

def _ar1_coefficient(rho: float) -> float:
    """c = sqrt(1 - rho^2) as the reference rounds it (float32)."""
    return float(np.sqrt(np.float32(1.0 - rho ** 2)))


def _fma_step(z: Tensor, ce: Tensor, rho: float) -> Tensor:
    """fma(f32(rho), z, ce) rounded to float32: XLA's contraction of the
    reference's scanned ``rho * z + c * e``."""
    rho32 = float(np.float32(rho))
    return (rho32 * z.to(torch.float64)
            + ce.to(torch.float64)).to(torch.float32)


def block_fading_trajectory(eps: Tensor, base_gains, rho: float = 0.9,
                            shadow_std_db: float = 4.0) -> Tensor:
    """Per-round large-scale gains (n_rounds, K), float32, from the
    (n_rounds, K) standard normals ``eps``: z_0 = eps_0,
    z_n = rho z_{n-1} + sqrt(1 - rho^2) eps_n (a stationary Gauss-Markov
    track, as the reference's scan rounds it), and
    gain_n = base_gains * 10^(shadow_std_db z_n / 10).  ``rho`` sets the
    coherence of consecutive rounds; every round's marginal is log-normal
    with ``shadow_std_db`` dB standard deviation."""
    eps = torch.as_tensor(eps, dtype=torch.float32)
    c = _ar1_coefficient(rho)
    zs = [eps[0]]
    for e in eps[1:]:
        zs.append(_fma_step(zs[-1], c * e, rho))
    return shadow_gains(base_gains, torch.stack(zs), shadow_std_db)


def shadow_init(eps: Tensor) -> Tensor:
    """z_0 of the shadowing track: the (K,) standard normals ``eps``."""
    return torch.as_tensor(eps).to(torch.float32)


def shadow_step(eps: Tensor, z: Tensor, rho: float = 0.9) -> Tensor:
    """One AR(1) transition z -> rho z + sqrt(1 - rho^2) eps, in ``z``'s
    dtype, one rounding per operation (the reference's step outside a
    scan)."""
    c = torch.sqrt(torch.tensor(1.0 - rho ** 2, dtype=z.dtype))
    return rho * z + c.to(z.device) * eps.to(z.dtype)


def shadow_gains(base_gains, z: Tensor, shadow_std_db: float = 4.0
                 ) -> Tensor:
    """Instantaneous large-scale gains base * 10^(shadow_std_db z / 10)
    for shadowing state ``z``, in the base gains' dtype."""
    base = torch.as_tensor(base_gains, device=z.device)
    x = true_div(shadow_std_db * z.to(base.dtype), 10.0)
    return base * _pow(10.0, x)


# ---------------------------------------------------------------------------
# capacities (9), (10), given an instantaneous fading realization
# ---------------------------------------------------------------------------

def sign_capacity(alpha, beta, p_w, gain, h2, fl: FLConfig):
    bw = beta * fl.bandwidth_hz / 2.0
    snr = 2.0 * alpha * p_w * h2 * gain / (beta * fl.bandwidth_hz
                                           * fl.noise_psd_w)
    return bw * torch.log2(1.0 + snr)


def modulus_capacity(alpha, beta, p_w, gain, h2, fl: FLConfig):
    bw = beta * fl.bandwidth_hz / 2.0
    snr = (2.0 * (1.0 - alpha) * p_w * h2 * gain
           / (beta * fl.bandwidth_hz * fl.noise_psd_w))
    return bw * torch.log2(1.0 + snr)


# ---------------------------------------------------------------------------
# the paper's H terms (12), (14) and success probabilities (11), (13)
# ---------------------------------------------------------------------------

def h_term(beta, p_w, gain, n_bits, fl: FLConfig):
    """H(beta) = beta B N0 / (4 P d^-zeta) (1 - 2^{2 R / (beta B tau)})
    for a packet of ``n_bits``.  Always <= 0."""
    bb = torch.as_tensor(beta) * fl.bandwidth_hz
    expo = _over(2.0 * n_bits, bb * fl.latency_s)
    return (bb * fl.noise_psd_w / (4.0 * p_w * gain)) * (1.0 - _pow(2.0,
                                                                     expo))


def h_sign(beta, p_w, gain, dim: int, fl: FLConfig):
    """H_s, eq. (12): the sign packet is l bits."""
    return h_term(beta, p_w, gain, float(dim), fl)


def h_modulus(beta, p_w, gain, dim: int, fl: FLConfig):
    """H_v, eq. (14): the modulus packet is l*b + b0 bits."""
    return h_term(beta, p_w, gain,
                  float(dim * fl.quant_bits + fl.b0_bits), fl)


def sign_success_prob(alpha, h_s):
    """q_{k,n}, eq. (11): exp(H_s / alpha); 0 at alpha = 0."""
    alpha = torch.as_tensor(alpha)
    safe = torch.clamp(alpha, min=1e-12)
    return torch.where(alpha > 0, torch.exp(h_s / safe), 0.0)


def modulus_success_prob(alpha, h_v):
    """p_{k,n}, eq. (13): exp(H_v / (1 - alpha)); 0 at alpha = 1."""
    alpha = torch.as_tensor(alpha)
    safe = torch.clamp(1.0 - alpha, min=1e-12)
    return torch.where(alpha < 1, torch.exp(h_v / safe), 0.0)


def success_probs(alpha, beta, p_w, gain, dim: int, fl: FLConfig):
    """(q, p) for all devices."""
    q = sign_success_prob(alpha, h_sign(beta, p_w, gain, dim, fl))
    p = modulus_success_prob(alpha, h_modulus(beta, p_w, gain, dim, fl))
    return q, p


def simulate_outcomes(u_sign: Tensor, u_mod: Tensor, q: Tensor, p: Tensor
                      ) -> Tuple[Tensor, Tensor]:
    """Independent Bernoulli(q) / Bernoulli(p) packet outcomes from the
    uniforms ``u_sign``, ``u_mod`` (same shapes as ``q``, ``p``)."""
    return u_sign < q, u_mod < p


def simulate_attempts(u: Tensor, q: Tensor, n_retx: int
                      ) -> Tuple[Tensor, Tensor]:
    """``1 + n_retx`` sign transmissions from uniforms ``u`` of shape
    (n_retx + 1, K) -> (sign_ok, number of resends performed)."""
    succ = u < q[None, ...]
    sign_ok = torch.any(succ, dim=0)
    first = torch.argmax(succ.to(torch.int32), dim=0).to(torch.int32)
    n_resends = torch.where(sign_ok, first,
                            torch.full_like(first, n_retx))
    return sign_ok, n_resends


def simulate_outcomes_fading(h2_s: Tensor, h2_v: Tensor, alpha, beta, p_w,
                             gain, dim: int, fl: FLConfig
                             ) -> Tuple[Tensor, Tensor]:
    """Outcomes from explicit Rayleigh draws |h|^2 ~ Exp(1) per packet
    (``h2_s``, ``h2_v``), thresholded: equivalent in distribution to
    :func:`simulate_outcomes` with the analytic (q, p)."""
    alpha = torch.as_tensor(alpha)
    thr_s = -h_sign(beta, p_w, gain, dim, fl) / torch.clamp(alpha, min=1e-12)
    thr_v = (-h_modulus(beta, p_w, gain, dim, fl)
             / torch.clamp(1.0 - alpha, min=1e-12))
    sign_ok = (alpha > 0) & (h2_s >= thr_s)
    mod_ok = (alpha < 1) & (h2_v >= thr_v)
    return sign_ok, mod_ok
