"""Wireless uplink channel model — paper §II-C1, eq. (9)-(14) (the port
of the subset of ``repro.core.channel`` the round uses).

Randomness is explicit: geometry draws take a ``torch.Generator``; the
per-round outcome simulators take their uniforms as tensors, so the
simulator can draw them from its generator and parity tests can pass
the reference's draws.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLConfig

Tensor = torch.Tensor

CHANNEL_KINDS = ('bernoulli', 'bitlevel')


def annulus_radius(u, radius_m: float, min_m: float = 10.0):
    """Inverse CDF of the uniform-in-annulus radial density."""
    return torch.sqrt(min_m ** 2 + (radius_m ** 2 - min_m ** 2)
                      * torch.as_tensor(u))


def sample_distances(generator: torch.Generator, k: int, radius_m: float,
                     min_m: float = 10.0) -> np.ndarray:
    """Uniform-in-annulus device placement around the PS (float32)."""
    u = torch.rand((k,), generator=generator, dtype=torch.float32)
    return annulus_radius(u, radius_m, min_m).numpy()


def path_gain(distance_m: np.ndarray, zeta: float) -> np.ndarray:
    """Large-scale gain d^{-zeta}."""
    return distance_m ** (-zeta)


def h_term(beta, p_w, gain, n_bits, fl: FLConfig):
    """H(beta) = beta B N0 / (4 P d^-zeta) (1 - 2^{2 R / (beta B tau)})."""
    bb = torch.as_tensor(beta) * fl.bandwidth_hz
    expo = 2.0 * n_bits / (bb * fl.latency_s)
    return (bb * fl.noise_psd_w / (4.0 * p_w * gain)) * (1.0 - 2.0 ** expo)


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
