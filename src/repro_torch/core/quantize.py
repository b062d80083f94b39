"""Stochastic gradient quantization — paper §II-B, eq. (7)-(8), Lemma 2
(the port of ``repro.core.quantize``).

The random input is explicit: ``stochastic_quantize`` takes the uniform
draws ``rand`` (same shape as ``g``) instead of a PRNG key, so parity
tests can feed the reference's own draws.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor


class QuantizedGradient(NamedTuple):
    """Sign/modulus-decoupled quantized gradient (the two packets)."""
    sign: Tensor       # int8, in {-1, 0, +1}
    qidx: Tensor       # int32 knob index in [0, 2^b - 1]
    g_min: Tensor      # per-client min |g| (broadcastable against g)
    g_max: Tensor      # per-client max |g|
    bits: int


def quant_range(g: Tensor, dim=None) -> Tuple[Tensor, Tensor]:
    """(g_min, g_max) = (min|g|, max|g|) — the paper's quantizer range."""
    a = torch.abs(g)
    if dim is None:
        return a.min(), a.max()
    return a.amin(dim=dim), a.amax(dim=dim)


def true_div(x: Tensor, divisor: float) -> Tensor:
    """``x / divisor`` as the IEEE quotient on every device.  PyTorch's
    CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which differs by an ulp for divisors like 7; a tensor
    divisor takes the true division."""
    return x / torch.full_like(x, divisor)


def knob_step(g_min: Tensor, g_max: Tensor, bits: int) -> Tensor:
    return true_div(g_max - g_min, float(2 ** bits - 1))


def stochastic_quantize(g: Tensor, bits: int, rand: Tensor,
                        g_min: Tensor | None = None,
                        g_max: Tensor | None = None) -> QuantizedGradient:
    """Quantize per eq. (8) with explicit uniforms ``rand`` in [0, 1).
    Same op order as the reference (and the ``quantize_pack`` kernel)."""
    if g_min is None or g_max is None:
        g_min, g_max = quant_range(g)
    step = knob_step(g_min, g_max, bits)
    a = torch.abs(g).to(torch.float32)
    u = torch.where(step > 0,
                    (a - g_min) / torch.where(step > 0, step, 1.0), 0.0)
    lower = torch.clamp(torch.floor(u), 0, 2 ** bits - 1)
    frac = u - lower                        # P(round up), eq. (8)
    qidx = (lower + (rand < frac).to(torch.float32)).to(torch.int32)
    qidx = torch.clamp(qidx, 0, 2 ** bits - 1)
    sign = torch.sign(g).to(torch.int8)
    return QuantizedGradient(sign, qidx, g_min, g_max, bits)


def dequantize_modulus(qg: QuantizedGradient) -> Tensor:
    """Recover the (nonnegative) modulus vector Q_v(g)."""
    step = knob_step(qg.g_min, qg.g_max, qg.bits)
    return qg.g_min + qg.qidx.to(torch.float32) * step


def expected_quant_mse(g: Tensor, bits: int, dim=None) -> Tensor:
    """EXACT E||Q(g) - g||^2 of the stochastic quantizer with the range
    taken over ``dim``: sum_i step^2 * frac_i * (1 - frac_i)."""
    g_min, g_max = quant_range(g, dim=dim)
    if dim is not None:
        g_min, g_max = g_min.unsqueeze(dim), g_max.unsqueeze(dim)
    step = knob_step(g_min, g_max, bits)
    safe = torch.where(step > 0, step, 1.0)
    u = torch.where(step > 0,
                    (torch.abs(g).to(torch.float32) - g_min) / safe, 0.0)
    frac = u - torch.floor(u)
    return torch.sum(step ** 2 * frac * (1.0 - frac), dim=dim)


def packet_bits(dim: int, bits: int, b0: int) -> Tuple[int, int]:
    """(sign packet bits, modulus packet bits), §II-C1."""
    return dim, dim * bits + b0
