"""Plain PyTorch versions of the CUDA kernels — the oracles.

Each function computes exactly what its kernel computes, with the
kernel's interface (padded group layout, precomputed knob step,
thresholds instead of BERs), in the kernel's order of float operations.  ``kernels.ops`` calls them for tensors that
lie on the CPU; ``chip_smoke.py`` holds each kernel against them on the
card.  They work on any device, in int64 masked to 32 bits for words.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quantize import knob_step
from repro_torch.wire import corrupt as wire_corrupt
from repro_torch.wire import format as fmt

Tensor = torch.Tensor


def _to_groups(x: Tensor) -> Tensor:
    """(K, n) -> (K, G, 32), zero-padded (the TPU kernels' _to_groups)."""
    k, n = x.shape
    g = fmt.n_groups(n)
    return torch.nn.functional.pad(x, (0, g * fmt.GROUP - n)).reshape(
        k, g, fmt.GROUP)


def _mask_tail(sign_words: Tensor, n: int) -> Tensor:
    """Zero the padding lanes of each client's last sign word (padding
    quantizes as g = 0, which packs as sign bit 1)."""
    rem = n % fmt.GROUP
    if rem == 0:
        return sign_words
    out = sign_words.clone()
    out[:, -1] = sign_words[:, -1] & ((1 << rem) - 1)
    return out


def _pack_planes(v: Tensor, bits: int) -> Tensor:
    """(K, G, 32) int64 values -> (K, G * bits) int64 words."""
    lane = torch.arange(fmt.GROUP, dtype=torch.int64, device=v.device)
    planes = [torch.sum(((v >> j) & 1) << lane, dim=-1) for j in range(bits)]
    return torch.stack(planes, dim=-1).reshape(v.shape[0], -1)


def quantize_body(g: Tensor, r: Tensor, gmin: Tensor, gmax: Tensor,
                  bits: int) -> Tensor:
    """Eq. (8) stochastic rounding -> knob index as f32 (same op order as
    ``repro.kernels.quantize_kernel.quantize_body``)."""
    nk = float(2 ** bits - 1)
    step = knob_step(gmin, gmax, bits)
    safe = torch.where(step > 0.0, step, 1.0)
    u = torch.where(step > 0.0, (torch.abs(g) - gmin) / safe, 0.0)
    lower = torch.clamp(torch.floor(u), 0.0, nk)
    frac = u - lower
    up = (r < frac).to(torch.float32)
    return torch.clamp(lower + up, 0.0, nk)


def quantize(g: Tensor, rand: Tensor, gmin: Tensor, gmax: Tensor,
             bits: int) -> Tuple[Tensor, Tensor]:
    """(n,) f32 gradient and uniforms, one-element ranges -> (sign int8 in
    {-1, 0, +1}: g = 0 and g = -0 give 0; knob index int32)."""
    qidx = quantize_body(g, rand, gmin, gmax, bits)
    return torch.sign(g).to(torch.int8), qidx.to(torch.int32)


def dequant(sign: Tensor, qidx: Tensor, gbar: Tensor, gmin: Tensor,
            gmax: Tensor, mod_ok: Tensor, weight: Tensor, bits: int
            ) -> Tensor:
    """(w * s) * (mod_ok ? gmin + q * step : gbar) with the knob step
    computed here (IEEE division), (n,) f32."""
    step = knob_step(gmin, gmax, bits)
    modulus = gmin + qidx.to(torch.float32) * step
    modulus = torch.where(mod_ok > 0.0, modulus, gbar)
    return (weight * sign.to(torch.float32)) * modulus


def roundtrip(g: Tensor, rand: Tensor, gbar: Tensor, gmin: Tensor,
              gmax: Tensor, mod_ok: Tensor, weight: Tensor, bits: int
              ) -> Tensor:
    """Quantize, dequantize, compensate and weight: ``dequant(quantize())``."""
    sign, qidx = quantize(g, rand, gmin, gmax, bits)
    return dequant(sign, qidx, gbar, gmin, gmax, mod_ok, weight, bits)


def pack_bits(values: Tensor, bits: int) -> Tensor:
    """(n,) values -> (G * bits,) bit-plane words; bits of a value at and
    above ``bits`` are dropped."""
    return fmt.pack_bits_ref(values, bits)


def unpack_bits(words: Tensor, n: int, bits: int) -> Tensor:
    """(G * bits,) words -> (n,) values as int32 patterns."""
    return fmt.to_words(fmt.unpack_bits_ref(words, n, bits))


def quantize_pack(g: Tensor, rand: Tensor, gmin: Tensor, gmax: Tensor,
                  bits: int) -> Tuple[Tensor, Tensor]:
    """(K, n) f32 gradient and uniforms, (K,) ranges -> (sign words
    (K, G), knob words (K, G * bits)), int32 patterns."""
    n = g.shape[1]
    g3, r3 = _to_groups(g), _to_groups(rand)
    qidx = quantize_body(g3, r3, gmin.reshape(-1, 1, 1),
                         gmax.reshape(-1, 1, 1), bits)
    sign = _pack_planes((g3 >= 0.0).to(torch.int64), 1)
    knob = _pack_planes(qidx.to(torch.int64), bits)
    return fmt.to_words(_mask_tail(sign, n)), fmt.to_words(knob)


def _contribs(sign_payload: Tensor, qidx_payload: Tensor, gbar: Tensor,
              gmin: Tensor, step: Tensor, mod_ok: Tensor, weight: Tensor,
              n: int, bits: int) -> Tuple[Tensor, Tensor]:
    """Decode of K clients' payload words -> (sign bits (K, n) int64,
    w_k * (s_k * (mod_ok_k ? gmin_k + q_k * step_k : gbar)) (K, n) f32)."""
    k = sign_payload.shape[0]
    sbits = fmt.unpack_bits_ref(sign_payload, n, 1)               # (K, n)
    sign = torch.where(sbits > 0, 1.0, -1.0)
    qidx = fmt.unpack_bits_ref(qidx_payload, n, bits).to(torch.float32)
    modulus = gmin.reshape(k, 1) + qidx * step.reshape(k, 1)
    gb = gbar if gbar.dim() == 2 else gbar[None, :]
    modulus = torch.where(mod_ok.reshape(k, 1) > 0.0, modulus, gb)
    return sbits, weight.reshape(k, 1) * (sign * modulus)


def spfl_accumulate(sign_payload: Tensor, qidx_payload: Tensor,
                    gbar: Tensor, gmin: Tensor, step: Tensor,
                    mod_ok: Tensor, weight: Tensor, vote_gate: Tensor,
                    n: int, bits: int, with_votes: bool
                    ) -> Tuple[Tensor, Optional[Tensor]]:
    """sum_k w_k * s_k * (mod_ok_k ? gmin_k + q_k * step_k : gbar), summed
    k = 0..K-1 in order in f32, and the gated +1 sign votes (int32)."""
    k = sign_payload.shape[0]
    sbits, contrib = _contribs(sign_payload, qidx_payload, gbar, gmin, step,
                               mod_ok, weight, n, bits)
    acc = contrib[0]
    for i in range(1, k):
        acc = acc + contrib[i]
    votes = None
    if with_votes:
        gate = vote_gate.reshape(k, 1).to(torch.int64)
        votes = torch.sum(sbits * gate, dim=0).to(torch.int32)
    return acc, votes


def unpack_dequant(sign_words: Tensor, qidx_words: Tensor, gbar: Tensor,
                   gmin: Tensor, step: Tensor, mod_ok: Tensor,
                   weight: Tensor, n: int, bits: int) -> Tensor:
    """One client's decode from its (G,) sign and (G * bits,) knob words:
    w * (s * (mod_ok ? gmin + q * step : gbar)), (n,) f32 — one row of
    :func:`spfl_accumulate` without votes."""
    return _contribs(sign_words[None], qidx_words[None], gbar, gmin, step,
                     mod_ok, weight, n, bits)[1][0]


def corrupt_fold(seeds, words: Tensor, thresh: Tensor,
                 allflip: Tensor, word0: int = 0
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """Counter-PRF flips of (K, W) words at per-client uint32 thresholds
    with the seed words ``seeds`` (two ints, or a (2,) int32 tensor of
    their patterns, as the kernel reads them) -> (received, mask xor-fold
    (K,), flip count (K,)), int32."""
    mask = wire_corrupt.threshold_mask(seeds, tuple(words.shape), thresh,
                                       allflip, word0, words.device)
    return (fmt.to_words(words) ^ fmt.to_words(mask), fmt.xor_fold(mask),
            wire_corrupt.count_flips(mask))


def fold_words(words: Tensor) -> Tensor:
    """Per-client xor-fold of (K, W) words -> (K,) int32."""
    return fmt.xor_fold(words)
