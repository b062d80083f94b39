"""Adversarial client models and the straggler/dropout process (the port
of ``repro.adversary.clients``).

Attacks are per-client transforms applied where the lie is told on the
wire:

* ``signflip``: the byzantine client sends the bitwise complement of its
  sign payload.  On the packed wire that is an xor of the framed sign
  buffer's payload words with a tail-masked all-ones pattern, and the
  CRC word is patched by the pattern's xor fold (the fold is linear), so
  the forged frame verifies.  On the analytic wire the quantized sign
  matrix is negated.
* ``scaled``: the client reports ``attack_scale`` x its ``(g_min,
  g_max)`` after quantizing honestly; dequantization is affine in the
  range, so the decoded row is ``scale`` x the honest modulus.
* ``labelflip``: data poisoning at set-up, ``n_classes - 1 - y`` on the
  byzantine rows; the radio stays honest.

Randomness is explicit: :func:`byzantine_mask` takes the permutation and
:func:`straggler_step` / :func:`bernoulli_active` the K uniforms.  The
simulator draws them from host generators seeded with the run seed plus
``BYZ_FOLD`` / ``STRAGGLER_FOLD`` (the reference folds the same constants
into its key), so switching a knob on leaves every other draw as it was.
The straggler state is a (K,) bool Gilbert chain (sticky two-state
Markov), True = active.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.quantize import QuantizedGradient
from repro_torch.wire import format as wire_fmt

Tensor = torch.Tensor

ATTACK_KINDS = ('none', 'signflip', 'scaled', 'labelflip')

BYZ_FOLD = 0xB12A          # byzantine membership (once per run)
STRAGGLER_FOLD = 0xD801    # per-round straggler transition draw


def byzantine_mask(k: int, frac: float, perm: Tensor) -> Tensor:
    """(K,) bool: the first floor(frac * k) entries of the permutation
    ``perm`` of range(k) are byzantine."""
    mask = torch.zeros((k,), dtype=torch.bool, device=perm.device)
    m = int(math.floor(float(frac) * k))
    if m > 0:
        mask[perm[:m]] = True
    return mask


# ---------------------------------------------------------------------------
# attacks
# ---------------------------------------------------------------------------

def signflip_pattern(n_words: int, n: int) -> np.ndarray:
    """(n_words,) uint32 xor pattern of a framed sign packet: all ones on
    the payload words (the last one's pad lanes clear), zero on the
    header, and the CRC word the xor fold of the rest."""
    h, c = wire_fmt.SIGN_HEADER_WORDS, wire_fmt.CRC_WORDS
    pat = np.zeros((n_words,), np.uint32)
    pat[h:n_words - c] = np.uint32(wire_fmt.MASK32)
    tail = n % wire_fmt.GROUP
    if tail:
        pat[n_words - c - 1] = np.uint32((1 << tail) - 1)
    pat[-1] = np.bitwise_xor.reduce(pat)
    return pat


def signflip_frames(sign_words: Tensor, mask: Tensor, n: int) -> Tensor:
    """Packed-domain sign flip of FRAMED sign buffers (K, Ws) int32: the
    byzantine rows' payload complemented (pad bits stay 0) and their CRC
    patched so the forged frame verifies; headers untouched."""
    pat = signflip_pattern(sign_words.shape[1], n).view(np.int32)
    pat = torch.as_tensor(pat, device=sign_words.device)
    return torch.where(mask[:, None], sign_words ^ pat[None, :], sign_words)


def flip_signs(qg: QuantizedGradient, mask: Tensor) -> QuantizedGradient:
    """Analytic-wire sign flip: negate the byzantine rows' signs."""
    s = torch.where(mask[:, None], -qg.sign, qg.sign).to(qg.sign.dtype)
    return qg._replace(sign=s)


def scale_range(x: Tensor, mask: Tensor, scale: float) -> Tensor:
    """One range scalar per client (``x`` (K,) or (K, 1)) times ``scale``
    on the byzantine rows, an f32 product by an f32 tensor."""
    m = mask.reshape((-1,) + (1,) * (x.dim() - 1))
    s = torch.full((), scale, dtype=torch.float32, device=x.device)
    return torch.where(m, x * s, x)


def scale_ranges(qg: QuantizedGradient, mask: Tensor,
                 scale: float) -> QuantizedGradient:
    """Scaled-update attack: the reported (g_min, g_max) inflated after
    honest quantization."""
    return qg._replace(g_min=scale_range(qg.g_min, mask, scale),
                       g_max=scale_range(qg.g_max, mask, scale))


def flip_labels(y: Tensor, mask: Tensor, n_classes: int = 10) -> Tensor:
    """Label-flip poisoning of the (K, B) client labels: byzantine rows
    see ``n_classes - 1 - y``."""
    return torch.where(mask[:, None], n_classes - 1 - y, y)


# ---------------------------------------------------------------------------
# straggler / dropout process
# ---------------------------------------------------------------------------

def straggler_probs(rate: float, stickiness: float):
    """Gilbert-chain transition probabilities (p_fail, p_recover) whose
    stationary inactive fraction is ``rate``; ``stickiness`` is the
    inactive state's persistence, clamped to [0, 0.999]."""
    rate = float(rate)
    st = min(max(float(stickiness), 0.0), 0.999)
    p_rec = 1.0 - st
    p_fail = min(1.0, rate * p_rec / max(1.0 - rate, 1e-6))
    return p_fail, p_rec


def straggler_init(k: int, device=None) -> Tensor:
    """(K,) bool straggler state (True = active); starts all active."""
    return torch.ones((k,), dtype=torch.bool, device=device)


def straggler_step(u: Tensor, state: Tensor, rate: float,
                   stickiness: float):
    """One sticky Markov transition on the (K,) f32 uniforms ``u`` ->
    (new state, active this round).  rate 0 keeps everyone active."""
    p_fail, p_rec = straggler_probs(rate, stickiness)
    nxt = torch.where(state, u >= p_fail, u < p_rec)
    return nxt, nxt


def bernoulli_active(u: Tensor, rate: float) -> Tensor:
    """Memoryless dropout (K,) bool from the (K,) uniforms ``u``."""
    return u >= float(rate)
