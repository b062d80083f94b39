"""The flat SP-FL transport — the uplink of one FL round (the port of
``repro.core.transport.spfl_aggregate`` for ``collective='gather'``).

``spfl_aggregate`` consumes per-client gradients (K, l) and produces the
aggregate the PS decodes, eq. (15)-(17): per-client stochastic
quantization into a sign packet and a modulus packet, packet outcomes,
ḡ compensation of lost moduli, 1/q weighting, and the sum over clients in
the order k = 0..K-1 (``_seq_client_sum``).

``wire='packed'`` materializes the packets as framed uint32 word buffers:
the ``quantize_pack`` kernel quantizes and packs every client in one
read of the gradients, and the ``spfl_accumulate`` kernel decodes,
compensates, weights and sums all clients straight from the payload
words.  ``channel='bitlevel'`` sends the buffers through the bit channel
(``core.bitchannel``: the ``corrupt_fold`` and ``fold_words`` kernels).
``wire='analytic'`` and ``channel='bernoulli'`` are the plain PyTorch
branches of the same function.

Randomness is explicit (:class:`Draws`): the (K, l) quantizer uniforms,
the seed words of every bit-channel stream, and the Bernoulli outcome
uniforms.  The simulator fills them from its generators; the parity
tests fill them from the reference's own keys.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import bitchannel
from repro_torch.core import channel as chan
from repro_torch.core.quantize import (
    dequantize_modulus, packet_bits, stochastic_quantize, true_div,
)
from repro_torch.kernels import ops as kops
from repro_torch.obs.record import RoundTelemetry
from repro_torch.wire import format as wire_fmt
from repro_torch.wire import packets as wire_packets

Tensor = torch.Tensor

WIRE_KINDS = ('analytic', 'packed')
_Q_FLOOR = 1e-8        # below this, 1/q unbiasing is switched off (q ~ 0)


class Draws(NamedTuple):
    """The random inputs of one round's transport."""
    rand: Tensor                          # (K, l) f32 quantizer uniforms
    sign_seeds: Tuple[Tuple[int, int], ...] = ()  # bitlevel: one uint32
    #   seed pair per sign transmission attempt (1 + n_retx)
    mod_seeds: Optional[Tuple[int, int]] = None   # bitlevel: modulus stream
    sign_u: Optional[Tensor] = None       # bernoulli: (1 + n_retx, K) f32
    mod_u: Optional[Tensor] = None        # bernoulli: (K,) f32


def make_draws(k: int, l: int, n_retx: int, channel: str,
               device: torch.device, generator: torch.Generator,
               host_generator: torch.Generator) -> Draws:
    """One round's draws: the (K, l) uniforms from ``generator`` on
    ``device``; seeds and outcome uniforms from ``host_generator``."""
    rand = torch.rand((k, l), generator=generator, device=device)
    if channel == 'bitlevel':
        words = torch.randint(0, 2 ** 32, (n_retx + 2, 2),
                              generator=host_generator).tolist()
        return Draws(rand, tuple(map(tuple, words[1:])), tuple(words[0]))
    sign_u = torch.rand((n_retx + 1, k), generator=host_generator)
    mod_u = torch.rand((k,), generator=host_generator)
    return Draws(rand, sign_u=sign_u.to(device), mod_u=mod_u.to(device))


def _inverse_prob(accept: Tensor, q: Tensor) -> Tensor:
    """accept/q with the q->0 guard (accept ~ Bernoulli(q))."""
    safe = torch.clamp(q, min=_Q_FLOOR)
    return torch.where(q > _Q_FLOOR, accept.to(torch.float32) / safe, 0.0)


def _seq_client_sum(vals: Tensor) -> Tensor:
    """Client sum in the order k = 0..K-1 (the kernel's order)."""
    acc = vals[0]
    for i in range(1, vals.shape[0]):
        acc = acc + vals[i]
    return acc


def spfl_aggregate(grads: Tensor, gbar: Tensor, q: Tensor, p: Tensor,
                   bits: int, b0: int, draws: Draws, n_retx: int = 0,
                   wire: str = 'analytic', round_idx=0,
                   channel: str = 'bernoulli',
                   min_participation: float = 0.0
                   ) -> Tuple[Tensor, RoundTelemetry]:
    """Eq. (15)-(17).  grads: (K, l) f32; gbar: (l,) or (K, l); q, p: (K,)
    f32 on the same device.  Returns (ghat (l,), telemetry).

    ``n_retx`` sign retransmissions (``spfl_retx`` uses 1);
    ``round_idx`` stamps the packet headers; ``min_participation`` is the
    graceful-degradation floor (fewer than ceil(m K) surviving modulus
    packets -> every client falls back to ḡ)."""
    if wire not in WIRE_KINDS:
        raise ValueError(f'wire must be one of {WIRE_KINDS}, got {wire!r}')
    if channel not in chan.CHANNEL_KINDS:
        raise ValueError(f'channel must be one of {chan.CHANNEL_KINDS}, '
                         f'got {channel!r}')
    if channel == 'bitlevel' and wire != 'packed':
        raise ValueError("channel='bitlevel' requires wire='packed'")
    K, l = grads.shape
    a = torch.abs(grads)
    g_min, g_max = a.amin(dim=1), a.amax(dim=1)
    q_eff = 1.0 - (1.0 - q) ** (n_retx + 1)      # sign retransmission(s)

    extras = {}
    if wire == 'packed':
        sign_pay, knob_pay = kops.quantize_pack_flat(grads, draws.rand,
                                                     g_min, g_max, bits)
        sign_words, mod_words = wire_packets.frame_uplink_batch(
            sign_pay, knob_pay, g_min, g_max, n=l, bits=bits,
            round_idx=round_idx)
        measured = wire_fmt.WORD_BITS * K * (sign_words.shape[1]
                                             + mod_words.shape[1])
    else:
        qg = stochastic_quantize(grads, bits, draws.rand, g_min[:, None],
                                 g_max[:, None])
    if channel == 'bitlevel':
        rep = bitchannel.transmit_uplink(
            sign_words, mod_words, q, p, n=l, bits=bits,
            sign_seeds=draws.sign_seeds, mod_seeds=draws.mod_seeds,
            n_retx=n_retx)
        sign_words, mod_words = rep.sign_words, rep.mod_words
        sign_ok, mod_ok = rep.sign_ok, rep.mod_ok
        retx = torch.sum(rep.retx_attempts).to(torch.float32)
        payload = float(measured) + rep.retx_bits
        extras = dict(sign_flips=rep.sign_flips, mod_flips=rep.mod_flips,
                      sign_crc_ok=rep.sign_crc_ok, mod_crc_ok=rep.mod_crc_ok,
                      retx_attempts=rep.retx_attempts)
    else:
        if wire == 'packed':
            sign_bits = wire_fmt.WORD_BITS * wire_fmt.sign_packet_words(l)
            payload_base = float(measured)
        else:
            sign_bits, mod_bits = packet_bits(l, bits, b0)
            payload_base = float(K * (sign_bits + mod_bits))
        if n_retx == 0:
            sign_ok, mod_ok = chan.simulate_outcomes(draws.sign_u[0],
                                                     draws.mod_u, q_eff, p)
            retx = torch.zeros((), dtype=torch.float32, device=grads.device)
        else:
            sign_ok, retx_k = chan.simulate_attempts(draws.sign_u, q, n_retx)
            mod_ok = draws.mod_u < p
            retx = torch.sum(retx_k).to(torch.float32)
            extras = dict(retx_attempts=retx_k)
        payload = payload_base + retx * sign_bits

    if min_participation > 0.0:
        floor = int(math.ceil(min_participation * K))
        n_mod = torch.sum(mod_ok.to(torch.int32))
        mod_ok = torch.where(n_mod >= floor, mod_ok,
                             torch.zeros_like(mod_ok))

    w = _inverse_prob(sign_ok, q_eff)
    gbar = gbar.to(torch.float32)
    if wire == 'packed':
        g_min, g_max = wire_packets.mod_header_ranges(mod_words)
        acc, votes = kops.spfl_aggregate_packed(
            wire_packets.sign_payload(sign_words),
            wire_packets.mod_payload(mod_words), gbar, g_min, g_max, mod_ok,
            w, sign_ok, l, bits)
        ghat = true_div(acc, float(K))
        if votes is not None:
            extras['sign_votes'] = votes
    else:
        modulus = dequantize_modulus(qg)                   # (K, l)
        gbar_k = gbar.expand(grads.shape) if gbar.dim() == 1 else gbar
        modulus = torch.where(mod_ok[:, None], modulus, gbar_k)
        signed = qg.sign.to(torch.float32) * modulus
        ghat = true_div(_seq_client_sum(w[:, None] * signed), float(K))
    payload = torch.as_tensor(payload, dtype=torch.float32,
                              device=grads.device)
    return ghat, RoundTelemetry(sign_ok, mod_ok, sign_ok, payload, retx,
                                **extras)
