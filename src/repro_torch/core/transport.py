"""Gradient transports — the uplink of one FL round (the port of the flat
transports of ``repro.core.transport`` for ``collective='gather'``).

* ``spfl`` / ``spfl_retx`` (:func:`spfl_aggregate`) consume per-client
  gradients (K, l) and produce the aggregate the PS decodes, eq.
  (15)-(17): per-client stochastic quantization into a sign packet and a
  modulus packet, packet outcomes, ḡ compensation of lost moduli, 1/q
  weighting, and the sum over clients in the order k = 0..K-1
  (``_seq_client_sum``); ``spfl_retx`` resends a failed sign packet once.
* The paper's §V baselines: ``dds`` [29] (one packet of l(b+1)+b0 bits,
  failures discarded), ``onebit`` [28] (sign-only), ``scheduling`` [46]
  (the top ceil(ratio K) instantaneous gains share the band) and
  ``error_free`` (quantized, lossless: the upper bound).  The first three
  send one analytic packet per client; under ``channel='bitlevel'`` its
  success probability goes through the bit channel's calibration
  (``bitchannel.calibrated_success_prob``) with nothing materialized.

``wire='packed'`` materializes the packets of ``spfl`` and ``error_free``
as framed uint32 word buffers: the ``quantize_pack`` kernel quantizes and
packs every client in one read of the gradients (:func:`encode_wire`),
and the ``spfl_accumulate`` kernel decodes, compensates, weights and sums
all clients straight from the payload words.  ``channel='bitlevel'``
sends spfl's buffers through the bit channel (``core.bitchannel``: the
``corrupt_fold`` and ``fold_words`` kernels).  ``wire='analytic'`` and
``channel='bernoulli'`` are the plain PyTorch branches of the same
functions.

``spfl`` also takes the adversarial knobs (``repro_torch.adversary``): a
byzantine mask with its attack (the packed sign frames forged before
transmit, or the reported ranges scaled), the stragglers' ``active``
mask (zero-weight rows, the mean over the present clients) and the
packed-domain screen (``wire.vote`` majority and disagreement, robust
z-scores of the header ranges, a {0, 1} gate on the weights, under the
profiler span ``round/screen``).

Randomness is explicit (:class:`Draws`): the (K, l) quantizer uniforms,
the seed words of every bit-channel stream, the Bernoulli outcome and
packet-fate uniforms, and scheduling's Rayleigh draws.  The simulator
fills them from its generators; the parity tests fill them from the
reference's own keys.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.adversary import clients as adv_clients
from repro_torch.adversary import screen as adv_screen
from repro_torch.core import bitchannel
from repro_torch.core import channel as chan
from repro_torch.configs.base import FLConfig
from repro_torch.core.quantize import (
    QuantizedGradient, dequantize_modulus, packet_bits, stochastic_quantize,
    true_div,
)
from repro_torch.kernels import ops as kops
from repro_torch.obs.record import RoundTelemetry
from repro_torch.wire import format as wire_fmt
from repro_torch.wire import packets as wire_packets
from repro_torch.wire import vote as wire_vote

Tensor = torch.Tensor

KINDS = ('spfl', 'spfl_retx', 'dds', 'onebit', 'scheduling', 'error_free')
WIRE_KINDS = ('analytic', 'packed')
_Q_FLOOR = 1e-8        # below this, 1/q unbiasing is switched off (q ~ 0)


class Draws(NamedTuple):
    """The random inputs of one round's transport."""
    rand: Optional[Tensor]                # (K, l) f32 quantizer uniforms
    #   (None for onebit, which does not quantize)
    sign_seeds: Tuple[Tuple[int, int], ...] = ()  # bitlevel: one uint32
    #   seed pair per sign transmission attempt (1 + n_retx)
    mod_seeds: Optional[Tuple[int, int]] = None   # bitlevel: modulus stream
    sign_u: Optional[Tensor] = None       # bernoulli: (1 + n_retx, K) f32
    mod_u: Optional[Tensor] = None        # bernoulli: (K,) f32
    fate_u: Optional[Tensor] = None       # dds/onebit/scheduling: (1, K)
    #   f32 packet-fate uniforms
    h2: Optional[Tensor] = None           # scheduling: (K,) f32 Rayleigh
    #   |h|^2 ~ Exp(1)


def make_draws(k: int, l: int, n_retx: int, channel: str,
               device: torch.device, generator: torch.Generator,
               host_generator: torch.Generator,
               kind: str = 'spfl') -> Draws:
    """One round's draws for transport ``kind``: the (K, l) uniforms from
    ``generator`` on ``device``; seeds, outcome uniforms and Rayleigh
    draws from ``host_generator``."""
    rand = (None if kind == 'onebit'
            else torch.rand((k, l), generator=generator, device=device))
    if kind == 'error_free':
        return Draws(rand)
    if kind not in ('spfl', 'spfl_retx'):
        h2 = (torch.empty((k,)).exponential_(generator=host_generator)
              if kind == 'scheduling' else None)
        fate_u = torch.rand((1, k), generator=host_generator)
        return Draws(rand, fate_u=fate_u.to(device),
                     h2=None if h2 is None else h2.to(device))
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


def _seq_client_mean(vals: Tensor) -> Tensor:
    """Mean over the leading client axis, summed in the kernel's order."""
    return true_div(_seq_client_sum(vals), float(vals.shape[0]))


def _present_denom(k: int, active: Optional[Tensor],
                   suspect: Optional[Tensor]):
    """The aggregate's denominator under dropout / screening: the Python
    int K when neither is in play, else the f32 count of present clients
    (active and not screened; channel erasures stay counted, the 1/q
    weights compensate them), at least 1.  At full benign participation
    the count is exactly float(K)."""
    if active is None and suspect is None:
        return k
    present = (torch.ones((k,), dtype=torch.float32, device=suspect.device)
               if active is None else active.to(torch.float32))
    if suspect is not None:
        present = present * (1.0 - suspect.to(torch.float32))
    return torch.clamp(torch.sum(present), min=1.0)


def _client_mean(acc: Tensor, k: int, active: Optional[Tensor],
                 suspect: Optional[Tensor]) -> Tensor:
    """``acc`` over :func:`_present_denom`, an IEEE quotient either way."""
    denom = _present_denom(k, active, suspect)
    if isinstance(denom, Tensor):
        return acc / denom
    return true_div(acc, float(denom))


def _per_client_quantize(grads: Tensor, bits: int, rand: Tensor
                         ) -> QuantizedGradient:
    """grads: (K, l) -> per-client-range quantization."""
    a = torch.abs(grads)
    return stochastic_quantize(grads, bits, rand, a.amin(1, keepdim=True),
                               a.amax(1, keepdim=True))


def _scalar(x: float, device) -> Tensor:
    """An f32 scalar on ``device`` (a fill, not a copy from the host)."""
    return torch.full((), x, dtype=torch.float32, device=device)


def encode_wire(grads: Tensor, rand: Tensor, bits: int, round_idx=0,
                scaled: Optional[Tuple[Tensor, float]] = None
                ) -> Tuple[Tensor, Tensor, int]:
    """Client side of the packed wire: quantize and pack (K, l) gradients
    with per-client ranges (the ``quantize_pack`` kernel) and frame them
    -> (sign_words (K, Ws), mod_words (K, Wm), measured bits).
    ``scaled`` = (byzantine mask, attack scale) is the scaled-update
    attack: the payload is quantized with the honest ranges and the
    masked rows' headers report the scaled ones."""
    K, l = grads.shape
    a = torch.abs(grads)
    g_min, g_max = a.amin(dim=1), a.amax(dim=1)
    sign_pay, knob_pay = kops.quantize_pack_flat(grads, rand, g_min, g_max,
                                                 bits)
    if scaled is not None:
        g_min = adv_clients.scale_range(g_min, *scaled)
        g_max = adv_clients.scale_range(g_max, *scaled)
    sign_words, mod_words = wire_packets.frame_uplink_batch(
        sign_pay, knob_pay, g_min, g_max, n=l, bits=bits,
        round_idx=round_idx)
    measured = wire_fmt.WORD_BITS * K * (sign_words.shape[1]
                                         + mod_words.shape[1])
    return sign_words, mod_words, measured


def spfl_aggregate(grads: Tensor, gbar: Tensor, q: Tensor, p: Tensor,
                   bits: int, b0: int, draws: Draws, n_retx: int = 0,
                   wire: str = 'analytic', round_idx=0,
                   channel: str = 'bernoulli',
                   attack: str = 'none', byz_mask: Optional[Tensor] = None,
                   attack_scale: float = 10.0,
                   active: Optional[Tensor] = None, screen: bool = False,
                   screen_z: float = 4.0, min_participation: float = 0.0
                   ) -> Tuple[Tensor, RoundTelemetry]:
    """Eq. (15)-(17).  grads: (K, l) f32; gbar: (l,) or (K, l); q, p: (K,)
    f32 on the same device.  Returns (ghat (l,), telemetry).

    ``n_retx`` sign retransmissions (``spfl_retx`` uses 1);
    ``round_idx`` stamps the packet headers; ``min_participation`` is the
    graceful-degradation floor (fewer than ceil(m K) surviving modulus
    packets -> every client falls back to ḡ).

    Adversarial cohort (``repro_torch.adversary``): ``attack`` in
    ``ATTACK_KINDS`` with ``byz_mask`` (K,) bool: 'signflip' forges the
    framed sign payload before transmit (CRC patched) or negates the
    analytic signs; 'scaled' reports ``attack_scale`` x the ranges;
    'labelflip' is a transport no-op.  ``active`` (K,) bool marks
    stragglers: they transmit nothing (sign_ok, mod_ok False: zero-weight
    rows) and the mean is over the present clients.  ``screen`` gates
    each weight by the suspicion verdict (``adversary.screen``, threshold
    ``screen_z``) and divides by the clients not screened out."""
    if wire not in WIRE_KINDS:
        raise ValueError(f'wire must be one of {WIRE_KINDS}, got {wire!r}')
    if channel not in chan.CHANNEL_KINDS:
        raise ValueError(f'channel must be one of {chan.CHANNEL_KINDS}, '
                         f'got {channel!r}')
    if channel == 'bitlevel' and wire != 'packed':
        raise ValueError("channel='bitlevel' requires wire='packed'")
    if attack not in adv_clients.ATTACK_KINDS:
        raise ValueError(f'attack must be one of {adv_clients.ATTACK_KINDS}'
                         f', got {attack!r}')
    K, l = grads.shape
    q_eff = 1.0 - (1.0 - q) ** (n_retx + 1)      # sign retransmission(s)
    lie = None if byz_mask is None else attack

    extras = {}
    if wire == 'packed':
        sign_words, mod_words, measured = encode_wire(
            grads, draws.rand, bits, round_idx,
            scaled=(byz_mask, attack_scale) if lie == 'scaled' else None)
        if lie == 'signflip':
            # the forged frame's CRC covers the lie: the channel and the
            # PS treat it as any other
            sign_words = adv_clients.signflip_frames(sign_words, byz_mask, l)
    else:
        qg = _per_client_quantize(grads, bits, draws.rand)
        if lie == 'scaled':
            qg = adv_clients.scale_ranges(qg, byz_mask, attack_scale)
        elif lie == 'signflip':
            qg = adv_clients.flip_signs(qg, byz_mask)
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

    if active is not None:           # stragglers transmit nothing
        sign_ok = sign_ok & active
        mod_ok = mod_ok & active
        extras['active'] = active
    if min_participation > 0.0:
        floor = int(math.ceil(min_participation * K))
        n_mod = torch.sum(mod_ok.to(torch.int32))
        mod_ok = torch.where(n_mod >= floor, mod_ok,
                             torch.zeros_like(mod_ok))

    w = _inverse_prob(sign_ok, q_eff)
    if wire == 'packed':
        g_min, g_max = wire_packets.mod_header_ranges(mod_words)
    suspect = None
    if screen:
        with record_function('round/screen'):
            if wire == 'packed':
                rows = wire_packets.sign_payload(sign_words)
                maj = wire_vote.majority_words(rows, sign_ok, l)
                dis = wire_vote.disagreement(rows, maj, l)
                gate, suspect, suspicion = adv_screen.screen_gate(
                    g_max, mod_ok, dis, l, sign_ok, screen_z)
            else:
                gate, suspect, suspicion = adv_screen.screen_gate(
                    qg.g_max, mod_ok, z_thresh=screen_z)
            w = w * gate             # a zero-weight row is a no-op
        extras['suspect'] = suspect
        extras['suspicion'] = suspicion
    gbar = gbar.to(torch.float32)
    if wire == 'packed':
        acc, votes = kops.spfl_aggregate_packed(
            wire_packets.sign_payload(sign_words),
            wire_packets.mod_payload(mod_words), gbar, g_min, g_max, mod_ok,
            w, sign_ok, l, bits)
        if votes is not None:
            extras['sign_votes'] = votes
    else:
        modulus = dequantize_modulus(qg)                   # (K, l)
        gbar_k = gbar.expand(grads.shape) if gbar.dim() == 1 else gbar
        modulus = torch.where(mod_ok[:, None], modulus, gbar_k)
        signed = qg.sign.to(torch.float32) * modulus
        acc = _seq_client_sum(w[:, None] * signed)
    ghat = _client_mean(acc, K, active, suspect)
    payload = torch.as_tensor(payload, dtype=torch.float32,
                              device=grads.device)
    return ghat, RoundTelemetry(sign_ok, mod_ok, sign_ok, payload, retx,
                                **extras)


# ---------------------------------------------------------------------------
# the baselines
# ---------------------------------------------------------------------------

def single_packet_success_prob(beta, p_w, gain, n_bits, fl: FLConfig):
    """Success probability of ONE packet of ``n_bits`` over the client's
    whole band at full power: the paper's H convention
    (``channel.h_term``) with the band-split factor removed."""
    return torch.exp(chan.h_term(beta, p_w, gain, n_bits / 2.0, fl))


def _baseline_packet_fate(fate_u: Tensor, q: Tensor, n_bits: int,
                          channel: str) -> Tensor:
    """One success draw per client from the (1, K) uniforms ``fate_u``:
    straight from q ('bernoulli'), or ('bitlevel') from q through the bit
    channel's calibration for a virtual packet of ``n_bits``, one attempt
    of ``simulate_attempts``."""
    if channel == 'bitlevel':
        q = bitchannel.calibrated_success_prob(q, n_bits)
        ok, _ = chan.simulate_attempts(fate_u, q, 0)
        return ok
    return fate_u[0] < q


def _received_mean(vals: Tensor, ok: Tensor) -> Tensor:
    """Mean of the rows of ``vals`` whose packet arrived."""
    denom = torch.clamp(torch.sum(ok.to(torch.float32)), min=1.0)
    kept = torch.where(ok[:, None], vals, torch.zeros_like(vals))
    return _seq_client_sum(kept) / denom


def _baseline_telemetry(ok: Tensor, mod_ok: Tensor, payload_bits: float
                        ) -> RoundTelemetry:
    dev = ok.device
    return RoundTelemetry(ok, mod_ok, ok, _scalar(payload_bits, dev),
                          _scalar(0.0, dev))


def dds_aggregate(grads: Tensor, beta: Tensor, gains: Tensor, p_w: Tensor,
                  fl: FLConfig, draws: Draws
                  ) -> Tuple[Tensor, RoundTelemetry]:
    """[29]: one packet of l(b+1)+b0 bits; failures discarded; mean over
    the received set."""
    K, l = grads.shape
    qg = _per_client_quantize(grads, fl.quant_bits, draws.rand)
    n_bits = l * (fl.quant_bits + 1) + fl.b0_bits
    q = single_packet_success_prob(beta, p_w, gains, n_bits, fl)
    ok = _baseline_packet_fate(draws.fate_u, q, n_bits, fl.channel)
    vals = qg.sign.to(torch.float32) * dequantize_modulus(qg)
    return _received_mean(vals, ok), _baseline_telemetry(ok, ok, K * n_bits)


def onebit_aggregate(grads: Tensor, beta: Tensor, gains: Tensor,
                     p_w: Tensor, fl: FLConfig, draws: Draws
                     ) -> Tuple[Tensor, RoundTelemetry]:
    """[28]: sign-only uplink.  The aggregate is the mean received sign
    (sign(0) = 0) scaled by each client's mean modulus (one extra scalar
    per client), so the step is comparable with modulus-carrying
    schemes."""
    K, l = grads.shape
    q = single_packet_success_prob(beta, p_w, gains, float(l), fl)
    ok = _baseline_packet_fate(draws.fate_u, q, l, fl.channel)
    scale = torch.mean(torch.abs(grads), dim=1, keepdim=True)    # (K, 1)
    vals = torch.sign(grads) * scale
    return _received_mean(vals, ok), _baseline_telemetry(
        ok, torch.zeros_like(ok), K * l)


def scheduling_aggregate(grads: Tensor, gains: Tensor, p_w: Tensor,
                         fl: FLConfig, draws: Draws,
                         ratio: Optional[float] = None
                         ) -> Tuple[Tensor, RoundTelemetry]:
    """[46]: the PS schedules the ceil(ratio K) devices with the largest
    instantaneous gain |h|^2 d^-zeta; each gets an equal share of the
    band, the others 1e-9 of it (their q is exactly 0)."""
    K, l = grads.shape
    ratio = fl.scheduling_ratio if ratio is None else ratio
    m = max(1, math.ceil(ratio * K))
    inst = draws.h2 * gains
    thresh = torch.sort(inst).values[K - m]
    sched = inst >= thresh
    beta = torch.where(sched, torch.full_like(inst, 1.0 / m),
                       torch.full_like(inst, 1e-9))
    qg = _per_client_quantize(grads, fl.quant_bits, draws.rand)
    n_bits = l * (fl.quant_bits + 1) + fl.b0_bits
    q = single_packet_success_prob(beta, p_w, gains, n_bits, fl)
    ok = _baseline_packet_fate(draws.fate_u, q, n_bits, fl.channel) & sched
    vals = qg.sign.to(torch.float32) * dequantize_modulus(qg)
    return _received_mean(vals, ok), _baseline_telemetry(ok, ok, m * n_bits)


def error_free_aggregate(grads: Tensor, fl: FLConfig, draws: Draws,
                         wire: Optional[str] = None, round_idx=0
                         ) -> Tuple[Tensor, RoundTelemetry]:
    """Quantized, lossless uplink (the upper bound).  On the packed wire
    the words go through ``quantize_pack`` and the decode-once
    ``spfl_accumulate`` with ḡ = 0, unit weights and every packet
    received; ``payload_bits`` is then the measured size of the frames."""
    wire = fl.wire if wire is None else wire
    if wire not in WIRE_KINDS:
        raise ValueError(f'wire must be one of {WIRE_KINDS}, got {wire!r}')
    K, l = grads.shape
    dev = grads.device
    ok = torch.ones((K,), dtype=torch.bool, device=dev)
    extras = {}
    if wire == 'packed':
        sign_words, mod_words, measured = encode_wire(
            grads, draws.rand, fl.quant_bits, round_idx)
        ones = torch.ones((K,), dtype=torch.float32, device=dev)
        g_min, g_max = wire_packets.mod_header_ranges(mod_words)
        acc, votes = kops.spfl_aggregate_packed(
            wire_packets.sign_payload(sign_words),
            wire_packets.mod_payload(mod_words),
            torch.zeros((l,), dtype=torch.float32, device=dev), g_min, g_max,
            ones, ones, ok, l, fl.quant_bits)
        ghat = true_div(acc, float(K))
        if votes is not None:
            extras['sign_votes'] = votes
        payload = float(measured)
    else:
        qg = _per_client_quantize(grads, fl.quant_bits, draws.rand)
        payload = float(K * (l * (fl.quant_bits + 1) + fl.b0_bits))
        ghat = _seq_client_mean(qg.sign.to(torch.float32)
                                * dequantize_modulus(qg))
    return ghat, RoundTelemetry(ok, ok, ok, _scalar(payload, dev),
                                _scalar(0.0, dev), **extras)
