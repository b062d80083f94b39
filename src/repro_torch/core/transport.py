"""Gradient transports — the uplink of one FL round (the port of
``repro.core.transport`` for ``collective='gather'``): the flat
transports over (K, l) gradient rows, and their tree variants over
per-client gradient trees of the LLM-scale step
(:func:`spfl_aggregate_tree`, :func:`error_free_aggregate_tree`, with
:class:`TreeDraws`; the end of this module).

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
reference's own keys.  Every draw is a tensor on the device and the
round index that stamps the packet headers may be one too, so a round
makes no copy from the host and can be captured in a CUDA graph
(``training.fl_loop``'s fused rounds).
"""
from __future__ import annotations

import math
from collections.abc import Sequence
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch import tree
from repro_torch.adversary import clients as adv_clients
from repro_torch.adversary import screen as adv_screen
from repro_torch.core import bitchannel
from repro_torch.core import channel as chan
from repro_torch.configs.base import FLConfig
from repro_torch.core.quantize import (
    QuantizedGradient, dequantize_modulus, packet_bits, stochastic_quantize,
    true_div,
)
from repro_torch.core.mesh import ClientMesh, pad_rows
from repro_torch.kernels import ops as kops
from repro_torch.obs.record import RoundTelemetry
from repro_torch.wire import corrupt as wire_corrupt
from repro_torch.wire import format as wire_fmt
from repro_torch.wire import packets as wire_packets
from repro_torch.wire import vote as wire_vote

Tensor = torch.Tensor

KINDS = ('spfl', 'spfl_retx', 'dds', 'onebit', 'scheduling', 'error_free')
WIRE_KINDS = ('analytic', 'packed')
COLLECTIVE_KINDS = ('gather', 'sharded')
_Q_FLOOR = 1e-8        # below this, 1/q unbiasing is switched off (q ~ 0)


class Draws(NamedTuple):
    """The random inputs of one round's transport."""
    rand: Optional[Tensor]                # (K, l) f32 quantizer uniforms
    #   (None for onebit, which does not quantize)
    seeds: Optional[Tensor] = None        # bitlevel: (2 + n_retx, 2) int32
    #   uint32 seed patterns: the modulus stream's, then one pair per sign
    #   transmission attempt
    sign_u: Optional[Tensor] = None       # bernoulli: (1 + n_retx, K) f32
    mod_u: Optional[Tensor] = None        # bernoulli: (K,) f32
    fate_u: Optional[Tensor] = None       # dds/onebit/scheduling: (1, K)
    #   f32 packet-fate uniforms
    h2: Optional[Tensor] = None           # scheduling: (K,) f32 Rayleigh
    #   |h|^2 ~ Exp(1)


def host_draws(k: int, n_retx: int, channel: str,
               host_generator: torch.Generator,
               kind: str = 'spfl') -> Dict[str, Tensor]:
    """The host half of one round's draws for transport ``kind``, CPU
    tensors by :class:`Draws` field: the bit channel's seed words (int32
    patterns), the Bernoulli outcome uniforms, or the baselines'
    packet-fate uniforms and scheduling's Rayleigh draws, in that order
    from ``host_generator``."""
    if kind == 'error_free':
        return {}
    if kind not in ('spfl', 'spfl_retx'):
        out = {}
        if kind == 'scheduling':
            out['h2'] = torch.empty((k,)).exponential_(
                generator=host_generator)
        out['fate_u'] = torch.rand((1, k), generator=host_generator)
        return out
    if channel == 'bitlevel':
        words = torch.randint(0, 2 ** 32, (n_retx + 2, 2),
                              generator=host_generator)
        return {'seeds': wire_fmt.to_words(words)}
    sign_u = torch.rand((n_retx + 1, k), generator=host_generator)
    return {'sign_u': sign_u,
            'mod_u': torch.rand((k,), generator=host_generator)}


def make_draws(k: int, l: int, n_retx: int, channel: str,
               device: torch.device, generator: torch.Generator,
               host_generator: torch.Generator,
               kind: str = 'spfl') -> Draws:
    """One round's draws for transport ``kind``: the (K, l) uniforms from
    ``generator`` on ``device``, then :func:`host_draws` from
    ``host_generator``, each copied to ``device``."""
    rand = (None if kind == 'onebit'
            else torch.rand((k, l), generator=generator, device=device))
    host = host_draws(k, n_retx, channel, host_generator, kind)
    return Draws(rand, **{name: t.to(device) for name, t in host.items()})


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


def _resolve_collective(collective: Optional[str], wire: str, mesh
                        ) -> ClientMesh:
    """Validate the collective knob: 'sharded' needs the packed wire and
    a mesh to shard over.  -> the mesh the transport runs on: ``mesh``,
    or for 'gather' the one-rank mesh (every client on this rank, every
    collective the identity)."""
    collective = 'gather' if collective is None else collective
    if collective not in COLLECTIVE_KINDS:
        raise ValueError(f"collective must be 'gather' or 'sharded', got "
                         f'{collective!r}')
    if collective != 'sharded':
        return ClientMesh()
    if wire != 'packed':
        raise ValueError("collective='sharded' requires wire='packed'")
    if mesh is None:
        raise ValueError("collective='sharded' requires a mesh "
                         "(training/distributed.py passes it through)")
    return mesh


def check_rows(mesh, k: int, rows: int) -> None:
    """The transports take this rank's rows of the K clients (all K on
    the one-rank mesh)."""
    want = mesh.rows(k)
    if rows != want.stop - want.start:
        raise ValueError(f'rank {mesh.rank} of {mesh.size} holds rows '
                         f'[{want.start}, {want.stop}) of the {k} clients, '
                         f'got {rows} rows')


def gather_clients(mesh, k: int, *vectors: Tensor) -> list:
    """Each rank's per-client vectors (bool, int32 or float32; its rows of
    the K clients, or its whole block) as the global (K,) vectors, in ONE
    ``all_gather`` (stacked as float64 columns, exact for all three
    dtypes; the vectors themselves on the one-rank mesh)."""
    if mesh.group is None:
        return list(vectors)
    kb = mesh.k_local(k)
    cols = torch.stack([pad_rows(v.to(torch.float64), kb) for v in vectors],
                       dim=1)
    every = mesh.gather_rows(cols, k)
    return [every[:, i].to(v.dtype) for i, v in enumerate(vectors)]


def _zero_words(rows: int, n: int, bits: int, device) -> Tuple[Tensor,
                                                               Tensor]:
    groups = wire_fmt.n_groups(n)
    return (torch.zeros((rows, groups), dtype=torch.int32, device=device),
            torch.zeros((rows, groups * bits), dtype=torch.int32,
                        device=device))


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


def _encode_block(grads: Tensor, rand: Tensor, bits: int, round_idx,
                  scaled, rows: int) -> Tuple[Tensor, Tensor]:
    """:func:`encode_wire` of this rank's rows, padded with zero words to
    its block of ``rows`` (a rank whose block is all padding encodes
    nothing)."""
    if grads.shape[0] == 0:
        l = grads.shape[1]
        zeros = dict(dtype=torch.int32, device=grads.device)
        return (torch.zeros((rows, wire_fmt.sign_packet_words(l)), **zeros),
                torch.zeros((rows, wire_fmt.modulus_packet_words(l, bits)),
                            **zeros))
    sign_words, mod_words, _ = encode_wire(grads, rand, bits, round_idx,
                                           scaled)
    return pad_rows(sign_words, rows), pad_rows(mod_words, rows)


def spfl_aggregate(grads: Tensor, gbar: Tensor, q: Tensor, p: Tensor,
                   bits: int, b0: int, draws: Draws, n_retx: int = 0,
                   wire: str = 'analytic', round_idx=0,
                   channel: str = 'bernoulli',
                   collective: str = 'gather', mesh=None,
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

    ``collective='sharded'`` (packed wire and ``mesh``, a
    ``core.mesh.ClientMesh``): ``grads`` (and a per-client ``gbar``)
    hold this rank's rows of the K = len(q) clients (``mesh.rows(K)``);
    q, p, the draws and the knobs' masks stay global.  Every (K, W) pass
    runs on the rank's block (quantize and pack, the bit channel at the
    block's word offset, the CRC folds, the decode-once kernel), the
    per-client verdicts cross ranks in one ``all_gather`` of (K,)
    vectors, the screen's disagreements and header ranges in another and
    its vote majority as count planes, and the (l,) partial sums (and
    votes) in one ``all_reduce``: no payload word leaves its rank.  Every
    rank returns the same ĝ and the global telemetry.  'gather' is the
    same path on the one-rank mesh, whose collectives are the identity.

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
    mesh = _resolve_collective(collective, wire, mesh)
    if attack not in adv_clients.ATTACK_KINDS:
        raise ValueError(f'attack must be one of {adv_clients.ATTACK_KINDS}'
                         f', got {attack!r}')
    K, l = q.shape[0], grads.shape[1]
    check_rows(mesh, K, grads.shape[0])
    q_eff = 1.0 - (1.0 - q) ** (n_retx + 1)      # sign retransmission(s)
    lie = None if byz_mask is None else attack

    extras = {}
    if wire == 'packed':
        rows = mesh.rows(K)
        scaled = ((byz_mask[rows], attack_scale) if lie == 'scaled'
                  else None)
        sign_words, mod_words = _encode_block(
            grads, draws.rand[rows], bits, round_idx, scaled,
            mesh.k_local(K))
        measured = wire_fmt.measured_uplink_bits(l, bits, K)
        if lie == 'signflip':
            # the forged frame's CRC covers the lie: the channel and the
            # PS treat it as any other
            sign_words = adv_clients.signflip_frames(
                sign_words, mesh.block(byz_mask, K, False), l)
    else:
        qg = _per_client_quantize(grads, bits, draws.rand)
        if lie == 'scaled':
            qg = adv_clients.scale_ranges(qg, byz_mask, attack_scale)
        elif lie == 'signflip':
            qg = adv_clients.flip_signs(qg, byz_mask)
    if channel == 'bitlevel':
        rep = bitchannel.transmit_uplink(
            sign_words, mod_words, mesh.block(q, K, 1.0),
            mesh.block(p, K, 1.0), n=l, bits=bits, seeds=draws.seeds,
            n_retx=n_retx, mesh=mesh)
        sign_words, mod_words = rep.sign_words, rep.mod_words
        # every rank's verdicts, in one all_gather
        sign_ok, mod_ok, sign_crc_ok, sign_flips, mod_flips, retx_k = (
            gather_clients(mesh, K, rep.sign_ok, rep.mod_ok,
                           rep.sign_crc_ok, rep.sign_flips, rep.mod_flips,
                           rep.retx_attempts))
        retx = torch.sum(retx_k).to(torch.float32)
        ws = sign_words.shape[-1]
        payload = float(measured) + retx * float(ws * wire_fmt.WORD_BITS)
        extras = dict(sign_flips=sign_flips, mod_flips=mod_flips,
                      sign_crc_ok=sign_crc_ok, mod_crc_ok=mod_ok,
                      retx_attempts=retx_k)
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
            retx = torch.zeros((), dtype=torch.float32, device=q.device)
        else:
            sign_ok, retx_k = chan.simulate_attempts(draws.sign_u, q, n_retx)
            mod_ok = draws.mod_u < p
            retx = torch.sum(retx_k).to(torch.float32)
            extras = dict(retx_attempts=retx_k)
        payload = payload_base + retx * sign_bits
    if wire == 'packed':
        g_min, g_max = wire_packets.mod_header_ranges(mod_words)

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
    suspect = None
    if screen:
        with record_function('round/screen'):
            if wire == 'packed':
                rows_w = wire_packets.sign_payload(sign_words)
                maj = wire_vote.majority_words(
                    rows_w, mesh.block(sign_ok, K, False), l,
                    torch.sum(sign_ok.to(torch.int32)), mesh)
                # each rank's disagreements and header ranges, in one
                # all_gather
                dis, hdr_max = gather_clients(
                    mesh, K, wire_vote.disagreement(rows_w, maj, l), g_max)
                gate, suspect, suspicion = adv_screen.screen_gate(
                    hdr_max, mod_ok, dis, l, sign_ok, screen_z)
            else:
                gate, suspect, suspicion = adv_screen.screen_gate(
                    qg.g_max, mod_ok, z_thresh=screen_z)
            w = w * gate             # a zero-weight row is a no-op
        extras['suspect'] = suspect
        extras['suspicion'] = suspicion
    gbar = gbar.to(torch.float32)
    if wire == 'packed':
        args = (wire_packets.sign_payload(sign_words),
                wire_packets.mod_payload(mod_words))
        gb = gbar if gbar.dim() == 1 else pad_rows(gbar, mesh.k_local(K))
        acc, votes = kops.spfl_aggregate_packed_sharded(
            *args, gb, g_min, g_max, mesh.block(mod_ok, K, False),
            mesh.block(w, K, 0.0), mesh.block(sign_ok, K, False), l, bits,
            mesh=mesh)
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
                         wire: Optional[str] = None, round_idx=0,
                         collective: Optional[str] = None, mesh=None,
                         k: Optional[int] = None
                         ) -> Tuple[Tensor, RoundTelemetry]:
    """Quantized, lossless uplink (the upper bound).  On the packed wire
    the words go through ``quantize_pack`` and the decode-once
    ``spfl_accumulate`` with ḡ = 0, unit weights and every packet
    received; ``payload_bits`` is then the measured size of the frames.
    ``collective`` (default ``fl.collective``) 'sharded' with ``mesh``:
    ``grads`` are this rank's rows of the ``k`` clients (as
    :func:`spfl_aggregate`'s), one ``all_reduce`` finishes the sum."""
    wire = fl.wire if wire is None else wire
    if wire not in WIRE_KINDS:
        raise ValueError(f'wire must be one of {WIRE_KINDS}, got {wire!r}')
    mesh = _resolve_collective(
        fl.collective if collective is None else collective, wire, mesh)
    l = grads.shape[1]
    K = grads.shape[0] if k is None else k
    dev = grads.device
    ok = torch.ones((K,), dtype=torch.bool, device=dev)
    extras = {}
    if wire == 'packed':
        check_rows(mesh, K, grads.shape[0])
        zero = torch.zeros((l,), dtype=torch.float32, device=dev)
        sign_words, mod_words = _encode_block(
            grads, draws.rand[mesh.rows(K)], fl.quant_bits, round_idx, None,
            mesh.k_local(K))
        measured = wire_fmt.measured_uplink_bits(l, fl.quant_bits, K)
        # the dummy rows weigh 0 and vote no
        ones = mesh.block(torch.ones((K,), dtype=torch.float32, device=dev),
                          K, 0.0)
        g_min, g_max = wire_packets.mod_header_ranges(mod_words)
        acc, votes = kops.spfl_aggregate_packed_sharded(
            wire_packets.sign_payload(sign_words),
            wire_packets.mod_payload(mod_words), zero, g_min, g_max, ones,
            ones, mesh.block(ok, K, False), l, fl.quant_bits, mesh=mesh)
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


# ---------------------------------------------------------------------------
# pytree variants (LLM scale): one radio per client, leaf-wise math
# ---------------------------------------------------------------------------

class TreeDraws(NamedTuple):
    """The random inputs of one round's tree transport, bound to the
    gradient tree's leaves in ``repro_torch.tree.leaves`` order."""
    rand: Sequence[Tensor]                # leaf i: (K, n_i) f32 quantizer
    #   uniforms (a LeafUniforms draws each when the transport asks)
    seeds: Optional[Tensor] = None        # bitlevel: (2 + n_retx, L + 1, 2)
    #   int32 uint32 seed patterns: per transmission pass (the modulus
    #   pass, then each sign attempt) one pair a leaf, then the pair of
    #   the pass's framing-word draw
    sign_u: Optional[Tensor] = None       # bernoulli: (1 + n_retx, K) f32
    mod_u: Optional[Tensor] = None        # bernoulli: (K,) f32


class LeafUniforms(Sequence):
    """Quantizer uniforms drawn leaf by leaf: item i is a fresh (K, n_i)
    f32 draw from ``generator`` on ``device``, made when the transport
    quantizes leaf i and dropped after it, so a round never holds the
    uniforms of the whole tree.  The transports take each item once, in
    leaf order."""

    def __init__(self, k: int, sizes: Sequence[int],
                 generator: torch.Generator, device):
        self.k, self.sizes = k, tuple(int(n) for n in sizes)
        self.generator, self.device = generator, device

    def __len__(self) -> int:
        return len(self.sizes)

    def __getitem__(self, i: int) -> Tensor:
        return torch.rand((self.k, self.sizes[i]), generator=self.generator,
                          device=self.device)


def tree_host_draws(k: int, n_leaves: int, n_retx: int, channel: str,
                    host_generator: torch.Generator,
                    kind: str = 'spfl') -> Dict[str, Tensor]:
    """The host half of one round's tree draws, CPU tensors by
    :class:`TreeDraws` field, from ``host_generator``: the bit channel's
    seed words (int32 patterns, 'bitlevel'), or the Bernoulli outcome
    uniforms; nothing for error_free."""
    if kind == 'error_free':
        return {}
    if channel == 'bitlevel':
        words = torch.randint(0, 2 ** 32, (n_retx + 2, n_leaves + 1, 2),
                              generator=host_generator)
        return {'seeds': wire_fmt.to_words(words)}
    sign_u = torch.rand((n_retx + 1, k), generator=host_generator)
    return {'sign_u': sign_u,
            'mod_u': torch.rand((k,), generator=host_generator)}


def make_tree_draws(k: int, sizes: Sequence[int], n_retx: int, channel: str,
                    device, generator: torch.Generator,
                    host_generator: torch.Generator,
                    kind: str = 'spfl') -> TreeDraws:
    """One round's tree draws: the leaves' uniforms from ``generator`` on
    ``device`` as the transport asks for them (:class:`LeafUniforms`),
    then :func:`tree_host_draws` from ``host_generator``, copied to
    ``device``."""
    rand = LeafUniforms(k, sizes, generator, device)
    host = tree_host_draws(k, len(sizes), n_retx, channel, host_generator,
                           kind)
    return TreeDraws(rand, **{f: t.to(device) for f, t in host.items()})


def _client_rows(leaf: Tensor) -> Tensor:
    """A (K, ...) leaf as (K, n) float32 rows (K may be 0)."""
    return leaf.to(torch.float32).reshape(leaf.shape[0],
                                          math.prod(leaf.shape[1:]))


def tree_client_stats(grads_tree) -> dict:
    """Per-client (leading-K) scalars across the whole gradient tree:
    ||g_k||^2 (f32, summed leaf by leaf), min |g|, max |g| and the
    dimension."""
    leaves = tree.leaves(grads_tree)
    k = leaves[0].shape[0]
    dev = leaves[0].device
    g2 = torch.zeros((k,), dtype=torch.float32, device=dev)
    g_min = torch.full((k,), math.inf, dtype=torch.float32, device=dev)
    g_max = torch.zeros((k,), dtype=torch.float32, device=dev)
    for lf in leaves:
        a = torch.abs(_client_rows(lf))
        g2 = g2 + torch.sum(a * a, dim=1)
        lo, hi = torch.aminmax(a, dim=1)
        g_min = torch.minimum(g_min, lo)
        g_max = torch.maximum(g_max, hi)
    dim = sum(math.prod(lf.shape[1:]) for lf in leaves)
    return {'g2': g2, 'g_min': g_min, 'g_max': g_max, 'dim': dim}


def delta_sq_tree(stats: dict, bits: int) -> Tensor:
    """Per-client quantization error bound delta^2 (Lemma 2, eq. (25))
    from the tree stats: l (g_max - g_min)^2 / (4 (2^b - 1))."""
    spread = stats['dim'] * (stats['g_max'] - stats['g_min']) ** 2
    return true_div(spread, 4.0 * (2 ** bits - 1))


def _bitlevel_tree_pass(seeds: Tensor, word_leaves, ber: Tensor,
                        frame_words: int, k: int, mesh: ClientMesh):
    """One transmission of every client's virtual framed packet whose
    payload words are scattered over the leaves' (K, W_i) buffers:
    ``seeds`` (L + 1, 2) holds one PRF pair a leaf (a ``corrupt_fold``
    launch each) and the pair of the (K, frame_words) framing words
    (header and CRC, never materialized: their flip mask alone is drawn).
    The PS check ``fold(received) == crc`` of a contiguous packet is
    ``fold(flip mask over all its words) == 0``, so the leaves' mask
    folds, xor-ed, verify the virtual packet.  ``ber`` is (K,).  The leaf
    buffers are this rank's block of ``mesh`` and each leaf's pass runs
    at the block's word offset (the gathered draw's bits); the O(K)
    framing draw is made whole and the block's rows kept.  -> (received
    leaf buffers, verify_ok, flips) of the block."""
    dev = ber.device
    rows = mesh.k_local(k)
    ber_leaf = mesh.block(ber, k, 0.0)
    fold = torch.zeros((rows,), dtype=torch.int32, device=dev)
    flips = torch.zeros((rows,), dtype=torch.int32, device=dev)
    rx = []
    for i, words in enumerate(word_leaves):
        cw, f, nf = kops.corrupt_fold_words(seeds[i], words, ber_leaf,
                                            mesh=mesh)
        rx.append(cw)
        fold = fold ^ f
        flips = flips + nf
    fmask = mesh.block(wire_corrupt.flip_mask(
        seeds[len(word_leaves)], (k, frame_words), ber, device=dev), k)
    fold = fold ^ wire_fmt.xor_fold(fmask)
    flips = flips + wire_corrupt.count_flips(fmask)
    return rx, fold == 0, flips


def _tree_mean(s: Tensor, k: int, denom) -> Tensor:
    """A leaf's client sum over the present count, as the reference's
    ``sum / denom`` promotes it: a tensor count takes the sum to float32
    first, the Python int K divides in the sum's dtype."""
    if isinstance(denom, Tensor):
        return s.to(torch.float32) / denom
    return true_div(s, float(k)).to(torch.float32)


def _tree_stats(grads_tree, stats: Optional[dict], mesh, k: int) -> dict:
    """The K clients' tree stats: given, or from the gradients (this
    rank's rows' stats brought together by one all_gather)."""
    if stats is not None:
        return stats
    stats = tree_client_stats(grads_tree)
    check_rows(mesh, k, stats['g2'].shape[0])
    g2, g_min, g_max = gather_clients(mesh, k, stats['g2'], stats['g_min'],
                                      stats['g_max'])
    return {'g2': g2, 'g_min': g_min, 'g_max': g_max, 'dim': stats['dim']}


def _pack_block(flat: Tensor, rand: Tensor, g_min: Tensor, g_max: Tensor,
                bits: int, rows: int) -> Tuple[Tensor, Tensor]:
    """``quantize_pack`` of this rank's rows of a leaf, padded with zero
    words to its block of ``rows``."""
    if flat.shape[0] == 0:
        return _zero_words(rows, flat.shape[1], bits, flat.device)
    sw, qw = kops.quantize_pack_flat(flat.contiguous(), rand, g_min, g_max,
                                     bits)
    return pad_rows(sw, rows), pad_rows(qw, rows)


def spfl_aggregate_tree(grads_tree, gbar_tree, q: Tensor, p: Tensor,
                        fl: FLConfig, draws: TreeDraws,
                        stats: Optional[dict] = None, n_retx: int = 0,
                        wire: Optional[str] = None,
                        channel: Optional[str] = None,
                        collective: Optional[str] = None, mesh=None,
                        attack: str = 'none',
                        byz_mask: Optional[Tensor] = None,
                        attack_scale: float = 10.0,
                        active: Optional[Tensor] = None,
                        screen: bool = False, screen_z: float = 4.0,
                        min_participation: float = 0.0):
    """SP-FL over per-client gradient trees (leaves (K, ...), any float
    dtype): eq. (15)-(17) leaf by leaf with per-client quantizer ranges,
    packet outcomes and 1/q weights shared by all leaves.  Returns
    (ghat tree (float32 leaves of the parameter shapes), stats,
    telemetry).

    ``wire='packed'`` (default ``fl.wire``): each leaf is quantized and
    packed by the ``quantize_pack`` kernel with the tree-wide ranges and
    decoded once by the ``spfl_accumulate`` kernel (no votes), so a round
    launches each once a leaf; the framing (headers and CRCs) is one
    packet pair a client, charged once in ``payload_bits``.
    ``channel='bitlevel'`` (packed only) sends every client's sign and
    modulus packets through the bit channel, one ``corrupt_fold`` launch
    a leaf a pass, verdicts from the folded flip masks; a failed sign
    packet is resent ``n_retx`` times (the pristine payload, a fresh
    draw).  ``wire='analytic'`` sums the dequantized contributions in
    ``fl.uplink_reduce_dtype``.

    ``collective`` (default ``fl.collective``) 'sharded' with ``mesh``
    (a ``core.mesh.ClientMesh``; packed wire only): the gradient leaves
    (and a per-client ḡ) hold this rank's rows of the K = len(q) clients,
    ``stats`` (if given) and everything else are global.  Each leaf is
    packed, sent and decoded on the rank's block; the verdicts cross
    ranks in one ``all_gather`` of (K,) vectors (with the tree stats,
    when the transport computes them) and each leaf's (n,) partial in
    one ``all_reduce``.  The returned stats are the K clients'.

    Adversarial knobs as ``spfl_aggregate``'s: 'signflip' negates the
    byzantine rows' gradients before quantization (their signs flip,
    zeros stay +1, the knobs are unchanged: the reference's pre-pack
    ``flip_signs``); 'scaled' quantizes honestly and reports scaled
    ranges to the decoder; ``active`` rows transmit nothing; ``screen``
    gates on the norm reports alone (the tree path keeps no votes)."""
    wire = fl.wire if wire is None else wire
    channel = fl.channel if channel is None else channel
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
    mesh = _resolve_collective(
        fl.collective if collective is None else collective, wire, mesh)
    K = q.shape[0]
    stats = _tree_stats(grads_tree, stats, mesh, K)
    bits = fl.quant_bits
    q_eff = 1.0 - (1.0 - q) ** (n_retx + 1)
    g_min, g_max = stats['g_min'], stats['g_max']
    byz = byz_mask if attack in ('signflip', 'scaled') else None
    g_min_rep, g_max_rep = g_min, g_max      # the range reports (the lie)
    if attack == 'scaled' and byz is not None:
        g_min_rep = adv_clients.scale_range(g_min, byz, attack_scale)
        g_max_rep = adv_clients.scale_range(g_max, byz, attack_scale)
    rdt = (torch.bfloat16 if fl.uplink_reduce_dtype == 'bfloat16'
           else torch.float32)
    leaves = tree.leaves(grads_tree)
    gbar_leaves = tree.leaves(gbar_tree)
    # the rows this rank quantizes, and its block of the per-client inputs
    rows, kb = mesh.rows(K), mesh.k_local(K)

    def blk(x, pad=0):
        return mesh.block(x, K, pad)

    # ---- clients: quantize every leaf (and pack, on the packed wire) ----
    qgs, sws, qws = [], [], []
    for i, lf in enumerate(leaves):
        flat = _client_rows(lf)
        if attack == 'signflip' and byz is not None and wire == 'packed':
            flat = torch.where(byz[rows, None], -flat, flat)
        if wire == 'packed':
            sw, qw = _pack_block(flat, draws.rand[i][rows], g_min[rows],
                                 g_max[rows], bits, kb)
            sws.append(sw)
            qws.append(qw)
            continue
        qg = stochastic_quantize(flat, bits, draws.rand[i], g_min[:, None],
                                 g_max[:, None])
        if attack == 'signflip' and byz is not None:
            qg = adv_clients.flip_signs(qg, byz)
        if attack == 'scaled' and byz is not None:
            # the analytic dequant sees the scaled report
            qg = qg._replace(g_min=g_min_rep[:, None],
                             g_max=g_max_rep[:, None])
        qgs.append(qg)

    # ---- channel: packet fate (and, bit-level, payload damage) ----
    extras = {}
    if channel == 'bitlevel':
        sign_frame = wire_fmt.SIGN_HEADER_WORDS + wire_fmt.CRC_WORDS
        mod_frame = wire_fmt.MOD_HEADER_WORDS + wire_fmt.CRC_WORDS
        ws = sum(sw.shape[-1] for sw in sws) + sign_frame
        wm = sum(qw.shape[-1] for qw in qws) + mod_frame
        ber_s = bitchannel.ber_for_success(q, ws)
        ber_v = bitchannel.ber_for_success(p, wm)
        qws, mod_ok, mod_flips = _bitlevel_tree_pass(
            draws.seeds[0], qws, ber_v, mod_frame, K, mesh)
        orig_sws = sws       # the pristine payloads the resends carry
        sws, sign_ok, sign_flips = _bitlevel_tree_pass(
            draws.seeds[1], sws, ber_s, sign_frame, K, mesh)
        sign_crc_ok = sign_ok
        retx_k = torch.zeros((kb,), dtype=torch.int32, device=q.device)
        for attempt in range(1, n_retx + 1):
            failed = ~sign_ok
            rx_a, ok_a, flips_a = _bitlevel_tree_pass(
                draws.seeds[1 + attempt], orig_sws, ber_s, sign_frame, K,
                mesh)
            rescued = failed & ok_a
            sws = [torch.where(rescued[:, None], a, r)
                   for a, r in zip(rx_a, sws)]
            sign_flips = sign_flips + torch.where(failed, flips_a, 0)
            retx_k = retx_k + failed.to(torch.int32)
            sign_ok = sign_ok | rescued
        # every rank's verdicts, in one all_gather
        (sign_ok, mod_ok, sign_crc_ok, sign_flips, mod_flips,
         retx_k) = gather_clients(mesh, K, sign_ok, mod_ok, sign_crc_ok,
                                  sign_flips, mod_flips, retx_k)
        retx = torch.sum(retx_k).to(torch.float32)
        extras = dict(sign_flips=sign_flips, mod_flips=mod_flips,
                      sign_crc_ok=sign_crc_ok, mod_crc_ok=mod_ok,
                      retx_attempts=retx_k)
    elif n_retx == 0:
        sign_ok, mod_ok = chan.simulate_outcomes(draws.sign_u[0], draws.mod_u,
                                                 q_eff, p)
        retx = torch.zeros((), dtype=torch.float32, device=q.device)
    else:
        sign_ok, retx_k = chan.simulate_attempts(draws.sign_u, q, n_retx)
        mod_ok = draws.mod_u < p
        retx = torch.sum(retx_k).to(torch.float32)
        extras = dict(retx_attempts=retx_k)

    if active is not None:           # stragglers transmit nothing
        sign_ok = sign_ok & active
        mod_ok = mod_ok & active
        extras['active'] = active
    if min_participation > 0.0:
        floor = int(math.ceil(min_participation * K))
        n_mod = torch.sum(mod_ok.to(torch.int32))
        mod_ok = torch.where(n_mod >= floor, mod_ok, torch.zeros_like(mod_ok))
    w = _inverse_prob(sign_ok, q_eff)
    suspect = None
    if screen:
        # the norm reports alone: the tree path keeps no votes
        gate, suspect, suspicion = adv_screen.screen_gate(
            g_max_rep, mod_ok, z_thresh=screen_z)
        w = w * gate
        extras['suspect'] = suspect
        extras['suspicion'] = suspicion
    denom = _present_denom(K, active, suspect)

    # ---- PS: decode-once aggregate per leaf ----
    out = []
    if wire == 'packed':
        kernel_args = (blk(g_min_rep), blk(g_max_rep), blk(mod_ok, False),
                       blk(w, 0.0), blk(sign_ok, False))
    for i, (lf, gbar_leaf) in enumerate(zip(leaves, gbar_leaves)):
        gb = gbar_leaf.to(torch.float32)
        per_client = tuple(gb.shape) == tuple(lf.shape)   # last_local
        if wire == 'packed':
            n = math.prod(lf.shape[1:])
            if per_client:
                gb = pad_rows(gb.reshape(lf.shape[0], n), kb)
            else:
                gb = gb.reshape(n)
            acc, _ = kops.spfl_aggregate_packed_sharded(
                sws[i], qws[i], gb.contiguous(), *kernel_args, n, bits,
                mesh=mesh, with_votes=False)
            out.append(_tree_mean(acc, K, denom).reshape(lf.shape[1:]))
            continue
        qg = qgs[i]
        modulus = dequantize_modulus(qg)
        gb = (gb.reshape(K, -1) if per_client
              else gb.reshape(1, -1).expand(modulus.shape))
        modulus = torch.where(mod_ok[:, None], modulus, gb)
        contrib = (w[:, None] * (qg.sign.to(torch.float32) * modulus)
                   ).to(rdt)
        s = (_seq_client_sum(contrib) if rdt == torch.float32
             else torch.sum(contrib, dim=0))
        out.append(_tree_mean(s, K, denom).reshape(lf.shape[1:]))
    ghat = tree.unflatten(grads_tree, out)

    l = stats['dim']
    if wire == 'packed':
        payload_words = sum(sw.shape[-1] + qw.shape[-1]
                            for sw, qw in zip(sws, qws))
        framing = (wire_fmt.SIGN_HEADER_WORDS + wire_fmt.MOD_HEADER_WORDS
                   + 2 * wire_fmt.CRC_WORDS)
        payload = K * wire_fmt.WORD_BITS * (payload_words + framing)
        sign_bits = wire_fmt.WORD_BITS * (
            sum(sw.shape[-1] for sw in sws) + wire_fmt.SIGN_HEADER_WORDS
            + wire_fmt.CRC_WORDS)
    else:
        sign_bits, mod_bits = packet_bits(l, bits, fl.b0_bits)
        payload = K * (sign_bits + mod_bits)
    diag = RoundTelemetry(sign_ok, mod_ok, sign_ok, payload + retx * sign_bits,
                          retx, **extras)
    return ghat, stats, diag


def error_free_aggregate_tree(grads_tree, fl: FLConfig, draws: TreeDraws,
                              stats: Optional[dict] = None,
                              wire: Optional[str] = None,
                              collective: Optional[str] = None, mesh=None,
                              k: Optional[int] = None):
    """Quantized, lossless tree aggregation (the error-free upper bound at
    LLM scale): every leaf quantized with the tree-wide per-client
    ranges and averaged over the K clients; on the packed wire through
    ``quantize_pack`` and ``spfl_accumulate`` (ḡ = 0, unit weights, no
    votes), one launch each a leaf.  ``collective`` 'sharded' with
    ``mesh``: the leaves hold this rank's rows of the ``k`` clients (as
    :func:`spfl_aggregate_tree`'s), each leaf's partial is summed over
    the ranks by one ``all_reduce``.  Returns (ghat tree, stats,
    telemetry)."""
    wire = fl.wire if wire is None else wire
    if wire not in WIRE_KINDS:
        raise ValueError(f'wire must be one of {WIRE_KINDS}, got {wire!r}')
    mesh = _resolve_collective(
        fl.collective if collective is None else collective, wire, mesh)
    leaves = tree.leaves(grads_tree)
    K = leaves[0].shape[0] if k is None else k
    stats = _tree_stats(grads_tree, stats, mesh, K)
    g_min, g_max = stats['g_min'], stats['g_max']
    bits = fl.quant_bits
    dev = leaves[0].device
    rows, kb = mesh.rows(K), mesh.k_local(K)
    # the dummies weigh 0
    ones = mesh.block(torch.ones((K,), dtype=torch.float32, device=dev), K,
                      0.0)
    g_min_b, g_max_b = mesh.block(g_min, K), mesh.block(g_max, K)
    out = []
    payload_words = 0
    for i, lf in enumerate(leaves):
        flat = _client_rows(lf)
        n = flat.shape[1]
        if wire == 'packed':
            zero = torch.zeros((n,), dtype=torch.float32, device=dev)
            sw, qw = _pack_block(flat, draws.rand[i][rows], g_min[rows],
                                 g_max[rows], bits, kb)
            acc, _ = kops.spfl_aggregate_packed_sharded(
                sw, qw, zero, g_min_b, g_max_b, ones, ones, ones, n, bits,
                mesh=mesh, with_votes=False)
            payload_words += sw.shape[-1] + qw.shape[-1]
            mean = true_div(acc, float(K))
        else:
            qg = stochastic_quantize(flat, bits, draws.rand[i],
                                     g_min[:, None], g_max[:, None])
            mean = _seq_client_mean(qg.sign.to(torch.float32)
                                    * dequantize_modulus(qg))
        out.append(mean.reshape(lf.shape[1:]))
    if wire == 'packed':
        payload = K * wire_fmt.WORD_BITS * (
            payload_words + wire_fmt.SIGN_HEADER_WORDS
            + wire_fmt.MOD_HEADER_WORDS + 2 * wire_fmt.CRC_WORDS)
    else:
        payload = K * (stats['dim'] * (bits + 1) + fl.b0_bits)
    ok = torch.ones((K,), dtype=torch.bool, device=dev)
    diag = RoundTelemetry(ok, ok, ok, _scalar(float(payload), dev),
                          _scalar(0.0, dev))
    return tree.unflatten(grads_tree, out), stats, diag
