"""Bit-level uplink channel — CRC-driven erasures over materialized
packets (the port of ``repro.core.bitchannel``).

(q, p) map to a per-bit flip probability (:func:`ber_for_success`, the
inverse of the fold-pass probability ``((1 + (1 - 2 eps)^B) / 2) ** 32``
of a ``B``-word packet), the ``corrupt_fold`` kernel flips real bits of
the framed buffers, and the ``fold_words`` kernel folds what the PS
received: ``sign_ok`` / ``mod_ok`` are decode outcomes of corrupted
buffers.  Failed sign packets are resent ``n_retx`` times (same payload,
fresh header stamp, fresh draw).

Randomness is explicit: each transmission takes the two uint32 seed
words of its counter-PRF stream from the round's ``seeds``, a
(2 + n_retx, 2) int32 tensor of their patterns on the device: row 0 for
the modulus packet, row 1 + a for sign attempt ``a``.  The kernel reads
them from device memory, so a round captured in a CUDA graph replays
with the words its input slot holds.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.quantize import true_div
from repro_torch.kernels import ops as kops
from repro_torch.wire import format as wire_fmt
from repro_torch.wire import packets as wire_packets

Tensor = torch.Tensor


def verify_sign_fold(sign_words: Tensor, *, n: int) -> Tensor:
    """PS-side acceptance of (K, Ws) received sign buffers, the fold by
    the ``fold_words`` kernel."""
    return (wire_packets.sign_header_ok(sign_words, n=n)
            & (kops.fold_words(sign_words) == 0))


def verify_mod_fold(mod_words: Tensor, *, n: int, bits: int) -> Tensor:
    """Kernel-fold acceptance of (K, Wm) received modulus buffers."""
    return (wire_packets.mod_header_ok(mod_words, n=n, bits=bits)
            & (kops.fold_words(mod_words) == 0))


def fold_pass_prob(ber, n_words: int) -> Tensor:
    """P(xor-fold verify passes) for i.i.d. flips at rate ``ber`` over
    ``n_words`` words (log1p/expm1 form, f32)."""
    ber = torch.as_tensor(ber, dtype=torch.float32)
    log_pow = n_words * torch.log1p(-2.0 * ber)
    even_m1 = 0.5 * torch.expm1(log_pow)
    return torch.exp(wire_fmt.WORD_BITS * torch.log1p(even_m1))


def ber_for_success(prob, n_words: int) -> Tensor:
    """Per-bit flip probability such that the fold verify of an
    ``n_words`` packet passes with probability ``prob`` (f32; saturates
    at 1/2 at the 2^-32 fold floor)."""
    prob = torch.clamp(torch.as_tensor(prob, dtype=torch.float32), 0.0, 1.0)
    rm1 = torch.clamp(
        2.0 * torch.expm1(torch.log(prob) / wire_fmt.WORD_BITS), min=-1.0)
    log_r = torch.log1p(rm1)
    return -0.5 * torch.expm1(true_div(log_r, float(n_words)))


def calibrated_success_prob(prob, n_bits: int) -> Tensor:
    """The success probability the bit-channel calibration realizes for a
    virtual packet of ``ceil(n_bits / 32)`` payload words plus the CRC
    word: ``prob`` through :func:`ber_for_success` and back through
    :func:`fold_pass_prob`.  The identity to f32 rounding at operating
    points, with a real 32-bit fold's floor (probabilities at or below
    2^-32 saturate).  The single-packet baselines (dds, onebit,
    scheduling) route their success probabilities through it under
    ``channel='bitlevel'`` without materializing their buffers."""
    n_words = -(-int(n_bits) // wire_fmt.WORD_BITS) + wire_fmt.CRC_WORDS
    return fold_pass_prob(ber_for_success(prob, n_words), n_words)


class UplinkReport(NamedTuple):
    """What the PS saw of one round's uplink through the bit channel."""
    sign_words: Tensor    # (K, Ws) received sign buffers (accepted attempt)
    mod_words: Tensor     # (K, Wm) received modulus buffers
    sign_ok: Tensor       # (K,) bool — verify outcome after retransmissions
    mod_ok: Tensor        # (K,) bool — modulus verify outcome
    sign_crc_ok: Tensor   # (K,) bool — first-attempt sign verify
    mod_crc_ok: Tensor    # (K,) bool — (== mod_ok; modulus has no retx)
    sign_flips: Tensor    # (K,) int32 — channel bit flips across attempts
    mod_flips: Tensor     # (K,) int32
    retx_attempts: Tensor  # (K,) int32 — materialized sign resends
    retx_bits: Tensor     # scalar f32 — measured bits of all resends


def transmit_uplink(sign_words: Tensor, mod_words: Tensor, q: Tensor,
                    p: Tensor, *, n: int, bits: int, seeds: Tensor,
                    n_retx: int = 0, mesh=None) -> UplinkReport:
    """Send every client's framed packet pair through the bit channel.
    ``seeds`` (2 + n_retx, 2) int32 on the words' device: the modulus
    packet's seed pair, then one per sign transmission attempt.

    ``mesh`` (``core.mesh.ClientMesh``): the buffers, q and p are this
    rank's block of clients; each pass runs at the block's global word
    offset (the gathered draw's bits), and the report is the block's
    (``retx_bits`` its resends)."""
    if tuple(seeds.shape) != (n_retx + 2, 2):
        raise ValueError(f'need {n_retx + 2} seed pairs, got seeds of shape '
                         f'{tuple(seeds.shape)}')
    ws = sign_words.shape[-1]
    ber_s = ber_for_success(q, ws)
    ber_v = ber_for_success(p, mod_words.shape[-1])

    sw, _, sign_flips = kops.corrupt_fold_words(seeds[1], sign_words, ber_s,
                                                mesh=mesh)
    mw, _, mod_flips = kops.corrupt_fold_words(seeds[0], mod_words, ber_v,
                                               mesh=mesh)
    sign_ok = verify_sign_fold(sw, n=n)
    mod_ok = verify_mod_fold(mw, n=n, bits=bits)
    sign_crc_ok = sign_ok

    retx_attempts = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    for attempt in range(1, n_retx + 1):
        failed = ~sign_ok
        resent = wire_packets.restamp_sign_retx(sign_words, attempt)
        rx, _, flips = kops.corrupt_fold_words(seeds[1 + attempt], resent,
                                               ber_s, mesh=mesh)
        ok = verify_sign_fold(rx, n=n)
        sw = torch.where((failed & ok)[:, None], rx, sw)
        sign_flips = sign_flips + torch.where(failed, flips, 0)
        retx_attempts = retx_attempts + failed.to(torch.int32)
        sign_ok = sign_ok | (failed & ok)

    retx_bits = (torch.sum(retx_attempts).to(torch.float32)
                 * float(ws * wire_fmt.WORD_BITS))
    return UplinkReport(sw, mw, sign_ok, mod_ok, sign_crc_ok, mod_ok,
                        sign_flips, mod_flips, retx_attempts, retx_bits)
