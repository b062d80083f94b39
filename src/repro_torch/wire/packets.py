"""Whole-packet encode/decode for the K-client uplink batch (the port of
``repro.wire.packets``).

Exactly one sign packet and one modulus packet per client per round;
client ids are the row indices.  ``frame_uplink_batch`` frames payload
words that are already packed — the live transport packs with the
``quantize_pack`` kernel, which is bit-identical to
``encode_uplink_batch``'s reference packers.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.wire import format as fmt

Tensor = torch.Tensor


class DecodedUplink(NamedTuple):
    """PS-side view of one round's uplink (batched over clients)."""
    sign: Tensor          # int8 in {-1, +1}
    qidx: Tensor          # int32 knob index
    g_min: Tensor         # float32 (b0 side-channel)
    g_max: Tensor         # float32
    client_id: Tensor     # uint32 (int64), from the header
    round_idx: Tensor     # uint32 (int64), from the header
    sign_ok: Tensor       # bool — sign packet framing + checksum valid
    mod_ok: Tensor        # bool — modulus packet framing + checksum valid


def frame_uplink_batch(sign_payload: Tensor, qidx_payload: Tensor,
                       g_min: Tensor, g_max: Tensor, *, n: int, bits: int,
                       round_idx=0):
    """Packed payloads (K, Gs) / (K, Gm) + per-client ranges (K,) ->
    framed (sign_words (K, Ws), mod_words (K, Wm)), int32 patterns."""
    k = sign_payload.shape[0]
    ids = torch.arange(k, dtype=torch.int32, device=sign_payload.device)
    sign_words = fmt.frame(fmt.sign_header(ids, round_idx, n), sign_payload)
    mod_words = fmt.frame(
        fmt.modulus_header(ids, round_idx, n, bits, g_min.reshape(k),
                           g_max.reshape(k)), qidx_payload)
    return sign_words, mod_words


def encode_uplink_batch(sign: Tensor, qidx: Tensor, g_min: Tensor,
                        g_max: Tensor, *, bits: int, round_idx=0):
    """sign/qidx (K, l), g_min/g_max (K,) -> (sign_words, mod_words)."""
    n = sign.shape[-1]
    return frame_uplink_batch(
        fmt.pack_bits_ref(fmt.sign_to_bits(sign), 1),
        fmt.pack_bits_ref(qidx, bits), g_min, g_max, n=n, bits=bits,
        round_idx=round_idx)


def sign_header_ok(sign_words: Tensor, *, n: int) -> Tensor:
    """Header part of sign-packet acceptance (magic + coordinate count)."""
    return ((sign_words[..., 0] == fmt.word(fmt.SIGN_MAGIC))
            & (sign_words[..., 3] == fmt.word(n)))


def mod_header_ok(mod_words: Tensor, *, n: int, bits: int) -> Tensor:
    """Header part of modulus-packet acceptance (magic, n, bit width)."""
    return ((mod_words[..., 0] == fmt.word(fmt.MOD_MAGIC))
            & (mod_words[..., 3] == fmt.word(n))
            & (mod_words[..., 4] == fmt.word(bits)))


def verify_sign_words(sign_words: Tensor, *, n: int) -> Tensor:
    return sign_header_ok(sign_words, n=n) & fmt.verify_frame(sign_words)


def verify_mod_words(mod_words: Tensor, *, n: int, bits: int) -> Tensor:
    return (mod_header_ok(mod_words, n=n, bits=bits)
            & fmt.verify_frame(mod_words))


def sign_payload(sign_words: Tensor) -> Tensor:
    """Payload region of framed sign packets (a strided view)."""
    return sign_words[..., fmt.SIGN_HEADER_WORDS:-fmt.CRC_WORDS]


def mod_payload(mod_words: Tensor) -> Tensor:
    """Payload region of framed modulus packets (a strided view)."""
    return mod_words[..., fmt.MOD_HEADER_WORDS:-fmt.CRC_WORDS]


def mod_header_ranges(mod_words: Tensor) -> tuple:
    """(g_min, g_max) bitcast back out of the modulus header."""
    return (fmt.word_to_f32(mod_words[..., 5].contiguous()),
            fmt.word_to_f32(mod_words[..., 6].contiguous()))


def restamp_sign_retx(sign_words: Tensor, attempt: int) -> Tensor:
    """Same payload, fresh [attempt | round] stamp, CRC patched."""
    old = sign_words[..., 2]
    return fmt.restamp_word(sign_words, 2,
                            fmt.stamp_round(fmt.round_of(old), attempt))


def decode_uplink_batch(sign_words: Tensor, mod_words: Tensor, *, n: int,
                        bits: int) -> DecodedUplink:
    """Parse + verify both packets of every client."""
    sign = fmt.bits_to_sign(fmt.unpack_bits_ref(sign_payload(sign_words),
                                                n, 1))
    qidx = fmt.unpack_bits_ref(mod_payload(mod_words), n, bits).to(
        torch.int32)
    g_min, g_max = mod_header_ranges(mod_words)
    return DecodedUplink(
        sign=sign, qidx=qidx, g_min=g_min, g_max=g_max,
        client_id=fmt.u64(sign_words[..., 1]),
        round_idx=fmt.round_of(sign_words[..., 2]),
        sign_ok=verify_sign_words(sign_words, n=n),
        mod_ok=verify_mod_words(mod_words, n=n, bits=bits))
