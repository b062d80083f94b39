"""Canonical wire layout: bit-plane packed uint32 words + packet framing
(the port of ``repro.wire.format``).

Payload layout: values are processed in groups of ``GROUP = 32``
consecutive coordinates; for group ``g`` and bit plane ``j`` (0 = LSB)

    w[g * bits + j] = sum_i  bit_j(v[32*g + i]) << i ,   i = 0..31

so a packet holds exactly ``ceil(n/32) * bits`` payload words.

Packet framing::

    sign packet     [SIGN_MAGIC, client_id, round, n] payload...  crc
    modulus packet  [MOD_MAGIC, client_id, round, n, bits,
                     bitcast(g_min), bitcast(g_max)]   payload...  crc

``crc`` is the xor-fold of every preceding word.

Word dtype: PyTorch's ``uint32`` lacks most operators, so words live in
``torch.int32`` tensors holding the uint32 bit pattern.  Xor, and, or and
equality work on the pattern directly; anything that shifts right,
compares by magnitude or multiplies goes through :func:`u64` (int64 masked
to 32 bits) and comes back with :func:`to_words`.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

WORD_BITS = 32
GROUP = 32                   # coordinates per bit-plane group
MASK32 = 0xFFFFFFFF

SIGN_MAGIC = 0x53474E31      # 'SGN1'
MOD_MAGIC = 0x4D4F4431       # 'MOD1'
SIGN_HEADER_WORDS = 4        # magic, client_id, round, n
MOD_HEADER_WORDS = 7         # magic, client_id, round, n, bits, gmin, gmax
CRC_WORDS = 1

# round header word: [attempt:8 | round:24] (retransmission stamp)
RETX_SHIFT = 24
ROUND_MASK = (1 << RETX_SHIFT) - 1


# ---------------------------------------------------------------------------
# uint32 bit patterns in int32 / int64 tensors
# ---------------------------------------------------------------------------

def u64(words: Tensor) -> Tensor:
    """Word tensor (any integer dtype) -> int64 in [0, 2^32)."""
    return words.to(torch.int64) & MASK32


def to_words(x: Tensor) -> Tensor:
    """int64 holding uint32 values (or already int32) -> int32 pattern."""
    if x.dtype == torch.int32:
        return x
    x = x.to(torch.int64) & MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def word(value: int) -> int:
    """Python uint32 constant -> the int32 value of the same pattern."""
    value &= MASK32
    return value - 2 ** 32 if value >= 2 ** 31 else value


# ---------------------------------------------------------------------------
# sizes (exact word counts of real buffers)
# ---------------------------------------------------------------------------

def n_groups(n: int) -> int:
    return -(-n // GROUP)


def payload_words(n: int, bits: int) -> int:
    return n_groups(n) * bits


def sign_packet_words(n: int) -> int:
    return SIGN_HEADER_WORDS + payload_words(n, 1) + CRC_WORDS


def modulus_packet_words(n: int, bits: int) -> int:
    return MOD_HEADER_WORDS + payload_words(n, bits) + CRC_WORDS


def measured_uplink_bits(n: int, bits: int, k: int = 1) -> int:
    """Total bits on the wire for k clients' (sign + modulus) packets."""
    return k * WORD_BITS * (sign_packet_words(n) + modulus_packet_words(n, bits))


# ---------------------------------------------------------------------------
# reference packers (arbitrary leading batch dims; last axis packed)
# ---------------------------------------------------------------------------

def _lane(device) -> Tensor:
    return torch.arange(GROUP, dtype=torch.int64, device=device)


def pack_bits_ref(values: Tensor, bits: int) -> Tensor:
    """(..., n) integer values in [0, 2^bits) -> (..., ceil(n/32)*bits)
    int32 payload words in the canonical bit-plane layout."""
    *lead, n = values.shape
    g = n_groups(n)
    v = u64(values)
    pad = g * GROUP - n
    if pad:
        v = torch.nn.functional.pad(v, (0, pad))
    v = v.reshape(*lead, g, GROUP)
    lane = _lane(values.device)
    planes = [torch.sum(((v >> j) & 1) << lane, dim=-1) for j in range(bits)]
    return to_words(torch.stack(planes, dim=-1).reshape(*lead, g * bits))


def unpack_bits_ref(words: Tensor, n: int, bits: int) -> Tensor:
    """Inverse of :func:`pack_bits_ref` -> (..., n) int64 values."""
    *lead, w = words.shape
    g = n_groups(n)
    if w != g * bits:
        raise ValueError(f'{w} words cannot hold n={n} at bits={bits}')
    wv = u64(words).reshape(*lead, g, bits)
    lane = _lane(words.device)
    acc = torch.zeros((*lead, g, GROUP), dtype=torch.int64,
                      device=words.device)
    for j in range(bits):
        acc = acc | (((wv[..., j:j + 1] >> lane) & 1) << j)
    return acc.reshape(*lead, g * GROUP)[..., :n]


def sign_to_bits(sign: Tensor) -> Tensor:
    """Sign in {-1, 0, +1} -> wire bit (1 <-> +1; 0 transmits as +1)."""
    return (sign >= 0).to(torch.int32)


def bits_to_sign(bits_: Tensor) -> Tensor:
    """Wire bit -> int8 sign in {-1, +1}."""
    return torch.where(bits_ > 0, 1, -1).to(torch.int8)


# ---------------------------------------------------------------------------
# framing helpers
# ---------------------------------------------------------------------------

def xor_fold(words: Tensor) -> Tensor:
    """Xor of all words along the last axis (the integrity word), as an
    int32 pattern.  A halving tree of ``bitwise_xor``: PyTorch has no xor
    reduction."""
    x = to_words(words)
    w = x.shape[-1]
    if w == 0:
        return torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    width = 1 << (w - 1).bit_length()
    if width != w:
        x = torch.nn.functional.pad(x, (0, width - w))
    while width > 1:
        width //= 2
        x = x[..., :width] ^ x[..., width:]
    return x[..., 0]


def verify_frame(words: Tensor) -> Tensor:
    """Fold check over the last axis: xor-fold of header + payload equals
    the trailing CRC word."""
    return xor_fold(words[..., :-1]) == to_words(words[..., -1])


def f32_to_word(x) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32).view(torch.int32)


def word_to_f32(w: Tensor) -> Tensor:
    return to_words(w).view(torch.float32)


def stamp_round(round_idx, attempt=0):
    """Round header word: [attempt:8 | round:24] (uint32 value; a Python
    int for Python inputs, an int64 tensor otherwise)."""
    return (((round_idx & ROUND_MASK) | (attempt << RETX_SHIFT)) & MASK32)


def round_of(word_: Tensor) -> Tensor:
    return u64(word_) & ROUND_MASK


def attempt_of(word_: Tensor) -> Tensor:
    return u64(word_) >> RETX_SHIFT


def _field(value, shape, device) -> Tensor:
    """One header field (Python int, uint32 tensor or int32 pattern)
    broadcast to ``shape`` as an int32 pattern."""
    if isinstance(value, int):
        value = torch.tensor(word(value), dtype=torch.int32, device=device)
    return to_words(torch.as_tensor(value, device=device)).expand(shape)


def frame(header_fields, payload: Tensor) -> Tensor:
    """[header..., payload..., crc] along the last axis, batched over the
    leading axes of ``payload``; header fields broadcast against them."""
    lead = payload.shape[:-1]
    header = torch.stack([_field(f, lead, payload.device)
                          for f in header_fields], dim=-1)
    body = torch.cat([header, to_words(payload)], dim=-1)
    return torch.cat([body, xor_fold(body)[..., None]], dim=-1)


def restamp_word(words: Tensor, idx: int, new_word) -> Tensor:
    """Rewrite one header word and patch the CRC in O(1): the xor-fold is
    linear, so crc' = crc ^ old ^ new.  Batched over leading axes."""
    new = _field(new_word, words.shape[:-1], words.device)
    out = words.clone()
    out[..., -1] = words[..., -1] ^ words[..., idx] ^ new
    out[..., idx] = new
    return out


def sign_header(client_id, round_idx, n: int):
    return (SIGN_MAGIC, client_id, stamp_round(round_idx), n)


def modulus_header(client_id, round_idx, n: int, bits: int, g_min, g_max):
    return (MOD_MAGIC, client_id, stamp_round(round_idx), n, bits,
            f32_to_word(g_min), f32_to_word(g_max))
