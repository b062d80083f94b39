"""Bit-level corruption of wire word buffers — the channel's write side
(the port of ``repro.wire.corrupt``).

Every bit of a buffer is addressed by its (word index, bit plane) pair;
its flip decision is a threshold test of a murmur3-fmix32 double mix —
the first round mixes the uint32 word counter with seed word ``s0``, the
second folds in ``s1`` salted by the bit plane.  The seeds are two
explicit uint32 words (the reference derives them from a JAX key with
``seeds_from_key``; parity tests pass the reference's words).

The plain functions here compute in int64 masked to 32 bits.  A product
``x * c`` of two uint32 values overflows int64, so :func:`_mul32` forms it
from the 16-bit halves of the constant, which keeps every intermediate
below 2^49.  The CUDA kernel (``kernels/csrc/corrupt_fold.cu``) runs the
same arithmetic natively in ``uint32_t``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.wire.format import (
    MASK32, WORD_BITS, to_words, u64, xor_fold,
)

Tensor = torch.Tensor

_MIX1 = 0x85EBCA6B
_MIX2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_PLANE_SALT = 0x9E3779B1
# largest f32 below 2^32: the threshold clamp for ber -> uint32 scaling
_THRESH_MAX = 4294967040.0


def _mul32(x: Tensor, c: int) -> Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def _fmix32(x: Tensor) -> Tensor:
    """Murmur3 32-bit finalizer on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _MIX1)
    x = x ^ (x >> 13)
    x = _mul32(x, _MIX2)
    return x ^ (x >> 16)


def hash_bits(word_idx: Tensor, plane: int, seed0: int, seed1: int
              ) -> Tensor:
    """Counter PRF: (uint32 word index, bit plane 0..31) -> uint32 hash,
    as int64 in [0, 2^32)."""
    p = (plane * _PLANE_SALT) & MASK32
    h = _fmix32(((word_idx.to(torch.int64) + _GOLDEN) & MASK32)
                ^ (seed0 & MASK32))
    return _fmix32(h ^ (seed1 & MASK32) ^ p)


def flip_threshold(ber) -> Tuple[Tensor, Tensor]:
    """ber (f32) -> (uint32 threshold as int64, all-flips flag).  A bit
    flips iff ``hash < threshold`` or the flag is set (ber >= 1).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    ber = torch.as_tensor(ber, dtype=torch.float32)
    t = torch.round(torch.clamp(ber, 0.0, 1.0) * 4294967296.0)
    return torch.clamp(t, 0.0, _THRESH_MAX).to(torch.int64), ber >= 1.0


def _word_index(shape, word0: int, device) -> Tensor:
    """Global uint32 word index over ``shape`` (row-major) plus ``word0``."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return (idx + word0) & MASK32


def threshold_mask(seeds: Tuple[int, int], shape, thresh: Tensor,
                   allflip: Tensor, word0: int = 0, device=None) -> Tensor:
    """uint32 flip mask (int64 values) for a word buffer of ``shape``
    given per-row uint32 thresholds and all-flip flags (broadcast over
    the leading axes)."""
    thresh = u64(thresh.to(device))
    allf = allflip.to(device=device, dtype=torch.bool)
    bshape = thresh.shape + (1,) * (len(shape) - thresh.dim())
    thresh = thresh.reshape(bshape)
    allf = allf.reshape(bshape)
    base = _word_index(shape, word0, device)
    mask = torch.zeros(shape, dtype=torch.int64, device=device)
    for j in range(WORD_BITS):
        h = hash_bits(base, j, seeds[0], seeds[1])
        bit = ((h < thresh) | allf).to(torch.int64)
        mask = mask | (bit << j)
    return mask


def flip_mask(seeds: Tuple[int, int], shape, ber, word0: int = 0,
              device=None) -> Tensor:
    """uint32 flip mask (int64 values) for a word buffer of ``shape``;
    ``ber`` broadcasts over the leading (per-client) axes."""
    thresh, allf = flip_threshold(ber)
    return threshold_mask(seeds, shape, thresh, allf, word0, device)


def count_flips(mask: Tensor) -> Tensor:
    """Flipped bits per buffer: popcount of the mask, summed over words."""
    m = mask.to(torch.int64) & MASK32
    count = torch.zeros_like(m)
    for j in range(WORD_BITS):
        count = count + ((m >> j) & 1)
    return count.sum(dim=-1).to(torch.int32)


def corrupt_fold(seeds: Tuple[int, int], words: Tensor, ber,
                 word0: int = 0) -> Tuple[Tensor, Tensor, Tensor]:
    """Transmit (K, W) buffers through the bit-flip channel ->
    (received words, per-client xor-fold of the flip mask, per-client
    flip count), all int32."""
    mask = flip_mask(seeds, tuple(words.shape), ber, word0, words.device)
    rx = to_words(words) ^ to_words(mask)
    return rx, xor_fold(mask), count_flips(mask)
