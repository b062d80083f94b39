"""Counter-based keys of the Threefry-2x32 generator — the key functions
of ``jax.random`` that the population module reaches, with jax's
defaults (``threefry2x32``, ``jax_threefry_partitionable=True``), so a
key here and a jax key of the same words draw the same bits.

A key is an int64 tensor of shape (..., 2) holding two uint32 words;
every function takes keys of any leading batch shape, so one call serves
many streams.  Words are int64 masked to 32 bits, as ``wire/`` keeps
them.

* ``key(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``fold_in(key, d)`` is ``threefry(key, (0, d))``;
* ``split(key, n)``'s row i is ``threefry(key, (0, i))``;
* ``bits(key, shape)`` is ``b0 ^ b1`` of ``threefry(key, (hi, lo))`` over
  the 64-bit flat index of each element;
* ``uniform`` puts the top 23 bits of ``bits`` under the exponent of 1.0
  and subtracts 1;
* ``normal`` is ``sqrt(2) erfinv(u)`` on ``u ~ U(nextafter(-1, 1), 1)``,
  with XLA's float32 ``ErfInv`` polynomial (its ``p = c + p w`` steps
  contracted into fused multiply-adds, as XLA compiles them) rather than
  ``torch.erfinv``, which is up to tens of ulp from it.  XLA's own
  ``log1p`` still differs from PyTorch's in the last bit now and then, so
  a normal is within a few ulp of jax's, and equal on ~99% of draws.
"""
from __future__ import annotations

import math
from typing import Sequence, Union

import torch

Tensor = torch.Tensor
IntLike = Union[int, Tensor]

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_BITS = 0x3F800000               # the bits of 1.0f
# XLA's ErfInv32 (xla/hlo/builder/lib/math.cc): w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _u32(x: IntLike, like: Tensor = None) -> Tensor:
    """``x`` as int64 words masked to 32 bits (on ``like``'s device)."""
    device = None if like is None else like.device
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0: IntLike, k1: IntLike, x0: IntLike, x1: IntLike
                 ) -> tuple:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key words (k0, k1), elementwise over their broadcast shape -> the two
    output words, int64 in [0, 2^32)."""
    ref = next((t for t in (k0, k1, x0, x1) if isinstance(t, Tensor)),
               None)
    k0, k1, x0, x1 = torch.broadcast_tensors(
        *(_u32(t, ref) for t in (k0, k1, x0, x1)))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int) -> Tensor:
    """The key of an integer seed, (2,) int64: ``jax.random.PRNGKey``."""
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64)


def fold_in(keys: Tensor, data: IntLike) -> Tensor:
    """``jax.random.fold_in``: keys (..., 2) and uint32 ``data``
    broadcast against the leading shape -> keys (..., 2)."""
    return torch.stack(threefry2x32(keys[..., 0], keys[..., 1], 0, data),
                       dim=-1)


def split(keys: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split``: keys (..., 2) -> (..., num, 2)."""
    i = torch.arange(num, dtype=torch.int64, device=keys.device)
    return torch.stack(threefry2x32(keys[..., None, 0], keys[..., None, 1],
                                    i >> 32, i), dim=-1)


def bits(keys: Tensor, shape: Sequence[int] = ()) -> Tensor:
    """``jax.random.bits`` (uint32): keys (..., 2) -> (..., *shape) words
    as int64."""
    shape = tuple(shape)
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=keys.device)
    b0, b1 = threefry2x32(keys[..., None, 0], keys[..., None, 1],
                          i >> 32, i)
    return (b0 ^ b1).reshape(keys.shape[:-1] + shape)


def _fma32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """fma(a, b, c) in float32, rounded once: the product is exact in
    float64; the float64 sum is rounded to odd (where it is inexact and
    its last bit even, it steps one float64 ulp toward the exact sum,
    whose error TwoSum gives), so the one rounding to float32 that
    follows is the exact sum's (float64 carries 29 more bits).  Rounded
    to nearest instead, a sum just off a float32 midpoint (a tiny c)
    would round twice, to the wrong side."""
    p = a.to(torch.float64) * b.to(torch.float64)
    q = c.to(torch.float64)
    s = p + q
    r = s - p
    err = (p - (s - r)) + (q - r)
    odd = torch.isfinite(s) & (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, math.inf, -math.inf).to(s)
    return torch.where(odd, torch.nextafter(s, toward), s).to(torch.float32)


def uniform_from_bits(words: Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> Tensor:
    """float32 uniforms from uint32 ``words`` (``bits``' output), as
    ``jax.random.uniform`` makes them: the top 23 bits under the exponent
    of 1.0, minus 1, scaled onto [minval, maxval) by one fused
    multiply-add (XLA contracts the scale and shift)."""
    lo = torch.tensor(minval, dtype=torch.float32, device=words.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=words.device)
    f = ((words >> 9) | _ONE_BITS).to(torch.int32).view(torch.float32)
    return torch.maximum(lo, _fma32(f - 1.0, hi - lo, lo))


def uniform(keys: Tensor, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """``jax.random.uniform`` (float32): keys (..., 2) -> (..., *shape)."""
    return uniform_from_bits(bits(keys, shape), minval, maxval)


def erfinv32(x: Tensor) -> Tensor:
    """XLA's float32 ``ErfInv`` (Giles' polynomial in w = -log1p(-x^2))."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    # the root correctly rounded, as XLA's (PyTorch's CPU float32 sqrt
    # is not)
    w = torch.where(lt, w - 2.5,
                    torch.sqrt(w.to(torch.float64)).to(torch.float32) - 3.0)

    def coefficient(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i]),
                           torch.tensor(_ERFINV_GE5[i])).to(x.device)

    p = coefficient(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32(p, w, coefficient(i))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NEXT_ABOVE_MINUS_ONE = float(torch.nextafter(torch.tensor(-1.0),
                                              torch.tensor(1.0)))
_SQRT2_F32 = float(torch.tensor(math.sqrt(2.0), dtype=torch.float32))


def normal_from_bits(words: Tensor) -> Tensor:
    """float32 standard normals from uint32 ``words``, as
    ``jax.random.normal`` makes them."""
    u = uniform_from_bits(words, _NEXT_ABOVE_MINUS_ONE, 1.0)
    return _SQRT2_F32 * erfinv32(u)


def normal(keys: Tensor, shape: Sequence[int] = ()) -> Tensor:
    """``jax.random.normal`` (float32): keys (..., 2) -> (..., *shape)."""
    return normal_from_bits(bits(keys, shape))
