"""Bit-sliced sign-vote majority and per-client disagreement on packed
sign payload words (the port of ``repro.wire.vote``).

The screening signal of ``adversary.screen``: the PS holds every client's
packed sign payload, so the majority sign of each coordinate and each
client's Hamming distance to it are word-parallel bit tricks over the
(K, W) rows, with no unpack.

Math.  Stack the K gated sign rows (bit 1 <-> sign +1).  The set bits of
each lane are counted across clients by a ripple-carry half-adder into
``NB = K.bit_length()`` count bit-planes (the count K < 2**NB never
overflows); the majority bit is the bit-sliced comparison
``count > n_ok // 2``, a strict majority of +1 votes with ties to -1,
against the threshold as a device tensor (no host read), most
significant plane first with greater/equal word accumulators.
Disagreement is ``popcount((row ^ majority) & lane_mask)``, the last
word's pad lanes masked out: under the bit-level channel they carry
flips that must count as neither votes nor disagreements.

Words are ``torch.int32`` tensors holding uint32 patterns (``wire.format``):
xor, and, or and not act on the pattern directly.  ``>>`` on int32 is
arithmetic, so it shifts only the small count ``t``; PyTorch has no
popcount, so :func:`popcount` is the SWAR bit trick in int64 masked to
32 bits.  Rows a caller wants out of the vote (CRC-failed, dropped) enter
through the boolean ``gate``: a gated-off row adds no count and no
threshold weight.
"""
from __future__ import annotations

import torch

from repro_torch.wire import format as fmt

Tensor = torch.Tensor


def lane_mask_words(n: int, n_words: int, device=None) -> Tensor:
    """(n_words,) int32 validity mask: all ones but the last word, which
    keeps only the low ``n % 32`` lanes (pad lanes are dead)."""
    masks = torch.full((n_words,), -1, dtype=torch.int32, device=device)
    tail = n % fmt.GROUP
    if tail and n_words:
        # a fill, not an item assignment (which copies from the host and
        # cannot be captured in a CUDA graph)
        masks[-1:].fill_((1 << tail) - 1)
    return masks


def add_planes(a: list, b: list) -> list:
    """Lane-wise sum of two counts held as bit-planes (full adders; the
    sum must fit the planes)."""
    out, carry = [], torch.zeros_like(a[0])
    for x, y in zip(a, b):
        half = x ^ y
        out.append(half ^ carry)
        carry = (x & y) | (carry & half)
    return out


def majority_words(rows: Tensor, gate: Tensor, n: int,
                   n_ok: Tensor = None, mesh=None) -> Tensor:
    """Majority sign word per payload word over the gated client rows.

    rows: (K, W) int32 packed sign payload (a strided view is fine);
    gate: (K,) voters (bool, or 0/1).  -> (W,) int32: bit 1 where a
    strict majority of the gated rows voted +1 (count > n_ok // 2),
    lane-masked in the tail word.

    ``mesh`` (a ``core.mesh.ClientMesh`` of S ranks): ``rows`` and
    ``gate`` are this rank's block and ``n_ok`` the global count of
    voters; each rank counts its block into the planes of S * K_local,
    one ``all_gather`` brings every rank's planes (none on a one-rank
    mesh) and their integer sum is compared with ``n_ok // 2``: equal to
    the gathered majority bit for bit."""
    k, w = rows.shape
    size = 1 if mesh is None else mesh.size
    nb = max(1, int(k * size).bit_length())
    on = gate.to(torch.bool)
    gated = torch.where(on[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    zero = torch.zeros((w,), dtype=torch.int32, device=rows.device)
    planes = [zero] * nb
    for r in range(k):                  # ripple-carry half-adders
        carry = gated[r]
        for j in range(nb):
            planes[j], carry = planes[j] ^ carry, planes[j] & carry
    if size > 1:
        every = mesh.all_gather(torch.stack(planes)).reshape(size, nb, w)
        planes = list(every[0].unbind(0))
        for r in range(1, size):
            planes = add_planes(planes, list(every[r].unbind(0)))
    if n_ok is None:
        n_ok = torch.sum(on.to(torch.int32))
    t = n_ok // 2
    gt = zero
    eq = torch.full((w,), -1, dtype=torch.int32, device=rows.device)
    for j in reversed(range(nb)):
        tb = -((t >> j) & 1)            # 0 or all ones
        cb = planes[j]
        gt = gt | (eq & cb & ~tb)
        eq = eq & ~(cb ^ tb)
    return gt & lane_mask_words(n, w, rows.device)


def popcount(words: Tensor) -> Tensor:
    """Set bits of each uint32 pattern, int64 (SWAR)."""
    x = fmt.u64(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & fmt.MASK32) >> 24


def disagreement(rows: Tensor, majority: Tensor, n: int) -> Tensor:
    """(K,) int32: per client, the valid lanes whose sign bit differs
    from the majority word (popcount of the masked xor)."""
    _, w = rows.shape
    diff = (rows ^ majority[None, :]) & lane_mask_words(n, w, rows.device)
    return torch.sum(popcount(diff), dim=-1).to(torch.int32)
