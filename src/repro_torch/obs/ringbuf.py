"""Device telemetry ring buffer — the zero-sync half of the obs layer (the
port of ``repro.obs.ringbuf``).

The training loop pushes one condensed :class:`~repro_torch.obs.record.
RoundTelemetry` a round into a fixed-capacity ring of stacked device
tensors.  A push is one in-place device copy per tensor field, with no
host synchronization; fields that are already host values (``round_idx``,
the 'numpy' backend's objective) stay on the host beside it.  Only
:func:`flush` crosses to the host: ONE device-to-host copy of the whole
buffer (its fields viewed as bytes and concatenated on the device),
sliced into host records, oldest first.

Records pushed into one ring share a layout: the same fields are
tensors, host values or ``None`` (one transport, wire and channel
configuration).  Pushing more than ``capacity`` records between flushes
wraps and overwrites the oldest; ``flush`` returns the surviving window.

Fused rounds (``training.fused``) write a segment's records into fixed
slots instead, inside a captured CUDA graph ('scan': round i of the
segment into slot i, :func:`ring_write`) or behind its replay ('eager':
a device copy from a one-slot ring, :func:`ring_copy`), and mark the
slots written with :func:`ring_written` before the flush.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.obs.record import RoundTelemetry


class TelemetryRing:
    """``buf`` holds each tensor field stacked to ``(capacity, *shape)``
    on its device; ``host`` each slot's host-valued fields; ``idx``
    counts the records pushed since the last flush."""

    def __init__(self, buf: Dict[str, torch.Tensor], host_fields,
                 capacity: int):
        self.buf = buf
        self.host_fields = tuple(host_fields)
        self.host: List[Dict[str, Any]] = [{} for _ in range(capacity)]
        self.capacity = capacity
        self.idx = 0


def _split(rec: RoundTelemetry):
    """-> ({tensor field: value}, {host field: value}) of a record."""
    tensors, host = {}, {}
    for name, val in rec._asdict().items():
        if isinstance(val, torch.Tensor):
            tensors[name] = val
        elif val is not None:
            host[name] = val
    return tensors, host


def ring_init(proto: RoundTelemetry, capacity: int) -> TelemetryRing:
    """A fresh ring shaped after ``proto`` (a record of the run, typically
    round 0's): zeros on each field's device."""
    if capacity < 1:
        raise ValueError(f'capacity must be >= 1, got {capacity}')
    tensors, host = _split(proto)
    buf = {name: torch.zeros((capacity,) + tuple(t.shape), dtype=t.dtype,
                             device=t.device)
           for name, t in tensors.items()}
    return TelemetryRing(buf, host, capacity)


def ring_write(ring: TelemetryRing, slot: int,
               rec: RoundTelemetry) -> None:
    """Write ``rec`` into slot ``slot``: device copies only (so a
    captured round can write its record)."""
    tensors, host = _split(rec)
    if set(tensors) != set(ring.buf) or set(host) != set(ring.host_fields):
        raise ValueError('a record of another layout than the ring\'s: '
                         f'{sorted(tensors)} / {sorted(host)}')
    for name, val in tensors.items():
        ring.buf[name][slot].copy_(val)
    ring.host[slot] = host


def ring_push(ring: TelemetryRing, rec: RoundTelemetry) -> TelemetryRing:
    """Write ``rec`` into the next slot: device copies only."""
    ring_write(ring, ring.idx % ring.capacity, rec)
    ring.idx += 1
    return ring


def ring_copy(dst: TelemetryRing, slot: int, src: TelemetryRing,
              src_slot: int = 0) -> None:
    """Device copies of ``src``'s slot ``src_slot`` into ``dst``'s slot
    ``slot`` (rings of one layout)."""
    for name, b in src.buf.items():
        dst.buf[name][slot].copy_(b[src_slot])
    dst.host[slot] = dict(src.host[src_slot])


def ring_written(ring: TelemetryRing, n: int) -> None:
    """Mark slots 0..n-1 as the records written since the last flush."""
    if not 0 <= n <= ring.capacity:
        raise ValueError(f'{n} records in a ring of {ring.capacity}')
    ring.idx = n


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def flush(ring: TelemetryRing) -> Tuple[List[RoundTelemetry], TelemetryRing]:
    """Drain the ring: ONE device-to-host copy of the stacked buffer,
    sliced into host records (NumPy arrays and host numbers), oldest
    first, and the ring reset to reuse its buffers."""
    n, cap = ring.idx, ring.capacity
    if n <= cap:
        order = list(range(n))
    else:                         # wrapped: oldest surviving slot first
        start = n % cap
        order = list(range(start, cap)) + list(range(start))
    host_bufs = {}
    if ring.buf and order:
        names = list(ring.buf)
        raw = torch.cat([ring.buf[name].reshape(-1).view(torch.uint8)
                         for name in names]).cpu().numpy()
        offset = 0
        for name in names:
            b = ring.buf[name]
            size = b.numel() * b.element_size()
            host_bufs[name] = raw[offset:offset + size].view(
                _numpy_dtype(b.dtype)).reshape(tuple(b.shape))
            offset += size
    recs = []
    for i in order:
        fields = {name: np.array(v[i]) for name, v in host_bufs.items()}
        fields.update(ring.host[i])
        recs.append(RoundTelemetry(**{
            name: fields.get(name) for name in RoundTelemetry._fields}))
    ring.idx = 0
    ring.host = [{} for _ in range(cap)]
    return recs, ring
