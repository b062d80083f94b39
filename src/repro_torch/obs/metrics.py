"""Host-side metrics registry: counters, gauges and reservoir histograms
behind named channels (the port of ``repro.obs.metrics``, pure Python,
so a snapshot equals the reference's on the same rows).

The registry is fed from *flushed* telemetry rows (``observe_round``) and
host-side events only; it never touches a device tensor.

Channels mirror the quantities the paper reasons about:

* ``transport``: payload_bits and retransmissions counters, flip
  counters, CRC-pass gauges, the packed-domain sign-vote agreement;
* ``bitchannel``: empirical (CRC-detected) vs calibrated erasure rates;
* ``allocation``: q/p mean gauges and histograms, the eq. (28) objective,
  solver effort and exit reasons, ``host_solver_calls``.

Histograms use seeded reservoir sampling (Vitter's algorithm R), so a
fixed-seed run snapshots the same whatever its round count.
"""
from __future__ import annotations

import math
import random
import zlib
from typing import Any, Dict, List, Optional

CHANNELS = ('transport', 'bitchannel', 'allocation')


class Counter:
    """Monotonic accumulator."""

    def __init__(self) -> None:
        self.value = 0.0
        self.events = 0

    def inc(self, v: float = 1.0) -> None:
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return
        self.value += float(v)
        self.events += 1

    def snapshot(self) -> Dict[str, Any]:
        return {'kind': 'counter', 'value': self.value,
                'events': self.events}


class Gauge:
    """Last-value-wins point-in-time reading."""

    def __init__(self) -> None:
        self.value: Optional[float] = None
        self.updates = 0

    def set(self, v: float) -> None:
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return
        self.value = float(v)
        self.updates += 1

    def snapshot(self) -> Dict[str, Any]:
        return {'kind': 'gauge', 'value': self.value,
                'updates': self.updates}


class ReservoirHistogram:
    """Fixed-size uniform sample of an unbounded stream (algorithm R),
    seeded for deterministic snapshots; tracks exact count/min/max/mean
    alongside the sampled quantiles."""

    def __init__(self, size: int = 256, seed: int = 0) -> None:
        self.size = size
        self._rng = random.Random(seed)
        self.reservoir: List[float] = []
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        if v is None or (isinstance(v, float) and math.isnan(v)):
            return
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self.reservoir) < self.size:
            self.reservoir.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.size:
                self.reservoir[j] = v

    def quantile(self, frac: float) -> Optional[float]:
        if not self.reservoir:
            return None
        s = sorted(self.reservoir)
        return s[min(len(s) - 1, int(frac * len(s)))]

    def snapshot(self) -> Dict[str, Any]:
        return {'kind': 'histogram', 'count': self.count,
                'min': self.min, 'max': self.max,
                'mean': self.total / self.count if self.count else None,
                'p50': self.quantile(0.50), 'p90': self.quantile(0.90),
                'p99': self.quantile(0.99)}


class Channel:
    """A named family of metrics; metric constructors are idempotent."""

    def __init__(self, name: str, seed: int = 0) -> None:
        self.name = name
        self._seed = seed
        self._metrics: Dict[str, Any] = {}

    def counter(self, name: str) -> Counter:
        return self._metrics.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._metrics.setdefault(name, Gauge())

    def histogram(self, name: str, size: int = 256) -> ReservoirHistogram:
        # seed per (channel, metric) so reservoirs are independent but
        # reproducible across runs and processes (crc32, not hash())
        seed = (zlib.crc32(f'{self.name}/{name}'.encode())
                ^ self._seed) & 0x7FFFFFFF
        return self._metrics.setdefault(
            name, ReservoirHistogram(size, seed))

    def snapshot(self) -> Dict[str, Any]:
        return {k: m.snapshot() for k, m in sorted(self._metrics.items())}


class MetricsRegistry:
    """Channel registry + the standard routing of flushed round rows."""

    def __init__(self, seed: int = 0) -> None:
        self._seed = seed
        self._channels: Dict[str, Channel] = {}
        for name in CHANNELS:
            self.channel(name)

    def channel(self, name: str) -> Channel:
        if name not in self._channels:
            self._channels[name] = Channel(name, self._seed)
        return self._channels[name]

    # ------------------------------------------------------------------
    def observe_round(self, row: Dict[str, Any]) -> None:
        """Route one flushed JSONL-shaped round row (record.to_row) into
        the named channels."""
        tr = self.channel('transport')
        tr.counter('payload_bits').inc(row.get('payload_bits', 0.0))
        tr.counter('retransmissions').inc(row.get('retransmissions', 0.0))
        tr.gauge('sign_ok_frac').set(row.get('sign_ok_frac'))
        tr.gauge('mod_ok_frac').set(row.get('mod_ok_frac'))
        agree = row.get('sign_agreement')
        if agree is not None:
            tr.gauge('sign_vote_agreement').set(agree)
            tr.histogram('sign_vote_agreement_hist').observe(agree)
        for name in ('sign_flips', 'mod_flips'):
            v = row.get(name)
            if v is not None:
                tr.counter(name).inc(float(sum(v)))

        bc = self.channel('bitchannel')
        for side in ('sign', 'mod'):
            emp = row.get(f'{side}_erasure_emp')
            cal = row.get(f'{side}_erasure_cal')
            if emp is not None:
                bc.gauge(f'{side}_erasure_emp').set(emp)
                bc.histogram(f'{side}_erasure_emp_hist').observe(emp)
            if cal is not None:
                bc.gauge(f'{side}_erasure_cal').set(cal)

        al = self.channel('allocation')
        al.gauge('q_mean').set(row.get('q_mean'))
        al.gauge('p_mean').set(row.get('p_mean'))
        qm = row.get('q_mean')
        if qm is not None:
            al.histogram('q_mean_hist').observe(qm)
        pm = row.get('p_mean')
        if pm is not None:
            al.histogram('p_mean_hist').observe(pm)
        obj = row.get('alloc_objective')
        if obj is not None:
            al.histogram('objective_hist').observe(obj)
            al.gauge('objective').set(obj)
        # solver effort: iterations-to-converge histogram + exit-reason
        # counters make the accuracy-vs-wall-time map reconstructible
        # from the metrics snapshot alone (NaN = path didn't solve)
        iters = row.get('alloc_iters')
        if iters is not None and not math.isnan(iters):
            al.gauge('alloc_iters').set(iters)
            al.histogram('alloc_iters_hist').observe(iters)
        reason = row.get('alloc_exit_reason')
        if reason is not None and not math.isnan(reason):
            al.counter(f'alloc_exit_reason_{int(reason)}').inc(1.0)

    def observe_alloc(self, *, host_solver_calls: Optional[int] = None,
                      outer_residual: Optional[float] = None) -> None:
        """Allocation-engine events the rows don't carry: the host-solve
        counter (the zero-host-solve guarantee of the jax backend) and
        per-outer-iteration residuals when a solver reports them."""
        al = self.channel('allocation')
        if host_solver_calls is not None:
            c = al.gauge('host_solver_calls')
            c.set(float(host_solver_calls))
        if outer_residual is not None:
            al.histogram('outer_residual_hist').observe(outer_residual)

    def snapshot(self) -> Dict[str, Any]:
        return {name: ch.snapshot()
                for name, ch in sorted(self._channels.items())}
