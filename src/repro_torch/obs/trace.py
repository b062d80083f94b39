"""Lightweight stage spans for the SP-FL round pipeline (the port of
``repro.obs.trace``).

* **Host spans** (:class:`StageTrace`): wall-clock timing of the host
  view of each stage.  On the card a span brackets the *queueing* of its
  stage, not the device's execution (a round whose spans are all
  sub-millisecond is a round with no host synchronization in it).
  ``annotate=True`` also opens a ``torch.profiler.record_function``
  named ``obs/<name>`` per span, so the stages land as named ranges in a
  ``torch.profiler`` trace, where the device time of each can be read.
* **Stage scopes** (:func:`stage_scope`): ``record_function`` ranges
  that name a stage inside the transport or kernel code.

``STAGES`` is the canonical decomposition of a round: allocation solve ->
quantize/pack -> corrupt/fold -> decode-once aggregate -> psum -> update.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from torch.profiler import record_function

STAGES = ('alloc_solve', 'quantize_pack', 'corrupt_fold',
          'decode_aggregate', 'psum', 'update')


@contextmanager
def stage_scope(name: str):
    """Name a pipeline stage ``obs/<name>`` for ``torch.profiler``."""
    with record_function(f'obs/{name}'):
        yield


class StageTrace:
    """Accumulates host wall-clock spans per stage name.

    >>> tracer = StageTrace()
    >>> with tracer.span('alloc_solve'):
    ...     queue_the_solve()
    >>> tracer.summary()['alloc_solve']['count']
    1
    """

    def __init__(self, annotate: bool = False) -> None:
        # annotate=True opens a profiler range per span: useful only under
        # an active profiler, and a few µs each
        self.annotate = annotate
        self._spans: Dict[str, List[float]] = {}

    @contextmanager
    def span(self, name: str):
        ann = record_function(f'obs/{name}') if self.annotate else None
        if ann is not None:
            ann.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if ann is not None:
                ann.__exit__(None, None, None)
            self._spans.setdefault(name, []).append(dt)

    # ------------------------------------------------------------------
    def durations(self, name: str) -> List[float]:
        return list(self._spans.get(name, []))

    def summary(self) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for name, ds in self._spans.items():
            out[name] = {'count': len(ds), 'total_s': sum(ds),
                         'mean_s': sum(ds) / len(ds), 'last_s': ds[-1]}
        return out

    def reset(self) -> None:
        self._spans.clear()


_NULL_SPANS: Optional['StageTrace'] = None


def null_trace() -> StageTrace:
    """A shared trace for call sites that want ``span`` always available;
    it still records, at a perf_counter pair per stage."""
    global _NULL_SPANS
    if _NULL_SPANS is None:
        _NULL_SPANS = StageTrace()
    return _NULL_SPANS
