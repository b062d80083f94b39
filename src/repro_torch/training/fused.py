"""Fused rounds (``FLConfig.round_fusion`` 'eager' and 'scan'): the
staging of a segment's inputs and the CUDA graphs that replay its rounds
(the port of the reference's ``_run_fused`` dispatch, whose rounds are
one jitted body or one ``lax.scan`` a segment).

A segment of m rounds runs with no host read or host copy inside it:

* :class:`Staging` holds every input a round takes that the host loop
  draws on the host (the bit channel's seed words, outcome and packet-fate
  uniforms, Rayleigh draws, straggler uniforms, fading rows, the
  seeded-random ḡ normals, the population cohort's columns, the round
  index) in one byte slot a round, laid out by :class:`SlotLayout`, and
  the (K, l) quantizer uniforms a round in a device buffer.  The
  dispatcher draws them at the segment boundary, from the same generators
  in the same order as the host loop, fills a pinned host buffer and
  moves it with ONE host-to-device copy a segment (:meth:`Staging.upload`).
* On the card a round body reads its slot's views and updates the
  simulator's carry (parameters, ḡ, straggler state) in place, so it can
  be captured: :func:`capture` records it into a ``torch.cuda.CUDAGraph``
  ('scan': the segment's m rounds into one graph; 'eager': one round,
  replayed once a round behind device copies of its slot), and the
  simulator keeps its graphs for its later runs.  On the CPU there is no
  graph: the same body runs eagerly on the same buffers.

``kernels.ops.launch_counts`` counts the launches the wrappers issue: a
captured launch counts once, where the capture issues it.  A replay runs
the graph's kernels without the wrappers, so what a replay ran is read
from the card's own record of it (``torch.profiler``; ``chip_smoke.py``
phase 10 does).
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, Optional, Tuple

import torch


Tensor = torch.Tensor

_ALIGN = 16        # byte alignment of each field of a slot


class SlotLayout:
    """Byte layout of one round's host-made inputs, shaped after
    ``example`` ({name: tensor}, one round's): each field at an offset
    aligned to 16 bytes, in name order."""

    def __init__(self, example: Dict[str, Tensor]):
        self.fields = []
        offset = 0
        for name in sorted(example):
            t = example[name]
            size = t.numel() * t.element_size()
            self.fields.append((name, t.dtype, tuple(t.shape), offset, size))
            offset += -(-size // _ALIGN) * _ALIGN
        self.nbytes = max(offset, _ALIGN)

    def views(self, row: Tensor) -> Dict[str, Tensor]:
        """{name: tensor} over one slot's bytes (a uint8 row)."""
        return {name: row[off:off + size].view(dtype).view(shape)
                for name, dtype, shape, off, size in self.fields}


class Staging:
    """The input slots of a segment of up to ``capacity`` rounds: a host
    buffer (pinned where the simulator runs on a card) and its device
    copy, ``layout.nbytes`` a slot, and the device's (capacity, K, l)
    quantizer uniforms (``rand_shape`` None: no uniforms)."""

    def __init__(self, layout: SlotLayout, capacity: int,
                 rand_shape: Optional[tuple], device: torch.device):
        self.layout = layout
        self.capacity = capacity
        self.device = device
        pin = device.type == 'cuda'
        self.host = torch.zeros((capacity, layout.nbytes), dtype=torch.uint8,
                                pin_memory=pin)
        self.dev = torch.zeros((capacity, layout.nbytes), dtype=torch.uint8,
                               device=device)
        self.rand = (None if rand_shape is None else torch.empty(
            (capacity,) + tuple(rand_shape), dtype=torch.float32,
            device=device))
        self.host_views = [layout.views(self.host[i]) for i in range(capacity)]
        self.dev_views = [layout.views(self.dev[i]) for i in range(capacity)]

    def put(self, i: int, values: Dict[str, Tensor]) -> None:
        """Write round i's host-made inputs (CPU tensors) into its host
        slot; every field of the layout must be given."""
        views = self.host_views[i]
        if set(values) != set(views):
            raise ValueError(f'slot fields {sorted(values)} != layout '
                             f'{sorted(views)}')
        for name, val in values.items():
            views[name].copy_(val.reshape(views[name].shape))

    def upload(self, m: int) -> None:
        """The segment's ONE host-to-device copy: slots 0..m-1 (from
        pinned memory on the card, so it does not wait for the card)."""
        self.dev[:m].copy_(self.host[:m], non_blocking=True)

    def slot(self, i: int) -> Tuple[Dict[str, Tensor], Optional[Tensor]]:
        """Round i's device views and its quantizer uniforms."""
        return self.dev_views[i], None if self.rand is None else self.rand[i]


def side_stream(device: torch.device):
    """A stream of its own for warm-up and capture (None on the CPU)."""
    return torch.cuda.Stream(device) if device.type == 'cuda' else None


@contextlib.contextmanager
def on_stream(stream):
    """Run the block on ``stream`` after the current stream's queued work,
    and have the current stream wait for it (nothing on the CPU)."""
    if stream is None:
        yield
        return
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        yield
    current.wait_stream(stream)


def capture(body: Callable[[], None], stream) -> torch.cuda.CUDAGraph:
    """Capture ``body`` (device work only: no host read, no host copy)
    into a CUDA graph on ``stream``.  A capture that fails raises; there
    is no uncaptured fallback.

    A graph destroyed while another is being captured ends that capture,
    and a simulator that is no longer referenced holds its graphs until
    the cyclic garbage collector frees it: so the collector runs before
    the capture and is off during it."""
    graph = torch.cuda.CUDAGraph()
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, stream=stream):
            body()
    finally:
        if enabled:
            gc.enable()
    return graph
