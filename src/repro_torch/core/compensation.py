"""Compensatory modulus vectors ḡ — paper §II-C2, eq. (15) and Fig. 5
(the port of ``repro.core.compensation``).

When a modulus packet is lost but the sign packet arrives, the PS rebuilds
the update as s(g_k) ⊙ ḡ.  Strategies:

* ``last_global``   — modulus of the previous round's aggregated gradient
                      (the paper's default, §V).
* ``last_local``    — per-client modulus of that client's previous local
                      gradient (paper Fig. 5).
* ``seeded_random`` — generated from a seed shared by PS and devices.
* ``zeros``         — degenerate baseline: lost modulus => dropped update.

Randomness is explicit: ``current_gbar('seeded_random', ...)`` takes its
standard normals as a tensor, or a ``torch.Generator`` to draw them from.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor

KINDS = ('last_global', 'last_local', 'zeros', 'seeded_random')
SEEDED_RANDOM_SCALE = 0.01

_KIND_IDS = {k: i for i, k in enumerate(KINDS)}


class CompensationState(NamedTuple):
    kind_id: int
    gbar: Tensor          # (l,) or per-client (K, l)
    round_idx: int        # rounds rolled so far (drives seeded_random)


def init_state(kind: str, template: Tensor, n_clients: int
               ) -> CompensationState:
    """``template``: a zeros-like of the flat gradient (l,)."""
    if kind not in _KIND_IDS:
        raise ValueError(f'unknown compensation kind {kind!r}')
    if kind == 'last_local':
        gbar = torch.zeros((n_clients,) + tuple(template.shape),
                           dtype=template.dtype, device=template.device)
    else:
        gbar = torch.zeros_like(template)
    return CompensationState(_KIND_IDS[kind], gbar, 0)


def per_client(kind: str) -> bool:
    return kind == 'last_local'


def current_gbar(kind: str, state: CompensationState,
                 normals: Optional[Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Tensor:
    """The modulus vector(s) to use this round (always >= 0).  For
    ``seeded_random``: |normals| * 0.01, with ``normals`` shaped like the
    state's ḡ or drawn from ``generator``."""
    if kind != 'seeded_random':
        return state.gbar
    if normals is None:
        if generator is None:
            raise ValueError("seeded_random needs its normals or a "
                             'generator')
        normals = torch.randn(state.gbar.shape, generator=generator,
                              dtype=torch.float32,
                              device=generator.device)
    normals = normals.to(device=state.gbar.device, dtype=torch.float32)
    return torch.abs(normals) * SEEDED_RANDOM_SCALE


def update_state(kind: str, state: CompensationState, aggregated: Tensor,
                 per_client_grads: Optional[Tensor] = None
                 ) -> CompensationState:
    """Roll the state after a round.  ``aggregated``: the round's
    aggregate (l,); ``per_client_grads``: (K, l), for ``last_local``."""
    if kind == 'last_global':
        gbar = torch.abs(aggregated.to(torch.float32))
    elif kind == 'last_local':
        if per_client_grads is None:
            raise ValueError('last_local needs the per-client gradients')
        gbar = torch.abs(per_client_grads.to(torch.float32))
    else:
        gbar = state.gbar
    return CompensationState(state.kind_id, gbar, state.round_idx + 1)
