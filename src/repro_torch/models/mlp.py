"""Gated MLP (llama/gemma-style): the dense FFN of every non-MoE block
(the port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.models import parallel
from repro_torch.models.common import dense_init, dot


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, device=None) -> dict:
    return {
        'w_gate': dense_init(generator, d_model, d_ff, dtype, device),
        'w_up': dense_init(generator, d_model, d_ff, dtype, device),
        'w_down': dense_init(generator, d_ff, d_model, dtype, device),
    }


def mlp_forward(params, x, tp=None):
    """With ``tp`` (``models.parallel``) whose MLP is split, ``params``
    are the rank's column blocks of ``w_gate``/``w_up`` and row block of
    ``w_down``: the partial output is summed over the model ranks."""
    if tp is None or not tp.mlp:
        h = F.silu(dot(x, params['w_gate'])) * dot(x, params['w_up'])
        return dot(h, params['w_down'])
    col = parallel.column(x, tp)
    h = F.silu(col(params['w_gate'])) * col(params['w_up'])
    return parallel.row(h, params['w_down'], tp)
