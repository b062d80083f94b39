"""Gated MLP (llama/gemma-style): the dense FFN of every non-MoE block
(the port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from repro_torch.models.common import dense_init


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype, device=None) -> dict:
    return {
        'w_gate': dense_init(generator, d_model, d_ff, dtype, device),
        'w_up': dense_init(generator, d_model, d_ff, dtype, device),
        'w_down': dense_init(generator, d_ff, d_model, dtype, device),
    }


def mlp_forward(params, x):
    h = F.silu(x @ params['w_gate']) * (x @ params['w_up'])
    return h @ params['w_down']
