"""Top-k mixture-of-experts with sort-based capacity dispatch (the port
of ``repro.models.moe``).

Routing runs in float32: router logits, softmax, the top k experts of
each token (ties to the lower expert index, as ``jax.lax.top_k``: a
stable descending sort, since ``torch.topk`` promises no order among
equal values) and their renormalised gates.  The (token, expert)
assignments are stably sorted by expert id; an assignment's position
within its expert is its index less its expert's segment start (the
count of smaller ids: ``jnp.searchsorted``'s left side).  Assignments at
position >= C, the expert capacity, are dropped.  The experts' SwiGLU
runs batched over E (``einsum``).

Dispatch and combine are gathers, with no scatter and no host read, so
the block runs under ``torch.func.vmap`` over the clients, under
``torch.use_deterministic_algorithms`` and inside a CUDA graph: slot
(e, c) reads token ``st[start_e + c]`` where ``c < count_e``, else a zero
row; each token then sums its own k outputs.  The reference adds them
into zeros by a scatter over tokens; for the zoo's ``topk <= 2`` the two
sums are the same float sum (0 + a + b), so the combine equals the
reference's bit for bit on equal expert outputs.

The reference's ``maybe_constrain`` lines (its GSPMD expert-parallel
all-to-all hints) have no single-process counterpart and are not
ported; they change no number.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init
from repro_torch.models.mlp import init_mlp, mlp_forward

Tensor = torch.Tensor


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, device=None) -> dict:
    """The reference's shapes and scales: a float32 (d, E) router, bf16
    (or ``dtype``) expert weights (E, d, f), (E, d, f), (E, f, d), and
    arctic's dense residual MLP."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    scale = 1.0 / np.sqrt(d)
    fscale = 1.0 / np.sqrt(f)

    def normal(shape, s):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * float(s)
        return w.to(dtype)

    p = {
        'router': dense_init(generator, d, E, torch.float32, device),
        'w_gate': normal((E, d, f), scale),
        'w_up': normal((E, d, f), scale),
        'w_down': normal((E, f, d), fscale),
    }
    if cfg.dense_residual:
        p['dense'] = init_mlp(generator, d, f, dtype, device)
    return p


def expert_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(cfg.capacity_factor * n_tokens * cfg.topk / cfg.n_experts)
    return max(8, ((c + 7) // 8) * 8)   # lane-aligned


def grouped_capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """The grouped path's capacity of a row of ``n_tokens`` tokens, in
    the reference's own arithmetic (``cf * (T k) / E``)."""
    n = n_tokens * cfg.topk
    return max(8, ((math.ceil(cfg.capacity_factor * n / cfg.n_experts) + 7)
                   // 8) * 8)


def top_k(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values by ascending index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params, cfg: ModelConfig, x: Tensor):
    """x: (..., D) -> float32 (probs (..., E), gates (..., k) renormalised,
    experts (..., k) int64)."""
    logits = torch.matmul(x.to(torch.float32), params['router'])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, cfg.topk)
    top_p = top_p / torch.clamp(torch.sum(top_p, -1, keepdim=True),
                                min=1e-9)
    return probs, top_p, top_e


def dispatch_plan(top_e: Tensor, n_experts: int, capacity: int) -> dict:
    """The sort-based plan of each row of (R, N, k) assignments: ``order``
    (the stable argsort of the flat expert ids), ``se`` and ``st`` (the
    sorted experts and their tokens), ``pos`` (the position within the
    expert), ``kept`` (pos < C), ``slot`` (e C + pos, or E C where
    dropped) and ``slot_tok`` (R, E C): each slot's token, N where empty."""
    R, N, k = top_e.shape
    n = N * k
    dev = top_e.device
    flat_e = top_e.reshape(R, n)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    st = torch.div(order, k, rounding_mode='floor')     # flat index // k
    experts = torch.arange(n_experts, device=dev)
    # segment starts: the count of smaller ids (searchsorted, left side)
    starts = torch.sum(se[:, None, :] < experts[None, :, None], dim=-1)
    ends = torch.sum(se[:, None, :] <= experts[None, :, None], dim=-1)
    pos = torch.arange(n, device=dev)[None] - torch.gather(starts, 1, se)
    kept = pos < capacity
    slot = torch.where(kept, se * capacity + pos, n_experts * capacity)
    idx = starts[:, :, None] + torch.arange(capacity, device=dev)[None, None]
    filled = idx < ends[:, :, None]
    tok = torch.gather(st, 1, torch.clamp(idx, max=n - 1).reshape(R, -1))
    slot_tok = torch.where(filled.reshape(R, -1), tok, N)
    return dict(order=order, se=se, st=st, pos=pos, kept=kept, slot=slot,
                slot_tok=slot_tok)


def _rows_gather(x: Tensor, idx: Tensor) -> Tensor:
    """x: (R, M, D), idx: (R, L) -> (R, L, D)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _dispatch(params, cfg: ModelConfig, x: Tensor, capacity: int
              ) -> Tuple[Tensor, dict]:
    """x: (R, N, D), each row dispatched on its own with ``capacity``
    slots an expert -> (y (R, N, D), aux)."""
    R, N, D = x.shape
    E, k = cfg.n_experts, cfg.topk
    probs, top_p, top_e = route(params, cfg, x)
    first = (top_e[..., :1] == torch.arange(E, device=x.device)).to(
        torch.float32)
    frac_tokens = torch.mean(first, dim=(0, 1))
    lb_loss = E * torch.sum(frac_tokens * torch.mean(probs, dim=(0, 1)))

    plan = dispatch_plan(top_e, E, capacity)
    x_pad = torch.cat([x, x.new_zeros((R, 1, D))], dim=1)
    buf = _rows_gather(x_pad, plan['slot_tok']).reshape(R, E, capacity, D)
    h = F.silu(torch.einsum('recd,edf->recf', buf, params['w_gate']))
    h = h * torch.einsum('recd,edf->recf', buf, params['w_up'])
    out = torch.einsum('recf,efd->recd', h, params['w_down'])
    out_pad = torch.cat([out.reshape(R, E * capacity, D),
                         out.new_zeros((R, 1, D))], dim=1)
    y_sorted = _rows_gather(out_pad, plan['slot'])          # (R, N k, D)
    kept = plan['kept'].to(torch.float32)
    drop_frac = 1.0 - torch.mean(kept)
    sg = torch.gather(top_p.reshape(R, N * k), 1, plan['order'])
    contrib = y_sorted * (sg * kept).to(x.dtype)[..., None]
    # back to flat (token, j) order: the inverse of the sort
    inv = torch.argsort(plan['order'], dim=-1)
    per_tok = _rows_gather(contrib, inv).reshape(R, N, k, D)
    y = per_tok[:, :, 0]
    for j in range(1, k):
        y = y + per_tok[:, :, j]
    return y, {'lb_loss': lb_loss, 'drop_frac': drop_frac}


def moe_forward_grouped(params, cfg: ModelConfig, x: Tensor
                        ) -> Tuple[Tensor, dict]:
    """Per-batch-row dispatch: capacity per row of T tokens."""
    y, aux = _dispatch(params, cfg, x, grouped_capacity(x.shape[1], cfg))
    if cfg.dense_residual:
        y = y + mlp_forward(params['dense'], x)
    return y, aux


def moe_forward(params, cfg: ModelConfig, x: Tensor) -> Tuple[Tensor, dict]:
    """x: (B, T, D) -> (y, aux) with aux = {'lb_loss', 'drop_frac'}: the
    flat dispatch over all B T tokens, or with ``moe_dispatch='grouped'``
    and T > 1 one dispatch a row."""
    if cfg.moe_dispatch == 'grouped' and x.shape[1] > 1:
        return moe_forward_grouped(params, cfg, x)
    B, T, D = x.shape
    y, aux = _dispatch(params, cfg, x.reshape(1, B * T, D),
                       expert_capacity(B * T, cfg))
    y = y.reshape(B, T, D)
    if cfg.dense_residual:
        y = y + mlp_forward(params['dense'], x)
    return y, aux
