"""Grouped-query attention (GQA/MQA/MHA) with RoPE, sliding windows,
gemma2 soft-capping and optional QKV bias, for the training pass (the
port of the training path of ``repro.models.attention``): an exact
softmax over the causal (optionally windowed) mask, chunked over the
queries so the logits are O(q_chunk * S) a head.

The same attention serves training (full causal), prefill (causal, with
the K/V handed back to seed a cache) and single-token decode (one query
row against a ring-buffer cache).  The reference computes attention with
plain array ops, not in a Pallas kernel; so does the port.  Its
``decode_cache_layout='batch'`` pins decode activations to batch-only
sharding (``_constrain_batch_only``): a GSPMD hint that has no effect in
one process, so the port has no counterpart and both layouts run the
same code.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import parallel
from repro_torch.models.common import (
    apply_rope_tables, dense_init, dot, rope_tables,
)

Tensor = torch.Tensor
NEG_INF = -2.3819763e38  # max-negative bf16-representable


def init_attention(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, device=None) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    p = {
        'wq': dense_init(generator, d, h * hd, dtype, device),
        'wk': dense_init(generator, d, kv * hd, dtype, device),
        'wv': dense_init(generator, d, kv * hd, dtype, device),
        'wo': dense_init(generator, h * hd, d, dtype, device),
    }
    if cfg.qkv_bias:
        p['bq'] = torch.zeros((h * hd,), dtype=dtype, device=device)
        p['bk'] = torch.zeros((kv * hd,), dtype=dtype, device=device)
        p['bv'] = torch.zeros((kv * hd,), dtype=dtype, device=device)
    return p


def _project_qkv(params, cfg: ModelConfig, x: Tensor, positions: Tensor,
                 rope=None, proj=None):
    """positions: (T,) absolute positions shared across the batch;
    ``rope``: their (cos, sin) tables (``common.rope_tables``), made here
    when not given; ``proj(w)`` the product of x with a weight (a
    tensor-parallel rank's: ``parallel.column``'s)."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    proj = functools.partial(dot, x) if proj is None else proj
    # the heads the weights hold (a tensor-parallel rank's blocks: fewer)
    h, kv = params['wq'].shape[-1] // hd, params['wk'].shape[-1] // hd
    q = proj(params['wq'])
    k = proj(params['wk'])
    v = proj(params['wv'])
    if cfg.qkv_bias:
        # a tensor-parallel rank's 'kv' bias comes in float32 (its
        # gradient partials summed in float32): added in the product's
        # dtype, as the unsharded pass adds its own
        q = q + params['bq'].to(q.dtype)
        k = k + params['bk'].to(k.dtype)
        v = v + params['bv'].to(v.dtype)
    cos, sin = (rope_tables(positions, hd, cfg.rope_theta) if rope is None
                else rope)
    q = apply_rope_tables(q.reshape(B, T, h, hd), cos, sin)
    k = apply_rope_tables(k.reshape(B, T, kv, hd), cos, sin)
    return q, k, v.reshape(B, T, kv, hd)


def _attend(q: Tensor, k: Tensor, v: Tensor, q_pos: Tensor, kv_pos: Tensor,
            window: int, cap: float, scale: float) -> Tensor:
    """q: (B, Tq, H, hd) grouped against k, v: (B, S, Kv, hd).  The
    logits accumulate in float32 (the reference's
    ``preferred_element_type``: a product of two bf16 values is exact in
    float32, so float32 operands give the same sums); the probabilities
    go back to v's dtype for the second product."""
    B, Tq, H, hd = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, Tq, Kv, H // Kv, hd)
    logits = torch.einsum('btkgh,bskh->bkgts', qg.to(torch.float32),
                          k.to(torch.float32))
    logits = logits * scale
    if cap > 0.0:
        logits = cap * torch.tanh(logits / cap)
    valid = kv_pos[None, :] <= q_pos[:, None]              # causal
    if window > 0:
        valid = valid & ((q_pos[:, None] - kv_pos[None, :]) < window)
    logits = torch.where(valid, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bkgts,bskh->btkgh', probs.to(v.dtype), v)
    return out.reshape(B, Tq, H, hd)


def multi_head_attention(q, k, v, q_pos, kv_pos, *, window: int = 0,
                         cap: float = 0.0, q_chunk: int = 1024) -> Tensor:
    """Query-chunked exact attention; memory O(B * H * q_chunk * S).  The
    reference pads the last chunk with queries at position -1, whose rows
    it drops; the port takes the last chunk short."""
    Tq, hd = q.shape[1], q.shape[-1]
    scale = hd ** -0.5
    if Tq <= q_chunk:
        return _attend(q, k, v, q_pos, kv_pos, window, cap, scale)
    outs = [_attend(q[:, s:s + q_chunk], k, v, q_pos[s:s + q_chunk], kv_pos,
                    window, cap, scale) for s in range(0, Tq, q_chunk)]
    return torch.cat(outs, dim=1)


def attention_forward(params, cfg: ModelConfig, x: Tensor,
                      positions: Tensor, window: int = 0,
                      rope=None, tp=None) -> Tensor:
    """Full-sequence causal attention (the training trunk); ``rope`` as
    in ``_project_qkv``.  With ``tp`` (``models.parallel``) whose
    attention is split, ``params`` are the rank's heads: their output
    (a row block of ``wo``) is summed over the model ranks."""
    return attention_prefill(params, cfg, x, positions, window, rope,
                             tp)[0]


def attention_prefill(params, cfg: ModelConfig, x: Tensor,
                      positions: Tensor, window: int = 0, rope=None,
                      tp=None):
    """Like :func:`attention_forward`, but also returns the (k, v) to
    seed a cache (the rank's heads under ``tp``)."""
    split = tp is not None and tp.attn is not None
    q, k, v = _project_qkv(params, cfg, x, positions, rope,
                           parallel.column(x, tp) if split else None)
    out = multi_head_attention(
        q, k, v, positions, positions, window=window, cap=cfg.attn_softcap,
        q_chunk=cfg.q_chunk)
    B, T = x.shape[:2]
    out = out.reshape(B, T, -1)
    y = (parallel.row(out, params['wo'], tp) if split
         else dot(out, params['wo']))
    return y, (k, v)


def heads_of_all(t: Tensor, tp, kv: bool, cfg: ModelConfig) -> Tensor:
    """A rank's heads of (B, T, h, hd) ``t`` -> every head, gathered over
    the model ranks; under 'q' a rank's k/v (``kv``) is its one kv head,
    taken from the first rank that holds each."""
    parts = tp.mesh.all_gather(t.movedim(2, 0).contiguous())
    per = parts.shape[0] // tp.size
    parts = parts.reshape((tp.size, per) + tuple(parts.shape[1:]))
    if kv and tp.attn == 'q':
        per_rank = cfg.n_heads // tp.size
        group = cfg.n_heads // cfg.n_kv_heads
        first = [j * group // per_rank for j in range(cfg.n_kv_heads)]
        parts = parts[first]
    return parts.flatten(0, 1).movedim(0, 2)


def _attend_split_sequence(q, cache_k, cache_v, positions, kv_pos, window,
                           cap, seq):
    """One query row against the rank's positions of a sequence-split
    cache: the partial row maximum, sum of exponentials and weighted V
    of its positions, combined over the ranks that share the sequence
    (``seq``, a ``core.mesh.ClientMesh``: one MAX and one SUM), as the
    whole-cache softmax."""
    B, Tq, H, hd = q.shape
    Kv = cache_k.shape[2]
    qg = q.reshape(B, Tq, Kv, H // Kv, hd)
    logits = torch.einsum('btkgh,bskh->bkgts', qg.to(torch.float32),
                          cache_k.to(torch.float32)) * hd ** -0.5
    if cap > 0.0:
        logits = cap * torch.tanh(logits / cap)
    valid = kv_pos[None, :] <= positions[:, None]
    if window > 0:
        valid = valid & ((positions[:, None] - kv_pos[None, :]) < window)
    logits = torch.where(valid, logits, NEG_INF)
    top = seq.all_reduce(torch.amax(logits, dim=-1, keepdim=True),
                         torch.distributed.ReduceOp.MAX)
    e = torch.exp(logits - top)
    part = torch.cat([torch.einsum('bkgts,bskh->btkgh', e,
                                   cache_v.to(torch.float32)),
                      torch.sum(e, dim=-1).movedim(-1, 1)[..., None]],
                     dim=-1)
    part = seq.all_reduce(part)
    out = part[..., :hd] / part[..., hd:]
    return out.to(q.dtype).reshape(B, Tq, H, hd)


def attention_decode(params, cfg: ModelConfig, x: Tensor, cache_k: Tensor,
                     cache_v: Tensor, pos: Tensor, window: int = 0,
                     rope=None, tp=None, seq=None):
    """One-token decode.  x: (B, 1, D); cache_k, cache_v: (B, S, Kv, hd);
    ``pos``: the int32 device scalar of the new token's absolute position.

    The new K/V is written at slot ``pos % S`` (a ring buffer: for
    sliding-window caches S = window, so this is the window; for full
    caches S >= pos + 1 in the launchers), in the cache's dtype, and the
    step attends over the cache in the model's dtype.  A slot never
    written holds position 2^30, which fails the causal test.  Returns
    (y (B, 1, D) in x's dtype, new cache_k, new cache_v).

    With ``tp`` whose attention is split, ``params`` are the rank's heads
    (q/k/v column products, ``wo`` a row product) and the cache holds
    the rank's kv heads (under 'q' the one it uses).  With ``seq`` (a
    ``core.mesh.ClientMesh``), the cache is the rank's block of
    ``seq.size`` equal blocks of the ring's slots (block ``seq.rank``):
    the rank that holds slot ``pos % S`` writes the new K/V, and each
    rank attends with every head over its own slots, the partials
    combined over ``seq`` (the q/k/v of a split attention gathered over
    the model ranks first; one token: small)."""
    B = x.shape[0]
    split = tp is not None and tp.attn is not None
    positions = pos.reshape(1)
    q, k, v = _project_qkv(params, cfg, x, positions, rope,
                           parallel.column(x, tp) if split else None)
    n_local = cache_k.shape[1]
    S = n_local * (seq.size if seq is not None else 1)
    start = seq.rank * n_local if seq is not None else 0
    slot = positions % S
    idx = torch.arange(start, start + n_local, dtype=torch.int32,
                       device=x.device)
    if seq is None:
        cache_k = cache_k.index_copy(1, slot.long(), k.to(cache_k.dtype))
        cache_v = cache_v.index_copy(1, slot.long(), v.to(cache_v.dtype))
    else:
        if split:
            k, v = (heads_of_all(t, tp, True, cfg) for t in (k, v))
        mine = (slot >= start) & (slot < start + n_local)
        at = torch.clamp(slot - start, 0, n_local - 1).long()

        def put(c, new):
            new = torch.where(mine, new.to(c.dtype), c.index_select(1, at))
            return c.index_copy(1, at, new)

        cache_k, cache_v = put(cache_k, k), put(cache_v, v)
    # the absolute position each slot holds (ring-aware)
    wrapped = positions - torch.remainder(slot - idx, S)
    kv_pos = torch.where(wrapped >= 0, wrapped,
                         torch.full_like(wrapped, 2 ** 30))
    if seq is None:
        # the cache read back in the model's dtype: a float32 cache of a
        # bf16 model holds the bf16 K/V exactly, and the step attends as
        # the full-sequence pass does
        out = multi_head_attention(
            q, cache_k.to(q.dtype), cache_v.to(q.dtype), positions, kv_pos,
            window=window, cap=cfg.attn_softcap, q_chunk=cfg.q_chunk)
    else:
        q_all = heads_of_all(q, tp, False, cfg) if split else q
        out = _attend_split_sequence(
            q_all, cache_k.to(q.dtype), cache_v.to(q.dtype), positions,
            kv_pos, window, cfg.attn_softcap, seq)
        if split:
            h = q.shape[2]
            out = out[:, :, tp.rank * h:(tp.rank + 1) * h]
    out = out.reshape(B, 1, -1)
    y = (parallel.row(out, params['wo'], tp) if split
         else dot(out, params['wo']))
    return y, cache_k, cache_v
