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

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (
    apply_rope_tables, dense_init, rope_tables,
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
                 rope=None):
    """positions: (T,) absolute positions shared across the batch;
    ``rope``: their (cos, sin) tables (``common.rope_tables``), made here
    when not given."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    q = x @ params['wq']
    k = x @ params['wk']
    v = x @ params['wv']
    if cfg.qkv_bias:
        q = q + params['bq']
        k = k + params['bk']
        v = v + params['bv']
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
                      rope=None) -> Tensor:
    """Full-sequence causal attention (the training trunk); ``rope`` as
    in ``_project_qkv``."""
    return attention_prefill(params, cfg, x, positions, window, rope)[0]


def attention_prefill(params, cfg: ModelConfig, x: Tensor,
                      positions: Tensor, window: int = 0, rope=None):
    """Like :func:`attention_forward`, but also returns the (k, v) to
    seed a cache."""
    q, k, v = _project_qkv(params, cfg, x, positions, rope)
    out = multi_head_attention(
        q, k, v, positions, positions, window=window, cap=cfg.attn_softcap,
        q_chunk=cfg.q_chunk)
    B, T = x.shape[:2]
    return out.reshape(B, T, -1) @ params['wo'], (k, v)


def attention_decode(params, cfg: ModelConfig, x: Tensor, cache_k: Tensor,
                     cache_v: Tensor, pos: Tensor, window: int = 0,
                     rope=None):
    """One-token decode.  x: (B, 1, D); cache_k, cache_v: (B, S, Kv, hd);
    ``pos``: the int32 device scalar of the new token's absolute position.

    The new K/V is written at slot ``pos % S`` (a ring buffer: for
    sliding-window caches S = window, so this is the window; for full
    caches S >= pos + 1 in the launchers), in the cache's dtype, and the
    step attends over the cache in the model's dtype.  A slot never
    written holds position 2^30, which fails the causal test.  Returns
    (y (B, 1, D) in x's dtype, new cache_k, new cache_v)."""
    B = x.shape[0]
    S = cache_k.shape[1]
    positions = pos.reshape(1)
    q, k, v = _project_qkv(params, cfg, x, positions, rope)
    slot = positions % S
    cache_k = cache_k.index_copy(1, slot.long(), k.to(cache_k.dtype))
    cache_v = cache_v.index_copy(1, slot.long(), v.to(cache_v.dtype))
    # the absolute position each slot holds (ring-aware)
    idx = torch.arange(S, dtype=torch.int32, device=x.device)
    wrapped = positions - torch.remainder(slot - idx, S)
    kv_pos = torch.where(wrapped >= 0, wrapped,
                         torch.full_like(wrapped, 2 ** 30))
    # the cache read back in the model's dtype: a float32 cache of a bf16
    # model holds the bf16 K/V exactly, and the step attends as the
    # full-sequence pass does
    out = multi_head_attention(
        q, cache_k.to(q.dtype), cache_v.to(q.dtype), positions, kv_pos,
        window=window, cap=cfg.attn_softcap, q_chunk=cfg.q_chunk)
    y = out.reshape(B, 1, -1) @ params['wo']
    return y, cache_k, cache_v
