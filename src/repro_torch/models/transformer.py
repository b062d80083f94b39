"""Decoder-only model assembly for every architecture of the zoo (the
port of ``repro.models.transformer``).

Parameters form a tree of tensors (nested dicts) with the reference's
names and grouped layout: ``embed``, ``final_norm``, ``lm_head`` where
the head is untied, ``frontend_proj`` where a frontend has a projector,
``shared`` (Zamba2's shared attention block, outside the groups: its
gradient is the sum over its uses) and ``groups.b{i}``, each group leaf
with a leading ``n_groups`` axis — one period of ``cfg.layer_pattern`` a
group.  An attention block is ``{ln, ln2, attn.{wq, wk, wv, wo}}`` with
``mlp.{w_gate, w_up, w_down}`` or ``moe.{router, w_gate, w_up, w_down}``
(+ ``moe.dense`` for arctic; ``pln``/``pln2`` with ``post_norm``), a
Mamba2 block ``{ln, mamba.{...}}``.  The router, ``A_log``, ``D`` and
``dt_bias`` are float32 leaves in a bf16 model.  :func:`repro_torch.tree.
leaves` lists them in ``jax.tree.flatten``'s order (keys sorted), the
order the LLM-scale transports bind their draws to; :class:`Transformer`
registers the same tree as an ``nn.Module``'s parameters.

The forward pass loops over the groups (the reference scans them under
``jax.checkpoint``; recomputation changes no number, and the port keeps
the activations) and makes the rotary tables once for all its layers.
The blocks' MoE load-balance losses add up into the aux loss, which
``loss_fn`` weighs by ``AUX_LOSS_WEIGHT``.  A vision prefix (precomputed
patch embeddings: the SigLIP encoder is a stub, as in the reference) is
projected by ``frontend_proj`` and prepended; the loss covers the text
positions only.  The audio frontend of musicgen has neither projector
nor prefix: its tokens are the EnCodec codes.

Serving: :func:`prefill` runs the prompt and builds a decode-ready cache
(:func:`init_cache`'s layout: per ``b{i}`` a leading ``n_groups`` axis
and ``{'k', 'v'}`` or ``{'conv', 'ssm'}``; a sliding-window layer keeps a
ring of ``sliding_window`` slots); :func:`decode_step` takes one token.
The cache may be of another dtype than the parameters (the serving
engine's float32): the new K/V and Mamba state go into it in its dtype
and each block hands back its output in the hidden state's dtype.  The
reference raises on that mix (a dtype mismatch in its cache update and
scan carry) and so serves only float32 models; on those the two are the
same computation.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (
    chunked_softmax_xent, dense_init, dtype_of, embed_init, rms_norm,
    rope_tables, softcap,
)
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.models.moe import init_moe, moe_forward
from repro_torch.models.ssm import (
    init_mamba, init_mamba_cache, mamba_decode, mamba_forward,
)

Tensor = torch.Tensor
AUX_LOSS_WEIGHT = 0.01   # switch-style load-balance loss weight


def n_groups(cfg: ModelConfig) -> int:
    pat = len(cfg.layer_pattern)
    if cfg.n_layers % pat:
        raise ValueError(f'{cfg.name}: {cfg.n_layers} layers do not tile '
                         f'the pattern {cfg.layer_pattern}')
    return cfg.n_layers // pat


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_attn_block(generator, cfg: ModelConfig, dtype, device) -> dict:
    d = cfg.d_model
    p = {
        'ln': torch.zeros((d,), dtype=dtype, device=device),
        'attn': attn_mod.init_attention(generator, cfg, dtype, device),
        'ln2': torch.zeros((d,), dtype=dtype, device=device),
    }
    if cfg.is_moe:
        p['moe'] = init_moe(generator, cfg, dtype, device)
    else:
        p['mlp'] = init_mlp(generator, d, cfg.d_ff, dtype, device)
    if cfg.post_norm:
        p['pln'] = torch.zeros((d,), dtype=dtype, device=device)
        p['pln2'] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _init_mamba_block(generator, cfg: ModelConfig, dtype, device) -> dict:
    return {
        'ln': torch.zeros((cfg.d_model,), dtype=dtype, device=device),
        'mamba': init_mamba(generator, cfg, dtype, device),
    }


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights (the reference's initializers and shapes) drawn
    from ``generator`` on ``device``: normal embeddings and dense
    weights, zero norm scales and biases, the Mamba2 block's own.  The
    draws are not the reference's; :func:`params_from_reference` carries
    those across."""
    dtype = dtype_of(cfg.param_dtype)
    params = {
        'embed': embed_init(generator, cfg.vocab_size, cfg.d_model, dtype,
                            device),
        'final_norm': torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=device),
    }
    if not cfg.tie_embeddings:
        params['lm_head'] = dense_init(generator, cfg.d_model,
                                       cfg.vocab_size, dtype, device)
    if cfg.frontend != 'none' and cfg.frontend_embed_dim:
        params['frontend_proj'] = dense_init(
            generator, cfg.frontend_embed_dim, cfg.d_model, dtype, device)
    if 'shared_attn' in cfg.layer_pattern:
        params['shared'] = _init_attn_block(generator, cfg, dtype, device)

    def init_group():
        entries = {}
        for i, kind in enumerate(cfg.layer_pattern):
            if kind == 'mamba':
                entries[f'b{i}'] = _init_mamba_block(generator, cfg, dtype,
                                                     device)
            elif kind != 'shared_attn':
                entries[f'b{i}'] = _init_attn_block(generator, cfg, dtype,
                                                    device)
        return entries

    groups = [init_group() for _ in range(n_groups(cfg))]
    params['groups'] = tree.map(lambda *ls: torch.stack(ls), *groups)
    return params


def params_from_reference(ref_params, device=None) -> dict:
    """The reference's parameter tree (arrays of any kind NumPy reads,
    bfloat16 included) as a tree of tensors of the same dtypes, names
    and shapes on ``device``."""
    def leaf(a):
        name = str(np.asarray(a).dtype)
        dtype = dtype_of(name)
        t = torch.as_tensor(np.array(a, np.float32))
        return t.to(dtype=dtype, device=device)

    if isinstance(ref_params, dict):
        return {k: params_from_reference(v, device)
                for k, v in ref_params.items()}
    return leaf(ref_params)


# ---------------------------------------------------------------------------
# block application (full sequence)
# ---------------------------------------------------------------------------

def _ffn(p, cfg: ModelConfig, h: Tensor) -> Tuple[Tensor, Optional[Tensor]]:
    """The block's feed-forward half: the MoE (-> its lb_loss) or the
    dense MLP (-> None)."""
    if cfg.is_moe:
        f, aux = moe_forward(p['moe'], cfg, h)
        return f, aux['lb_loss']
    return mlp_forward(p['mlp'], h), None


def _attn_block(p, cfg: ModelConfig, x: Tensor, attend):
    """Pre-norm attention (``attend(h) -> (a, extra)``) then the FFN,
    with gemma2's post-norms -> (x, lb_loss or None, extra)."""
    a, extra = attend(rms_norm(x, p['ln'], cfg.norm_eps))
    if cfg.post_norm:
        a = rms_norm(a, p['pln'], cfg.norm_eps)
    x = x + a
    f, lb = _ffn(p, cfg, rms_norm(x, p['ln2'], cfg.norm_eps))
    if cfg.post_norm:
        f = rms_norm(f, p['pln2'], cfg.norm_eps)
    return x + f, lb, extra


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == 'swa' else 0


def _block_params(kind: str, bparams, shared):
    return shared if kind == 'shared_attn' else bparams


def embed_tokens(params, cfg: ModelConfig, tokens: Tensor,
                 prefix_embeds: Optional[Tensor] = None) -> Tensor:
    x = F.embedding(tokens.to(torch.int64), params['embed'])
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if prefix_embeds is not None:
        prefix = prefix_embeds.to(x.dtype)
        if 'frontend_proj' in params:
            prefix = prefix @ params['frontend_proj']
        x = torch.cat([prefix, x], dim=1)
    return x


def group_params(params, cfg: ModelConfig) -> list:
    """The groups' parameter trees, one a group: each leaf unbound once
    along its group axis (its gradient then stacks once)."""
    gtree = params['groups']
    unbound = [leaf.unbind(0) for leaf in tree.leaves(gtree)]
    return [tree.unflatten(gtree, [u[g] for u in unbound])
            for g in range(n_groups(cfg))]


def forward(params, cfg: ModelConfig, tokens: Tensor,
            prefix_embeds: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """tokens: (B, T) [+ prefix (B, P, E)] -> (final hidden states (B,
    P + T, D), the summed MoE load-balance loss, float32)."""
    x = embed_tokens(params, cfg, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rope = (rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if not cfg.attention_free else None)
    shared = params.get('shared')
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gparams in group_params(params, cfg):
        for i, kind in enumerate(cfg.layer_pattern):
            bp = gparams.get(f'b{i}')
            if kind == 'mamba':
                x = x + mamba_forward(bp['mamba'], cfg,
                                      rms_norm(x, bp['ln'], cfg.norm_eps))
                continue
            p = _block_params(kind, bp, shared)

            def attend(h, p=p, kind=kind):
                return attn_mod.attention_forward(
                    p['attn'], cfg, h, positions, _window(cfg, kind),
                    rope), None

            x, lb, _ = _attn_block(p, cfg, x, attend)
            if lb is not None:
                aux = aux + lb
    return rms_norm(x, params['final_norm'], cfg.norm_eps), aux


def lm_head_t(params, cfg: ModelConfig) -> Tensor:
    """(D, V) output projection (tied -> embed^T)."""
    if cfg.tie_embeddings:
        return params['embed'].t()
    return params['lm_head']


def logits_fn(params, cfg: ModelConfig, hidden: Tensor) -> Tensor:
    return softcap(hidden @ lm_head_t(params, cfg), cfg.logit_softcap)


def loss_fn(params, cfg: ModelConfig, tokens: Tensor,
            prefix_embeds: Optional[Tensor] = None) -> Tensor:
    """Next-token cross-entropy of (B, T) tokens over the text positions
    (after a prefix), plus ``AUX_LOSS_WEIGHT`` x the MoE aux loss (a
    float32 scalar)."""
    hidden, aux = forward(params, cfg, tokens, prefix_embeds)
    P = hidden.shape[1] - tokens.shape[1]      # prefix length
    # hidden at text position i predicts token i + 1
    h = hidden[:, P:-1] if tokens.shape[1] > 1 else hidden[:, P:]
    labels = tokens[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    xent = chunked_softmax_xent(h, lm_head_t(params, cfg), labels, mask,
                                cfg.logit_softcap)
    return xent + AUX_LOSS_WEIGHT * aux


# ---------------------------------------------------------------------------
# KV / SSM caches
# ---------------------------------------------------------------------------

def entry_cache_len(cfg: ModelConfig, kind: str, cache_len: int) -> int:
    if kind == 'swa' and cfg.sliding_window:
        return min(cache_len, cfg.sliding_window)
    return cache_len


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Zero caches: per ``b{i}`` of the pattern (Zamba2's shared block
    too: one cache an occurrence) a leading ``n_groups`` axis over
    ``{'k', 'v'}`` (B, S, Kv, hd) or ``{'conv', 'ssm'}``."""
    ng = n_groups(cfg)
    hd, kv = cfg.resolved_head_dim, cfg.n_kv_heads
    cache = {}
    for i, kind in enumerate(cfg.layer_pattern):
        if kind == 'mamba':
            c = init_mamba_cache(cfg, batch, dtype, device)
        else:
            S = entry_cache_len(cfg, kind, cache_len)
            c = {'k': torch.zeros((batch, S, kv, hd), dtype=dtype,
                                  device=device),
                 'v': torch.zeros((batch, S, kv, hd), dtype=dtype,
                                  device=device)}
        cache[f'b{i}'] = tree.map(
            lambda a: a[None].expand((ng,) + a.shape).clone(), c)
    return cache


def _group_caches(cache, ng: int) -> list:
    unbound = [leaf.unbind(0) for leaf in tree.leaves(cache)]
    return [tree.unflatten(cache, [u[g] for u in unbound]) for g in range(ng)]


def _stack_caches(caches: list):
    return tree.map(lambda *xs: torch.stack(xs), *caches)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(params, cfg: ModelConfig, cache: dict, token: Tensor,
                pos) -> Tuple[Tensor, dict]:
    """token: (B, 1) int; ``pos`` (an int or an int32 device scalar): the
    absolute position of the new token.  Returns (logits (B, 1, V), new
    cache)."""
    x = embed_tokens(params, cfg, token)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    rope = (rope_tables(pos[None], cfg.resolved_head_dim, cfg.rope_theta)
            if not cfg.attention_free else None)
    shared = params.get('shared')
    new = []
    for gparams, gcache in zip(group_params(params, cfg),
                               _group_caches(cache, n_groups(cfg))):
        new_g = {}
        for i, kind in enumerate(cfg.layer_pattern):
            bp, bc = gparams.get(f'b{i}'), gcache[f'b{i}']
            if kind == 'mamba':
                h = rms_norm(x, bp['ln'], cfg.norm_eps)
                y, new_g[f'b{i}'] = mamba_decode(bp['mamba'], cfg, h, bc)
                x = x + y
                continue
            p = _block_params(kind, bp, shared)

            def attend(h, p=p, kind=kind, bc=bc):
                y, ck, cv = attn_mod.attention_decode(
                    p['attn'], cfg, h, bc['k'], bc['v'], pos,
                    _window(cfg, kind), rope)
                return y, {'k': ck, 'v': cv}

            x, _, new_g[f'b{i}'] = _attn_block(p, cfg, x, attend)
        new.append(new_g)
    x = rms_norm(x, params['final_norm'], cfg.norm_eps)
    return logits_fn(params, cfg, x), _stack_caches(new)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def _ring_scatter(full_kv: Tensor, S: int) -> Tensor:
    """Place the last S positions of a (B, T, Kv, hd) tensor into their
    ring-buffer slots (pos % S) of a length-S cache."""
    B, T = full_kv.shape[:2]
    take = min(T, S)
    last = full_kv[:, T - take:]
    slots = torch.arange(T - take, T, device=full_kv.device) % S
    out = full_kv.new_zeros((B, S) + tuple(full_kv.shape[2:]))
    return out.index_copy(1, slots, last)


def _kv_cache(cfg: ModelConfig, kind: str, kv: Tensor, cache_len: int,
              dtype: torch.dtype) -> Tensor:
    """One of a layer's prefilled (B, T, Kv, hd) K or V as its cache."""
    B, T = kv.shape[:2]
    S = entry_cache_len(cfg, kind, cache_len)
    kv = kv.to(dtype)
    if S >= T and kind != 'swa':
        out = kv.new_zeros((B, S) + tuple(kv.shape[2:]))
        out[:, :T] = kv
        return out
    return _ring_scatter(kv, S)


def prefill(params, cfg: ModelConfig, tokens: Tensor, cache_len: int,
            prefix_embeds: Optional[Tensor] = None,
            cache_dtype: torch.dtype = torch.bfloat16) -> Tuple[Tensor, dict]:
    """Run the prompt, build a decode-ready cache of ``cache_dtype``.

    Returns (last-position logits (B, 1, V), cache).  The caller goes on
    with ``decode_step(..., pos=T_total)``.
    """
    x = embed_tokens(params, cfg, tokens, prefix_embeds)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rope = (rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if not cfg.attention_free else None)
    shared = params.get('shared')
    caches = []
    for gparams in group_params(params, cfg):
        new_g = {}
        for i, kind in enumerate(cfg.layer_pattern):
            bp = gparams.get(f'b{i}')
            if kind == 'mamba':
                h = rms_norm(x, bp['ln'], cfg.norm_eps)
                y, c = mamba_forward(bp['mamba'], cfg, h, return_cache=True)
                x = x + y
                new_g[f'b{i}'] = tree.map(lambda a: a.to(cache_dtype), c)
                continue
            p = _block_params(kind, bp, shared)

            def attend(h, p=p, kind=kind):
                a, (k, v) = attn_mod.attention_prefill(
                    p['attn'], cfg, h, positions, _window(cfg, kind), rope)
                return a, {'k': _kv_cache(cfg, kind, k, cache_len,
                                          cache_dtype),
                           'v': _kv_cache(cfg, kind, v, cache_len,
                                          cache_dtype)}

            x, _, new_g[f'b{i}'] = _attn_block(p, cfg, x, attend)
        caches.append(new_g)
    x = rms_norm(x[:, -1:], params['final_norm'], cfg.norm_eps)
    return logits_fn(params, cfg, x), _stack_caches(caches)


# ---------------------------------------------------------------------------
# the nn.Module view
# ---------------------------------------------------------------------------

class _Node(nn.Module):
    """One dict of the parameter tree: tensors become parameters, dicts
    child nodes, under the tree's names."""

    def __init__(self, subtree: dict):
        super().__init__()
        for key in sorted(subtree):
            val = subtree[key]
            if isinstance(val, dict):
                self.add_module(key, _Node(val))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def tree(self) -> dict:
        out = {name: p for name, p in self.named_parameters(recurse=False)}
        out.update({name: m.tree() for name, m in self.named_children()})
        return out


class Transformer(_Node):
    """A decoder of the zoo as an ``nn.Module``: its parameters are the tree's
    under the tree's names (``named_parameters()`` gives ``embed``,
    ``groups.b0.attn.wq`` and so on, group leaves with their leading
    group axis); :meth:`tree` hands them to the functional forward and
    loss of this module."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, tokens: Tensor, prefix_embeds: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        return forward(self.tree(), self.cfg, tokens, prefix_embeds)

    def loss(self, tokens: Tensor, prefix_embeds: Optional[Tensor] = None
             ) -> Tensor:
        return loss_fn(self.tree(), self.cfg, tokens, prefix_embeds)
