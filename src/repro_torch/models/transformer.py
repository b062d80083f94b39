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

The forward pass loops over the groups (the reference scans them) and
makes the rotary tables once for all its layers.  Under grad mode each
group keeps for its backward what ``cfg.remat_policy`` says, as the
reference's ``jax.checkpoint`` of a group does: 'full' its inputs only
(its forward runs again in the backward), 'dots' its inputs and the
products without a batch dimension (``common.dot``), 'none' every
activation; the gradients are the same bits under each policy.  With a
``tp`` partition (``models.parallel``, the 'model' axis of a production
mesh) the blocks compute with the rank's blocks of the weights.
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

On the 'model' axis (``tp``) the serving path computes with the rank's
blocks as the training pass does, Mamba2's included; the head's logits
of a vocabulary split are gathered over the model ranks, so the caller
sees (B, 1, V).  ``at_use`` (an :class:`AtUse`) says how a rank takes
each weight and cache leaf at use from what it holds
(``training.model_axis.Serving``: the rank's blocks, gathered one group
of layers at a time where the partition does not split them); the cache
of :func:`init_cache` under ``tp`` is the rank's compute layout.
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, parallel
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

def _ffn(p, cfg: ModelConfig, h: Tensor, tp=None
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """The block's feed-forward half: the MoE (-> its lb_loss) or the
    dense MLP (-> None)."""
    if cfg.is_moe:
        f, aux = moe_forward(p['moe'], cfg, h, tp)
        return f, aux['lb_loss']
    return mlp_forward(p['mlp'], h, tp), None


def _attn_block(p, cfg: ModelConfig, x: Tensor, attend, tp=None):
    """Pre-norm attention (``attend(h) -> (a, extra)``) then the FFN,
    with gemma2's post-norms -> (x, lb_loss or None, extra)."""
    a, extra = attend(rms_norm(x, p['ln'], cfg.norm_eps))
    if cfg.post_norm:
        a = rms_norm(a, p['pln'], cfg.norm_eps)
    x = x + a
    f, lb = _ffn(p, cfg, rms_norm(x, p['ln2'], cfg.norm_eps), tp)
    if cfg.post_norm:
        f = rms_norm(f, p['pln2'], cfg.norm_eps)
    return x + f, lb, extra


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == 'swa' else 0


def _block_params(kind: str, bparams, shared):
    return shared if kind == 'shared_attn' else bparams


def embed_tokens(params, cfg: ModelConfig, tokens: Tensor,
                 prefix_embeds: Optional[Tensor] = None, tp=None) -> Tensor:
    if tp is not None and tp.vocab:
        x = parallel.vocab_embed(tokens, params['embed'], tp)
    else:
        x = F.embedding(tokens.to(torch.int64), params['embed'])
    if cfg.embed_scale:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype,
                           device=x.device)
    if prefix_embeds is not None:
        prefix = prefix_embeds.to(x.dtype)
        if 'frontend_proj' in params:
            prefix = common.dot(prefix, params['frontend_proj'])
        x = torch.cat([prefix, x], dim=1)
    return x


def group_slice(params, g: int):
    """The g-th group's parameter tree of the stacked ``params['groups']``."""
    return tree.map(lambda a: a[g], params['groups'])


def group_params(params, cfg: ModelConfig) -> list:
    """The groups' parameter trees, one a group: each leaf unbound once
    along its group axis (its gradient then stacks once)."""
    gtree = params['groups']
    unbound = [leaf.unbind(0) for leaf in tree.leaves(gtree)]
    return [tree.unflatten(gtree, [u[g] for u in unbound])
            for g in range(n_groups(cfg))]


def _group_forward(gparams, shared, cfg: ModelConfig, x: Tensor,
                   aux: Tensor, positions: Tensor, rope, tp=None
                   ) -> Tuple[Tensor, Tensor]:
    """One group (a period of ``cfg.layer_pattern``) on the carry (x,
    aux): the unit the reference scans and checkpoints."""
    for i, kind in enumerate(cfg.layer_pattern):
        bp = gparams.get(f'b{i}')
        if kind == 'mamba':
            x = x + mamba_forward(bp['mamba'], cfg,
                                  rms_norm(x, bp['ln'], cfg.norm_eps),
                                  tp=tp)
            continue
        p = _block_params(kind, bp, shared)

        def attend(h, p=p, kind=kind):
            return attn_mod.attention_forward(
                p['attn'], cfg, h, positions, _window(cfg, kind),
                rope, tp), None

        x, lb, _ = _attn_block(p, cfg, x, attend, tp)
        if lb is not None:
            aux = aux + lb
    return x, aux


class _Group:
    """A group's forward as a function of flat tensors: the carry (x,
    aux), the positions and the rotary tables (cos, sin; or none), then
    the group's leaves, then the shared block's (Zamba2)."""

    def __init__(self, cfg: ModelConfig, gtree, shared, n_fixed: int, tp):
        self.cfg, self.gtree, self.stree = cfg, gtree, shared
        self.n_group = len(tree.leaves(gtree))
        self.n_fixed, self.tp = n_fixed, tp

    def __call__(self, x, aux, *rest):
        positions, rope = rest[0], rest[1:self.n_fixed] or None
        leaves = rest[self.n_fixed:]
        g = tree.unflatten(self.gtree, leaves[:self.n_group])
        s = (None if self.stree is None
             else tree.unflatten(self.stree, leaves[self.n_group:]))
        return _group_forward(g, s, self.cfg, x, aux, positions, rope,
                              self.tp)


class _Recompute(torch.autograd.Function):
    """A group whose backward runs its forward again: 'full' keeps the
    group's inputs only; 'dots' also keeps the products without a batch
    dimension (``common.dot``), which the second forward takes back
    instead of multiplying again.  The backward pulls the cotangent of
    (x, aux) back through the second forward with ``torch.func.vjp``, so
    every leaf's gradient is the one the kept activations would give,
    and a leaf the group shares with the others (Zamba2's block) is an
    input of each group, its gradient summed over the groups as autograd
    sums it over its uses.  The backward takes its inputs and cotangents
    detached: ``torch.func.grad`` runs the backward with
    ``create_graph=True``, which would otherwise record the second forward
    in the outer graph and keep all of it to the end of the pass (the
    backward is therefore not differentiable again)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, dots, x, aux, *leaves):
        with common.recording() if dots else contextlib.nullcontext() as kept:
            x_out, aux_out = run(x, aux, *leaves)
        # a carry the group leaves as it was goes out as a view of it
        out = tuple(o.view_as(o) if o is i else o
                    for o, i in ((x_out, x), (aux_out, aux)))
        return out + tuple(kept or ())

    @staticmethod
    def setup_context(ctx, inputs, output):
        run, dots, *tensors = inputs
        ctx.run, ctx.dots, ctx.n_in = run, dots, len(tensors)
        kept = tuple(output[2:]) if dots else ()
        ctx.mark_non_differentiable(*kept)
        ctx.save_for_backward(*tensors, *kept)

    @staticmethod
    def backward(ctx, gx, gaux, *_):
        saved = [t.detach() for t in ctx.saved_tensors]
        gx, gaux = gx.detach(), gaux.detach()
        inputs, kept = saved[:ctx.n_in], saved[ctx.n_in:]

        n_fixed = ctx.run.n_fixed          # positions, rope: no gradient
        fixed = inputs[2:2 + n_fixed]

        def again(x, aux, *leaves):
            with (common.replaying(kept) if ctx.dots
                  else contextlib.nullcontext()):
                return ctx.run(x, aux, *fixed, *leaves)

        _, pull = torch.func.vjp(again, inputs[0], inputs[1],
                                 *inputs[2 + n_fixed:])
        gx, gaux, *gleaves = pull((gx, gaux))
        return (None, None, gx, gaux) + (None,) * n_fixed + tuple(gleaves)


def forward(params, cfg: ModelConfig, tokens: Tensor,
            prefix_embeds: Optional[Tensor] = None,
            remat: bool = True, tp=None) -> Tuple[Tensor, Tensor]:
    """tokens: (B, T) [+ prefix (B, P, E)] -> (final hidden states (B,
    P + T, D), the summed MoE load-balance loss, float32).

    Under ``remat`` (with grad mode on) a group keeps for the backward
    what ``cfg.remat_policy`` says, as the reference's
    ``jax.checkpoint`` of a group: 'none' every activation, 'dots' its
    inputs and the products without a batch dimension (the attention
    projections, the MLP's and Mamba's, the router; the attention and
    expert einsums are done again), any other value ('full') its inputs
    alone.  The gradients are the same bits under each policy.

    ``tp``: the 'model' axis's partition (``models.parallel``; None: the
    unsharded ops), ``params`` then the rank's blocks where it splits."""
    x = embed_tokens(params, cfg, tokens, prefix_embeds, tp)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rope = (rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if not cfg.attention_free else None)
    shared = params.get('shared')
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    policy = cfg.remat_policy if remat else 'none'
    keep_all = policy == 'none' or not torch.is_grad_enabled()
    for gparams in group_params(params, cfg):
        if keep_all:
            x, aux = _group_forward(gparams, shared, cfg, x, aux, positions,
                                    rope, tp)
            continue
        fixed = (positions,) + tuple(rope or ())
        run = _Group(cfg, gparams, shared, len(fixed), tp)
        out = _Recompute.apply(run, policy == 'dots', x, aux, *fixed,
                               *tree.leaves(gparams), *tree.leaves(shared))
        x, aux = out[0], out[1]
    return rms_norm(x, params['final_norm'], cfg.norm_eps), aux


def lm_head_t(params, cfg: ModelConfig) -> Tensor:
    """(D, V) output projection (tied -> embed^T)."""
    if cfg.tie_embeddings:
        return params['embed'].t()
    return params['lm_head']


def logits_fn(params, cfg: ModelConfig, hidden: Tensor, tp=None
              ) -> Tensor:
    """The (..., V) logits of ``hidden``; with ``tp`` whose vocabulary is
    split, the rank's (D, V / size) columns of the head give its logits
    (a ``parallel.column`` product), gathered over the model ranks."""
    if tp is None or not tp.vocab:
        return softcap(hidden @ lm_head_t(params, cfg), cfg.logit_softcap)
    mine = parallel.column(hidden, tp)(lm_head_t(params, cfg))
    return parallel.gather_columns(softcap(mine, cfg.logit_softcap), tp)


def loss_fn(params, cfg: ModelConfig, tokens: Tensor,
            prefix_embeds: Optional[Tensor] = None, tp=None) -> Tensor:
    """Next-token cross-entropy of (B, T) tokens over the text positions
    (after a prefix), plus ``AUX_LOSS_WEIGHT`` x the MoE aux loss (a
    float32 scalar); the groups under ``cfg.remat_policy``.  ``tp`` as
    in :func:`forward` (the head and cross-entropy vocab-parallel where
    it splits the vocabulary)."""
    hidden, aux = forward(params, cfg, tokens, prefix_embeds, tp=tp)
    P = hidden.shape[1] - tokens.shape[1]      # prefix length
    # hidden at text position i predicts token i + 1
    h = hidden[:, P:-1] if tokens.shape[1] > 1 else hidden[:, P:]
    labels = tokens[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    xent_fn = (chunked_softmax_xent if tp is None or not tp.vocab
               else functools.partial(parallel.vocab_xent, tp=tp))
    xent = xent_fn(h, lm_head_t(params, cfg), labels, mask,
                   cfg.logit_softcap)
    return xent + AUX_LOSS_WEIGHT * aux


# ---------------------------------------------------------------------------
# KV / SSM caches
# ---------------------------------------------------------------------------

def entry_cache_len(cfg: ModelConfig, kind: str, cache_len: int) -> int:
    if kind == 'swa' and cfg.sliding_window:
        return min(cache_len, cfg.sliding_window)
    return cache_len


def kv_heads(cfg: ModelConfig, tp=None) -> int:
    """KV heads of a cache: all, or the rank's under a split ``tp`` (its
    block under 'heads', the one it uses under 'q')."""
    if tp is None or tp.attn is None:
        return cfg.n_kv_heads
    return cfg.n_kv_heads // tp.size if tp.attn == 'heads' else 1


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None, tp=None
               ) -> dict:
    """Zero caches: per ``b{i}`` of the pattern (Zamba2's shared block
    too: one cache an occurrence) a leading ``n_groups`` axis over
    ``{'k', 'v'}`` (B, S, Kv, hd) or ``{'conv', 'ssm'}``; under ``tp``
    the rank's kv heads (:func:`kv_heads`) and Mamba2 heads."""
    ng = n_groups(cfg)
    hd, kv = cfg.resolved_head_dim, kv_heads(cfg, tp)
    cache = {}
    for i, kind in enumerate(cfg.layer_pattern):
        if kind == 'mamba':
            c = init_mamba_cache(cfg, batch, dtype, device, tp)
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

class AtUse:
    """How a rank takes each weight and cache leaf at use from what it
    holds: here as it is (the unsharded model, or the compute blocks
    themselves).  Paths are ``tree.paths``' (a group's leaf without its
    group axis, e.g. ``groups.b0.attn.wq``; a group's cache leaf ``b0.k``)."""

    def params(self, path: str, x: Tensor) -> Tensor:
        return x

    def cache_in(self, path: str, x: Tensor) -> Tensor:
        return x

    def cache_out(self, path: str, x: Tensor) -> Tensor:
        return x

    def seq(self, path: str):
        """The ranks that split cache leaf ``path``'s sequence (a
        ``core.mesh.ClientMesh``), or None."""
        return None


def _used(use: AtUse, sub, prefix: str):
    """The subtree ``sub`` (at ``prefix``) as the forward computes with
    it."""
    if sub is None:
        return None
    return tree.unflatten(sub, [use.params(prefix + p, x) for p, x in
                                zip(tree.paths(sub), tree.leaves(sub))])


def _head_params(params, cfg: ModelConfig, use: AtUse) -> dict:
    name = 'embed' if cfg.tie_embeddings else 'lm_head'
    return {name: use.params(name, params[name])}


def _embed_params(params, use: AtUse) -> dict:
    return {k: use.params(k, params[k]) for k in ('embed', 'frontend_proj')
            if k in params}


def decode_step(params, cfg: ModelConfig, cache: dict, token: Tensor,
                pos, tp=None, at_use: Optional[AtUse] = None
                ) -> Tuple[Tensor, dict]:
    """token: (B, 1) int; ``pos`` (an int or an int32 device scalar): the
    absolute position of the new token.  Returns (logits (B, 1, V), new
    cache).  ``tp``: the 'model' axis's partition (the blocks compute
    split where it splits them); ``at_use``: how the rank takes each
    leaf from what it holds (one group of layers at a time)."""
    use = at_use or AtUse()
    x = embed_tokens(_embed_params(params, use), cfg, token, tp=tp)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    rope = (rope_tables(pos[None], cfg.resolved_head_dim, cfg.rope_theta)
            if not cfg.attention_free else None)
    shared = _used(use, params.get('shared'), 'shared.')
    new = []
    for gparams, gcache in zip(group_params(params, cfg),
                               _group_caches(cache, n_groups(cfg))):
        gparams = _used(use, gparams, 'groups.')
        new_g = {}
        for i, kind in enumerate(cfg.layer_pattern):
            bp, name = gparams.get(f'b{i}'), f'b{i}'
            bc = {n: use.cache_in(f'{name}.{n}', t)
                  for n, t in gcache[name].items()}
            if kind == 'mamba':
                h = rms_norm(x, bp['ln'], cfg.norm_eps)
                y, out = mamba_decode(bp['mamba'], cfg, h, bc, tp)
                x = x + y
            else:
                p = _block_params(kind, bp, shared)

                def attend(h, p=p, kind=kind, bc=bc, name=name):
                    y, ck, cv = attn_mod.attention_decode(
                        p['attn'], cfg, h, bc['k'], bc['v'], pos,
                        _window(cfg, kind), rope, tp, use.seq(f'{name}.k'))
                    return y, {'k': ck, 'v': cv}

                x, _, out = _attn_block(p, cfg, x, attend, tp)
            new_g[name] = {n: use.cache_out(f'{name}.{n}', t)
                           for n, t in out.items()}
        new.append(new_g)
    x = rms_norm(x, params['final_norm'], cfg.norm_eps)
    return (logits_fn(_head_params(params, cfg, use), cfg, x, tp),
            _stack_caches(new))


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
            cache_dtype: torch.dtype = torch.bfloat16, tp=None,
            at_use: Optional[AtUse] = None) -> Tuple[Tensor, dict]:
    """Run the prompt, build a decode-ready cache of ``cache_dtype``.

    Returns (last-position logits (B, 1, V), cache).  The caller goes on
    with ``decode_step(..., pos=T_total)``.  ``tp`` and ``at_use`` as in
    :func:`decode_step` (each new cache leaf handed to
    ``at_use.cache_out``).
    """
    use = at_use or AtUse()
    x = embed_tokens(_embed_params(params, use), cfg, tokens, prefix_embeds,
                     tp)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rope = (rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
            if not cfg.attention_free else None)
    shared = _used(use, params.get('shared'), 'shared.')
    caches = []
    for gparams in group_params(params, cfg):
        gparams = _used(use, gparams, 'groups.')
        new_g = {}
        for i, kind in enumerate(cfg.layer_pattern):
            bp = gparams.get(f'b{i}')
            if kind == 'mamba':
                h = rms_norm(x, bp['ln'], cfg.norm_eps)
                y, c = mamba_forward(bp['mamba'], cfg, h, return_cache=True,
                                     tp=tp)
                x = x + y
                c = tree.map(lambda a: a.to(cache_dtype), c)
            else:
                p = _block_params(kind, bp, shared)

                def attend(h, p=p, kind=kind):
                    a, (k, v) = attn_mod.attention_prefill(
                        p['attn'], cfg, h, positions, _window(cfg, kind),
                        rope, tp)
                    return a, {'k': _kv_cache(cfg, kind, k, cache_len,
                                              cache_dtype),
                               'v': _kv_cache(cfg, kind, v, cache_len,
                                              cache_dtype)}

                x, _, c = _attn_block(p, cfg, x, attend, tp)
            new_g[f'b{i}'] = {n: use.cache_out(f'b{i}.{n}', t)
                              for n, t in c.items()}
        caches.append(new_g)
    x = rms_norm(x[:, -1:], params['final_norm'], cfg.norm_eps)
    return (logits_fn(_head_params(params, cfg, use), cfg, x, tp),
            _stack_caches(caches))


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
