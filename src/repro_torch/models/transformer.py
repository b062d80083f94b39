"""Decoder-only model assembly for the dense architectures of the zoo
(the port of the training path of ``repro.models.transformer``).

Parameters form a tree of tensors (nested dicts) with the reference's
names and grouped layout: ``embed``, ``final_norm``, ``lm_head`` where
the head is untied, and ``groups.b{i}.{ln, ln2, attn.{wq, wk, wv, wo},
mlp.{w_gate, w_up, w_down}}`` (``pln``/``pln2`` with ``post_norm``),
each group leaf with a leading ``n_groups`` axis — one period of
``cfg.layer_pattern`` a group.  :func:`repro_torch.tree.leaves` lists
them in ``jax.tree.flatten``'s order (keys sorted), the order the
LLM-scale transports bind their draws to; :class:`Transformer` registers
the same tree as an ``nn.Module``'s parameters.

The forward pass loops over the groups (the reference scans them under
``jax.checkpoint``; recomputation changes no number, and the port keeps
the activations) and makes the rotary tables once for all its layers.
Layers of kind 'attn' and 'swa' run here, with ``post_norm``,
``embed_scale``, ``logit_softcap``, QKV bias and tied or untied heads.
Mixture-of-experts and Mamba2 blocks, Zamba2's shared attention block
and the vision/audio frontends raise ``NotImplementedError``: they are
ROADMAP Queue 1 item 13, with prefill, decode and serving.
"""
from __future__ import annotations

import math
from typing import Tuple

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

Tensor = torch.Tensor
AUX_LOSS_WEIGHT = 0.01   # the MoE load-balance loss weight (no MoE here)
LATER = 'ROADMAP Queue 1 item 13'


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for the architectures whose blocks
    or frontends the port does not have yet."""
    missing = []
    if cfg.is_moe:
        missing.append('mixture-of-experts blocks')
    kinds = set(cfg.layer_pattern)
    if 'mamba' in kinds:
        missing.append('Mamba2 blocks')
    if 'shared_attn' in kinds:
        missing.append('the shared attention block')
    if cfg.frontend != 'none':
        missing.append(f'the {cfg.frontend} frontend')
    if missing:
        raise NotImplementedError(
            f'{cfg.name} needs {", ".join(missing)}: {LATER} (the port '
            "runs the dense 'attn'/'swa' decoders)")


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
        'mlp': init_mlp(generator, d, cfg.d_ff, dtype, device),
    }
    if cfg.post_norm:
        p['pln'] = torch.zeros((d,), dtype=dtype, device=device)
        p['pln2'] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random weights (the reference's initializers and shapes) drawn
    from ``generator`` on ``device``: normal embeddings and dense
    weights, zero norm scales and biases.  The draws are not the
    reference's; :func:`params_from_reference` carries those across."""
    check_supported(cfg)
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
    groups = [{f'b{i}': _init_attn_block(generator, cfg, dtype, device)
               for i in range(len(cfg.layer_pattern))}
              for _ in range(n_groups(cfg))]
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
# forward / loss
# ---------------------------------------------------------------------------

def _apply_attn_block(p, cfg: ModelConfig, x: Tensor, positions: Tensor,
                      window: int, rope) -> Tensor:
    a = attn_mod.attention_forward(
        p['attn'], cfg, rms_norm(x, p['ln'], cfg.norm_eps), positions, window,
        rope)
    if cfg.post_norm:
        a = rms_norm(a, p['pln'], cfg.norm_eps)
    x = x + a
    f = mlp_forward(p['mlp'], rms_norm(x, p['ln2'], cfg.norm_eps))
    if cfg.post_norm:
        f = rms_norm(f, p['pln2'], cfg.norm_eps)
    return x + f


def embed_tokens(params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    x = F.embedding(tokens.to(torch.int64), params['embed'])
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def group_params(params, cfg: ModelConfig) -> list:
    """The groups' parameter trees, one a group: each leaf unbound once
    along its group axis (its gradient then stacks once)."""
    gtree = params['groups']
    unbound = [leaf.unbind(0) for leaf in tree.leaves(gtree)]
    return [tree.unflatten(gtree, [u[g] for u in unbound])
            for g in range(n_groups(cfg))]


def forward(params, cfg: ModelConfig, tokens: Tensor) -> Tuple[Tensor, Tensor]:
    """tokens: (B, T) -> (final hidden states (B, T, D), aux loss 0)."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rope = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)
    for gparams in group_params(params, cfg):
        for i, kind in enumerate(cfg.layer_pattern):
            window = cfg.sliding_window if kind == 'swa' else 0
            x = _apply_attn_block(gparams[f'b{i}'], cfg, x, positions, window,
                                  rope)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params['final_norm'], cfg.norm_eps), aux


def lm_head_t(params, cfg: ModelConfig) -> Tensor:
    """(D, V) output projection (tied -> embed^T)."""
    if cfg.tie_embeddings:
        return params['embed'].t()
    return params['lm_head']


def logits_fn(params, cfg: ModelConfig, hidden: Tensor) -> Tensor:
    return softcap(hidden @ lm_head_t(params, cfg), cfg.logit_softcap)


def loss_fn(params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    """Next-token cross-entropy of (B, T) tokens (a float32 scalar)."""
    hidden, aux = forward(params, cfg, tokens)
    # hidden at position i predicts token i + 1
    h = hidden[:, :-1] if tokens.shape[1] > 1 else hidden
    labels = tokens[:, 1:]
    mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    xent = chunked_softmax_xent(h, lm_head_t(params, cfg), labels, mask,
                                cfg.logit_softcap)
    return xent + AUX_LOSS_WEIGHT * aux


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
    """A dense decoder as an ``nn.Module``: its parameters are the tree's
    under the tree's names (``named_parameters()`` gives ``embed``,
    ``groups.b0.attn.wq`` and so on, group leaves with their leading
    group axis); :meth:`tree` hands them to the functional forward and
    loss of this module."""

    def __init__(self, cfg: ModelConfig, params: dict):
        check_supported(cfg)
        super().__init__(params)
        self.cfg = cfg

    def forward(self, tokens: Tensor) -> Tuple[Tensor, Tensor]:
        return forward(self.tree(), self.cfg, tokens)

    def loss(self, tokens: Tensor) -> Tensor:
        return loss_fn(self.tree(), self.cfg, tokens)
