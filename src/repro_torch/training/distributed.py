"""LLM-scale federated train step — SP-FL as the gradient transport of a
data-parallel training step (the port of ``repro.training.distributed``
on one device, ``collective='gather'``).

Each of the K clients takes the gradient of its own batch
(``torch.func.vmap`` over the clients, the reference's
``jax.vmap(jax.value_and_grad)``) into (K, ...) leaves, and the tree
transport (``core.transport.spfl_aggregate_tree`` or
``error_free_aggregate_tree``) carries them to the PS: on the packed
wire each leaf is one ``quantize_pack`` and one ``spfl_accumulate``
launch, and on the bit channel two ``corrupt_fold`` launches (sign and
modulus passes).  The update is plain GD in float32, cast back to the
parameters' dtype, and ḡ becomes |ĝ| in float32.

The channel's (q, p) enter as inputs: the launcher (``launch.train``)
solves eq. (28) between steps on the per-client scalars this step
returns, one step stale, as the reference's host launcher does.  The
random inputs are explicit (``core.transport.TreeDraws``, and the
straggler uniforms when ``fl.dropout_rate > 0``).

The profiler spans ``step/gradients``, ``step/stats``,
``step/transport`` and ``step/update`` split a step (the launcher adds
``step/solve``).  Not here yet (ROADMAP Queue 1 item 12): the sharded
collective (``collective='sharded'`` raises) and the fused LLM rounds
(``make_fused_fl_round``, ``make_fused_fl_scan`` raise).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.func import grad_and_value, vmap
from torch.profiler import record_function

from repro_torch import adversary
from repro_torch import tree
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core import transport as tr
from repro_torch.models import transformer as tf
from repro_torch.obs.record import round_scalars

Tensor = torch.Tensor
LATER = 'ROADMAP Queue 1 item 12'
TRANSPORTS = ('spfl', 'error_free')


def init_gbar(params) -> Any:
    """Compensation modulus tree (last_global style), float32 zeros."""
    return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _adversary_closures(fl: FLConfig):
    """The byzantine mask of the LLM-scale step (fixed for the run: the
    first floor(attack_frac K) of a permutation from a host generator
    seeded with the seed plus ``adversary.BYZ_FOLD``; on the CPU) and the
    per-step dropout: i.i.d. each step from K uniforms, ``u >=
    dropout_rate`` (the reference draws them from the step key's
    ``STRAGGLER_FOLD`` stream; no sticky chain at this scale).
    'labelflip' has no packet effect on token batches, so its mask stays
    unused in the transport."""
    k = fl.n_devices
    byz = None
    if fl.attack != 'none' and not fl.population_n:
        perm = torch.randperm(k, generator=torch.Generator().manual_seed(
            fl.seed + adversary.BYZ_FOLD))
        byz = adversary.byzantine_mask(k, fl.attack_frac, perm)

    def draw_active(u: Optional[Tensor]) -> Optional[Tensor]:
        if fl.dropout_rate <= 0.0:
            return None
        if u is None:
            raise ValueError('dropout_rate > 0: the step needs the (K,) '
                             'straggler uniforms')
        return adversary.bernoulli_active(u, fl.dropout_rate)

    return byz, draw_active


def client_batch_shapes(cfg: ModelConfig, n_clients: int,
                        global_batch: int, seq_len: int) -> Dict[str, Any]:
    """(shape, dtype) of each array of one training batch, client-major."""
    if global_batch % n_clients:
        raise ValueError(f'global batch {global_batch} does not split over '
                         f'{n_clients} clients')
    b = global_batch // n_clients
    shapes = {'tokens': ((n_clients, b, seq_len), torch.int32)}
    if cfg.frontend == 'vision' and cfg.n_prefix_tokens:
        shapes['prefix'] = ((n_clients, b, cfg.n_prefix_tokens,
                             cfg.frontend_embed_dim), torch.bfloat16)
    return shapes


def client_grads(params, cfg: ModelConfig, tokens: Tensor
                 ) -> Tuple[Tensor, Any]:
    """Each client's loss and gradient on its own (b, T) batch of the
    (K, b, T) ``tokens`` -> (losses (K,) f32, gradient tree with (K, ...)
    leaves in the parameters' dtypes): ``torch.func.vmap`` of
    ``grad_and_value`` over the client axis, the reference's
    ``jax.vmap(jax.value_and_grad)``: one batched pass for all K clients
    (fewer, larger launches than a loop over the clients; all K clients'
    activations at once)."""
    leaves = [p.detach() for p in tree.leaves(params)]

    def loss(ls, toks):
        return tf.loss_fn(tree.unflatten(params, ls), cfg, toks)

    grads, losses = vmap(grad_and_value(loss), in_dims=(None, 0))(leaves,
                                                                  tokens)
    return losses, tree.unflatten(params, list(grads))


def make_fl_train_step(cfg: ModelConfig, fl: FLConfig,
                       transport_kind: str = 'spfl'):
    """Returns ``train_step(params, batch, gbar, q, p, draws,
    active_u=None) -> (new_params, new_gbar, metrics)``: ``batch`` holds
    (K, b, T) int ``tokens``, ``draws`` the step's ``TreeDraws``,
    ``active_u`` the (K,) straggler uniforms (``fl.dropout_rate > 0``).
    The metrics are the reference's: the mean and per-client losses, the
    per-client stats (``g_norm_sq``, ``g_min``, ``g_max``) the launcher's
    allocator reads, ``sign_ok``/``mod_ok``, the step's
    ``RoundTelemetry`` under 'telemetry' and its ``round_scalars``."""
    if fl.collective == 'sharded':
        raise NotImplementedError(tr.SHARDED_LATER)
    if transport_kind not in TRANSPORTS:
        raise ValueError(f'LLM-scale transport must be spfl|error_free, '
                         f'got {transport_kind!r}')
    tf.check_supported(cfg)
    lr = fl.learning_rate
    byz_cpu, draw_active = _adversary_closures(fl)

    def train_step(params, batch, gbar, q, p, draws: tr.TreeDraws,
                   active_u: Optional[Tensor] = None):
        with record_function('step/gradients'):
            losses, grads = client_grads(params, cfg, batch['tokens'])
        with record_function('step/stats'):
            stats = tr.tree_client_stats(grads)
        with record_function('step/transport'):
            if transport_kind == 'spfl':
                byz = None if byz_cpu is None else byz_cpu.to(q.device)
                ghat, stats, diag = tr.spfl_aggregate_tree(
                    grads, gbar, q, p, fl, draws, stats=stats,
                    attack=fl.attack, byz_mask=byz,
                    attack_scale=fl.attack_scale,
                    active=draw_active(active_u), screen=fl.screen,
                    screen_z=fl.screen_z,
                    min_participation=fl.min_participation)
            else:
                ghat, stats, diag = tr.error_free_aggregate_tree(
                    grads, fl, draws, stats=stats)
        del grads
        with record_function('step/update'):
            new_params = tree.map(
                lambda pp, g: (pp.to(torch.float32) - lr * g).to(pp.dtype),
                params, ghat)
            new_gbar = tree.map(torch.abs, ghat)
        diag = diag.with_allocation(q, p)
        metrics = {
            'loss': torch.mean(losses),
            'client_losses': losses,
            'g_norm_sq': stats['g2'],            # -> the host allocator
            'g_min': stats['g_min'],
            'g_max': stats['g_max'],
            'sign_ok': diag.sign_ok,
            'mod_ok': diag.mod_ok,
            'telemetry': diag,
            **round_scalars(diag),
        }
        return new_params, new_gbar, metrics

    return train_step


def make_fused_fl_round(cfg: ModelConfig, fl: FLConfig, *args, **kwargs):
    """The whole Algorithm-2 round of the LLM-scale step as one traced
    body: not ported yet."""
    raise NotImplementedError(f'fused LLM rounds are {LATER}')


def make_fused_fl_scan(cfg: ModelConfig, fl: FLConfig, *args, **kwargs):
    """Segments of fused LLM-scale rounds: not ported yet."""
    raise NotImplementedError(f'fused LLM rounds are {LATER}')


def make_standard_train_step(cfg: ModelConfig, fl: FLConfig):
    """Plain data-parallel step (batch (B, T), one global gradient, the
    update of :func:`make_fl_train_step` without a transport): returns
    ``train_step(params, batch) -> (new_params, {'loss', 'g_norm_sq'})``."""
    tf.check_supported(cfg)
    lr = fl.learning_rate

    def train_step(params, batch):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree.leaves(params)]
        loss = tf.loss_fn(tree.unflatten(params, leaves), cfg,
                          batch['tokens'])
        grads = torch.autograd.grad(loss, leaves)
        new_params = tree.unflatten(params, [
            (p.detach().to(torch.float32) - lr * g.to(torch.float32)
             ).to(p.dtype) for p, g in zip(leaves, grads)])
        g2 = sum(torch.sum(torch.square(g.to(torch.float32)))
                 for g in grads)
        return new_params, {'loss': loss.detach(), 'g_norm_sq': g2}

    return train_step


def make_eval_step(cfg: ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            return tf.loss_fn(params, cfg, batch['tokens'])
    return eval_step
