"""Minimal optimizers over parameter trees (the port of
``repro.training.optimizer``).

The FL global update is plain GD (paper eq. (6)); SGD-momentum and AdamW
exist for the LM launchers and beyond-paper experiments.  Each update
computes in float32 and casts the new parameters back to their dtype;
the state is float32 (AdamW's step count an int32 scalar).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch import tree

F32 = torch.float32


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # update(grads, state, params) -> (params, state)
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def _zeros(p):
    return torch.zeros(p.shape, dtype=F32, device=p.device)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        new = tree.map(lambda p, g: (p.to(F32) - lr * g.to(F32)).to(p.dtype),
                       params, grads)
        return new, state
    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return tree.map(_zeros, params)

    def update(grads, state, params):
        vel = tree.map(lambda v, g: beta * v + g.to(F32), state, grads)
        new = tree.map(lambda p, v: (p.to(F32) - lr * v).to(p.dtype),
                       params, vel)
        return new, vel
    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        first = tree.leaves(params)[0]
        return {'m': tree.map(_zeros, params), 'v': tree.map(_zeros, params),
                't': torch.zeros((), dtype=torch.int32, device=first.device)}

    def update(grads, state, params):
        t = state['t'] + 1
        m = tree.map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(F32),
                     state['m'], grads)
        v = tree.map(
            lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(F32)),
            state['v'], grads)
        tf = t.to(F32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=F32, device=tf.device), tf)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=F32, device=tf.device), tf)

        def step(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            p32 = p.to(F32)
            return (p32 - lr * (upd + weight_decay * p32)).to(p.dtype)

        return tree.map(step, params, m, v), {'m': m, 'v': v, 't': t}
    return Optimizer(init, update)


def get_optimizer(name: str, lr: float) -> Optimizer:
    return {'sgd': sgd, 'momentum': momentum, 'adamw': adamw}[name](lr)
