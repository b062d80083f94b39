"""The paper's CIFAR-10 CNN (§V): two 5x5 conv layers and three fully
connected layers, max-pooling after each conv, ReLU — 62,006 parameters
(the port of ``repro.models.cnn``).

Layouts.  The module keeps PyTorch's layouts (conv weights OIHW, Linear
weights (out, in)) and takes images NCHW.  The reference keeps HWIO conv
weights, (in, out) dense weights and NHWC images, and flattens the pooled
(5, 5, 16) activation in NHWC order; the module permutes its pooled
activation to NHWC before the flatten, so ``fc1`` sees the reference's
400-vector and its weight is the reference's ``fc1_w`` transposed, with
no row permutation.

The flat parameter vector — the coordinate order of every packet, of ḡ
and of the update — is ``jax.flatten_util.ravel_pytree``'s order of the
reference dict: keys sorted (``KEYS``), each leaf flattened row-major in
the reference's layout.  :func:`module_params` maps a flat vector to the
module's parameters differentiably, so a gradient taken with respect to
the flat vector is already in that order.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

Tensor = torch.Tensor

# reference key -> (module parameter name, reference shape)
_LEAVES = {
    'conv1_b': ('conv1.bias', (6,)),
    'conv1_w': ('conv1.weight', (5, 5, 3, 6)),
    'conv2_b': ('conv2.bias', (16,)),
    'conv2_w': ('conv2.weight', (5, 5, 6, 16)),
    'fc1_b': ('fc1.bias', (120,)),
    'fc1_w': ('fc1.weight', (400, 120)),
    'fc2_b': ('fc2.bias', (84,)),
    'fc2_w': ('fc2.weight', (120, 84)),
    'fc3_b': ('fc3.bias', (10,)),
    'fc3_w': ('fc3.weight', (84, 10)),
}
KEYS = tuple(sorted(_LEAVES))
N_PARAMS = sum(math.prod(shape) for _, shape in _LEAVES.values())


def _to_module_layout(key: str, leaf: Tensor) -> Tensor:
    """Reference layout -> module layout (HWIO -> OIHW, (in,out) -> (out,in))."""
    if key.startswith('conv') and key.endswith('_w'):
        return leaf.permute(3, 2, 0, 1)
    if key.endswith('_w'):
        return leaf.t()
    return leaf


def _to_ref_layout(key: str, param: Tensor) -> Tensor:
    if key.startswith('conv') and key.endswith('_w'):
        return param.permute(2, 3, 1, 0)
    if key.endswith('_w'):
        return param.t()
    return param


class CNN(nn.Module):
    """The §V CNN on NCHW images -> logits (B, 10)."""

    def __init__(self, n_classes: int = 10):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 6, 5)
        self.conv2 = nn.Conv2d(6, 16, 5)
        self.fc1 = nn.Linear(400, 120)
        self.fc2 = nn.Linear(120, 84)
        self.fc3 = nn.Linear(84, n_classes)

    def forward(self, x: Tensor) -> Tensor:
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)     # (B, 6, 14, 14)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)     # (B, 16, 5, 5)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


def init_params(generator: torch.Generator) -> Tensor:
    """Flat initial parameters with the reference's distributions:
    weights N(0, 1) / sqrt(fan_in), biases zero."""
    leaves = {}
    for key in KEYS:
        shape = _LEAVES[key][1]
        if key.endswith('_b'):
            leaves[key] = torch.zeros(shape)
        else:
            fan_in = math.prod(shape[:-1])
            leaves[key] = (torch.randn(shape, generator=generator)
                           / math.sqrt(fan_in))
    return torch.cat([leaves[key].reshape(-1) for key in KEYS])


def module_params(flat: Tensor) -> Dict[str, Tensor]:
    """Flat reference-order vector -> {module parameter name: tensor in
    the module's layout} (views and permutes, differentiable)."""
    out, off = {}, 0
    for key in KEYS:
        name, shape = _LEAVES[key]
        size = math.prod(shape)
        leaf = flat[off:off + size].reshape(shape)
        out[name] = _to_module_layout(key, leaf)
        off += size
    return out


def params_from_jax(params: Mapping[str, np.ndarray]) -> Dict[str, Tensor]:
    """Reference parameter dict -> the module's state dict."""
    return {_LEAVES[key][0]: _to_module_layout(
        key, torch.as_tensor(np.asarray(params[key], np.float32))
    ).contiguous() for key in KEYS}


def flat_from_module(module: CNN) -> Tensor:
    """The module's parameters as the flat reference-order vector."""
    state = dict(module.named_parameters())
    return torch.cat([_to_ref_layout(key, state[_LEAVES[key][0]].detach())
                      .reshape(-1) for key in KEYS])


def module_from_flat(module: CNN, flat: Tensor) -> CNN:
    """Load a flat reference-order vector into ``module`` (in place)."""
    module.load_state_dict({name: p.contiguous() for name, p
                            in module_params(flat.detach()).items()})
    return module


def cnn_loss(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean cross-entropy, written as the reference writes it."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)
