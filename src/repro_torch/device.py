"""The port's device rule.

Every entry point (``build_simulator``, ``FLSimulator``, and the kernel
wrappers through their tensors' device) runs on the CUDA card by default.
The CPU is used only when the caller asks for it explicitly with
``device='cpu'`` — as the CPU tests do — and a missing card is an error,
never a silent fallback.  ``device='meta'`` (shapes and dtypes, no data)
is taken only where the caller names it, as ``launch.dryrun`` does.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda`` (``RuntimeError`` without a card); an explicit
    device ('cuda', 'cpu' or 'meta') is returned as a ``torch.device``
    after the same check."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'repro_torch runs on a CUDA card by default and none is '
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ('cuda', 'cpu', 'meta'):
        raise ValueError(f'unsupported device {dev}')
    return dev

