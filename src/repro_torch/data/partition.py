"""Federated dataset partitioning — paper §V (NumPy; the port's own copy
of ``repro.data.partition``, identical index draws for the same seed).

IID: shuffle and split into equal shards.  Non-IID: per-device class
mixture drawn from Dirichlet(alpha).  Both accept ``k * per_device``
beyond the dataset size (with-replacement contract of the reference).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def iid_partition(labels: np.ndarray, k: int, per_device: int,
                  seed: int = 0) -> List[np.ndarray]:
    """Equal IID shards; each wraparound pass is a fresh permutation."""
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(labels))
    need = k * per_device
    while len(idx) < need:
        idx = np.concatenate([idx, rng.permutation(len(labels))])
    return [idx[i * per_device:(i + 1) * per_device] for i in range(k)]


def dirichlet_partition(labels: np.ndarray, k: int, per_device: int,
                        alpha: float, seed: int = 0,
                        n_classes: int = 10) -> List[np.ndarray]:
    """Each device draws its class mixture from Dirichlet(alpha), then
    exactly ``per_device`` samples (with replacement if a class runs
    short).  Classes absent from ``labels`` get their mass renormalized
    away before the multinomial draw."""
    rng = np.random.RandomState(seed)
    by_class = [np.nonzero(labels == c)[0] for c in range(n_classes)]
    nonempty = np.array([len(p) > 0 for p in by_class], dtype=bool)
    if not nonempty.any():
        raise ValueError('dirichlet_partition: no labels in [0, n_classes)')
    parts = []
    for _ in range(k):
        mix = rng.dirichlet(np.full(n_classes, alpha))
        mix = np.where(nonempty, mix, 0.0)
        if mix.sum() == 0.0:        # all mass landed on empty classes
            mix = nonempty / nonempty.sum()
        counts = rng.multinomial(per_device, mix / mix.sum())
        take = []
        for c, m in enumerate(counts):
            if m == 0:
                continue
            pool = by_class[c]
            take.append(rng.choice(pool, size=m, replace=m > len(pool)))
        parts.append(np.concatenate(take) if take else np.array([], np.int64))
    return parts


def stack_client_data(x: np.ndarray, y: np.ndarray,
                      parts: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """-> (K, per_device, ...) stacked arrays."""
    xs = np.stack([x[p] for p in parts])
    ys = np.stack([y[p] for p in parts])
    return xs, ys
