"""Datasets (NumPy; the port's own copy of ``repro.data.synthetic``).

``load_image_dataset`` reads the real CIFAR-10 binary batches when present
under ``data_dir`` and otherwise falls back to **SynthCIFAR**: a
deterministic 10-class, 32x32x3 dataset whose classes are separable but
noisy.  ``synth_tokens`` is the LM token stream of the LLM-scale
launcher (``launch.train``).  Same seed, same arrays as the reference,
bit for bit.
"""
from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np


def synth_cifar(n: int, seed: int = 0, n_classes: int = 10
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic CIFAR-shaped synthetic dataset: (n,32,32,3), (n,)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, n_classes, size=n)
    xx, yy = np.meshgrid(np.arange(32), np.arange(32))
    images = np.empty((n, 32, 32, 3), np.float32)
    # fixed per-class spatial frequencies + colour phase
    freqs = np.linspace(1.0, 4.0, n_classes)
    for c in range(n_classes):
        mask = labels == c
        m = int(mask.sum())
        if not m:
            continue
        base = np.sin(2 * np.pi * freqs[c] * xx / 32.0 +
                      np.cos(2 * np.pi * freqs[c] * yy / 32.0))
        phase = rng.uniform(-0.5, 0.5, size=(m, 1, 1, 1))
        chan = np.stack([np.roll(base, c, axis=0),
                         np.roll(base, 2 * c, axis=1),
                         base.T], axis=-1)[None]
        images[mask] = (0.5 * chan + phase
                        + 0.45 * rng.randn(m, 32, 32, 3)).astype(np.float32)
    images = (images - images.mean()) / (images.std() + 1e-8)
    return images, labels.astype(np.int32)


def _load_real_cifar(data_dir: str):
    files = [os.path.join(data_dir, f'data_batch_{i}') for i in range(1, 6)]
    test = os.path.join(data_dir, 'test_batch')
    if not all(os.path.exists(f) for f in files + [test]):
        return None
    xs, ys = [], []
    for f in files + [test]:
        with open(f, 'rb') as fh:
            d = pickle.load(fh, encoding='bytes')
        xs.append(np.asarray(d[b'data'], np.float32))
        ys.append(np.asarray(d[b'labels'], np.int32))
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    x = (x / 255.0 - 0.5) / 0.25
    return x.astype(np.float32), np.concatenate(ys)


def load_image_dataset(n_train: int = 40_000, n_test: int = 4_000,
                       seed: int = 0, data_dir: str = 'data/cifar-10'):
    """(train_x, train_y), (test_x, test_y) — real CIFAR-10 if present."""
    real = _load_real_cifar(data_dir)
    if real is not None:
        x, y = real
        return (x[:n_train], y[:n_train]), (x[-n_test:], y[-n_test:])
    xtr, ytr = synth_cifar(n_train, seed)
    xte, yte = synth_cifar(n_test, seed + 10_000)
    return (xtr, ytr), (xte, yte)


def synth_tokens(n_seqs: int, seq_len: int, vocab: int, seed: int = 0
                 ) -> np.ndarray:
    """Zipf-ish synthetic token stream with short-range structure (so a tiny
    LM actually has something to learn), (n_seqs, seq_len) int32."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    toks = rng.choice(vocab, size=(n_seqs, seq_len), p=probs)
    # inject bigram structure: with prob .5, t[i+1] = (t[i]*7+3) % vocab
    follow = rng.rand(n_seqs, seq_len) < 0.5
    for i in range(seq_len - 1):
        nxt = (toks[:, i] * 7 + 3) % vocab
        toks[:, i + 1] = np.where(follow[:, i], nxt, toks[:, i + 1])
    return toks.astype(np.int32)
