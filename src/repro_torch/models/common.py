"""Shared neural-net primitives of the model zoo (the port of
``repro.models.common``): initializers, the ``1 + scale`` RMS norm, soft
capping, rotary embeddings and the sequence-chunked cross-entropy, as
torch ops on parameter trees of tensors.

The reference's mesh helpers (``current_mesh_axes``, ``maybe_constrain``,
``client_mesh_axes``) are sharding hints for GSPMD with no numerical
effect; they are not ported.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

Tensor = torch.Tensor

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
           'float16': torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# initialisers (random weights from an explicit generator)
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype, device=None) -> Tensor:
    scale = 1.0 / np.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=generator,
                    dtype=torch.float32, device=device) * float(scale)
    return w.to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype, device=None) -> Tensor:
    w = torch.randn((vocab, dim), generator=generator, dtype=torch.float32,
                    device=device) * 0.02
    return w.to(dtype)


# ---------------------------------------------------------------------------
# normalisation / activations
# ---------------------------------------------------------------------------

def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm in float32 with the ``1 + scale`` gain, cast back to x's
    dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.to(torch.float32))).to(dt)


def gated_rms_norm(x: Tensor, z: Tensor, scale: Tensor,
                   eps: float = 1e-6) -> Tensor:
    """Mamba2 output norm: RMSNorm(x * silu(z)), silu taken in float32
    and cast to x's dtype."""
    gate = torch.nn.functional.silu(z.to(torch.float32)).to(x.dtype)
    return rms_norm(x * gate, scale, eps)


def softplus(x: Tensor) -> Tensor:
    """``jax.nn.softplus`` as jax writes it (``logaddexp(x, 0)``):
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def softcap(x: Tensor, cap: float) -> Tensor:
    """Gemma2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _frequencies_on(head_dim: int, theta: float, device: str) -> Tensor:
    """``rope_frequencies`` on ``device``, copied there once a process,
    from pinned memory to a card (a copy from pageable host memory would
    wait for the card's queue); on 'meta' its shape alone."""
    host = torch.as_tensor(rope_frequencies(head_dim, theta))
    kind = torch.device(device).type
    if kind == 'cpu':
        return host
    if kind == 'cuda':
        return host.pin_memory().to(device, non_blocking=True)
    return host.to(device)


def rope_tables(positions: Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, float32 (..., T, 1, head_dim / 2),
    for ``apply_rope_tables``: a forward pass makes them once for all
    its layers."""
    freqs = _frequencies_on(head_dim, theta, str(positions.device))
    angles = positions[..., None].to(torch.float32) * freqs   # (..., T, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope_tables(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """x: (..., T, n_heads, head_dim) rotated by the tables of
    ``rope_tables``, in float32, cast back to x's dtype."""
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., T, n_heads, head_dim); positions: broadcastable to (..., T)."""
    return apply_rope_tables(x, *rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def chunked_softmax_xent(x: Tensor, embed_t: Tensor, labels: Tensor,
                         mask: Tensor, logit_softcap_val: float = 0.0,
                         chunk: int = 512) -> Tensor:
    """Cross-entropy over a large vocabulary without the whole (B, T, V)
    logits: x (B, T, D) final hidden states, embed_t (D, V), labels
    (B, T) int, mask (B, T) {0, 1}.  Sequence chunks of ``chunk``
    positions; each chunk's logits are a product in the parameters' dtype
    cast to float32, and its summed NLL is added to the float32 total in
    chunk order (the reference pads the last chunk with masked rows,
    which add 0)."""
    T = x.shape[1]
    n_chunks = max(1, (T + chunk - 1) // chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = torch.matmul(x[:, sl], embed_t)
        logits = softcap(logits, logit_softcap_val).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, sl, None].to(torch.int64)
                            )[..., 0]
        nll = (logz - gold) * mask[:, sl]
        total = total + torch.sum(nll)
    denom = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
    return total / denom
