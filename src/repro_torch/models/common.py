"""Shared neural-net primitives of the model zoo (the port of
``repro.models.common``): initializers, the ``1 + scale`` RMS norm, soft
capping, rotary embeddings and the sequence-chunked cross-entropy, as
torch ops on parameter trees of tensors.

The reference's mesh helpers (``current_mesh_axes``, ``maybe_constrain``,
``client_mesh_axes``) are sharding hints for GSPMD with no numerical
effect; they are not ported.

:func:`dot` is every product without a batch dimension of the blocks
(``x @ w`` with a weight matrix ``w``): the unit that the 'dots'
recomputation policy keeps (``transformer.forward``; the reference's
``checkpoint_dots_with_no_batch_dims``).  Inside :func:`recording` it
appends each product to a list; inside :func:`replaying` it hands back
those products in the same order instead of multiplying again.
"""
from __future__ import annotations

import contextlib
import functools
from typing import List, Optional

import numpy as np
import torch

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# products without a batch dimension ('dots')
# ---------------------------------------------------------------------------

class _Tape:
    """What :func:`dot` does now: multiply (``mode`` None), multiply and
    keep the product ('record'), or take the next kept one ('replay')."""
    mode: Optional[str] = None
    products: List[Tensor] = []
    at: int = 0


def _mm_grad(x: Tensor, w: Tensor, g: Tensor):
    """The gradients of ``x @ w`` (x (..., D), w (D, F)) as autograd
    takes them from the product's fold ``x.reshape(-1, D).mm(w)``
    (``mm_mat1_backward``, ``mm_mat2_backward``; both operands row-major),
    so that a kept product's backward has the bits of a computed one."""
    g2 = g.reshape(-1, g.shape[-1])
    x2 = x.reshape(-1, x.shape[-1])
    return g2.mm(w.t()).reshape(x.shape), x2.t().mm(g2)


class _KeptProduct(torch.autograd.Function):
    """``x @ w`` whose value was kept by a recording pass: forward hands
    back ``out``, backward is the product's."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, w, out):
        return out.view_as(out)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, _ = inputs
        ctx.save_for_backward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx, gw = _mm_grad(x, w, g)
        return gx, gw, None


def dot(x: Tensor, w: Tensor) -> Tensor:
    """``x @ w`` (x (..., D), w (D, F)): a product with no batch
    dimension, kept or replayed as the current tape says."""
    if _Tape.mode == 'replay':
        out = _Tape.products[_Tape.at]
        _Tape.at += 1
        return _KeptProduct.apply(x, w, out)
    out = x @ w
    if _Tape.mode == 'record':
        _Tape.products.append(out)
    return out


@contextlib.contextmanager
def recording():
    """Inside: every :func:`dot` also appends its product to the list
    this yields."""
    before = (_Tape.mode, _Tape.products, _Tape.at)
    _Tape.mode, _Tape.products, _Tape.at = 'record', [], 0
    try:
        yield _Tape.products
    finally:
        _Tape.mode, _Tape.products, _Tape.at = before


@contextlib.contextmanager
def replaying(products):
    """Inside: every :func:`dot` hands back the next of ``products`` (a
    recording's, in its order) with the product's backward."""
    before = (_Tape.mode, _Tape.products, _Tape.at)
    _Tape.mode, _Tape.products, _Tape.at = 'replay', list(products), 0
    try:
        yield
    finally:
        _Tape.mode, _Tape.products, _Tape.at = before

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
