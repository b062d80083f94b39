"""Mamba2 block via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060] (the port of ``repro.models.ssm``).

Training and prefill use the chunked form: within-chunk decay matrices
(exp of masked differences of the cumulative log decay; the -inf above
the diagonal gives 0, and a 0 gradient) and an inter-chunk recurrence,
here a Python loop over the chunks where the reference runs
``lax.scan``.  The depthwise causal conv is the reference's stack of
shifted copies contracted by ``einsum``.  Decode is the exact recurrence
h <- exp(dt A) h + dt B x, y = C h, with O(1) state a token.

With a ``tp`` partition whose SSM is split (``models.parallel``: the
'model' axis), the block computes with the rank's heads: ``params`` are
then its compute blocks (``training.model_axis`` hands them over: the
``in_proj`` columns of ``parallel.ssm_columns``, the conv channels of
``parallel.conv_channels``, its heads' ``A_log``, ``D`` and ``dt_bias``,
its block of ``norm_scale`` and its row block of ``out_proj``), ``in_proj``
a column product, the norm's mean of squares summed over the ranks,
``out_proj`` a row product; the decode state is the rank's heads and its
conv window the rank's x channels with B and C whole.

``A_log``, ``D`` and ``dt_bias`` are float32 leaves in a bf16 model, as
in the reference.  The decode state lives in the cache's dtype (the
serving engine's float32): the step reads the new token's projections
into it and hands its output back in the block's dtype (the reference's
decode mixes the two dtypes in its scan carry and raises on a bf16
model; on float32 models the two are the same computation).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import parallel
from repro_torch.models.common import (
    dense_init, dot, gated_rms_norm, softplus,
)

Tensor = torch.Tensor


def _split(tp) -> bool:
    return tp is not None and tp.ssm


def _dims(cfg: ModelConfig, tp=None):
    """(inner, heads, state, conv channels) of the block, or of the
    rank's part of it under a split ``tp``."""
    m = tp.size if _split(tp) else 1
    inner = cfg.ssm_inner // m
    nh = cfg.ssm_heads // m
    s = cfg.ssm_state
    conv_dim = inner + 2 * s
    return inner, nh, s, conv_dim


def _in_proj(params, u: Tensor, tp) -> Tensor:
    if _split(tp):
        return parallel.column(u, tp)(params['in_proj'])
    return dot(u, params['in_proj'])


def _out(params, cfg: ModelConfig, y: Tensor, z: Tensor, tp) -> Tensor:
    """The gated norm and ``out_proj`` (a row product under ``tp``)."""
    if _split(tp):
        y = parallel.gated_rms_norm(y, z, params['norm_scale'],
                                    cfg.norm_eps, tp)
        return parallel.row(y, params['out_proj'], tp)
    y = gated_rms_norm(y, z, params['norm_scale'], cfg.norm_eps)
    return dot(y, params['out_proj'])


def init_mamba(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype, device=None) -> dict:
    d = cfg.d_model
    inner, nh, s, conv_dim = _dims(cfg)
    proj_out = 2 * inner + 2 * s + nh           # z, xBC, dt
    lo, hi = np.log(1e-3), np.log(1e-1)
    u = torch.rand((nh,), generator=generator, dtype=torch.float32,
                   device=device)
    dt = torch.exp(u * float(hi - lo) + float(lo))
    conv_w = torch.randn((cfg.conv_width, conv_dim), generator=generator,
                         dtype=torch.float32, device=device) * 0.1
    return {
        'in_proj': dense_init(generator, d, proj_out, dtype, device),
        'conv_w': conv_w.to(dtype),
        'conv_b': torch.zeros((conv_dim,), dtype=dtype, device=device),
        'A_log': torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                        device=device)),
        'D': torch.ones((nh,), dtype=torch.float32, device=device),
        'dt_bias': dt + torch.log(-torch.expm1(-dt)),   # inverse softplus
        'norm_scale': torch.zeros((inner,), dtype=dtype, device=device),
        'out_proj': dense_init(generator, inner, d, dtype, device),
    }


# ---------------------------------------------------------------------------
# chunked SSD scan (training / prefill)
# ---------------------------------------------------------------------------

def _segsum_decay(cum: Tensor) -> Tensor:
    """cum: (..., Q, H) within-chunk cumulative log decay -> the lower
    triangular decay matrix L[t, j] = exp(cum_t - cum_j), j <= t, shape
    (..., H, Q, Q)."""
    diff = cum[..., :, None, :] - cum[..., None, :, :]     # (..., Q, Q, H)
    Q = cum.shape[-2]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=cum.device))
    diff = torch.where(mask[..., None], diff, -torch.inf)
    return torch.exp(diff).movedim(-1, -3)                 # (..., H, Q, Q)


def ssd_chunked(x_dt: Tensor, dA: Tensor, Bm: Tensor, Cm: Tensor,
                chunk: int = 256, initial_state: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
    """SSD scan.

    x_dt: (B, T, H, P) inputs pre-multiplied by dt
    dA:   (B, T, H)    per-step log decay (dt * A, A < 0)
    Bm:   (B, T, S)    input projection (single group, broadcast over heads)
    Cm:   (B, T, S)    output projection
    Returns y: (B, T, H, P) and the final state (B, H, P, S).
    """
    B, T, H, P = x_dt.shape
    S = Bm.shape[-1]
    Q = min(chunk, T)
    assert T % Q == 0, f'seq {T} not divisible by chunk {Q}'
    nc = T // Q
    dt = x_dt.dtype

    xc = x_dt.reshape(B, nc, Q, H, P)
    dAc = dA.reshape(B, nc, Q, H).to(torch.float32)
    Bc = Bm.reshape(B, nc, Q, S)
    Cc = Cm.reshape(B, nc, Q, S)

    cum = torch.cumsum(dAc, dim=2)                      # (B, nc, Q, H)
    L = _segsum_decay(cum)                              # (B, nc, H, Q, Q)
    CB = torch.einsum('bcqs,bcjs->bcqj', Cc, Bc)        # (B, nc, Q, Q)
    y_diag = torch.einsum('bchqj,bcqj,bcjhp->bcqhp', L.to(dt), CB.to(dt),
                          xc)

    total = cum[:, :, -1]                               # (B, nc, H)
    decay_states = torch.exp(total[:, :, None] - cum)   # (B, nc, Q, H)
    states = torch.einsum('bcqh,bcqs,bcqhp->bchps', decay_states.to(dt), Bc,
                          xc)
    chunk_decay = torch.exp(total).to(dt)               # (B, nc, H)
    out_decay = torch.exp(cum).to(dt)                   # (B, nc, Q, H)

    h = (initial_state if initial_state is not None
         else torch.zeros((B, H, P, S), dtype=dt, device=x_dt.device))
    y_off = []
    for c in range(nc):
        y_off.append(torch.einsum('bqs,bhps,bqh->bqhp', Cc[:, c], h,
                                  out_decay[:, c]))
        h = h * chunk_decay[:, c][:, :, None, None] + states[:, c]
    y = y_diag + torch.stack(y_off, dim=1)
    return y.reshape(B, T, H, P), h


# ---------------------------------------------------------------------------
# block-level forward / decode
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, zxbcdt: Tensor, tp=None):
    inner, nh, s, _ = _dims(cfg, tp)
    z = zxbcdt[..., :inner]
    xBC = zxbcdt[..., inner:inner + inner + 2 * s]
    dt = zxbcdt[..., inner + inner + 2 * s:]
    return z, xBC, dt


def _causal_conv(xBC: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv, width W: y_t = sum_i w[i] x_{t-W+1+i}."""
    W = w.shape[0]
    pads = [xBC]
    for i in range(1, W):
        pads.append(F.pad(xBC, (0, 0, i, 0))[:, :-i])
    stack = torch.stack(pads[::-1], dim=2)    # (B, T, W, C) oldest..newest
    y = torch.einsum('btwc,wc->btc', stack, w.to(xBC.dtype))
    return F.silu(y + b.to(xBC.dtype))


def mamba_forward(params, cfg: ModelConfig, u: Tensor,
                  return_cache: bool = False, tp=None):
    """u: (B, T, D) -> y (B, T, D) [, cache {'conv', 'ssm'}] (the rank's
    heads' under a split ``tp``)."""
    B, T, _ = u.shape
    inner, nh, s, conv_dim = _dims(cfg, tp)
    P = cfg.ssm_headdim

    zxbcdt = _in_proj(params, u, tp)
    z, xBC_raw, dt_raw = _split_proj(cfg, zxbcdt, tp)
    xBC = _causal_conv(xBC_raw, params['conv_w'], params['conv_b'])
    x = xBC[..., :inner].reshape(B, T, nh, P)
    Bm = xBC[..., inner:inner + s]
    Cm = xBC[..., inner + s:]

    dt = softplus(dt_raw.to(torch.float32) + params['dt_bias'])
    A = -torch.exp(params['A_log'])                   # (nh,)
    dA = dt * A                                       # (B, T, nh)
    x_dt = x * dt.to(x.dtype)[..., None]

    y, h_final = ssd_chunked(x_dt, dA, Bm, Cm)
    y = y + x * params['D'].to(x.dtype)[:, None]
    y = y.reshape(B, T, inner)
    out = _out(params, cfg, y, z, tp)
    if not return_cache:
        return out
    # the conv window holds the *pre-activation* conv inputs
    Wd = cfg.conv_width
    if T >= Wd - 1:
        conv_state = xBC_raw[:, T - (Wd - 1):]
    else:
        conv_state = F.pad(xBC_raw, (0, 0, Wd - 1 - T, 0))
    return out, {'conv': conv_state, 'ssm': h_final}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device=None, tp=None) -> dict:
    """Zero conv window and state (the rank's under a split ``tp``)."""
    inner, nh, s, conv_dim = _dims(cfg, tp)
    return {
        'conv': torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        'ssm': torch.zeros((batch, nh, cfg.ssm_headdim, s), dtype=dtype,
                           device=device),
    }


def mamba_decode(params, cfg: ModelConfig, u: Tensor, cache: dict,
                 tp=None):
    """u: (B, 1, D); the exact recurrent step in the cache's dtype (the
    rank's heads under a split ``tp``).  Returns (y (B, 1, D) in u's
    dtype, new cache)."""
    B = u.shape[0]
    inner, nh, s, conv_dim = _dims(cfg, tp)
    P = cfg.ssm_headdim
    cdt = cache['ssm'].dtype

    zxbcdt = _in_proj(params, u, tp)
    z, xBC_new, dt_raw = _split_proj(cfg, zxbcdt, tp)  # (B, 1, .)

    window = torch.cat([cache['conv'], xBC_new.to(cache['conv'].dtype)],
                       dim=1)                         # (B, W, C)
    y_conv = torch.einsum('bwc,wc->bc', window,
                          params['conv_w'].to(window.dtype))
    xBC = F.silu(y_conv + params['conv_b'].to(window.dtype)).to(cdt)
    new_conv = window[:, 1:]

    x = xBC[..., :inner].reshape(B, nh, P)
    Bm = xBC[..., inner:inner + s]                    # (B, S)
    Cm = xBC[..., inner + s:]

    dt = softplus(dt_raw[:, 0].to(torch.float32) + params['dt_bias'])
    A = -torch.exp(params['A_log'])
    decay = torch.exp(dt * A).to(cdt)                 # (B, nh)
    h = cache['ssm']                                  # (B, nh, P, S)
    add = torch.einsum('bhp,bs,bh->bhps', x, Bm, dt.to(cdt))
    h = h * decay[..., None, None] + add
    y = torch.einsum('bs,bhps->bhp', Cm, h)
    y = y + x * params['D'].to(cdt)[:, None]
    y = y.reshape(B, 1, inner).to(u.dtype)
    return _out(params, cfg, y, z, tp), {'conv': new_conv, 'ssm': h}
