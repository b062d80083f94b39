"""Mamba2 block via the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060] (the port of ``repro.models.ssm``).

Training and prefill use the chunked form: within-chunk decay matrices
(exp of masked differences of the cumulative log decay; the -inf above
the diagonal gives 0, and a 0 gradient) and an inter-chunk recurrence,
here a Python loop over the chunks where the reference runs
``lax.scan``.  The depthwise causal conv is the reference's stack of
shifted copies contracted by ``einsum``.  Decode is the exact recurrence
h <- exp(dt A) h + dt B x, y = C h, with O(1) state a token.

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
from repro_torch.models.common import dense_init, gated_rms_norm, softplus

Tensor = torch.Tensor


def _dims(cfg: ModelConfig):
    inner = cfg.ssm_inner
    nh = cfg.ssm_heads
    s = cfg.ssm_state
    conv_dim = inner + 2 * s
    return inner, nh, s, conv_dim


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

def _split_proj(cfg: ModelConfig, zxbcdt: Tensor):
    inner, nh, s, _ = _dims(cfg)
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
                  return_cache: bool = False):
    """u: (B, T, D) -> y (B, T, D) [, cache {'conv', 'ssm'}]."""
    B, T, _ = u.shape
    inner, nh, s, conv_dim = _dims(cfg)
    P = cfg.ssm_headdim

    zxbcdt = u @ params['in_proj']
    z, xBC_raw, dt_raw = _split_proj(cfg, zxbcdt)
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
    y = gated_rms_norm(y, z, params['norm_scale'], cfg.norm_eps)
    out = y @ params['out_proj']
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
                     device=None) -> dict:
    inner, nh, s, conv_dim = _dims(cfg)
    return {
        'conv': torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
        'ssm': torch.zeros((batch, nh, cfg.ssm_headdim, s), dtype=dtype,
                           device=device),
    }


def mamba_decode(params, cfg: ModelConfig, u: Tensor, cache: dict):
    """u: (B, 1, D); the exact recurrent step in the cache's dtype.
    Returns (y (B, 1, D) in u's dtype, new cache)."""
    B = u.shape[0]
    inner, nh, s, conv_dim = _dims(cfg)
    P = cfg.ssm_headdim
    cdt = cache['ssm'].dtype

    zxbcdt = u @ params['in_proj']
    z, xBC_new, dt_raw = _split_proj(cfg, zxbcdt)     # (B, 1, .)

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
    y = gated_rms_norm(y, z, params['norm_scale'], cfg.norm_eps)
    return y @ params['out_proj'], {'conv': new_conv, 'ssm': h}
