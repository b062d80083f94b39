"""Packed-domain screening: per-client suspicion -> weight gate (the port
of ``repro.adversary.screen``).

Two statistics the PS already holds, neither of which decodes a payload:

* **Sign-vote disagreement** (packed wire): each client's Hamming
  distance to the majority sign word (``wire.vote``).  A sign-flipping
  client is anti-correlated with the majority; only clients disagreeing
  on more than half their lanes are eligible.
* **Norm-report outliers**: a robust z-score (median/MAD) of the log of
  the ``g_max`` range scalar from the modulus headers, which the
  scaled-update attack inflates.

Both are median/MAD with a floor on the MAD scale, so a tight benign
cohort cannot turn round-off into false positives: with no attacker the
gate is exactly 1.0 and ``w * 1.0`` leaves the aggregate bit-identical.
The verdict is a {0, 1} gate on the decode-once kernel's weights (a
zero-weight row is a no-op there).

The median is ``jnp.nanmedian``'s (``_nanmedian``): the mean of the two
middle values of the valid ones (method 'midpoint'), where
``torch.nanmedian`` takes the lower one.  Nothing here reads a value back
to the host.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import true_div

Tensor = torch.Tensor

# MAD floors: at z = 4 a client must disagree with the majority on >= 20
# percentage points more lanes than the median client (0.05 * 4), or
# report a range >= e**1.4 ~ 4x off the median (0.35 * 4).
VOTE_MAD_FLOOR = 0.05      # disagreement-fraction space
NORM_MAD_FLOOR = 0.35      # log-range space
# anti-majority rule: frac > 1/2 + ANTI_EPS while the median client sits
# below 1/2 - CONSENSUS_EPS is flagged outright (only a sign-mirrored
# client disagrees with a consensual cohort on more than half its lanes)
VOTE_ANTI_EPS = 0.02       # client-side anti-majority margin
VOTE_CONSENSUS_EPS = 0.05  # cohort-side consensus margin on the median


def _nanmedian(x: Tensor) -> Tensor:
    """Median of the non-NaN entries of the 1-D f32 ``x`` as
    ``jnp.nanmedian`` computes it: sorted valid values a[0..c-1],
    q = 0.5 (c - 1), low/high = floor/ceil(q) clamped to [0, c - 1], and
    (a[low] + a[high]) * 0.5 in f32.  NaN when no entry is valid."""
    nan = torch.isnan(x)
    # NaNs sort after every valid value (+inf ties do not matter: only
    # the first c positions are read)
    a = torch.sort(torch.where(nan, torch.inf, x)).values
    c = torch.sum(~nan).to(torch.float32)
    q = 0.5 * (c - 1.0)
    top = c - 1.0
    low = torch.clamp(torch.minimum(torch.floor(q), top), min=0.0)
    high = torch.clamp(torch.minimum(torch.ceil(q), top), min=0.0)
    # gathered with a device index (indexing with a 0-d tensor reads it
    # back to the host, which a captured round cannot)
    ends = a.index_select(0, torch.stack([low, high]).to(torch.int64))
    mid = (ends[0] + ends[1]) * 0.5
    return torch.where(c > 0.0, mid, torch.nan)


def robust_z(x: Tensor, valid: Tensor, floor: float) -> Tensor:
    """|x - median| / max(1.4826 * MAD, floor) over the valid rows.
    Median and MAD are of the valid subset only; invalid rows and a
    cohort with no valid row score 0."""
    xn = torch.where(valid, x, torch.nan)
    med = _nanmedian(xn)
    mad = _nanmedian(torch.abs(xn - med))
    z = torch.abs(x - med) / torch.clamp(1.4826 * mad, min=floor)
    return torch.where(valid & torch.isfinite(z), z, 0.0)


def screen_gate(g_max: Tensor, mod_valid: Tensor, disagree=None,
                n_lanes: int = 0, sign_valid=None, z_thresh: float = 4.0):
    """Suspicion scores -> multiplicative weight gate.

    g_max: (K,) or (K, 1) reported range scalars; mod_valid: (K,) bool
    rows whose norm report counts (CRC-ok, not dropped).  ``disagree``
    (K,) int, ``n_lanes`` and ``sign_valid`` (K,) bool add the sign-vote
    test (packed wire).  -> (gate (K,) f32 in {0, 1}, suspect (K,) bool,
    suspicion (K,) f32, the max of the z-scores)."""
    logr = torch.log(torch.clamp(g_max.reshape(-1), min=1e-30))
    suspicion = robust_z(logr, mod_valid, NORM_MAD_FLOOR)
    if disagree is not None:
        frac = true_div(disagree.to(torch.float32), float(max(int(n_lanes),
                                                              1)))
        z_vote = robust_z(frac, sign_valid, VOTE_MAD_FLOOR)
        z_vote = torch.where(frac > 0.5, z_vote, 0.0)   # anti-majority only
        med = _nanmedian(torch.where(sign_valid, frac, torch.nan))
        anti = (sign_valid & (frac > 0.5 + VOTE_ANTI_EPS)
                & (med < 0.5 - VOTE_CONSENSUS_EPS))
        z_vote = torch.where(anti, torch.clamp(z_vote, min=2.0 * z_thresh),
                             z_vote)
        suspicion = torch.maximum(suspicion, z_vote)
    suspect = suspicion > z_thresh
    gate = torch.where(suspect, 0.0, 1.0)
    return gate, suspect, suspicion
