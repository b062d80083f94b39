"""RoundTelemetry — the typed per-round record of the SP-FL stack (the
port of ``repro.obs.record``; same field names, row keys and schema).

The first five fields exist on every round; the trailing ones are filled
by the paths that measure them (``channel='bitlevel'`` for the CRC state,
the packed wire for votes, the training loop's :meth:`with_allocation`
for the allocation state, ``spfl_aggregate``'s ``active`` and ``screen``
for the adversarial fields, the population loop for ``cohort_ids``) and
stay ``None`` elsewhere.  Fields are device tensors, or host numbers
where the round made them on the host (``round_idx``; the 'numpy'
backend's objective and effort).

Two serializers share one schema:

* :func:`round_scalars` — the per-round scalar summary as device
  scalars, keyed like the matching ``FLHistory`` lists (``SCALAR_KEYS``);
* :func:`to_row` — a JSON-safe row of a HOST record (after the ring's
  flush), carrying the scalar summary, the per-client vectors
  (``VECTOR_KEYS``) and the bit channel's empirical-vs-calibrated
  erasure-rate pair.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor

# scalar summary keys — the per-round FLHistory list names
SCALAR_KEYS = ('payload_bits', 'retransmissions', 'sign_ok_frac',
               'mod_ok_frac', 'q_mean', 'p_mean', 'sign_agreement',
               'alloc_iters', 'alloc_exit_reason', 'participation_frac',
               'suspect_frac')
# per-client (K,) vectors serialized into rows when present
VECTOR_KEYS = ('sign_ok', 'mod_ok', 'accepted', 'sign_flips', 'mod_flips',
               'sign_crc_ok', 'mod_crc_ok', 'retx_attempts', 'q', 'p',
               'active', 'suspect', 'suspicion', 'cohort_ids')


class RoundTelemetry(NamedTuple):
    sign_ok: Tensor          # (K,) bool — sign packet decoded
    mod_ok: Tensor           # (K,) bool — modulus packet decoded
    accepted: Tensor         # (K,) bool — client contributed to the update
    payload_bits: Tensor     # scalar — total uplink payload this round
    retransmissions: Tensor  # scalar — total sign resends this round
    sign_flips: Optional[Tensor] = None    # (K,) channel bit flips (sign)
    mod_flips: Optional[Tensor] = None     # (K,) channel bit flips (mod)
    sign_crc_ok: Optional[Tensor] = None   # (K,) first-attempt CRC verify
    mod_crc_ok: Optional[Tensor] = None    # (K,) modulus CRC verify
    retx_attempts: Optional[Tensor] = None  # (K,) per-client resend count
    sign_votes: Optional[Tensor] = None    # (l,) int32 +1 sign votes among
    #   accepted clients (packed wire, K <= 32)
    q: Optional[Tensor] = None             # (K,) allocated sign success prob
    p: Optional[Tensor] = None             # (K,) allocated mod success prob
    alloc_objective: Optional[Any] = None  # eq. (28) objective
    round_idx: Optional[int] = None        # round number
    agreement: Optional[Tensor] = None     # scalar — the sign-vote
    #   agreement (:meth:`condensed`); supersedes ``sign_votes`` when set
    alloc_iters: Optional[Any] = None      # solver outer iterations
    alloc_exit_reason: Optional[Any] = None  # 0 converged, 1 cap,
    #   2 non-finite, 3 uniform fallback
    active: Optional[Tensor] = None        # (K,) bool — not dropped this
    #   round (stragglers, arrivals; None = everyone)
    suspect: Optional[Tensor] = None       # (K,) bool — screened out (its
    #   weight gated to 0)
    suspicion: Optional[Tensor] = None     # (K,) f32 — the robust-z score
    #   behind the verdict
    cohort_ids: Optional[Tensor] = None    # (K,) int64 — global device ids
    #   of the sampled cohort (population mode; uint32 values)

    def with_allocation(self, q, p, objective=None, round_idx=None,
                        iters=None, exit_reason=None) -> 'RoundTelemetry':
        """Attach the round's allocation state."""
        return self._replace(q=q, p=p, alloc_objective=objective,
                             round_idx=round_idx, alloc_iters=iters,
                             alloc_exit_reason=exit_reason)

    def to_host(self) -> 'RoundTelemetry':
        """Every tensor field as a NumPy array on the host (one copy
        each; the training loop flushes its ring instead)."""
        return self._replace(**{
            name: val.detach().cpu().numpy()
            for name, val in self._asdict().items()
            if isinstance(val, torch.Tensor)})

    def condensed(self) -> 'RoundTelemetry':
        """Reduce the (l,) vote vector to the agreement scalar on the
        device, so a ring slot stays O(K)."""
        if self.sign_votes is None:
            return self
        return self._replace(
            sign_votes=None,
            agreement=sign_agreement(self.sign_votes, self.sign_ok))


def sign_agreement(sign_votes: Optional[Tensor], sign_ok: Tensor
                   ) -> Tensor:
    """Mean |2 v_i - K_ok| / K_ok over coordinates, an f32 device scalar:
    1 when every accepted client agrees on every sign; NaN without votes
    or accepted packets.  The sum of these integers is exact in float32
    and both divisions are IEEE quotients, so the value is the host
    NumPy mean's on every device."""
    n_ok = torch.sum(sign_ok.to(torch.float32))
    if sign_votes is None:
        return torch.full((), math.nan, device=sign_ok.device)
    v = sign_votes.to(torch.float32)
    total = torch.sum(torch.abs(2.0 * v - n_ok))
    mean = total / torch.full((), float(v.numel()), device=v.device)
    agree = mean / torch.clamp(n_ok, min=1.0)
    return torch.where(n_ok > 0, agree, math.nan)


def _mean32(x, device) -> Tensor:
    return torch.mean(torch.as_tensor(x, device=device).to(torch.float32))


def round_scalars(t: RoundTelemetry) -> Dict[str, Tensor]:
    """The per-round scalar summary as device scalars, keyed by
    ``SCALAR_KEYS``."""
    dev = t.sign_ok.device

    def scalar(x):
        return torch.full((), math.nan, device=dev) if x is None else (
            torch.as_tensor(x, device=dev).to(torch.float32))

    return {
        'payload_bits': scalar(t.payload_bits),
        'retransmissions': scalar(t.retransmissions),
        'sign_ok_frac': _mean32(t.sign_ok, dev),
        'mod_ok_frac': _mean32(t.mod_ok, dev),
        'q_mean': scalar(None) if t.q is None else _mean32(t.q, dev),
        'p_mean': scalar(None) if t.p is None else _mean32(t.p, dev),
        'sign_agreement': (scalar(t.agreement) if t.agreement is not None
                           else sign_agreement(t.sign_votes, t.sign_ok)),
        'alloc_iters': scalar(t.alloc_iters),
        'alloc_exit_reason': scalar(t.alloc_exit_reason),
        'participation_frac': (scalar(None) if t.active is None
                               else _mean32(t.active, dev)),
        'suspect_frac': (scalar(None) if t.suspect is None
                         else _mean32(t.suspect, dev)),
    }


# ---------------------------------------------------------------------------
# host-side serialization (after the ring's flush)
# ---------------------------------------------------------------------------

def _np_scalar(x) -> float:
    return float(np.asarray(x))


def _frac(x) -> float:
    return float(np.asarray(x, np.float32).mean())


def to_row(t: RoundTelemetry, round_idx: Optional[int] = None
           ) -> Dict[str, Any]:
    """One JSON-safe row from a HOST record (NumPy arrays and numbers):
    scalars under ``SCALAR_KEYS``, per-client vectors under
    ``VECTOR_KEYS`` (``None`` where the path did not measure them), and
    the bit channel's empirical-vs-calibrated erasure rates."""
    sign_ok = np.asarray(t.sign_ok)
    n_ok = float(sign_ok.astype(np.float32).sum())
    if t.agreement is not None:
        agreement = float(np.asarray(t.agreement))
    elif t.sign_votes is not None and n_ok > 0:
        v = np.asarray(t.sign_votes, np.float32)
        agreement = float(np.mean(np.abs(2.0 * v - n_ok)) / n_ok)
    else:
        agreement = math.nan
    if round_idx is None and t.round_idx is not None:
        round_idx = int(np.asarray(t.round_idx))
    row: Dict[str, Any] = {
        'round': round_idx,
        'payload_bits': _np_scalar(t.payload_bits),
        'retransmissions': _np_scalar(t.retransmissions),
        'sign_ok_frac': _frac(sign_ok),
        'mod_ok_frac': _frac(t.mod_ok),
        'q_mean': math.nan if t.q is None else _frac(t.q),
        'p_mean': math.nan if t.p is None else _frac(t.p),
        'sign_agreement': agreement,
        'alloc_iters': math.nan if t.alloc_iters is None
        else _np_scalar(t.alloc_iters),
        'alloc_exit_reason': math.nan if t.alloc_exit_reason is None
        else _np_scalar(t.alloc_exit_reason),
        'alloc_objective': None if t.alloc_objective is None
        else _np_scalar(t.alloc_objective),
        'participation_frac': math.nan if t.active is None
        else _frac(t.active),
        'suspect_frac': math.nan if t.suspect is None else _frac(t.suspect),
    }
    for name in VECTOR_KEYS:
        val = getattr(t, name)
        row[name] = None if val is None else np.asarray(val).tolist()
    # the calibration contract: the DETECTED first-attempt erasure rate
    # reproduces 1 - q / 1 - p
    if t.sign_crc_ok is not None:
        row['sign_erasure_emp'] = 1.0 - _frac(t.sign_crc_ok)
        row['sign_erasure_cal'] = None if t.q is None else 1.0 - _frac(t.q)
    if t.mod_crc_ok is not None:
        row['mod_erasure_emp'] = 1.0 - _frac(t.mod_crc_ok)
        row['mod_erasure_cal'] = None if t.p is None else 1.0 - _frac(t.p)
    return row
