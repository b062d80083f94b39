"""RoundTelemetry — the per-round record of the flat SP-FL transport
(the port of the fields of ``repro.obs.record.RoundTelemetry`` that the
flat ``spfl`` transport and the host loop fill; same field names).

The first five fields exist on every round; the trailing ones are filled
by the paths that measure them (``channel='bitlevel'`` for the CRC state,
the packed wire for votes, the training loop's :meth:`with_allocation`
for the allocation state, ``spfl_aggregate``'s ``active`` and ``screen``
for the adversarial fields) and stay ``None`` elsewhere.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

Tensor = torch.Tensor


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
    alloc_objective: Optional[float] = None  # eq. (28) objective
    round_idx: Optional[int] = None        # round number
    alloc_iters: Optional[int] = None      # solver outer iterations
    alloc_exit_reason: Optional[int] = None  # 0 converged, 1 cap,
    #   2 non-finite, 3 uniform fallback
    active: Optional[Tensor] = None        # (K,) bool — not dropped this
    #   round (the straggler process; None = everyone)
    suspect: Optional[Tensor] = None       # (K,) bool — screened out (its
    #   weight gated to 0)
    suspicion: Optional[Tensor] = None     # (K,) f32 — the robust-z score
    #   behind the verdict

    def with_allocation(self, q, p, objective=None, round_idx=None,
                        iters=None, exit_reason=None) -> 'RoundTelemetry':
        """Attach the round's allocation state."""
        return self._replace(q=q, p=p, alloc_objective=objective,
                             round_idx=round_idx, alloc_iters=iters,
                             alloc_exit_reason=exit_reason)

    def to_host(self) -> 'RoundTelemetry':
        """Every tensor field as a NumPy array on the host (one copy each;
        the only device->host transfer of a round's telemetry)."""
        return self._replace(**{
            name: val.detach().cpu().numpy()
            for name, val in self._asdict().items()
            if isinstance(val, torch.Tensor)})


def sign_agreement(sign_votes, sign_ok) -> float:
    """Mean |2 v_i - K_ok| / K_ok over coordinates: 1 when every accepted
    client agrees on every sign; NaN without votes or accepted packets."""
    n_ok = float(np.asarray(sign_ok, np.float32).sum())
    if sign_votes is None or n_ok == 0.0:
        return math.nan
    v = np.asarray(sign_votes, np.float32)
    return float(np.mean(np.abs(2.0 * v - n_ok)) / n_ok)
