"""Fault injection and screening for the FL round (the port of
``repro.adversary``): byzantine clients, stragglers/dropouts, and the
packed-domain defense that gates them out.

* ``clients``: the attacker transforms (sign flip, scaled update, label
  flip) on the packed payload words or the quantizer state, and the
  Gilbert straggler chain;
* ``screen``: per-client suspicion from sign-vote disagreement
  (``wire.vote``, no unpack) and robust z-scores of the modulus headers'
  range scalars, as a multiplicative gate on the decode-once kernel's
  weights.

The random inputs (the byzantine permutation, the straggler uniforms)
are explicit arguments.
"""
from repro_torch.adversary.clients import (  # noqa: F401
    ATTACK_KINDS, BYZ_FOLD, STRAGGLER_FOLD, bernoulli_active,
    byzantine_mask, flip_labels, flip_signs, scale_range, scale_ranges,
    signflip_frames, straggler_init, straggler_probs, straggler_step,
)
from repro_torch.adversary.screen import robust_z, screen_gate  # noqa: F401
