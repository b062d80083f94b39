"""The materialized wire (bit-plane packed uint32 words, packet framing,
counter-PRF bit channel) in PyTorch."""
from repro_torch.wire.vote import (  # noqa: F401
    disagreement, lane_mask_words, majority_words,
)
