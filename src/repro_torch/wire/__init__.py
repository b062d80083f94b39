"""The materialized wire (bit-plane packed uint32 words, packet framing,
counter-PRF bit channel) in PyTorch."""
