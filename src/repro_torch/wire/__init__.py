"""The materialized wire (bit-plane packed uint32 words, packet framing,
counter-PRF bit channel) in PyTorch: the reference's re-exports, name for
name, and the packed-domain vote."""
from repro_torch.wire import corrupt, format, packets  # noqa: F401
from repro_torch.wire.corrupt import (  # noqa: F401
    corrupt_fold, corrupt_words, count_flips, flip_mask, flip_mask_ref,
    hash_bits,
)
from repro_torch.wire.format import (  # noqa: F401
    GROUP, MOD_HEADER_WORDS, SIGN_HEADER_WORDS, WORD_BITS,
    measured_uplink_bits, modulus_packet_words, pack_bits_ref,
    payload_words, sign_packet_words, unpack_bits_ref, verify_frame,
)
from repro_torch.wire.packets import (  # noqa: F401
    DecodedUplink, decode_client_uplink, decode_uplink_batch,
    encode_client_uplink, encode_uplink_batch, mod_header_ranges,
    mod_payload, restamp_sign_retx, sign_payload, verify_mod_words,
    verify_sign_words,
)
from repro_torch.wire.vote import (  # noqa: F401
    disagreement, lane_mask_words, majority_words,
)
