"""musicgen-medium — decoder-only LM over EnCodec audio tokens
[arXiv:2306.05284].

Per the harness carve-out, the EnCodec tokenizer / conv feature extractor is
a STUB: ``input_specs()`` supplies token ids in the 2048-entry EnCodec
codebook (and, for conditioned generation, precomputed frame embeddings).
This module is the transformer backbone only.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='musicgen-medium',
    arch_type='audio',
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    layer_pattern=('attn',),
    frontend='audio',
    n_prefix_tokens=0,       # tokens ARE the EnCodec codes; no prefix needed
    citation='[arXiv:2306.05284] MusicGen — decoder-only over EnCodec tokens',
)
