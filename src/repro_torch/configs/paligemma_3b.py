"""paligemma-3b — SigLIP vision encoder + gemma decoder [arXiv:2407.07726].

Per the harness carve-out, the SigLIP ViT + projector is a STUB:
``input_specs()`` supplies precomputed patch embeddings (256 patches) of the
right shape; this module is the gemma-style language decoder that consumes
them (MQA, kv=1).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='paligemma-3b',
    arch_type='vlm',
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    layer_pattern=('attn',),
    frontend='vision',
    n_prefix_tokens=256,          # SigLIP 224px/14 -> 256 patches
    frontend_embed_dim=1152,      # SigLIP-So400m width
    tie_embeddings=True,
    embed_scale=True,
    citation='[arXiv:2407.07726] PaliGemma — SigLIP + gemma, MQA kv=1',
)
