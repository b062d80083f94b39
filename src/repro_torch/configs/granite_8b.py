"""granite-8b — llama-architecture dense code model [arXiv:2405.04324]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='granite-8b',
    arch_type='dense',
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=10_000.0,
    layer_pattern=('attn',),
    citation='[arXiv:2405.04324] Granite Code Models — llama-arch, GQA kv=8',
)
