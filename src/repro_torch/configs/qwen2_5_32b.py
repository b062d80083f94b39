"""qwen2.5-32b — dense GQA decoder with QKV bias [hf:Qwen/Qwen2.5-0.5B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='qwen2.5-32b',
    arch_type='dense',
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    layer_pattern=('attn',),
    citation='[hf:Qwen/Qwen2.5-0.5B] — GQA kv=8, QKV bias',
)
