"""arctic-480b — 128-expert top-2 MoE with dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='arctic-480b',
    arch_type='moe',
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    topk=2,
    dense_residual=True,
    layer_pattern=('attn',),
    citation='[hf:Snowflake/snowflake-arctic-base] — 128e top-2 + dense residual',
)
