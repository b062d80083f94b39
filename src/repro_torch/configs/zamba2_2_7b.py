"""zamba2-2.7b — Mamba2 backbone + shared attention blocks [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

# 54 layers arranged as 9 groups of (5 mamba + 1 shared attention block);
# the attention block weights are shared across all 9 occurrences
# (Zamba2's shared transformer block).
CONFIG = ModelConfig(
    name='zamba2-2.7b',
    arch_type='hybrid',
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_headdim=64,
    layer_pattern=('mamba', 'mamba', 'mamba', 'mamba', 'mamba', 'shared_attn'),
    subquadratic=True,
    citation='[arXiv:2411.15242] Zamba2 — Mamba2 + shared attn blocks',
)
