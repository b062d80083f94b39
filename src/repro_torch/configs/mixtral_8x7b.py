"""mixtral-8x7b — sparse MoE (8 experts, top-2) with SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='mixtral-8x7b',
    arch_type='moe',
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    n_experts=8,
    topk=2,
    sliding_window=4096,
    layer_pattern=('swa',),
    rope_theta=1_000_000.0,
    subquadratic=True,   # SWA caps the KV cache -> long_500k applicable
    citation='[arXiv:2401.04088] Mixtral of Experts — 8e top-2, sliding window',
)
