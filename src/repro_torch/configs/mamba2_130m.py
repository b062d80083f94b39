"""mamba2-130m — attention-free SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='mamba2-130m',
    arch_type='ssm',
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    layer_pattern=('mamba',),
    tie_embeddings=True,
    subquadratic=True,
    citation='[arXiv:2405.21060] Mamba2 / SSD — attention-free',
)
