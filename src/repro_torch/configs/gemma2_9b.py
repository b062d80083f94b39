"""gemma2-9b — alternating local/global attention with logit soft-capping
[arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='gemma2-9b',
    arch_type='dense',
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    sliding_window=4096,
    layer_pattern=('swa', 'attn'),       # local/global alternating
    attn_softcap=50.0,
    logit_softcap=30.0,
    tie_embeddings=True,
    post_norm=True,
    embed_scale=True,
    subquadratic=True,   # local layers are SWA; global layers decode via
                         # sequence-parallel attention (see DESIGN.md)
    citation='[arXiv:2408.00118] Gemma 2 — local+global alternating, softcap',
)
