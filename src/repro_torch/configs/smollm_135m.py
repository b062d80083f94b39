"""smollm-135m — small llama-architecture dense model
[hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name='smollm-135m',
    arch_type='dense',
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    layer_pattern=('attn',),
    citation='[hf:HuggingFaceTB/SmolLM-135M] — llama-arch small, GQA kv=3',
)
