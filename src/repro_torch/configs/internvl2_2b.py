"""InternVL2-2B [arXiv:2404.16821]: InternViT stub + InternLM2 backbone.

The vision frontend (InternViT + MLP projector) is the allowed STUB:
``input_specs`` provides (B, n_patches, d_model) precomputed patch
embeddings, consumed by the LM backbone via prefix concatenation.
"""
from repro_torch.configs.base import ModelConfig, VLM, register

CONFIG = register(ModelConfig(
    name="internvl2-2b",
    family=VLM,
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92_553,
    n_patches=256,
    source="[arXiv:2404.16821]",
))
