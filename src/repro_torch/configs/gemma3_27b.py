"""Gemma-3 27B [hf:google/gemma-3-1b-pt family]: 5:1 local:global SWA, 128k ctx."""
from repro_torch.configs.base import ModelConfig, DENSE, register

CONFIG = register(ModelConfig(
    name="gemma3-27b",
    family=DENSE,
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21_504,
    vocab=262_144,
    sliding_window=1024,       # local layers
    local_global_pattern=5,    # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    source="[hf:google/gemma-3-1b-pt]",
))
