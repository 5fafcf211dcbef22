"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + shared attention blocks."""
from repro_torch.configs.base import ModelConfig, HYBRID, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family=HYBRID,
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14_336,
    vocab=32_000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    attn_every=6,             # shared attn block interleave period
    source="[arXiv:2411.15242]",
))
