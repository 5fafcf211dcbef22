"""Qwen3-MoE 235B-A22B [hf:Qwen/Qwen3-30B-A3B family, scaled per assignment]."""
from repro_torch.configs.base import ModelConfig, MOE, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family=MOE,
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,            # Qwen3 uses fixed 128 head_dim (> d_model/H)
    d_ff=1536,               # == moe_intermediate_size (per-expert)
    expert_d_ff=1536,
    vocab=151_936,
    n_experts=128,
    top_k=8,
    rope_theta=1_000_000.0,
    source="[hf:Qwen/Qwen3-30B-A3B]",
))
