"""Mixtral 8x22B [arXiv:2401.04088]: 8 experts top-2, sliding-window attention."""
from repro_torch.configs.base import ModelConfig, MOE, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family=MOE,
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    expert_d_ff=16_384,
    vocab=32_768,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    source="[arXiv:2401.04088]",
))
