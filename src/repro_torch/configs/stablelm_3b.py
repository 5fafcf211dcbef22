"""StableLM-3B [hf:stabilityai/stablelm-2-1_6b family]."""
from repro_torch.configs.base import ModelConfig, DENSE, register

CONFIG = register(ModelConfig(
    name="stablelm-3b",
    family=DENSE,
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab=50_304,
    rope_theta=10_000.0,
    source="[hf:stabilityai/stablelm-2-1_6b]",
))
