"""StarCoder2-15B [arXiv:2402.19173]: GQA kv=4, RoPE, full attention."""
from repro_torch.configs.base import ModelConfig, DENSE, register

CONFIG = register(ModelConfig(
    name="starcoder2-15b",
    family=DENSE,
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24_576,
    vocab=49_152,
    mlp_gelu=True,            # starcoder2 uses a 2-matrix GELU MLP
    rope_theta=100_000.0,
    source="[arXiv:2402.19173]",
))
