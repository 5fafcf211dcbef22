"""xLSTM-350M [arXiv:2405.04517]: alternating sLSTM + mLSTM blocks, d_ff=0."""
from repro_torch.configs.base import ModelConfig, SSM, register

CONFIG = register(ModelConfig(
    name="xlstm-350m",
    family=SSM,
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,                   # xLSTM blocks carry their own projection FFs
    vocab=50_304,
    slstm_every=2,            # every 2nd block is sLSTM, rest mLSTM
    source="[arXiv:2405.04517]",
))
