"""Whisper-large-v3 [arXiv:2212.04356]: enc-dec; mel+conv frontend is a STUB.

``input_specs`` provides (B, 1500, d_model) precomputed frame embeddings
(post-conv features); we implement the transformer encoder + decoder with
cross-attention. long_500k is skipped: the decoder is architecturally capped
(30 s audio => <=448 text tokens) — see DESIGN.md §3.
"""
from repro_torch.configs.base import ModelConfig, AUDIO, register

CONFIG = register(ModelConfig(
    name="whisper-large-v3",
    family=AUDIO,
    n_layers=32,              # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51_866,
    mlp_gelu=True,            # whisper uses a 2-matrix GELU MLP
    encoder_layers=32,
    encoder_seq=1500,
    rope_theta=10_000.0,      # (whisper uses sinusoidal; RoPE stands in)
    source="[arXiv:2212.04356]",
))
