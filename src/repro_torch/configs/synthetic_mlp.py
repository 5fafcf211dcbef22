"""The paper's evaluation model: a 2-layer MLP on Synthetic(alpha, beta)
(60-dim features, 10 classes, q-FedAvg's synthetic recipe).

``TOKEN_CONFIG`` registers a token-model stand-in under the same name,
so ``--arch synthetic-mlp`` resolves in the launchers (a tiny dense
decoder; the FL engine uses ``MLPConfig`` directly).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import DENSE, ModelConfig, register


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str = "synthetic-mlp"
    d_in: int = 60
    d_hidden: int = 128
    n_classes: int = 10


CONFIG = MLPConfig()

TOKEN_CONFIG = register(ModelConfig(
    name="synthetic-mlp",
    family=DENSE,
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=256,
    vocab=512,
    source="[paper §3.2, q-FedAvg synthetic recipe]",
))
