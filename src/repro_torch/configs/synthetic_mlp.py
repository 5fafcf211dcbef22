"""The paper's evaluation model: a 2-layer MLP on Synthetic(alpha, beta)
(60-dim features, 10 classes, q-FedAvg's synthetic recipe)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    name: str = "synthetic-mlp"
    d_in: int = 60
    d_hidden: int = 128
    n_classes: int = 10


CONFIG = MLPConfig()
