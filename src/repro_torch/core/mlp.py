"""The paper's evaluation model: a 2-layer MLP (nonconvex, §5) on 60-dim
synthetic features, 10 classes. Parameters are a dict of tensors in the
reference's leaf order (b1, b2, w1, w2)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import prng
from repro_torch.configs.synthetic_mlp import MLPConfig

Params = Dict[str, torch.Tensor]


def mlp_init(key: torch.Tensor, cfg: MLPConfig = MLPConfig()) -> Params:
    """He-normal weights, zero biases, drawn from the port's threefry."""
    k1, k2 = prng.split(key)
    s1 = (2.0 / cfg.d_in) ** 0.5
    s2 = (2.0 / cfg.d_hidden) ** 0.5
    dev = key.device
    return {
        "b1": torch.zeros(cfg.d_hidden, device=dev),
        "b2": torch.zeros(cfg.n_classes, device=dev),
        "w1": s1 * prng.normal(k1, (cfg.d_in, cfg.d_hidden)),
        "w2": s2 * prng.normal(k2, (cfg.d_hidden, cfg.n_classes)),
    }


def mlp_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _nll(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logits = mlp_logits(params, x)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y.long()[..., None])[..., 0]
    return lse - ll


def mlp_loss(params: Params, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    return _nll(params, x, y).mean()


def mlp_weighted_loss(params: Params, x: torch.Tensor, y: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    return (_nll(params, x, y) * w).sum() / torch.clamp(w.sum(), min=1.0)


def mlp_accuracy(params: Params, x: torch.Tensor, y: torch.Tensor,
                 w: torch.Tensor):
    """Weighted accuracy; w masks padding. Returns (acc, n_correct, n).
    ``argmax`` returns the first maximum, as the reference's does."""
    pred = torch.argmax(mlp_logits(params, x), dim=-1)
    correct = ((pred == y).to(w.dtype) * w).sum()
    n = torch.clamp(w.sum(), min=1.0)
    return correct / n, correct, w.sum()
