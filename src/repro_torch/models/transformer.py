"""Model assembly for the port: the reference's
``repro/models/transformer.py``, as far as serving the dense family
needs it.

``init_params`` builds the dense family's parameter tree (the same keys,
leaf shapes, dtypes and init std as the reference), with the decoder
stack's leaves stacked on a leading ``L`` axis. The other families, the
training forward, ``stack_hidden`` and the chunked cross-entropy wait
for ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import DENSE, SSM, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_init, truncated_normal


def layer_flags(cfg: ModelConfig) -> np.ndarray:
    """Per-layer int flag of the block stack.

    dense/vlm: 1 = global-attention layer (gemma3 pattern), else local.
    ssm:       1 = sLSTM block, 0 = mLSTM.
    """
    L = cfg.n_layers
    if cfg.local_global_pattern:
        p = cfg.local_global_pattern + 1
        return np.array([(i % p) == (p - 1) for i in range(L)], np.int32)
    if cfg.family == SSM:
        return np.array([(i % cfg.slstm_every) == (cfg.slstm_every - 1)
                         for i in range(L)], np.int32)
    return np.ones(L, np.int32)  # full attention everywhere


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported to "
            f"repro_torch yet (ROADMAP Queue 1 item 8); the port serves "
            f"the dense family")


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32) -> Dict[str, Any]:
    """The dense family's parameters on ``gen``'s device, drawn from
    ``gen``: truncated normals of std 0.02 (0.01 for the output
    projections), zero norms and biases."""
    require_dense(cfg)
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    zeros = dict(dtype=dtype, device=gen.device)
    params: Dict[str, Any] = {
        "embed": truncated_normal(gen, (V, d), dtype=dtype),
        "final_norm": torch.zeros((d,), **zeros),
    }
    if not cfg.tie_embeddings:
        params["head"] = truncated_normal(gen, (d, V), dtype=dtype)
    params["blocks"] = {
        "attn": attn.attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                               qkv_bias=cfg.qkv_bias, dtype=dtype,
                               stack=(L,)),
        "norm1": torch.zeros((L, d), **zeros),
        "norm2": torch.zeros((L, d), **zeros),
        "mlp": mlp_init(gen, d, cfg.d_ff, cfg.mlp_gelu, dtype, stack=(L,)),
    }
    return params


def _lm_head(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]
