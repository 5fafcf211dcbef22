"""Shape and dtype stand-ins for the model inputs (the reference's
``repro/launch/input_specs.py``), and small real inputs made from them."""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import AUDIO, VLM, InputShape, ModelConfig


class TensorSpec(NamedTuple):
    """``jax.ShapeDtypeStruct``'s counterpart: a shape and a dtype."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


S = TensorSpec


def train_inputs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    B, L = shape.global_batch, shape.seq_len
    if cfg.family == VLM:
        Lt = L - cfg.n_patches
        return {
            "patches": S((B, cfg.n_patches, cfg.d_model), torch.bfloat16),
            "tokens": S((B, Lt), torch.int32),
            "labels": S((B, Lt), torch.int32),
        }
    if cfg.family == AUDIO:
        return {
            "frames": S((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16),
            "tokens": S((B, L), torch.int32),
            "labels": S((B, L), torch.int32),
        }
    return {"tokens": S((B, L), torch.int32),
            "labels": S((B, L), torch.int32)}


def concrete_like(specs, seed: int = 0, device=None):
    """Small REAL inputs matching a spec dict: integer leaves zeros,
    float leaves 0.01."""
    out = {}
    for k, v in specs.items():
        if v.dtype == torch.int32:
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
        else:
            out[k] = torch.full(v.shape, 0.01, dtype=v.dtype, device=device)
    return out
