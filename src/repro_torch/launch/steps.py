"""Step functions (the reference's ``repro/launch/steps.py``): the greedy
serve step. The train and prefill steps come with training."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import decode as decode_mod


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step: greedy next token against the KV cache (updated
    in place). Returns (next tokens (B,) int32, cache)."""
    def serve_step(params, cache, batch, pos):
        logits, cache = decode_mod.decode_step(cfg, params, batch["tokens"],
                                               cache, pos)
        return logits.argmax(-1).int(), cache
    return serve_step
