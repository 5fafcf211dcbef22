"""Decode path: the KV cache and one-token ``decode_step`` (the reference's
``repro/models/decode.py``), for the dense family.

The cache is ``{"k", "v"}`` of shape (L, B, max_seq, KV, dh). A decode
step walks the L stacked layers in a Python loop where the reference
scans them, and writes each layer's new k and v into the cache in
place. Each layer's attention is one launch of the flash-decode kernel
on the card. The other families raise (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_decode.ops import decode_bias
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp_apply, rms_norm
from repro_torch.models.transformer import _lm_head, layer_flags, require_dense


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    require_dense(cfg)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_step(cfg: ModelConfig, params, tokens, cache, pos: int
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: (B,1) integer; pos: Python int (the write position).

    Returns (logits (B, vocab) f32, cache), the cache updated in place.
    The attention mask is built once a step for each layer kind (local,
    global) rather than once a layer: the same values, fewer launches.
    """
    require_dense(cfg)
    embed = params["embed"]
    h = embed[tokens]
    if cfg.tie_embeddings:
        h = h * (cfg.d_model ** 0.5)
    h = h.to(embed.dtype)

    flags = layer_flags(cfg)
    window = cfg.sliding_window
    T = cache["k"].shape[2]
    biases = {f: decode_bias(T, pos, window,
                             bool(f) if window is not None else None,
                             device=h.device)
              for f in sorted(set(flags.tolist()))}
    blocks = params["blocks"]
    for i, flag in enumerate(flags.tolist()):
        layer = {k: t[i] for k, t in blocks["attn"].items()}
        a, _, _ = attn.decode_attn_apply(
            layer, rms_norm(h, blocks["norm1"][i], cfg.norm_eps),
            cache["k"][i], cache["v"][i], pos, rope_theta=cfg.rope_theta,
            bias=biases[flag])
        h = h + a
        h = h + mlp_apply(rms_norm(h, blocks["norm2"][i], cfg.norm_eps),
                          {k: t[i] for k, t in blocks["mlp"].items()})

    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = torch.matmul(h[:, 0, :], _lm_head(cfg, params)).float()
    return logits, cache
