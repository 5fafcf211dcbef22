"""Model assembly for the port: the reference's
``repro/models/transformer.py`` for the dense family.

``init_params`` builds the dense family's parameter tree (the same keys,
leaf shapes, dtypes and init std as the reference), with the decoder
stack's leaves stacked on a leading ``L`` axis. ``forward`` is the
training forward: the block stack walked in a Python loop where the
reference scans it, then a sequence-chunked cross-entropy whose chunks
are checkpointed under autograd (the ``(B, C, V)`` f32 logits are
recomputed in backward, never kept for every chunk). ``prefill_logits``
returns the last position's logits. The other families wait for ROADMAP
Queue 1 item 8.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import DENSE, SSM, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (mlp_apply, mlp_init, rms_norm,
                                       truncated_normal)
from repro_torch.utils.shardctx import shard

CE_CHUNK = 512          # seq chunk for chunked cross-entropy


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
            f"and trains the dense family")


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


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep the outputs of plain (unbatched) matmuls, recompute the rest:
    ``dots_with_no_batch_dims_saveable``."""
    if op in _MATMULS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _ckpt(body, remat):
    """remat: False/"none" -> plain; True/"full" -> full recompute;
    "dots" -> selective: matmul outputs saved, the rest recomputed.
    Non-reentrant checkpointing, and only while autograd records: it is
    a memory device and changes no value."""
    if not remat or remat == "none" or not torch.is_grad_enabled():
        return body
    if remat == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _dots_policy)
        return lambda *a: checkpoint(body, *a, use_reentrant=False,
                                     context_fn=ctx)
    return lambda *a: checkpoint(body, *a, use_reentrant=False)


def _layers(tree, L: int) -> list:
    """The stacked block parameters as L per-layer trees. One ``unbind``
    a leaf: its backward stacks the L slices' gradients once, where
    indexing would add L full-size zero-padded gradients."""
    if isinstance(tree, dict):
        subs = {k: _layers(v, L) for k, v in tree.items()}
        return [{k: subs[k][i] for k in subs} for i in range(L)]
    return list(torch.unbind(tree, 0))


def _dense_block(cfg: ModelConfig, p, h, flag, *, remat):
    if "moe" in p:
        raise NotImplementedError(
            f"{cfg.name}: the MoE block is not ported to repro_torch yet "
            f"(ROADMAP Queue 1 item 8)")
    window = cfg.sliding_window
    is_global = bool(flag) if window is not None else None

    def body(h):
        a = attn.attn_apply(p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps),
                            rope_theta=cfg.rope_theta, window=window,
                            is_global=is_global)
        h = h + a
        hn = rms_norm(h, p["norm2"], cfg.norm_eps)
        return h + mlp_apply(hn, p["mlp"])

    return _ckpt(body, remat)(h)


def stack_hidden(cfg: ModelConfig, params, batch: Dict[str, Any], *,
                 remat=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed inputs and run the full block stack; returns (h, moe_aux),
    moe_aux a () f32 zero for the dense family."""
    require_dense(cfg)
    h, _ = _embed_inputs(cfg, params, batch)
    h = shard(h, "batch", "seq", "d_model")
    flags = layer_flags(cfg).tolist()
    for p, flag in zip(_layers(params["blocks"], len(flags)), flags):
        h = _dense_block(cfg, p, h, flag, remat=remat)
    return h, torch.zeros((), dtype=torch.float32, device=h.device)


def forward(cfg: ModelConfig, params, batch: Dict[str, Any], *,
            remat=False) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Returns (loss, metrics); batch: tokens (B,S), labels (B,S)."""
    h, moe_aux = stack_hidden(cfg, params, batch, remat=remat)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    loss, metrics = _chunked_ce(cfg, params, h, batch)
    metrics["moe_aux"] = moe_aux
    return loss + 0.01 * moe_aux, metrics


def _embed_inputs(cfg, params, batch):
    """Token embeddings, times sqrt(d_model) where the head is the
    embedding's transpose (tied)."""
    tokens = batch["tokens"]
    embed = params["embed"]
    h = embed[tokens] * (cfg.d_model ** 0.5 if cfg.tie_embeddings else 1.0)
    return h.to(embed.dtype), None


def _lm_head(cfg, params):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["head"]


def _chunked_ce(cfg, params, h, batch):
    """Chunked cross-entropy over the sequence: the mean over B * S of
    logsumexp - the label's logit, summed a chunk at a time in order."""
    labels = batch["labels"]
    B, S, d = h.shape
    head = _lm_head(cfg, params)
    nc = max(1, S // CE_CHUNK)
    while S % nc:
        nc -= 1
    C = S // nc

    def chunk_ce(hc, lc):
        logits = (hc @ head).float()
        lse = torch.logsumexp(logits, -1)
        ll = logits.gather(-1, lc[..., None].long())[..., 0]
        return (lse - ll).sum()

    grad = torch.is_grad_enabled() and (h.requires_grad
                                        or head.requires_grad)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        hc, lc = h[:, i * C:(i + 1) * C], labels[:, i * C:(i + 1) * C]
        tot = tot + (checkpoint(chunk_ce, hc, lc, use_reentrant=False)
                     if grad else chunk_ce(hc, lc))
    loss = tot / (B * S)
    return loss, {"ce": loss}


def prefill_logits(cfg: ModelConfig, params, batch, *, remat=True):
    """Prefill path for serving: runs the stack, returns the last
    position's logits (B, vocab) f32."""
    h, _ = stack_hidden(cfg, params, batch, remat=remat)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    last = h[:, -1, :]
    return (last @ _lm_head(cfg, params)).float()
