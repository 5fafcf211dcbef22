"""Step builders (the reference's ``repro/launch/steps.py``): the train
step, the prefill step and the greedy serve step, for the dense family.

The train step takes gradients with ``torch.autograd`` over the
parameter tree's leaves (``value_and_grad``), accumulates microbatches
in order, clips by the global norm and applies the optimizer. The FL
driver (``fl_train.py``) wraps the same gradient path per client.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import decode as decode_mod
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import (clip_by_global_norm, make_optimizer,
                                          tree_leaves, tree_map,
                                          tree_unflatten)


def value_and_grad(fn: Callable, params) -> Tuple[Tuple[torch.Tensor, Any],
                                                  Dict[str, Any]]:
    """``((value, aux), grads)`` of ``fn(params) -> (value, aux)``, the
    gradient a tree shaped as ``params`` (``jax.value_and_grad`` with
    ``has_aux``). The value and every tensor of ``aux`` come back
    detached; a leaf the value does not reach gets a zero gradient."""
    leaves = [leaf.detach().requires_grad_(True)
              for leaf in tree_leaves(params)]
    with torch.enable_grad():
        value, aux = fn(tree_unflatten(params, leaves))
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for leaf, g in zip(leaves, grads)]
    aux = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                   else t, aux)
    return (value.detach(), aux), tree_unflatten(params, grads)


def make_train_step(cfg: ModelConfig,
                    tcfg: TrainConfig) -> Tuple[Callable, Any]:
    """Returns (train_step, opt); ``train_step(params, opt_state, batch)
    -> (params, opt_state, metrics)``.

    The step writes the new parameters and optimizer state into the
    given tensors and returns them (``jax.jit``'s ``donate_argnums``):
    the caller's old trees are then the new ones. That is what lets a
    full-width AdamW step fit one card.
    """
    opt = make_optimizer(tcfg.optimizer, tcfg.lr, momentum=tcfg.momentum,
                         weight_decay=tcfg.weight_decay)
    remat = tcfg.remat if tcfg.remat != "none" else False
    mb = max(tcfg.microbatch, 0)

    def grads_of(params, batch):
        return value_and_grad(
            lambda p: tf.forward(cfg, p, batch, remat=remat), params)

    def train_step(params, opt_state, batch):
        if mb > 1:
            # gradient accumulation over microbatches, in order
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            losses, metricses = [], []
            for j in range(mb):
                b = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[j]
                     for k, v in batch.items()}
                (loss, metrics), g = grads_of(params, b)
                grads = tree_map(lambda a, gg: a + gg.float() / mb, grads, g)
                del g
                losses.append(loss)
                metricses.append(metrics)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        else:
            (loss, metrics), grads = grads_of(params, batch)
        if tcfg.grad_clip > 0:
            grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        else:
            gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)
        with torch.no_grad():
            params, opt_state = opt.update_(grads, opt_state, params)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step, opt


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """``prefill_step(params, batch) -> (B, vocab)`` f32 logits of the
    last prompt position."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return tf.prefill_logits(cfg, params, batch, remat=True)
    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """One decode step: greedy next token against the KV cache (updated
    in place). Returns (next tokens (B,) int32, cache)."""
    def serve_step(params, cache, batch, pos):
        logits, cache = decode_mod.decode_step(cfg, params, batch["tokens"],
                                               cache, pos)
        return logits.argmax(-1).int(), cache
    return serve_step
