"""Carry state across from the JAX reference.

The reference's parameters, EF memory, simulator state, model weights
and KV caches arrive as numpy arrays (the tests hand them over with
``np.asarray``); these helpers turn them into the port's tensors, so
both packages can start a run from the same weights and state.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.async_agg import ArrivalBuffer
from repro_torch.core.engine import EngineState
from repro_torch.core.telemetry import TelemetryState
from repro_torch.netsim.state import NetSimState


def params_from_jax(tree: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
    """The reference MLP's parameter dict -> the port's, float32 tensors
    on ``device`` in the reference's leaf order (b1, b2, w1, w2). A
    leading scenario axis, as in a sweep's stacked state, is kept."""
    return {k: torch.tensor(np.asarray(tree[k], np.float32), device=device)
            for k in sorted(tree)}


def ef_mem_from_numpy(ef_mem: np.ndarray, device) -> torch.Tensor:
    """(N, D) error-feedback memory -> float32 tensor on ``device``."""
    return torch.tensor(np.asarray(ef_mem, np.float32), device=device)


def net_state_from_jax(net, device) -> NetSimState:
    """The reference's ``NetSimState`` (fields as numpy arrays) -> the
    port's: int32 channel states, f32 log-bandwidth levels and downlink
    states on ``device``, so a run can start from the reference's
    simulator state."""
    return NetSimState(
        channel=torch.tensor(np.asarray(net.channel, np.int32),
                             device=device),
        logbw=torch.tensor(np.asarray(net.logbw, np.float32),
                           device=device),
        down=torch.tensor(np.asarray(net.down, np.int32), device=device))


def engine_state_from_jax(state, device) -> EngineState:
    """The reference's ``EngineState`` (fields as arrays) -> the port's:
    params, EF memory, AFL weights, simulator state (the downlink chain
    included), the fault model's echo and reputation memories, the
    stale-model buffer, the loss-budget controller's carries, SCAFFOLD's
    control variates, the selection scores' memories, the async
    server's arrival buffer and the telemetry's per-client aggregates,
    single or stacked along a scenario axis."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return EngineState(
        params=params_from_jax({k: np.asarray(v)
                                for k, v in state.params.items()}, device),
        ef_mem=f32(state.ef_mem), lam=f32(state.lam),
        net=net_state_from_jax(state.net, device),
        echo_mem=f32(state.echo_mem), rep_mem=f32(state.rep_mem),
        stale_model=f32(state.stale_model), bud_level=f32(state.bud_level),
        bud_loss=f32(state.bud_loss), c_global=f32(state.c_global),
        c_i=f32(state.c_i), gnorm_mem=f32(state.gnorm_mem),
        loss_mem=f32(state.loss_mem), stale_mem=f32(state.stale_mem),
        buf=ArrivalBuffer(*(f32(a) for a in state.buf)),
        tele=TelemetryState(*(f32(a) for a in state.tele)))


def model_params_from_jax(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """A model's nested parameter dict of arrays (``repro.models``) ->
    the same nested dict of tensors on ``device``, each leaf in its own
    dtype and shape (the stacked ``L`` axes kept)."""
    return {k: model_params_from_jax(v, device) if isinstance(v, dict)
            else _leaf(np.asarray(v), device) for k, v in tree.items()}


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16: carry the bits
        return torch.tensor(a.view(np.int16), device=device).view(
            torch.bfloat16)
    return torch.tensor(a, device=device)


def cache_from_jax(cache: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The reference's KV cache ``{"k", "v"}`` (L, B, T, KV, dh) ->
    tensors on ``device`` in its dtype, so a decode can continue from the
    reference's state."""
    return model_params_from_jax(cache, device)


def opt_state_from_jax(state, device):
    """An optimizer state of ``repro.optim`` -> the port's
    (``repro_torch.optim``), in the reference's tree layout: SGD's
    ``()`` or momentum tree, AdamW's ``{"mu", "nu", "count"}`` (the count
    an int32 scalar), single or stacked along a scenario axis."""
    if isinstance(state, tuple):
        return tuple(opt_state_from_jax(s, device) for s in state)
    if isinstance(state, dict):
        return model_params_from_jax(state, device)
    return _leaf(np.asarray(state), device)


def tree_to_numpy(tree):
    """A tree of tensors (nested dicts and tuples; a gradient tree, a
    step's parameters or optimizer state) -> the same tree of numpy
    arrays on the host, each in its dtype (bf16 as ``ml_dtypes``' if
    numpy has it, else f32)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_to_numpy(v) for v in tree)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            import ml_dtypes
        except ImportError:
            return t.float().numpy()
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()
