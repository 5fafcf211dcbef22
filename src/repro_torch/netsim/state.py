"""Simulator state carried from round to round inside ``EngineState``.

Under the sweep engine every field gains a leading scenario axis. A
field is a zero-size tensor when its model is off, so the ``iid``
default carries three (0,) tensors through an otherwise unchanged step.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import prng
from repro_torch.netsim.bandwidth import init_logbw
from repro_torch.netsim.channel import (DOWN_INIT_FOLD, init_channel_state,
                                        stationary_bad_frac)
from repro_torch.netsim.config import NetSimConfig


class NetSimState(NamedTuple):
    channel: torch.Tensor  # (N,) int32 GE states (0=GOOD, 1=BAD), or (0,)
    logbw: torch.Tensor    # (N,) f32 log upload Mbps levels, or (0,)
    # downlink GE states: a second, independent chain per client (the
    # broadcast fades apart from the uplink); (0,) unless
    # down_channel == "gilbert_elliott"
    down: torch.Tensor     # (N,) int32, or (0,)


def good_state_scores(net: NetSimState) -> torch.Tensor:
    """(N,) f32: 1.0 for a client in the GOOD Gilbert–Elliott state, 0.0
    in BAD, the ``netsim_state`` selection policy's raw score (which
    reads ``state.net.channel`` through the same expression)."""
    return 1.0 - net.channel.to(torch.float32)


def init_net_state(ns: NetSimConfig, n_clients: int, *, device,
                   base_key=None, loss_rate=None,
                   upload_mbps=None) -> NetSimState:
    """Fresh per-scenario simulator state on ``device``.

    ``base_key`` is the scenario's PRNG root (the channel init draws off
    a fold of it), ``loss_rate`` its scalar or per-client (N,) rate and
    ``upload_mbps`` the static trace draw that seeds the bandwidth walk.
    The single engine and the sweep call this with the same values."""
    channel = torch.zeros((0,), dtype=torch.int32, device=device)
    logbw = torch.zeros((0,), dtype=torch.float32, device=device)
    if ns.channel == "gilbert_elliott":
        if base_key is None:
            raise ValueError("gilbert_elliott channel needs base_key")
        channel = init_channel_state(
            base_key, n_clients,
            torch.as_tensor(loss_rate, dtype=torch.float32, device=device),
            ns.good_loss, ns.bad_loss)
    if ns.bw_ar1 or ns.deadline:
        if upload_mbps is None:
            raise ValueError(
                "netsim bandwidth/deadline models need the per-client "
                "upload speeds (pass nets.upload_mbps through the engine)")
        logbw = init_logbw(upload_mbps, device=device)
    down = torch.zeros((0,), dtype=torch.int32, device=device)
    if ns.down_channel == "gilbert_elliott":
        if base_key is None:
            raise ValueError("gilbert_elliott downlink needs base_key")
        # stationary draw at the nominal downlink rate, off its own fold
        pi_b = stationary_bad_frac(ns.down_loss, ns.good_loss, ns.bad_loss)
        u = prng.uniform(prng.fold_in(base_key, DOWN_INIT_FOLD),
                         (n_clients,))
        down = (u < pi_b.to(u.device)).to(torch.int32)
    return NetSimState(channel=channel, logbw=logbw, down=down)
