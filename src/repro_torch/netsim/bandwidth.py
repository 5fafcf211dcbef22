"""Time-varying per-client bandwidth: an AR(1) walk in log-speed space.

Each client carries a log-Mbps level l_t in ``NetSimState.logbw``,
initialised from its ``sample_networks`` speed and advanced once per
round for all N clients by

    l_t = mu + rho (l_{t-1} - mu) + sigma sqrt(1 - rho^2) eps_t

(``network/trace.ar1_logspeed_step``), whose stationary law is the FCC
lognormal fit. Only the deadline delivery model reads it.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.network.trace import ar1_logspeed_step, log_upload_speeds

# fold_in tag of the per-round innovation draw, applied to the round key
BW_FOLD = 0x42574550  # "BWEP"


def init_logbw(upload_mbps, device=None) -> torch.Tensor:
    """(N,) f32 initial log-levels from a static trace draw."""
    return log_upload_speeds(upload_mbps, device=device)


def logbw_round_step(round_key: torch.Tensor, logbw: torch.Tensor,
                     rho) -> torch.Tensor:
    """Advance every client's log-bandwidth by one round. The normals
    go through ``erfinv``, so they match the reference's to a few ulps."""
    eps = prng.normal(prng.fold_in(round_key, BW_FOLD), logbw.shape)
    return ar1_logspeed_step(logbw, rho, eps)
