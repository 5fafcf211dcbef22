"""FCC-calibrated mobile network model (paper §3.1, Fig. 2).

Three calibration points from the FCC "Measuring Broadband America"
2019 mobile trace: 90% of users lose < 10% of packets, 76% upload
faster than 2 Mbps, 51% faster than 8 Mbps. Upload speed is
LogNormal(mu, sigma) fitted to the two speed quantiles; packet loss is
Exponential(lambda) truncated to [0, 1] with P(L < 0.1) = 0.9.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SPEED_MU = 2.1305
SPEED_SIGMA = 2.0351
LOSS_LAMBDA = 23.0259
DEFAULT_THRESHOLD_MBPS = 2.0   # OpenMined default cited by the paper


@dataclasses.dataclass
class ClientNetworks:
    """Per-client network conditions (host-side numpy)."""
    upload_mbps: np.ndarray     # (N,)
    packet_loss: np.ndarray     # (N,) in [0, 1]

    @property
    def n(self) -> int:
        return len(self.upload_mbps)


def sample_networks(rng: np.random.Generator, n_clients: int
                    ) -> ClientNetworks:
    speed = rng.lognormal(SPEED_MU, SPEED_SIGMA, n_clients)
    loss = np.minimum(rng.exponential(1.0 / LOSS_LAMBDA, n_clients), 1.0)
    return ClientNetworks(speed, loss)


def eligible_by_threshold(nets: ClientNetworks,
                          threshold_mbps: float = DEFAULT_THRESHOLD_MBPS
                          ) -> np.ndarray:
    return nets.upload_mbps >= threshold_mbps


def eligible_by_ratio(nets: ClientNetworks, ratio: float) -> np.ndarray:
    """Top-``ratio`` fraction of clients by upload speed (the paper's
    eligible ratios 70/80/90/100%)."""
    n_eligible = int(round(ratio * nets.n))
    order = np.argsort(-nets.upload_mbps)
    mask = np.zeros(nets.n, bool)
    mask[order[:n_eligible]] = True
    return mask


def eligible_mask_device(upload_mbps: torch.Tensor, selection: str, *,
                         eligible_ratio: float = 1.0,
                         threshold_mbps: float = DEFAULT_THRESHOLD_MBPS
                         ) -> torch.Tensor:
    """(N,) bool eligibility mask on ``upload_mbps``'s device. ``ratio``
    keeps the top-k speeds; a stable descending sort breaks ties
    lowest index first, as the reference's ``top_k`` does."""
    n = upload_mbps.shape[0]
    if selection == "all":
        return torch.ones((n,), dtype=torch.bool, device=upload_mbps.device)
    if selection == "threshold":
        return upload_mbps >= threshold_mbps
    if selection == "ratio":
        k = int(round(eligible_ratio * n))
        mask = torch.zeros((n,), dtype=torch.bool, device=upload_mbps.device)
        order = torch.sort(upload_mbps, descending=True, stable=True).indices
        mask[order[:k]] = True
        return mask
    raise ValueError(selection)


def stage_network_scenarios(nets_list, selections, *, eligible_ratios=1.0,
                            thresholds_mbps=DEFAULT_THRESHOLD_MBPS,
                            device=None) -> torch.Tensor:
    """(S, N) bool eligibility masks of S scenarios, on ``device``, for
    the sweep engine. ``selections`` / ``eligible_ratios`` /
    ``thresholds_mbps`` are scalars (broadcast) or length-S sequences.
    Each row is ``eligible_mask_device`` of that scenario's policy."""
    S = len(nets_list)

    def _bcast(v):
        if isinstance(v, (list, tuple)):
            if len(v) != S:
                raise ValueError(f"expected {S} per-scenario values, "
                                 f"got {len(v)}")
            return list(v)
        return [v] * S

    rows = [eligible_mask_device(
        torch.tensor(np.asarray(nets.upload_mbps), dtype=torch.float32,
                     device=device), sel, eligible_ratio=r,
        threshold_mbps=th)
        for nets, sel, r, th in zip(nets_list, _bcast(selections),
                                    _bcast(eligible_ratios),
                                    _bcast(thresholds_mbps))]
    return torch.stack(rows)


def log_upload_speeds(upload_mbps, device=None) -> torch.Tensor:
    """(N,) f32 log upload speeds: the initial levels of the netsim
    AR(1) bandwidth walk."""
    return torch.log(torch.as_tensor(np.asarray(upload_mbps, np.float32),
                                     device=device))


def ar1_logspeed_step(logbw, rho, eps, mu: float = SPEED_MU,
                      sigma: float = SPEED_SIGMA) -> torch.Tensor:
    """One round of the stationarity-preserving AR(1) on log upload
    speed: ``logbw`` (N,) levels, ``eps`` (N,) standard normals, ``rho``
    the round-to-round correlation. The innovation is scaled by
    ``sigma * sqrt(1 - rho^2)``, so N(mu, sigma^2) stays the stationary
    law for every rho. The reference's expression, in float32."""
    rho = torch.as_tensor(rho, dtype=torch.float32)
    innov = sigma * torch.sqrt(torch.clamp(1.0 - rho * rho, min=0.0))
    return mu + rho * (logbw - mu) + innov * eps


def upload_seconds(n_bytes: float, mbps: float, loss: float,
                   retransmit: bool) -> float:
    """Analytic upload time of ``n_bytes`` at ``mbps``: with
    retransmission every lost packet is resent (geometric rounds, an
    expected 1/(1 - loss)); without (TRA) the client sends once."""
    base = n_bytes * 8 / (mbps * 1e6)
    if retransmit and loss < 1.0:
        return base / (1.0 - loss)
    return base
