"""ThrowRightAway (TRA) — the paper's core protocol (§4, Algorithm 1).

Server side:
  1. collect 1-bit sufficiency reports (client speed >= threshold),
  2. select clients regardless of network condition,
  3. on upload loss: sufficient clients retransmit; insufficient
     clients' lost packets are thrown away and their coordinates zeroed,
  4. aggregation debiases the zero-filled updates (Eq. 1 and variants).

This module is protocol plus the flat <-> parameter-dict helpers over
flat (C, D) client uploads; ``aggregate`` runs the debiased aggregate in
the ``tra_agg`` kernel (``kernels/tra_agg``). The engine's round step
folds the same estimators into the uplink megakernel
(``kernels/uplink_fused``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.kernels.tra_agg.ops import DEBIAS_MODES, tra_aggregate
from repro_torch.network.packets import (PACKET_FLOATS, kept_fraction,
                                        n_packets)
from repro_torch.network.trace import ClientNetworks, DEFAULT_THRESHOLD_MBPS


@dataclasses.dataclass(frozen=True)
class TRAConfig:
    enabled: bool = True
    loss_rate: float = 0.1            # nominal drop rate r for insufficient
    debias: str = "group_rate"        # paper-faithful Eq. (1) default
    packet_floats: int = PACKET_FLOATS
    threshold_mbps: float = DEFAULT_THRESHOLD_MBPS
    # each client's own drop rate (ClientNetworks.packet_loss) instead of
    # the scalar above, for both the loss mask and the group_rate debias
    per_client_loss: bool = False

    def __post_init__(self):
        if self.debias not in DEBIAS_MODES:
            raise ValueError(f"unknown debias mode {self.debias!r}")


def sufficiency_report(nets: ClientNetworks,
                       threshold_mbps: float = DEFAULT_THRESHOLD_MBPS
                       ) -> np.ndarray:
    """The client -> server 1-bit report (0 insufficient, 1 sufficient)."""
    return (nets.upload_mbps >= threshold_mbps).astype(np.float32)


def simulate_uploads(key: torch.Tensor, updates: torch.Tensor,
                     sufficient: torch.Tensor, loss_rate,
                     packet_floats: int = PACKET_FLOATS
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-packet Bernoulli loss on insufficient clients' uploads.

    updates: (C, D); sufficient: (C,) 0/1. Sufficient clients retransmit,
    so their mask is all ones. Returns (masked (C, D), pkt_mask (C, P),
    kept_frac (C,))."""
    C, D = updates.shape
    P = n_packets(D, packet_floats)
    u = prng.uniform(key, (C, P))
    lost = (u < loss_rate) & ~sufficient.bool()[:, None]
    pkt_mask = 1.0 - lost.float()
    coord = torch.repeat_interleave(pkt_mask, packet_floats, dim=1)[:, :D]
    return updates * coord, pkt_mask, kept_fraction(coord)


def aggregate(updates: torch.Tensor, pkt_mask: torch.Tensor,
              weights: torch.Tensor, sufficient: torch.Tensor,
              kept_frac: torch.Tensor, cfg: TRAConfig) -> torch.Tensor:
    """Debiased weighted mean of (C, D) client uploads, the FedAvg-style
    combine: one ``tra_agg`` launch on the card. For sum semantics
    (q-FedAvg's sum of deltas) multiply by ``weights.sum()``."""
    rate = torch.full(updates.shape[:1], cfg.loss_rate,
                      dtype=torch.float32, device=updates.device)
    return tra_aggregate(
        updates, pkt_mask, weights, mode=cfg.debias, kept_frac=kept_frac,
        nominal_rate=rate, sufficient=sufficient,
        packet_floats=cfg.packet_floats)


def flatten_clients(tree: Dict[str, torch.Tensor], n_clients: int
                    ) -> torch.Tensor:
    """Parameter dict with a leading client dim C on every leaf ->
    (C, D), leaves in the reference's (sorted-key) order."""
    return torch.cat([tree[k].reshape(n_clients, -1).float()
                      for k in sorted(tree)], dim=1)


def unflatten_like(vec: torch.Tensor, template: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """(..., D) -> parameter dict shaped like ``template``, each leaf
    with the leading dims of ``vec`` (a (C, D) block gives per-client
    parameters)."""
    out, off = {}, 0
    lead = tuple(vec.shape[:-1])
    for k in sorted(template):
        leaf = template[k]
        out[k] = vec[..., off:off + leaf.numel()].reshape(
            lead + tuple(leaf.shape)).to(leaf.dtype)
        off += leaf.numel()
    return out
