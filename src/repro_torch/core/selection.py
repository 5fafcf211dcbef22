"""Client selection by weighted Gumbel-top-k (paper §5, the bias axis).

    ids = top_k( where(eligible, gumbel + logits, -inf), k )

``logits = None`` is the ``uniform`` policy, the engine's default: a
uniform sample without replacement from the eligible set. This slice
ports that policy; the score-based policies wait for their slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.network.trace import DEFAULT_THRESHOLD_MBPS

POLICIES = ("uniform", "bandwidth_threshold", "gradient_norm",
            "loss_aware", "netsim_state", "staleness_aware",
            "reputation_aware", "recovery_pressure")


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    """Selection-policy knobs. Only ``policy="uniform"`` (untraced) is
    ported; the engine raises ``NotImplementedError`` for the rest."""
    policy: str = "uniform"
    traced: bool = False
    threshold_mbps: float = DEFAULT_THRESHOLD_MBPS
    temperature: float = 1.0
    explore: float = 0.0

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown selection policy {self.policy!r}")


def select_from_uniforms(u: torch.Tensor, logits, eligible: torch.Tensor,
                         k: int) -> torch.Tensor:
    """Gumbel-top-k from pre-drawn uniforms ``u`` (N,). ``logits`` must
    be None (the uniform policy); score policies come with their slice.

    Ineligible clients score -inf and are picked only once the eligible
    set is exhausted. A stable descending sort breaks ties lowest index
    first, as the reference's ``top_k`` does.
    """
    if logits is not None:
        raise NotImplementedError(
            "score-weighted selection is not ported to repro_torch yet")
    keys = torch.where(eligible, -torch.log(-torch.log(u)), float("-inf"))
    return torch.sort(keys, descending=True, stable=True).indices[:k]
