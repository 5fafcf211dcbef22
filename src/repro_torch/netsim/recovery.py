"""Loss-recovery policy family: one_shot (TRA) / fec / arq.

The paper's throw-right-away scheme (TRA) is one point in the recovery
design space: a client that loses packets may also spend uplink budget
recovering them. Each round, a client (or the adaptive loss-budget
controller, ``core/lossbudget.py``) picks one of:

  * ``one_shot`` — TRA: lost packets stay lost, and the debias
    machinery corrects the aggregate in expectation.
  * ``fec``      — forward error correction: one XOR parity packet per
    group of G data packets. A group with exactly one data loss and a
    delivered parity is repaired (``kernels/fec_recover``, the CUDA
    kernel on the card) before the uplink kernel sees the mask. It
    costs 1 + 1/G of the bandwidth and adds no latency.
  * ``arq``      — bounded retransmission: each lost packet is retried
    up to ``retries`` times, each retry lost with probability r, so the
    residual per-packet loss is r^(1+retries); the expected extra sends
    inflate the upload time by ``backoff`` per resend, which the
    deadline model charges.

The policy name and the FEC group size are static (they pick the round
step's structure), except under ``RecoveryConfig(traced=True)``, where
the policy rides ``ScenarioCtx`` as a one-hot and a recovery x loss-rate
grid is one batched step. ``retries`` and ``backoff`` are always
scenario knobs.

Every expression is the reference's (``repro/netsim/recovery.py``) in
float32. Powers with an integer exponent (the FEC group) multiply by
repeated squaring, as XLA's ``integer_pow`` does, so they are bitwise;
powers with a float exponent go through ``torch.pow``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import RATE_EPS
from repro_torch.netsim.delivery import (INFEASIBLE_SECS,
                                         PACKET_BYTES_PER_FLOAT,
                                         retransmit_sends)

# the escalation ladder's order: the loss-budget controller walks levels
# 0 -> 1 -> 2 (one_shot -> fec -> arq) while realized loss exceeds budget
RECOVERY_POLICIES = ("one_shot", "fec", "arq")

# RecoveryConfig fields a sweep scenario may vary; the policy joins them
# when ``traced`` (it rides ScenarioCtx as a one-hot then)
SWEEP_VARYING_REC_FIELDS = ("retries", "backoff")


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    policy: str = "one_shot"  # static, unless ``traced``
    traced: bool = False      # the policy one-hot rides ScenarioCtx and
    #                           all three recovery paths are built into
    #                           the step (the controller needs this)
    group: int = 8            # static FEC group size G (one parity per G)
    retries: float = 2.0      # scenario knob: ARQ retry budget m
    backoff: float = 1.0      # scenario knob: upload-time cost per resend
    #                           (1.0 = a resend costs a full send)

    def __post_init__(self):
        if self.policy not in RECOVERY_POLICIES:
            raise ValueError(f"unknown recovery policy {self.policy!r}")
        if self.group < 2:
            raise ValueError("FEC needs a group of at least 2")


def recovery_onehot(policy: str) -> np.ndarray:
    """(len(RECOVERY_POLICIES),) f32 one-hot for ScenarioCtx."""
    oh = np.zeros((len(RECOVERY_POLICIES),), np.float32)
    oh[RECOVERY_POLICIES.index(policy)] = 1.0
    return oh


def _f32(v, like=None) -> torch.Tensor:
    dev = None if like is None else like.device
    return torch.as_tensor(v, dtype=torch.float32, device=dev)


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n for a static integer n >= 1 by repeated squaring, in XLA's
    ``integer_pow`` order, so the rounding is the reference's."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


# -- ARQ ---------------------------------------------------------------------

def arq_residual_mask(mask, u_rec, loss_rate, retries):
    """(C, P) delivery mask after bounded retransmission.

    A packet the channel lost stays lost only if all ``retries`` resends
    fail too: P(still lost | lost) = r^m. ``u_rec`` is a fresh (C, P)
    uniform block (drawn per packet whether or not it was lost, so the
    draw layout does not depend on the policy); ``loss_rate`` broadcasts
    (scalar or (C, 1)). retries = 0 is one_shot exactly (r^0 = 1)."""
    r = torch.clamp(_f32(loss_rate, mask), 0.0, 1.0)
    m = torch.clamp(_f32(retries, mask), min=0.0)
    still_lost = u_rec < torch.pow(r, m)
    recovered = (mask < 0.5) & ~still_lost
    return torch.where(recovered, 1.0, mask)


def arq_sends(loss_rate, retries, backoff):
    """Expected sends per packet under m-bounded retransmission,
    1 + backoff * sum_{k=1..m} r^k. The partial geometric sum
    r(1-r^m)/(1-r) saturates at its limit m as r -> 1 (never above m,
    never NaN)."""
    r = torch.clamp(_f32(loss_rate), 0.0, 1.0)
    m = torch.clamp(_f32(retries, r), min=0.0)
    geo = r * (1.0 - torch.pow(r, m)) / torch.clamp(1.0 - r, min=RATE_EPS)
    extra = torch.where(r > 1.0 - RATE_EPS, m, torch.minimum(geo, m))
    return 1.0 + torch.clamp(_f32(backoff, r), min=0.0) * extra


# -- FEC ---------------------------------------------------------------------

def fec_groups(n_pkts: int, group: int) -> int:
    """Number of parity packets (= groups) covering P data packets."""
    return -(-n_pkts // group)


def fec_sends(group: int) -> float:
    """Bandwidth inflation of FEC: one parity packet per G data."""
    return 1.0 + 1.0 / float(group)


def fec_parity_mask(u_par, loss_rate):
    """(C, Gn) f32 parity-packet delivery mask. Parities ride the same
    uplink, modelled i.i.d. at the nominal rate (the reference's stated
    simplification: a parity inside a burst is no safer than data)."""
    return (u_par >= torch.clamp(_f32(loss_rate, u_par), 0.0, 1.0)).float()


def recovery_upload_seconds(n_pkts: int, packet_floats: int, mbps,
                            loss_rate, retransmit, policy_sends):
    """``delivery.round_upload_seconds`` with the send count of clients
    that do not retransmit taken from the recovery policy instead of 1
    (one_shot rows pass 1 and are bitwise the plain expression).
    Finite always; ``INFEASIBLE_SECS`` on bad bandwidth."""
    bits = float(n_pkts * packet_floats * PACKET_BYTES_PER_FLOAT * 8)
    sends = torch.where(retransmit, retransmit_sends(loss_rate),
                        policy_sends)
    secs = bits * sends / (torch.clamp(mbps, min=RATE_EPS) * 1e6)
    ok = torch.isfinite(secs) & (secs > 0.0) \
        & torch.isfinite(mbps) & (mbps > 0.0)
    return torch.where(ok, secs, INFEASIBLE_SECS)


def residual_rate_mixed(onehot, loss_rate, retries, group: int):
    """Post-recovery residual loss rate, mixed by the policy one-hot.

    ``onehot`` (..., 3) selects among the closed forms of
    ``residual_loss_rate`` (one_shot r, fec r(1-(1-r)^G), arq r^(1+m));
    ``loss_rate`` broadcasts. The group_rate debias divides by this once
    recovery is built in: dividing by the raw channel rate after ARQ
    repaired most losses would over-inflate every insufficient client. A
    one_shot row mixes to 1*r + 0*r_fec + 0*r_arq, bitwise r."""
    r = torch.clamp(_f32(loss_rate, onehot), 0.0, 1.0)
    m = torch.clamp(_f32(retries, onehot), min=0.0)
    r_fec = r * (1.0 - _integer_pow(1.0 - r, group))
    r_arq = torch.pow(r, 1.0 + m)
    return (onehot[..., 0] * r + onehot[..., 1] * r_fec
            + onehot[..., 2] * r_arq)


def residual_loss_rate(policy: str, loss_rate, *, retries: float = 2.0,
                       group: int = 8) -> float:
    """Host-side closed form of the post-recovery per-packet loss rate:

      one_shot: r
      arq:      r^(1+m)                  (first send + m retries)
      fec:      r * (1 - (1-r)^G)        (lost, and not the group's
                                          sole loss with its parity)
    """
    r = float(np.clip(loss_rate, 0.0, 1.0))
    if policy == "one_shot":
        return r
    if policy == "arq":
        return r ** (1.0 + max(float(retries), 0.0))
    if policy == "fec":
        return r * (1.0 - (1.0 - r) ** int(group))
    raise ValueError(f"unknown recovery policy {policy!r}")
