"""Deadline-based delivery: bandwidth and packets sent -> round outcome.

    secs_c      = P * packet_bytes * 8 * sends_c / (mbps_c * 1e6)
    sends_c     = 1/(1 - r_c) if client c retransmits (sufficient, or
                  TRA off), else 1 (it throws lost packets away)
    delivered_c = secs_c <= deadline_s and deadline_s > 0

Under the sync server a missed deadline drops the whole upload. The
expressions and their guards are the reference's
(``repro/netsim/delivery.py``), in float32: degenerate inputs give the
finite ``INFEASIBLE_SECS`` and a deterministic not-delivered bit.
The async server's ``arrival_lateness`` and ``grace_staleness`` come
with the async slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import RATE_EPS

PACKET_BYTES_PER_FLOAT = 4  # f32 payload coordinates
# finite arrival time of an infeasible upload (no, zero or NaN bandwidth)
INFEASIBLE_SECS = 1.0e30
# cap on whole rounds late (read by the async slice)
MAX_LATENESS = 1.0e6


def retransmit_sends(loss_rate) -> torch.Tensor:
    """Expected sends per packet under unbounded retransmission,
    1/(1-r), saturating at 1/RATE_EPS as r -> 1 (the reference's
    ``netsim/recovery.retransmit_sends``)."""
    r = torch.clamp(torch.as_tensor(loss_rate, dtype=torch.float32),
                    0.0, 1.0)
    return 1.0 / torch.clamp(1.0 - r, min=RATE_EPS)


def round_upload_seconds(n_pkts: int, packet_floats: int, mbps,
                         loss_rate, retransmit) -> torch.Tensor:
    """(C,) seconds to complete this round's upload; ``loss_rate`` may
    be a scalar. Degenerate inputs give ``INFEASIBLE_SECS``."""
    bits = float(n_pkts * packet_floats * PACKET_BYTES_PER_FLOAT * 8)
    sends = torch.where(retransmit, retransmit_sends(loss_rate), 1.0)
    secs = bits * sends / (torch.clamp(mbps, min=RATE_EPS) * 1e6)
    ok = torch.isfinite(secs) & (secs > 0.0) \
        & torch.isfinite(mbps) & (mbps > 0.0)
    return torch.where(ok, secs, INFEASIBLE_SECS)


def deadline_delivered(secs, deadline_s) -> torch.Tensor:
    """(C,) f32: 1 made the deadline, 0 missed it. A degenerate
    deadline (<= 0 or NaN) delivers nothing."""
    return ((secs <= deadline_s) & (deadline_s > 0.0)).to(torch.float32)
