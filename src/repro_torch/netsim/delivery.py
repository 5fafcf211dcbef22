"""Deadline-based delivery: bandwidth and packets sent -> round outcome.

    secs_c      = P * packet_bytes * 8 * sends_c / (mbps_c * 1e6)
    sends_c     = 1/(1 - r_c) if client c retransmits (sufficient, or
                  TRA off), else 1 (it throws lost packets away)
    delivered_c = secs_c <= deadline_s and deadline_s > 0

Under the sync server a missed deadline drops the whole upload. The
expressions and their guards are the reference's
(``repro/netsim/delivery.py``), in float32: degenerate inputs give the
finite ``INFEASIBLE_SECS`` and a deterministic not-delivered bit.
``arrival_lateness`` counts the whole rounds an upload is late, which
the ``staleness_aware`` selection policy remembers and the async
server's buffer waits; ``grace_staleness`` is the fractional lateness
that discounts a semi_sync upload landing in the grace window.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import RATE_EPS

PACKET_BYTES_PER_FLOAT = 4  # f32 payload coordinates
# finite arrival time of an infeasible upload (no, zero or NaN bandwidth)
INFEASIBLE_SECS = 1.0e30
# cap on whole rounds late: ceil(secs / deadline) stays finite in f32
# even for INFEASIBLE_SECS over a tiny deadline
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


def arrival_lateness(secs, deadline_s) -> torch.Tensor:
    """(C,) f32 whole rounds late: 0 on time, ceil(secs / deadline) - 1
    otherwise, clamped to [0, MAX_LATENESS]. A degenerate deadline (<= 0
    or not finite) pins every upload at MAX_LATENESS, never NaN."""
    if not isinstance(deadline_s, torch.Tensor):
        deadline_s = torch.tensor(deadline_s, dtype=torch.float32,
                                  device=secs.device)
    dl_ok = (deadline_s > 0.0) & torch.isfinite(deadline_s)
    dl = torch.where(dl_ok, deadline_s, 1.0)
    late = torch.clamp(torch.ceil(secs / dl) - 1.0, 0.0, MAX_LATENESS)
    return torch.where(dl_ok & torch.isfinite(late), late, MAX_LATENESS)


def grace_staleness(secs, deadline_s) -> torch.Tensor:
    """(C,) f32 fractional staleness (secs - deadline) / deadline of the
    semi_sync grace-window discount, clamped to [0, MAX_LATENESS]; a
    degenerate deadline (<= 0 or not finite) pins it at MAX_LATENESS,
    never NaN."""
    if not isinstance(deadline_s, torch.Tensor):
        deadline_s = torch.tensor(deadline_s, dtype=torch.float32,
                                  device=secs.device)
    dl_ok = (deadline_s > 0.0) & torch.isfinite(deadline_s)
    dl = torch.where(dl_ok, deadline_s, 1.0)
    tau = torch.clamp((secs - dl) / dl, 0.0, MAX_LATENESS)
    return torch.where(dl_ok & torch.isfinite(tau), tau, MAX_LATENESS)
