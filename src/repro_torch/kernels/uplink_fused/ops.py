"""Engine-facing entry point of the fused uplink step.

``uplink_round`` performs the whole server uplink step — EF re-inject,
delivery-mask fold, per-mode debias scaling (all four DEBIAS_MODES),
weighted aggregation with fp32 accumulation, the new EF memory rows and
(for q-FedAvg) the masked per-client squared norms — in one pass over
the (C, P, F) upload tensor. On a CUDA tensor it launches the Hopper
kernel (``uplink_fused.uplink_fused_call``); on a CPU tensor it runs the
plain version (``ref.uplink_ref``). Nothing else picks the path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.tra import DEBIAS_MODES
from repro_torch.kernels.common import DENOM_EPS, RATE_EPS
from repro_torch.kernels.uplink_fused.ref import uplink_ref
from repro_torch.kernels.uplink_fused.uplink_fused import uplink_fused_call


def debias_client_scale(weights, *, mode, kept=None, sufficient=None,
                        loss_rate=None, mult=None):
    """Fold the per-mode debias estimator into per-client scales q_c
    (the reference's expressions and guards, one for one)."""
    q_c = weights if mult is None else weights * mult
    if mode == "per_client_rate":
        q_c = q_c / torch.clamp(kept, min=RATE_EPS)
    elif mode == "group_rate":
        loss_rate = torch.as_tensor(loss_rate, dtype=torch.float32,
                                    device=weights.device)
        q_c = q_c * torch.where(
            sufficient.bool(), 1.0,
            1.0 / torch.clamp(1.0 - loss_rate, min=RATE_EPS))
    return q_c


def _pack_rows(rows, P: int, F_: int):
    """(C, d) rows -> zero-padded (C, P, F) packet view."""
    C, d = rows.shape
    return F.pad(rows, (0, P * F_ - d)).reshape(C, P, F_)


def uplink_round(xp, pkt_mask, weights, *, mode: str, d_up: int,
                 ef_rows=None, kept=None, sufficient=None, loss_rate=None,
                 mult=None, want_ssq: bool = False, stream_dtype=None):
    """One fused uplink step over a packetised cohort.

    xp: (C, P, F) unmasked uploads without error feedback; pkt_mask:
    (C, P); weights: (C,) aggregation weights (they enter the
    denominator); ef_rows: (C, d_up) EF memory rows or None; kept /
    sufficient (C,) and loss_rate (scalar or (C,)) feed the per-mode
    scales as in ``debias_client_scale``; ``mult`` scales clients on top
    of ``weights`` without entering the denominator (q-FedAvg's F^q).

    Returns ``(agg (d_up,), new_ef_rows (C, d_up) | None, ssq (C,) |
    None)``, ssq being the masked squared norms of the EF-adjusted
    uploads. ``stream_dtype`` (e.g. torch.bfloat16) streams uploads and
    EF in that dtype with fp32 accumulation; None keeps f32.
    """
    if mode not in DEBIAS_MODES:
        raise ValueError(f"unknown debias mode {mode!r}")
    C, P, F_ = xp.shape
    q_c = debias_client_scale(weights, mode=mode, kept=kept,
                              sufficient=sufficient, loss_rate=loss_rate,
                              mult=mult)
    per_coord = mode == "per_coord_count"
    w_or_den = weights if per_coord \
        else torch.clamp(weights.sum(), min=DENOM_EPS)
    ef_p = _pack_rows(ef_rows, P, F_) if ef_rows is not None else None
    x = xp if stream_dtype is None else xp.to(stream_dtype)
    ef_s = ef_p if ef_p is None or stream_dtype is None \
        else ef_p.to(stream_dtype)

    if xp.is_cuda:
        agg, ef_out, ssq = uplink_fused_call(
            x.contiguous(), pkt_mask.float().contiguous(),
            q_c.float().contiguous(), w_or_den.float().contiguous(),
            ef=None if ef_s is None else ef_s.contiguous(),
            want_ssq=want_ssq, per_coord=per_coord)
        if ssq is not None:
            ssq = ssq.sum(dim=-1)
    elif xp.device.type == "cpu":
        agg, ef_out, ssq = uplink_ref(x, pkt_mask, q_c, w_or_den, ef=ef_s,
                                      want_ssq=want_ssq,
                                      per_coord=per_coord)
        if ef_out is not None and stream_dtype is not None:
            ef_out = ef_out.to(stream_dtype)
    else:
        raise ValueError(f"no uplink path for device {xp.device}")

    new_ef_rows = ef_out.reshape(C, P * F_)[:, :d_up] \
        if ef_out is not None else None
    return agg.reshape(-1)[:d_up], new_ef_rows, ssq
