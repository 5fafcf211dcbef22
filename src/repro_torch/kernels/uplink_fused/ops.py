"""Engine-facing entry point of the fused uplink step.

``uplink_round`` performs the whole server uplink step — EF re-inject,
delivery-mask fold, per-mode debias scaling (all four DEBIAS_MODES),
weighted aggregation with fp32 accumulation, the new EF memory rows and
(for q-FedAvg) the masked per-client squared norms — in one pass over
the (C, P, F) upload tensor, through the ``repro_torch::uplink_fused``
op. On a CUDA tensor the op launches the Hopper kernel
(``uplink_fused.uplink_fused_call``); on a CPU tensor it runs the plain
version (``ref.uplink_ref``). Nothing else picks the path.

Scenario batching: under ``torch.func.vmap`` (the sweep engine's
scenario axis) the op's batching rule calls
``repro_torch::uplink_fused_batched``, one launch of the kernel's
scenario grid (``uplink_fused_batched_call``) for all S scenarios,
bitwise equal to S single calls. A ctypes launch cannot run under vmap
itself; these registered ops are what let it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.tra import DEBIAS_MODES
from repro_torch.kernels.common import DENOM_EPS, RATE_EPS
from repro_torch.kernels.uplink_fused.ref import uplink_ref
from repro_torch.kernels.uplink_fused.uplink_fused import (
    uplink_fused_batched_call, uplink_fused_call)


def _outputs(agg, ef_out, ssq_partials):
    """Kernel outputs in the ops' form: an absent output is an empty
    tensor, and ssq is summed over its per-packet partials."""
    def none():
        return torch.empty(0, device=agg.device)

    return (agg, none() if ef_out is None else ef_out,
            none() if ssq_partials is None else ssq_partials.sum(dim=-1))


def _plain(x, m, q, w_or_den, ef, want_ssq, per_coord):
    agg, ef_out, ssq = uplink_ref(x, m, q, w_or_den, ef=ef,
                                  want_ssq=want_ssq, per_coord=per_coord)
    if ef_out is not None:
        ef_out = ef_out.to(x.dtype)      # written back in the stream dtype
    return agg, torch.empty(0) if ef_out is None else ef_out, \
        torch.empty(0) if ssq is None else ssq


@torch.library.custom_op("repro_torch::uplink_fused", mutates_args=(),
                         device_types="cpu")
def uplink_fused_op(x: torch.Tensor, m: torch.Tensor, q: torch.Tensor,
                    w_or_den: torch.Tensor, ef: Optional[torch.Tensor],
                    want_ssq: bool, per_coord: bool
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One scenario's uplink: (agg (P, F) f32, ef_out (C, P, F) in the
    stream dtype or empty, ssq (C,) or empty). Operands as in
    ``uplink_fused.uplink_fused_call``."""
    return _plain(x, m, q, w_or_den, ef, want_ssq, per_coord)


@uplink_fused_op.register_kernel("cuda")
def _uplink_fused_cuda(x, m, q, w_or_den, ef, want_ssq, per_coord):
    return _outputs(*uplink_fused_call(x, m, q, w_or_den, ef=ef,
                                       want_ssq=want_ssq,
                                       per_coord=per_coord))


@torch.library.custom_op("repro_torch::uplink_fused_batched",
                         mutates_args=(), device_types="cpu")
def uplink_fused_batched_op(x: torch.Tensor, m: torch.Tensor,
                            q: torch.Tensor, w_or_den: torch.Tensor,
                            ef: Optional[torch.Tensor], want_ssq: bool,
                            per_coord: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """S scenarios' uplink: ``uplink_fused_op`` with a leading S on
    every operand and output."""
    return _plain(x, m, q, w_or_den, ef, want_ssq, per_coord)


@uplink_fused_batched_op.register_kernel("cuda")
def _uplink_fused_batched_cuda(x, m, q, w_or_den, ef, want_ssq, per_coord):
    return _outputs(*uplink_fused_batched_call(
        x, m, q, w_or_den, ef=ef, want_ssq=want_ssq, per_coord=per_coord))


@uplink_fused_op.register_vmap
def _uplink_fused_vmap(info, in_dims, x, m, q, w_or_den, ef, want_ssq,
                       per_coord):
    B = info.batch_size

    def lead(t, d):
        t = t.unsqueeze(0).expand(B, *t.shape) if d is None \
            else t.movedim(d, 0)
        return t.contiguous()

    x, m, q, w_or_den = (lead(t, d) for t, d in
                         zip((x, m, q, w_or_den), in_dims))
    if ef is not None:
        ef = lead(ef, in_dims[4])
    outs = uplink_fused_batched_op(x, m, q, w_or_den, ef, want_ssq,
                                   per_coord)
    return outs, (0, 0 if ef is not None else None,
                  0 if want_ssq else None)


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

    agg, ef_out, ssq = uplink_fused_op(
        x.contiguous(), pkt_mask.float().contiguous(),
        q_c.float().contiguous(), w_or_den.float().contiguous(),
        None if ef_s is None else ef_s.contiguous(), want_ssq, per_coord)

    new_ef_rows = ef_out.reshape(C, P * F_)[:, :d_up] \
        if ef_s is not None else None
    return agg.reshape(-1)[:d_up], new_ef_rows, ssq if want_ssq else None


def uplink_round_scenarios(xp, pkt_mask, weights, *, mode: str, d_up: int,
                           ef_rows=None, kept=None, sufficient=None,
                           loss_rate=None, mult=None, want_ssq=False,
                           stream_dtype=None):
    """Scenario-batched (S, C, P, F) entry: ``uplink_round`` vmapped
    over the leading axis of every operand given, which lands in one
    launch of the batched kernel on the card."""
    optional = dict(ef_rows=ef_rows, kept=kept, sufficient=sufficient,
                    loss_rate=loss_rate, mult=mult)
    names = [k for k, v in optional.items() if v is not None]

    def one(xp, pkt_mask, weights, *opts):
        outs = uplink_round(
            xp, pkt_mask, weights, mode=mode, d_up=d_up, want_ssq=want_ssq,
            stream_dtype=stream_dtype, **dict(zip(names, opts)))
        return tuple(o for o in outs if o is not None)

    outs = list(torch.func.vmap(one)(xp, pkt_mask, weights,
                                     *[optional[k] for k in names]))
    agg = outs.pop(0)
    new_ef = outs.pop(0) if ef_rows is not None else None
    ssq = outs.pop(0) if want_ssq else None
    return agg, new_ef, ssq
