"""Public entry points of the TRA debiased aggregation.

Debias modes (how the server debiases zero-filled uploads):
  per_coord_count  the kernel's own estimator: per-coordinate masked
                   mean, sum_c w_c m_c x_c / sum_c w_c m_c
  per_client_rate  each client rescaled by 1 / its kept fraction, over
                   the full weight sum
  group_rate       paper Eq. (1), corrected: insufficient clients
                   rescaled by 1 / (1 - r), over the full weight sum
  none             zero-filled weighted mean (biased; for ablation)

The three rescaling modes pre-scale x and replace the mask by ones before
the kernel, with the reference's expressions in the reference's order
(``repro/kernels/tra_agg/ops.py``), so the pre-scaled tensor is bitwise
the reference's. ``tra_aggregate`` is the flat (C, D) entry point;
``tra_aggregate_packed`` takes a packetised (C, P, F) view.

Both call the ``repro_torch::tra_agg`` op. On a CUDA tensor the op
launches the Hopper kernel (``tra_agg.tra_agg_call``); on a CPU tensor it
runs the plain version (``ref.tra_agg_ref``). Nothing else picks the
path, whatever P is. Under ``torch.func.vmap`` the op's batching rule
calls ``repro_torch::tra_agg_batched``: one launch of the kernel's
scenario grid for the whole batch, bitwise equal to single launches.

The engine does not call through here: its round step folds the same
mode semantics into the uplink megakernel (``kernels/uplink_fused``);
``tests/test_torch_protocol.py`` locks the two together.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import RATE_EPS
from repro_torch.kernels.tra_agg.ref import tra_agg_ref
from repro_torch.kernels.tra_agg.tra_agg import (tra_agg_batched_call,
                                                 tra_agg_call)

DEBIAS_MODES = ("per_coord_count", "per_client_rate", "group_rate", "none")


@torch.library.custom_op("repro_torch::tra_agg", mutates_args=(),
                         device_types="cpu")
def tra_agg_op(x: torch.Tensor, m: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """(P, F) aggregate of x (C, P, F) under mask m (C, P) and weights
    w (C,); see ``ref.tra_agg_ref``."""
    return tra_agg_ref(x, m, w)


@tra_agg_op.register_kernel("cuda")
def _tra_agg_cuda(x, m, w):
    return tra_agg_call(x.contiguous(), m.contiguous(), w.contiguous())


@torch.library.custom_op("repro_torch::tra_agg_batched", mutates_args=(),
                         device_types="cpu")
def tra_agg_batched_op(x: torch.Tensor, m: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """S aggregates: ``tra_agg_op`` with a leading S on every operand."""
    return tra_agg_ref(x, m, w)


@tra_agg_batched_op.register_kernel("cuda")
def _tra_agg_batched_cuda(x, m, w):
    return tra_agg_batched_call(x.contiguous(), m.contiguous(),
                                w.contiguous())


@tra_agg_op.register_vmap
def _tra_agg_vmap(info, in_dims, x, m, w):
    B = info.batch_size

    def lead(t, d):
        return t.unsqueeze(0).expand(B, *t.shape) if d is None \
            else t.movedim(d, 0)

    return tra_agg_batched_op(*(lead(t, d) for t, d in
                                zip((x, m, w), in_dims))), 0


def debias_inputs(x, pkt_mask, *, mode, kept_frac=None, nominal_rate=None,
                  sufficient=None):
    """The kernel's (x, mask) for debias ``mode``: per_coord_count keeps
    both; the other modes replace the mask by ones, per_client_rate
    divides each client by max(kept, RATE_EPS) and group_rate multiplies
    insufficient clients by 1 / max(1 - r, RATE_EPS), a reciprocal
    first, then a multiply."""
    if mode not in DEBIAS_MODES:
        raise ValueError(f"unknown debias mode {mode!r}")
    if mode == "per_coord_count":
        return x, pkt_mask
    if mode == "per_client_rate":
        if kept_frac is None:
            raise ValueError("per_client_rate needs kept_frac")
        x = x / torch.clamp(kept_frac, min=RATE_EPS)[:, None, None]
    elif mode == "group_rate":
        if nominal_rate is None or sufficient is None:
            raise ValueError("group_rate needs nominal_rate and sufficient")
        scale = torch.where(sufficient.bool(), 1.0,
                            1.0 / torch.clamp(1.0 - nominal_rate,
                                              min=RATE_EPS))
        x = x * scale[:, None, None]
    return x, torch.ones_like(pkt_mask)


def tra_aggregate_packed(x, pkt_mask, weights, *, mode="per_coord_count",
                         kept_frac=None, nominal_rate=None,
                         sufficient=None):
    """Debias and aggregate a packetised update tensor.

    x: (C, P, F) already masked; pkt_mask: (C, P); weights: (C,), need
    not be normalised; ``kept_frac`` (C,) for per_client_rate,
    ``nominal_rate`` and ``sufficient`` (C,) for group_rate. Returns the
    (P, F) f32 aggregate (the caller flattens and truncates to (D,)).
    """
    x, m = debias_inputs(x, pkt_mask, mode=mode, kept_frac=kept_frac,
                         nominal_rate=nominal_rate, sufficient=sufficient)
    return tra_agg_op(x.float(), m.float(), weights.float())


def tra_aggregate(updates, pkt_mask, weights, *, mode="per_coord_count",
                  kept_frac=None, nominal_rate=None, sufficient=None,
                  packet_floats: int = 256):
    """updates: (C, D) already masked; pkt_mask: (C, P); weights: (C,).

    Returns the (D,) aggregated update; see ``tra_aggregate_packed``.
    """
    C, D = updates.shape
    P = -(-D // packet_floats)
    x = F.pad(updates, (0, P * packet_floats - D)).reshape(
        C, P, packet_floats)
    out = tra_aggregate_packed(x, pkt_mask, weights, mode=mode,
                               kept_frac=kept_frac,
                               nominal_rate=nominal_rate,
                               sufficient=sufficient)
    return out.reshape(-1)[:D]
