"""Plain PyTorch version of the TRA aggregation kernel.

The reference's oracle (``repro/kernels/tra_agg/ref.py``), expression for
expression: one masked-weight einsum over the clients, divided by the
guarded masked weight sum. Every operand may carry a leading scenario
axis S (the plain version of the op's batched route). The op runs it for
tensors on the CPU; the tests and ``chip_smoke.py`` hold the CUDA kernel
against it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import DENOM_EPS


def tra_agg_ref(x, mask, w, eps: float = DENOM_EPS):
    """x: (..., C, P, F); mask: (..., C, P); w: (..., C) -> (..., P, F)
    f32."""
    wm = mask.float() * w.float()[..., None]                  # (C, P)
    num = torch.einsum("...cpf,...cp->...pf", x.float(), wm)
    den = torch.clamp(wm.sum(-2), min=eps)
    return num / den[..., None]
