"""Plain PyTorch version of the uplink megakernel.

Expression for expression the reference's jnp oracle
(``repro/kernels/uplink_fused/ref.py``): EF re-inject, one
debias-aggregate einsum, the EF-update product and q-FedAvg's masked
squared norms. The engine runs it for tensors on the CPU; the tests and
``chip_smoke.py`` hold the CUDA kernel against it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import DENOM_EPS


def uplink_ref(x, m, q, w_or_den, *, ef=None, want_ssq=False,
               per_coord: bool, eps: float = DENOM_EPS):
    """x: (C, P, F) unmasked uploads; ef: (C, P, F) or None; m: (C, P);
    q: (C,) pre-folded debias scales; ``w_or_den``: raw weights (C,)
    when ``per_coord``, else the ready scalar denominator ().

    Returns (agg (P, F) f32, ef_out (C, P, F) f32 | None, ssq (C,) | None).
    Every operand may carry a leading scenario axis S (the batched
    kernel's plain version); each scenario's results are then its own.
    """
    x = x.float()
    if ef is not None:
        x = x + ef.float()
    wm = m * q[..., None]
    num = torch.einsum("...cpf,...cp->...pf", x, wm)
    if per_coord:
        den = torch.clamp((m * w_or_den[..., None]).sum(-2),
                          min=eps)[..., None]
    else:
        den = w_or_den[..., None, None]
    agg = num / den
    ef_out = x * (1.0 - m[..., None]) if ef is not None else None
    ssq = ((x * x).sum(-1) * m).sum(-1) if want_ssq else None
    return agg, ef_out, ssq
