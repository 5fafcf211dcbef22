"""Public entry points of the q-FedAvg server reweighting.

``qfed_reweight`` is the flat (C, D) entry point; ``qfed_reweight_packed``
takes a packetised (C, P, F) view. Both form fq = (F_k + 1e-10)^q and
h_k = q (F_k + 1e-10)^(q-1) ||dw_k||^2 + L fq here, with the reference's
expressions in the reference's order (``repro/kernels/qfed_reweight/
ops.py``), and call the ``repro_torch::qfed_reweight`` op for the
scaled pseudo-gradients and the squared norms. On a CUDA tensor the op
is one launch of the Hopper kernel (``qfed_reweight.qfed_reweight_call``),
which returns both outputs as they are: one device op, the norms reduced
inside the kernel; on a CPU tensor it runs the plain version
(``ref.qfed_reweight_ref``). Nothing else picks the path. Under
``torch.func.vmap`` the op's batching rule folds the batch into the
clients: one launch, bitwise the single calls.

The engine does not call through here: its round step takes the masked
norms from the uplink megakernel and forms delta and h inline.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import fold_rows
from repro_torch.kernels.qfed_reweight.qfed_reweight import \
    qfed_reweight_call
from repro_torch.kernels.qfed_reweight.ref import qfed_reweight_ref

LOSS_EPS = 1e-10


@torch.library.custom_op("repro_torch::qfed_reweight", mutates_args=(),
                         device_types="cpu")
def qfed_reweight_op(dw: torch.Tensor, fq: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delta (C, P, F), ssq (C,)) of dw (C, P, F) and fq (C,); see
    ``ref.qfed_reweight_ref``."""
    return qfed_reweight_ref(dw, fq)


@qfed_reweight_op.register_kernel("cuda")
def _qfed_reweight_cuda(dw, fq):
    return qfed_reweight_call(dw.contiguous(), fq.contiguous())


@qfed_reweight_op.register_vmap
def _qfed_reweight_vmap(info, in_dims, dw, fq):
    B = info.batch_size
    delta, ssq = qfed_reweight_op(fold_rows(dw, in_dims[0], B),
                                  fold_rows(fq, in_dims[1], B))
    return (delta.reshape(B, -1, *delta.shape[1:]),
            ssq.reshape(B, -1)), (0, 0)


def qfed_reweight_packed(x, losses, q: float, lipschitz: float):
    """x: (C, P, F) pseudo-gradients (zero-padded); losses: (C,) F_k >= 0.

    Returns (delta (C, P, F), h (C,)) per q-FedAvg:
        delta_k = F_k^q dw_k
        h_k     = q F_k^(q-1) ||dw_k||^2 + L F_k^q
    """
    fq = torch.pow(losses + LOSS_EPS, q)
    delta, ssq = qfed_reweight_op(x.float(), fq.float())
    h = q * torch.pow(losses + LOSS_EPS, q - 1) * ssq + lipschitz * fq
    return delta, h


def qfed_reweight(dw, losses, q: float, lipschitz: float,
                  packet_floats: int = 256):
    """dw: (C, D) pseudo-gradients; losses: (C,) client losses F_k >= 0.

    Returns (delta (C, D), h (C,)); see ``qfed_reweight_packed``.
    """
    C, D = dw.shape
    P = -(-D // packet_floats)
    x = F.pad(dw, (0, P * packet_floats - D)).reshape(C, P, packet_floats)
    delta, h = qfed_reweight_packed(x, losses, q, lipschitz)
    return delta.reshape(C, -1)[:, :D], h
