"""Plain PyTorch version of the q-FedAvg reweighting kernel.

The reference's oracle (``repro/kernels/qfed_reweight/ref.py``): the
scaled pseudo-gradients and each client's squared norm. The op runs it
for tensors on the CPU; the tests and ``chip_smoke.py`` hold the CUDA
kernel against it.
"""
from __future__ import annotations

import torch


def qfed_reweight_ref(dw, fq):
    """dw: (C, P, F); fq: (C,) -> (delta (C, P, F) f32, ssq (C,))."""
    dw = dw.float()
    delta = dw * fq.float()[:, None, None]
    ssq = (dw * dw).sum(dim=(1, 2))
    return delta, ssq
