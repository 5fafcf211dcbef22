"""Plain PyTorch version of the packet-mask kernel.

The reference's oracle (``repro/kernels/packet_mask/ref.py``): each
packet row times its delivery bit, the bit cast to x's dtype first. A
multiply, not a select, so NaN * 0 stays NaN and -x * 0 is -0.0. The
op runs it for tensors on the CPU; the tests and ``chip_smoke.py`` hold
the CUDA kernel against it.
"""
from __future__ import annotations

import torch


def packet_mask_ref(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x: (P, F); mask: (P,) -> (P, F) in x's dtype."""
    return x * mask.to(x.dtype)[:, None]
