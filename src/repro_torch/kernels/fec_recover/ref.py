"""Plain PyTorch version of the FEC repair kernel.

The reference's oracle (``repro/kernels/fec_recover/ref.py``): XOR-parity
group repair as a reshape plus a per-group reduction. The masks are 0/1,
so the sums are exact and the result is bitwise the reference's and the
CUDA kernel's. The engine runs it for tensors on the CPU; the tests and
``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def fec_recover_ref(mask, parity, group: int):
    """mask: (R, P) f32 delivery mask (1 = delivered); parity: (R, Gn)
    f32 parity-packet delivery mask, Gn = ceil(P / group).

    A group of ``group`` consecutive data packets with exactly one loss
    is repaired when its parity packet arrived (the XOR of the group
    rebuilds the one missing packet; two or more losses are beyond one
    parity). Packets past P in the last group count as delivered.
    Returns the repaired (R, P) mask: entries only ever flip 0 -> 1."""
    R, P = mask.shape
    gn = parity.shape[1]
    m = F.pad(mask, (0, gn * group - P), value=1.0).reshape(R, gn, group)
    n_lost = (1.0 - m).sum(dim=2)                        # (R, Gn)
    repair = (n_lost == 1.0) & (parity > 0.5)            # (R, Gn)
    out = torch.where(repair[:, :, None] & (m < 0.5), 1.0, m)
    return out.reshape(R, gn * group)[:, :P]
