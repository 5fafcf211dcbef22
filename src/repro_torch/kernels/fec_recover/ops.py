"""Engine-facing entry point of the FEC group repair.

``fec_recover`` calls the ``repro_torch::fec_recover`` op. On a CUDA
tensor the op launches the Hopper kernel (``fec_recover.fec_recover_call``);
on a CPU tensor it runs the plain version (``ref.fec_recover_ref``).
Nothing else picks the path. Under ``torch.func.vmap`` (the sweep's
scenario axis) the op's batching rule folds the scenarios into the rows,
so a whole grid's repair is one launch over S*C rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import fold_rows
from repro_torch.kernels.fec_recover.fec_recover import fec_recover_call
from repro_torch.kernels.fec_recover.ref import fec_recover_ref


@torch.library.custom_op("repro_torch::fec_recover", mutates_args=(),
                         device_types="cpu")
def fec_recover_op(mask: torch.Tensor, parity: torch.Tensor,
                   group: int) -> torch.Tensor:
    """(R, P) repaired mask; see ``ref.fec_recover_ref``."""
    return fec_recover_ref(mask, parity, group)


@fec_recover_op.register_kernel("cuda")
def _fec_recover_cuda(mask, parity, group):
    return fec_recover_call(mask.contiguous(), parity.contiguous(),
                            group=group)


@fec_recover_op.register_vmap
def _fec_recover_vmap(info, in_dims, mask, parity, group):
    B = info.batch_size
    out = fec_recover_op(fold_rows(mask, in_dims[0], B),
                         fold_rows(parity, in_dims[1], B), group)
    return out.reshape(B, -1, out.shape[-1]), 0


def fec_recover(mask, parity, *, group: int):
    """Group-parity mask repair for a cohort.

    mask: (C, P) f32 delivery mask (1 = delivered); parity: (C, Gn) f32
    parity delivery mask with Gn = ceil(P / group). Returns the repaired
    (C, P) f32 mask: a group with exactly one data loss and a delivered
    parity has that loss flipped back to delivered.
    """
    return fec_recover_op(mask.float().contiguous(),
                          parity.float().contiguous(), int(group))
