"""Public entry point: apply a per-packet delivery mask to a flat update.

``apply_packet_mask`` pads the (D,) update to P packets and calls the
``repro_torch::packet_mask`` op. On a CUDA tensor the op launches the
Hopper kernel (``packet_mask.packet_mask_call``); on a CPU tensor it
runs the plain version (``ref.packet_mask_ref``). Nothing else picks the
path. Under ``torch.func.vmap`` (a cohort of uploads) the op's batching
rule folds the batch into the packet rows, so the whole cohort is one
launch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import fold_rows
from repro_torch.kernels.packet_mask.packet_mask import packet_mask_call
from repro_torch.kernels.packet_mask.ref import packet_mask_ref


@torch.library.custom_op("repro_torch::packet_mask", mutates_args=(),
                         device_types="cpu")
def packet_mask_op(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(R, F) rows times their (R,) delivery bits, in x's dtype."""
    return packet_mask_ref(x, mask)


@packet_mask_op.register_kernel("cuda")
def _packet_mask_cuda(x, mask):
    return packet_mask_call(x.contiguous(), mask.contiguous())


@packet_mask_op.register_vmap
def _packet_mask_vmap(info, in_dims, x, mask):
    B = info.batch_size
    out = packet_mask_op(fold_rows(x, in_dims[0], B).contiguous(),
                         fold_rows(mask, in_dims[1], B).contiguous())
    return out.reshape(B, -1, out.shape[-1]), 0


def apply_packet_mask(vec: torch.Tensor, pkt_mask: torch.Tensor,
                      packet_floats: int = 256) -> torch.Tensor:
    """vec: (D,) float32 or bfloat16; pkt_mask: (P,) with
    P = ceil(D / packet_floats) -> (D,) with lost packets' coordinates
    multiplied by 0."""
    D = vec.shape[0]
    P = pkt_mask.shape[0]
    x = F.pad(vec, (0, P * packet_floats - D)).reshape(P, packet_floats)
    return packet_mask_op(x, pkt_mask.float()).reshape(-1)[:D]
