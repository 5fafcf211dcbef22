"""Engine-facing entry point of the Gilbert–Elliott mask.

``ge_packet_mask`` broadcasts the channel parameters per row and calls
the ``repro_torch::netsim_mask`` op. On a CUDA tensor the op launches
the Hopper kernel (``netsim_mask.netsim_mask_call``); on a CPU tensor it
runs the plain version (``ref.ge_mask_ref``). Nothing else picks the
path. Under ``torch.func.vmap`` (the sweep's scenario axis) the op's
batching rule folds the scenarios into the rows, so a whole grid's
masks are one launch over S*C rows.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.common import fold_rows
from repro_torch.kernels.netsim_mask.netsim_mask import netsim_mask_call
from repro_torch.kernels.netsim_mask.ref import ge_mask_ref


@torch.library.custom_op("repro_torch::netsim_mask", mutates_args=(),
                         device_types="cpu")
def netsim_mask_op(u_t: torch.Tensor, u_e: torch.Tensor, s0: torch.Tensor,
                   p_gb: torch.Tensor, p_bg: torch.Tensor, h_g: torch.Tensor,
                   h_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, P) masks and (R,) final states; see ``ref.ge_mask_ref``."""
    return ge_mask_ref(u_t, u_e, s0, p_gb, p_bg, h_g, h_b)


@netsim_mask_op.register_kernel("cuda")
def _netsim_mask_cuda(u_t, u_e, s0, p_gb, p_bg, h_g, h_b):
    return netsim_mask_call(*(t.contiguous() for t in
                              (u_t, u_e, s0, p_gb, p_bg, h_g, h_b)))


@netsim_mask_op.register_vmap
def _netsim_mask_vmap(info, in_dims, *args):
    B = info.batch_size
    rows = [fold_rows(a, d, B) for a, d in zip(args, in_dims)]
    mask, s_fin = netsim_mask_op(*rows)
    return (mask.reshape(B, -1, mask.shape[-1]), s_fin.reshape(B, -1)), \
        (0, 0)


def ge_packet_mask(u_t, u_e, s0, p_gb, p_bg, h_g, h_b):
    """Gilbert–Elliott delivery masks for a cohort.

    u_t, u_e: (C, P) per-packet uniforms (transition / emission); s0:
    (C,) channel states; p_gb, p_bg, h_g, h_b: scalars or (C,)
    per-client probabilities (broadcast here).

    Returns (mask (C, P) f32 with 1 = delivered, s_final (C,) int32).
    """
    C = u_t.shape[0]

    def _c(v):
        v = torch.as_tensor(v, dtype=torch.float32, device=u_t.device)
        return v.expand(C).contiguous()

    return netsim_mask_op(u_t.contiguous(), u_e.contiguous(),
                          s0.to(torch.int32).contiguous(), _c(p_gb),
                          _c(p_bg), _c(h_g), _c(h_b))
