"""Public entry points: the decode mask and flash-decode attention.

``flash_decode`` takes the reference's layouts (q (B,1,H,dh) or
(B,H,dh); k, v (B,T,KV,dh) in f32 or bf16) and returns (B,H,dh) in f32.
It calls the ``repro_torch::flash_decode`` op: on a CUDA tensor the op
launches the Hopper kernel (``flash_decode.flash_decode_call``); on a
CPU tensor it runs the plain version (``ref.flash_decode_ref``). Nothing
else picks the path. No path vmaps it, so it has no batching rule.

The T rule. The reference's kernel asserts ``T % t_blk == 0`` and its op
falls back to the plain version otherwise. The port's kernel takes any
T >= 1 and stops each split at T itself: ``t_blk`` is the shortest T
split it makes (a tuning knob, never a restriction), and the plain
version runs only for CPU tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_decode.flash_decode import flash_decode_call
from repro_torch.kernels.flash_decode.ref import flash_decode_ref

NEG_INF = -1e30


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=(),
                         device_types="cpu")
def flash_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, t_blk: int) -> torch.Tensor:
    """(B,KV,G,dh) f32 attention of q (B,KV,G,dh) over k, v (B,T,KV,dh)
    under the additive mask bias (T,); see ``ref.flash_decode_ref``."""
    return flash_decode_ref(q, k, v, bias)


@flash_decode_op.register_kernel("cuda")
def _flash_decode_cuda(q, k, v, bias, t_blk):
    return flash_decode_call(q.float().contiguous(), k.contiguous(),
                             v.contiguous(), bias.float().contiguous(),
                             t_blk=t_blk)


def decode_bias(T: int, pos, window=None, is_global=None,
                device=None) -> torch.Tensor:
    """(T,) f32 additive mask: 0 for attendable positions (at or before
    ``pos``, and inside the window unless ``is_global``), -1e30
    otherwise; bitwise the reference's."""
    idx = torch.arange(T, device=device)
    valid = idx <= pos
    if window is not None:
        local = idx > (pos - window)
        if is_global is not None:
            local = local | is_global
        valid &= local
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def flash_decode(q, k, v, pos, *, window=None, is_global=None,
                 t_blk: int = 512,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B,1,H,dh) or (B,H,dh); k,v: (B,T,KV,dh). Returns (B,H,dh) f32.

    ``bias`` is the (T,) mask ``decode_bias(T, pos, window, is_global)``
    builds, for a caller that builds it once for many calls (the decode
    step, once per step and layer kind); then pos, window and is_global
    are not read."""
    if q.dim() == 4:
        q = q[:, 0]
    B, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    if bias is None:
        bias = decode_bias(T, pos, window, is_global, device=k.device)
    out = flash_decode_op(q.reshape(B, KV, H // KV, dh), k, v, bias, t_blk)
    return out.reshape(B, H, dh)
