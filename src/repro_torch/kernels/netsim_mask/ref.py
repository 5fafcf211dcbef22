"""Plain PyTorch version of the Gilbert–Elliott mask kernel.

The reference's oracle (``repro/kernels/netsim_mask/ref.py``), a scan
over the packet axis, as a Python loop over P. It uses only float32
comparisons and selects, so it is bitwise the reference and the CUDA
kernel. The engine runs it for tensors on the CPU; the tests and
``chip_smoke.py`` hold the kernel against it.
"""
from __future__ import annotations

import torch


def ge_mask_ref(u_t, u_e, s0, p_gb, p_bg, h_g, h_b):
    """u_t, u_e: (R, P) f32 transition / emission uniforms; s0: (R,)
    int32 states (0=GOOD, 1=BAD); p_gb, p_bg, h_g, h_b: (R,) f32.

    Per packet: transition first (flip with p_gb from GOOD, p_bg from
    BAD), then emission at the new state's loss rate. Returns (mask
    (R, P) f32 with 1 = delivered, s_final (R,) int32)."""
    s = s0.to(torch.int32).clone()
    cols = []
    for p in range(u_t.shape[-1]):
        flip = torch.where(s == 1, p_bg, p_gb)
        s = torch.where(u_t[..., p] < flip, 1 - s, s)
        h = torch.where(s == 1, h_b, h_g)
        cols.append((u_e[..., p] >= h).to(torch.float32))
    return torch.stack(cols, dim=-1), s
