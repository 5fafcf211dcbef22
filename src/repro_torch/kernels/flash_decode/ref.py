"""Plain PyTorch version of the flash-decode kernel.

The reference's oracle (``repro/kernels/flash_decode/ref.py``): scores
``q.k * dh**-0.5 + bias`` in f32, a softmax over T, then ``p.v``, all
in f32 whatever the K/V dtype. The op runs it for tensors on the CPU;
the tests and ``chip_smoke.py`` hold the CUDA kernel against it.
"""
from __future__ import annotations

import torch


def flash_decode_ref(q, k, v, bias):
    """q: (B,KV,G,dh); k,v: (B,T,KV,dh); bias: (T,) -> (B,KV,G,dh) f32."""
    dh = q.shape[-1]
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k.float()) * dh ** -0.5
    s = s + bias.float()[None, None, None, :]
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p, v.float())
