"""Binding of the Hopper packet-mask kernel (``csrc/packet_mask.cu``).

``packet_mask_call`` launches the CUDA kernel on tensors that lie on the
card and raises on anything else: there is no fallback here. The choice
between the kernel and its plain version (``ref.py``) is made by the
``repro_torch::packet_mask`` op in ``ops.py``, by device alone.
``LAUNCHES`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.uplink_fused.uplink_fused import _check

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("packet_mask")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.packet_mask_launch.argtypes = [ptr, ptr, ptr, ctypes.c_longlong,
                                       i32, i32, i32, i32, ptr]
    lib.packet_mask_launch.restype = i32
    lib.packet_mask_error_string.argtypes = [i32]
    lib.packet_mask_error_string.restype = ctypes.c_char_p
    return lib


def packet_mask_call(x, mask):
    """One launch of the packet-mask kernel.

    x: (R, F) float32 or bfloat16 packet rows on the card; mask: (R,)
    f32 delivery bits; both contiguous. R is P for one upload and B*P
    for a vmapped cohort. Returns x * mask[:, None] in x's dtype.
    """
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError("packet_mask_call runs on CUDA tensors only; the "
                         "plain version is ref.packet_mask_ref")
    if x.dim() != 2:
        raise ValueError(f"x must be (R, F), not {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    R, F = x.shape
    dev = x.device
    _check("x", x, (R, F), x.dtype, dev)
    _check("mask", mask, (R,), torch.float32, dev)
    out = torch.empty_like(x)
    if R == 0 or F == 0:
        return out
    vec4 = (x.dtype == torch.float32 and F % 4 == 0
            and x.data_ptr() % 16 == 0)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES += 1
    err = lib.packet_mask_launch(x.data_ptr(), mask.data_ptr(),
                                 out.data_ptr(), R, F,
                                 int(x.dtype == torch.bfloat16), int(vec4),
                                 dev.index, stream)
    if err:
        raise RuntimeError("packet_mask kernel launch failed: "
                           + lib.packet_mask_error_string(err).decode())
    return out
