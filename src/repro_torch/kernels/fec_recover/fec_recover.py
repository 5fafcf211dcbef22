"""Binding of the Hopper FEC repair kernel (``csrc/fec_recover.cu``).

``fec_recover_call`` launches the CUDA kernel on tensors that lie on the
card and raises on anything else: there is no fallback here. The choice
between the kernel and its plain version (``ref.py``) is made by the
``repro_torch::fec_recover`` op in ``ops.py``, by device alone.
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
    lib = _build.load("fec_recover")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fec_recover_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32,
                                       i32, ptr]
    lib.fec_recover_launch.restype = i32
    lib.fec_recover_error_string.argtypes = [i32]
    lib.fec_recover_error_string.restype = ctypes.c_char_p
    return lib


def fec_recover_call(mask, parity, *, group: int):
    """One launch of the FEC repair kernel.

    mask: (R, P) f32 0/1 delivery mask on the card; parity: (R, Gn) f32
    0/1 parity delivery mask with Gn = ceil(P / group); both contiguous.
    R is the cohort size C for one scenario and S*C for a sweep. No
    padding: the kernel counts packets past P as delivered.

    Returns the repaired (R, P) f32 mask.
    """
    global LAUNCHES
    if not mask.is_cuda:
        raise ValueError("fec_recover_call runs on CUDA tensors only; the "
                         "plain version is ref.fec_recover_ref")
    if mask.dim() != 2 or parity.dim() != 2:
        raise ValueError(f"mask and parity must be 2-d, not "
                         f"{tuple(mask.shape)} and {tuple(parity.shape)}")
    if group < 1:
        raise ValueError(f"group must be positive, not {group}")
    R, P = mask.shape
    gn = -(-P // group)
    dev = mask.device
    _check("mask", mask, (R, P), torch.float32, dev)
    _check("parity", parity, (R, gn), torch.float32, dev)
    out = torch.empty_like(mask)
    if R == 0 or P == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES += 1
    err = lib.fec_recover_launch(mask.data_ptr(), parity.data_ptr(),
                                 out.data_ptr(), R, P, gn, group, dev.index,
                                 stream)
    if err:
        raise RuntimeError("fec_recover kernel launch failed: "
                           + lib.fec_recover_error_string(err).decode())
    return out
