"""Binding of the Hopper packet-mask kernel (``csrc/packet_mask.cu``).

``packet_mask_call`` launches the CUDA kernel on tensors that lie on the
card and raises on anything else: there is no fallback here. The choice
between the kernel and its plain version (``ref.py``) is made by the
``repro_torch::packet_mask`` op in ``ops.py``, by device alone.
``LAUNCHES`` counts the kernel launches of this process.

The binding's contract, in order: the first statement refuses an
operand that is not a CUDA tensor, with a ``ValueError`` that names
CUDA, before the counter moves and before the library is built or
loaded; then one pass checks device, dtype, shape and contiguity, and
only when it finds a fault does ``_check`` run per operand to name it.
A failed launch raises ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

LAUNCHES = 0
_DTYPES = (torch.float32, torch.bfloat16)


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


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, not "
                         f"on {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be {' or '.join(map(str, dtypes))}, "
                        f"not {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, not "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def packet_mask_call(x, mask):
    """One launch of the packet-mask kernel.

    x: (R, F) float32 or bfloat16 packet rows on the card; mask: (R,)
    f32 delivery bits; both contiguous. R is P for one upload and B*P
    for a vmapped cohort. Returns x * mask[:, None] in x's dtype.
    """
    global LAUNCHES
    if not (x.is_cuda and mask.is_cuda):
        name, t = ("x", x) if not x.is_cuda else ("mask", mask)
        raise ValueError(f"packet_mask_call runs on CUDA tensors only, and "
                         f"{name} lies on {t.device}; the plain version is "
                         f"ref.packet_mask_ref")
    if x.dim() != 2:
        raise ValueError(f"x must be (R, F), not {tuple(x.shape)}")
    R, F = x.shape
    index = x.get_device()
    # one pass over the common case; _check names the first fault
    if not (x.dtype in _DTYPES and x.is_contiguous()
            and mask.get_device() == index and mask.dtype is torch.float32
            and mask.shape == (R,) and mask.is_contiguous()):
        _check("x", x, (R, F), _DTYPES, x.device)
        _check("mask", mask, (R,), (torch.float32,), x.device)
    out = torch.empty_like(x)
    if R == 0 or F == 0:
        return out
    vec4 = (x.dtype is torch.float32 and F % 4 == 0
            and x.data_ptr() % 16 == 0)
    lib = _lib()
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    LAUNCHES += 1
    err = lib.packet_mask_launch(x.data_ptr(), mask.data_ptr(),
                                 out.data_ptr(), R, F,
                                 x.dtype is torch.bfloat16, vec4, index,
                                 stream)
    if err:
        raise RuntimeError("packet_mask kernel launch failed: "
                           + lib.packet_mask_error_string(err).decode())
    return out
