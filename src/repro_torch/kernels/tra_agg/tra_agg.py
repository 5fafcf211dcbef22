"""Binding of the Hopper TRA aggregation kernel (``csrc/tra_agg.cu``).

``tra_agg_call`` (one aggregate) and ``tra_agg_batched_call`` (S
scenarios in one launch) launch the CUDA kernel on tensors that lie on
the card and raise on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
the ``repro_torch::tra_agg`` ops in ``ops.py``, by device alone.
``LAUNCHES`` counts the kernel launches of this process, through either
entry.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import DENOM_EPS
from repro_torch.kernels.uplink_fused.uplink_fused import _check

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("tra_agg")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tra_agg_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                   ctypes.c_float, i32, ptr]
    lib.tra_agg_launch.restype = i32
    lib.tra_agg_error_string.argtypes = [i32]
    lib.tra_agg_error_string.restype = ctypes.c_char_p
    return lib


def _launch(x, m, w, eps):
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError("tra_agg runs on CUDA tensors only; the plain "
                         "version is ref.tra_agg_ref")
    S, C, P, F = x.shape
    if S > 65535:
        raise ValueError(f"at most 65535 scenarios in one launch, not {S}")
    dev = x.device
    _check("x", x, (S, C, P, F), torch.float32, dev)
    _check("m", m, (S, C, P), torch.float32, dev)
    _check("w", w, (S, C), torch.float32, dev)
    out = torch.empty((S, P, F), dtype=torch.float32, device=dev)
    if S == 0 or P == 0 or F == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES += 1
    err = lib.tra_agg_launch(x.data_ptr(), m.data_ptr(), w.data_ptr(),
                             out.data_ptr(), S, C, P, F, eps, dev.index,
                             stream)
    if err:
        raise RuntimeError("tra_agg kernel launch failed: "
                           + lib.tra_agg_error_string(err).decode())
    return out


def tra_agg_call(x, mask, w, *, eps: float = DENOM_EPS):
    """One launch: x (C, P, F) f32, mask (C, P) f32, w (C,) f32, all
    contiguous on the card -> the (P, F) f32 debiased aggregate. Any P
    and F."""
    if x.dim() != 3:
        raise ValueError(f"x must be (C, P, F), not {tuple(x.shape)}")
    return _launch(x[None], mask[None], w[None], eps)[0]


def tra_agg_batched_call(x, mask, w, *, eps: float = DENOM_EPS):
    """One launch for S scenarios: the operands of ``tra_agg_call`` with
    a leading S -> (S, P, F), bitwise S single calls."""
    if x.dim() != 4:
        raise ValueError(f"x must be (S, C, P, F), not {tuple(x.shape)}")
    return _launch(x, mask, w, eps)
