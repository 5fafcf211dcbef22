"""Binding of the Hopper uplink megakernel (``csrc/uplink_fused.cu``).

``uplink_fused_call`` launches the CUDA kernel on tensors that lie on
the card and raises on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
``ops.uplink_round``, by the device of its input alone.
``LAUNCHES`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import DENOM_EPS

LAUNCHES = 0

_MAX_SMEM = 48 * 1024      # shared memory a CTA gets without an opt-in


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("uplink_fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.uplink_fused_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
    lib.uplink_fused_launch.restype = i32
    lib.uplink_fused_error_string.argtypes = [i32]
    lib.uplink_fused_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, dtype, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must lie on {device}, not {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, not "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def uplink_fused_call(x, m, q, w_or_den, *, ef=None, want_ssq=False,
                      per_coord: bool):
    """One launch of the fused uplink kernel.

    x: (C, P, F) packetised unmasked uploads on the card, float32 or
    bfloat16 (the stream dtype), F a multiple of 32; ef: matching tensor
    or None; m: (C, P) f32 delivery mask; q: (C,) f32 pre-folded debias
    scales; ``w_or_den``: raw weights (C,) f32 when ``per_coord``, else
    the ready scalar denominator () f32.

    Returns (agg (P, F) f32, ef_out (C, P, F) stream dtype | None,
    ssq (C, P) f32 per-packet partials | None: sum over P for the
    masked squared norms).
    """
    global LAUNCHES
    if not x.is_cuda:
        raise ValueError("uplink_fused_call runs on CUDA tensors only; "
                         "the plain version is ref.uplink_ref")
    if x.dim() != 3:
        raise ValueError(f"x must be (C, P, F), not {tuple(x.shape)}")
    C, P, F = x.shape
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if F % 32 or (F + 32) * 4 > _MAX_SMEM or P == 0:
        raise ValueError(f"unsupported packet shape P={P}, F={F}: P > 0 "
                         f"and F a multiple of 32 up to "
                         f"{_MAX_SMEM // 4 - 32}")
    _check("x", x, (C, P, F), x.dtype, dev)
    if ef is not None:
        _check("ef", ef, (C, P, F), x.dtype, dev)
    _check("m", m, (C, P), torch.float32, dev)
    _check("q", q, (C,), torch.float32, dev)
    _check("w_or_den", w_or_den, (C,) if per_coord else (), torch.float32,
           dev)

    agg = torch.empty((P, F), dtype=torch.float32, device=dev)
    ef_out = torch.empty_like(x) if ef is not None else None
    ssq = torch.empty((C, P), dtype=torch.float32, device=dev) \
        if want_ssq else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES += 1
    err = lib.uplink_fused_launch(
        ptr(x), ptr(ef), ptr(m), ptr(q), ptr(w_or_den), ptr(agg),
        ptr(ef_out), ptr(ssq), C, P, F, int(x.dtype == torch.bfloat16),
        int(per_coord), DENOM_EPS, dev.index, stream)
    if err:
        raise RuntimeError("uplink_fused kernel launch failed: "
                           + lib.uplink_fused_error_string(err).decode())
    return agg, ef_out, ssq
