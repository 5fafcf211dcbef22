"""Binding of the Hopper uplink megakernel (``csrc/uplink_fused.cu``).

``uplink_fused_call`` (one scenario) and ``uplink_fused_batched_call``
(S scenarios in one launch) launch the CUDA kernel on tensors that lie
on the card and raise on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
the ``repro_torch::uplink_fused`` ops in ``ops.py``, by device alone.
``LAUNCHES`` and ``BATCHED_LAUNCHES`` count the launches of this
process through each entry.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import DENOM_EPS

LAUNCHES = 0
BATCHED_LAUNCHES = 0

_MAX_SMEM = 48 * 1024      # shared memory a CTA gets without an opt-in


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("uplink_fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.uplink_fused_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
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


def _launch(x, m, q, w_or_den, ef, want_ssq, per_coord, *, batched):
    """Check the (S, C, P, F) operands and launch the kernel once,
    counted under the entry that asked for it."""
    global LAUNCHES, BATCHED_LAUNCHES
    S, C, P, F = x.shape
    dev = x.device
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, not {x.dtype}")
    if F % 32 or (F + 32) * 4 > _MAX_SMEM or P == 0 or S == 0:
        raise ValueError(f"unsupported packet shape S={S}, P={P}, F={F}: "
                         f"S, P > 0 and F a multiple of 32 up to "
                         f"{_MAX_SMEM // 4 - 32}")
    if S > 65535:
        raise ValueError(f"at most 65535 scenarios in one launch, not {S}")
    _check("x", x, (S, C, P, F), x.dtype, dev)
    if ef is not None:
        _check("ef", ef, (S, C, P, F), x.dtype, dev)
    _check("m", m, (S, C, P), torch.float32, dev)
    _check("q", q, (S, C), torch.float32, dev)
    _check("w_or_den", w_or_den, (S, C) if per_coord else (S,),
           torch.float32, dev)

    agg = torch.empty((S, P, F), dtype=torch.float32, device=dev)
    ef_out = torch.empty_like(x) if ef is not None else None
    ssq = torch.empty((S, C, P), dtype=torch.float32, device=dev) \
        if want_ssq else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if batched:
        BATCHED_LAUNCHES += 1
    else:
        LAUNCHES += 1
    err = lib.uplink_fused_launch(
        ptr(x), ptr(ef), ptr(m), ptr(q), ptr(w_or_den), ptr(agg),
        ptr(ef_out), ptr(ssq), S, C, P, F, int(x.dtype == torch.bfloat16),
        int(per_coord), DENOM_EPS, dev.index, stream)
    if err:
        raise RuntimeError("uplink_fused kernel launch failed: "
                           + lib.uplink_fused_error_string(err).decode())
    return agg, ef_out, ssq


def _require_cuda(x, name):
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors only; the plain "
                         f"version is ref.uplink_ref")


def uplink_fused_call(x, m, q, w_or_den, *, ef=None, want_ssq=False,
                      per_coord: bool):
    """One launch of the fused uplink kernel for one scenario.

    x: (C, P, F) packetised unmasked uploads on the card, float32 or
    bfloat16 (the stream dtype), F a multiple of 32; ef: matching tensor
    or None; m: (C, P) f32 delivery mask; q: (C,) f32 pre-folded debias
    scales; ``w_or_den``: raw weights (C,) f32 when ``per_coord``, else
    the ready scalar denominator () f32.

    Returns (agg (P, F) f32, ef_out (C, P, F) stream dtype | None,
    ssq (C, P) f32 per-packet partials | None: sum over P for the
    masked squared norms).
    """
    _require_cuda(x, "uplink_fused_call")
    if x.dim() != 3:
        raise ValueError(f"x must be (C, P, F), not {tuple(x.shape)}")
    agg, ef_out, ssq = _launch(
        x[None], m[None], q[None], w_or_den[None], None if ef is None
        else ef[None], want_ssq, per_coord, batched=False)
    return agg[0], None if ef_out is None else ef_out[0], \
        None if ssq is None else ssq[0]


def uplink_fused_batched_call(x, m, q, w_or_den, *, ef=None,
                              want_ssq=False, per_coord: bool):
    """One launch of the fused uplink kernel for S scenarios: the
    operands of ``uplink_fused_call`` with a leading S (``w_or_den`` is
    (S, C) when ``per_coord``, else (S,) ready denominators).

    Returns (agg (S, P, F) f32, ef_out (S, C, P, F) | None, ssq
    (S, C, P) partials | None), bitwise equal to S single calls.
    """
    _require_cuda(x, "uplink_fused_batched_call")
    if x.dim() != 4:
        raise ValueError(f"x must be (S, C, P, F), not {tuple(x.shape)}")
    return _launch(x, m, q, w_or_den, ef, want_ssq, per_coord,
                   batched=True)
