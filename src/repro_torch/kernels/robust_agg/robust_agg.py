"""Binding of the Hopper robust-aggregation kernel (``csrc/robust_agg.cu``).

``robust_agg_call`` (one scenario) and ``robust_agg_batched_call`` (S
scenarios in one launch) launch the CUDA kernel on tensors that lie on
the card and raise on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
the ``repro_torch::robust_agg`` ops in ``ops.py``, by device alone.
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

_MAX_SMEM = 232448          # dynamic shared memory a CTA may opt into


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("robust_agg")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.robust_agg_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, ptr]
    lib.robust_agg_launch.restype = i32
    lib.robust_agg_error_string.argtypes = [i32]
    lib.robust_agg_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, shape, device):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must lie on {device}, not {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, not {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, not "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos, trim_k,
            per_coord, *, batched):
    """Check the (S, C, P, F) operands and launch the kernel once,
    counted under the entry that asked for it."""
    global LAUNCHES, BATCHED_LAUNCHES
    S, C, P, F = x.shape
    dev = x.device
    if F % 32 or not 32 <= F <= 1024 or P == 0 or S == 0 or C == 0:
        raise ValueError(f"unsupported packet shape S={S}, C={C}, P={P}, "
                         f"F={F}: S, C, P > 0 and F a multiple of 32 in "
                         f"[32, 1024]")
    if S > 65535:
        raise ValueError(f"at most 65535 scenarios in one launch, not {S}")
    if trim_k < 0:
        raise ValueError(f"trim_k must be >= 0, not {trim_k}")
    smem = C * (F + 1) * 4 if trim_k > 0 else 0
    if smem > _MAX_SMEM:
        raise ValueError(f"the trimmed mean stages C*(F+1) floats in shared "
                         f"memory: C={C}, F={F} needs {smem} B, over "
                         f"{_MAX_SMEM}")
    _check("x", x, (S, C, P, F), dev)
    if ef is not None:
        _check("ef", ef, (S, C, P, F), dev)
    _check("m", m, (S, C, P), dev)
    _check("q", q, (S, C), dev)
    _check("w_or_den", w_or_den, (S, C) if per_coord else (S,), dev)
    _check("screen", screen, (S,), dev)
    _check("trim_gate", trim_gate, (S,), dev)
    if trim_k > 0:
        if g is None or w_pos is None:
            raise ValueError("trim_k > 0 needs g and w_pos")
        _check("g", g, (S, C), dev)
        _check("w_pos", w_pos, (S, C), dev)

    agg = torch.empty((S, P, F), dtype=torch.float32, device=dev)
    ef_out = torch.empty_like(x) if ef is not None else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if batched:
        BATCHED_LAUNCHES += 1
    else:
        LAUNCHES += 1
    err = lib.robust_agg_launch(
        ptr(x), ptr(ef), ptr(m), ptr(q), ptr(g if trim_k > 0 else None),
        ptr(w_pos if trim_k > 0 else None), ptr(w_or_den), ptr(screen),
        ptr(trim_gate), ptr(agg), ptr(ef_out), S, C, P, F, int(per_coord),
        int(trim_k), DENOM_EPS, dev.index, stream)
    if err:
        raise RuntimeError("robust_agg kernel launch failed: "
                           + lib.robust_agg_error_string(err).decode())
    return agg, ef_out


def _require_cuda(x, name):
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors only; the plain "
                         f"version is ref.robust_ref")


def robust_agg_call(x, m, q, w_or_den, screen, trim_gate, *, ef=None,
                    g=None, w_pos=None, trim_k: int = 0, per_coord: bool):
    """One launch of the robust-aggregation kernel for one scenario.

    x: (C, P, F) f32 uploads after fault injection, on the card, F a
    multiple of 32 up to 1024; ef: matching tensor or None; m: (C, P)
    delivery mask; q: (C,) debias scales with the clip factor folded in;
    ``w_or_den``: raw weights (C,) when ``per_coord``, else the ready
    scalar denominator (); ``screen`` / ``trim_gate``: () f32 gates;
    ``g`` (C,) trim estimate scales and ``w_pos`` (C,) weight > 0
    validity, needed when ``trim_k > 0``.

    Returns (agg (P, F) f32, ef_out (C, P, F) f32 | None).
    """
    _require_cuda(x, "robust_agg_call")
    if x.dim() != 3:
        raise ValueError(f"x must be (C, P, F), not {tuple(x.shape)}")

    def lead(t):
        return None if t is None else t[None]

    agg, ef_out = _launch(
        x[None], m[None], q[None], w_or_den[None], screen[None],
        trim_gate[None], lead(ef), lead(g), lead(w_pos), trim_k, per_coord,
        batched=False)
    return agg[0], None if ef_out is None else ef_out[0]


def robust_agg_batched_call(x, m, q, w_or_den, screen, trim_gate, *,
                            ef=None, g=None, w_pos=None, trim_k: int = 0,
                            per_coord: bool):
    """One launch of the robust-aggregation kernel for S scenarios: the
    operands of ``robust_agg_call`` with a leading S (gates (S,),
    ``w_or_den`` (S, C) when ``per_coord``, else (S,)).

    Returns (agg (S, P, F) f32, ef_out (S, C, P, F) | None), bitwise
    equal to S single calls.
    """
    _require_cuda(x, "robust_agg_batched_call")
    if x.dim() != 4:
        raise ValueError(f"x must be (S, C, P, F), not {tuple(x.shape)}")
    return _launch(x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos,
                   trim_k, per_coord, batched=True)
