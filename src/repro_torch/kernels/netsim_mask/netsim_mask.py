"""Binding of the Hopper Gilbert–Elliott mask kernel
(``csrc/netsim_mask.cu``).

``netsim_mask_call`` launches the CUDA kernel on tensors that lie on the
card and raises on anything else: there is no fallback here. The choice
between the kernel and its plain version (``ref.py``) is made by the
``repro_torch::netsim_mask`` op in ``ops.py``, by device alone.
``LAUNCHES`` counts the kernel launches of this process.

The binding's contract, in order: the first statement refuses any
operand that is not a CUDA tensor, with a ``ValueError`` that names
CUDA, before the counter moves and before the library is built or
loaded; then one pass checks device, dtype, shape and contiguity, and
only when it finds a fault does ``_check`` run per operand to name it;
then ``plan`` sets the geometry. A failed launch raises ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

LAUNCHES = 0

THREADS = 128           # threads a CTA: THREADS // lanes rows
_OPERANDS = ("u_t", "u_e", "s0", "p_gb", "p_bg", "h_g", "h_b")


class Plan(NamedTuple):
    """Launch geometry of one call: a segment of ``lanes`` lanes scans a
    row, ``vec`` 4 packets a lane with 16-byte loads (else 1)."""
    lanes: int      # a power of two, at most 32
    vec: bool
    threads: int    # whole warps


@functools.lru_cache(maxsize=None)
def plan(P: int, vec: bool) -> Plan:
    """The kernel's geometry for rows of P packets; ``vec`` when P % 4 ==
    0 and the uniforms are 16-byte aligned. A row's segment is the fewest
    lanes (a power of two, at most 32) that cover it in one step, so
    that short rows share a warp and long rows take a whole one. On an
    H100 at P = 36, R = 72 or 270: 16 or 32 lanes 0.0017 ms device, 8
    lanes 0.0019, 4 lanes 0.0023, one packet a lane 0.0020; CTAs of 64,
    128 or 256 threads alike, so R does not enter."""
    need = -(-P // (4 if vec else 1))
    lanes = min(32, 1 << (need - 1).bit_length())
    return Plan(lanes, vec, THREADS)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("netsim_mask")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.netsim_mask_launch.argtypes = [ptr] * 9 + [i32] * 6 + [ptr]
    lib.netsim_mask_launch.restype = i32
    lib.netsim_mask_error_string.argtypes = [i32]
    lib.netsim_mask_error_string.restype = ctypes.c_char_p
    return lib


def _refuse(operands):
    """Raise the CPU refusal, naming the first operand off the card."""
    name, t = next((n, t) for n, t in zip(_OPERANDS, operands)
                   if not t.is_cuda)
    raise ValueError(f"netsim_mask_call runs on CUDA tensors only, and "
                     f"{name} lies on {t.device}; the plain version is "
                     f"ref.ge_mask_ref")


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, not "
                         f"on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, not "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _fits(t, shape, dtype, index):
    return (t.get_device() == index and t.dtype is dtype
            and t.shape == shape and t.is_contiguous())


def netsim_mask_call(u_t, u_e, s0, p_gb, p_bg, h_g, h_b):
    """One launch of the Gilbert–Elliott mask kernel.

    u_t, u_e: (R, P) f32 uniforms on the card; s0: (R,) int32 states, 0
    (GOOD) or 1 (BAD); p_gb, p_bg, h_g, h_b: (R,) f32, all contiguous. R
    is the cohort size C for one scenario and S*C for a sweep. Any R >=
    0 and P >= 0.

    Returns (mask (R, P) f32 with 1 = delivered, s_final (R,) int32).
    """
    global LAUNCHES
    if not (u_t.is_cuda and u_e.is_cuda and s0.is_cuda and p_gb.is_cuda
            and p_bg.is_cuda and h_g.is_cuda and h_b.is_cuda):
        _refuse((u_t, u_e, s0, p_gb, p_bg, h_g, h_b))
    if u_t.dim() != 2:
        raise ValueError(f"u_t must be (R, P), not {tuple(u_t.shape)}")
    R, P = u_t.shape
    index = u_t.get_device()
    rows, f32 = (R,), torch.float32
    # one pass over the common case; _check names the first fault
    if not (_fits(u_t, (R, P), f32, index)
            and _fits(u_e, (R, P), f32, index)
            and _fits(s0, rows, torch.int32, index)
            and _fits(p_gb, rows, f32, index)
            and _fits(p_bg, rows, f32, index)
            and _fits(h_g, rows, f32, index)
            and _fits(h_b, rows, f32, index)):
        for name, t, shape, dtype in (
                ("u_t", u_t, (R, P), f32), ("u_e", u_e, (R, P), f32),
                ("s0", s0, rows, torch.int32), ("p_gb", p_gb, rows, f32),
                ("p_bg", p_bg, rows, f32), ("h_g", h_g, rows, f32),
                ("h_b", h_b, rows, f32)):
            _check(name, t, shape, dtype, u_t.device)
    mask = u_t.new_empty((R, P))
    s_fin = s0.new_empty(rows)
    if R == 0 or P == 0:
        s_fin.copy_(s0)
        return mask, s_fin
    pl = plan(P, P % 4 == 0 and u_t.data_ptr() % 16 == 0
              and u_e.data_ptr() % 16 == 0)
    lib = _lib()
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    LAUNCHES += 1
    err = lib.netsim_mask_launch(
        u_t.data_ptr(), u_e.data_ptr(), s0.data_ptr(), p_gb.data_ptr(),
        p_bg.data_ptr(), h_g.data_ptr(), h_b.data_ptr(), mask.data_ptr(),
        s_fin.data_ptr(), R, P, pl.lanes, pl.vec, pl.threads, index, stream)
    if err:
        raise RuntimeError("netsim_mask kernel launch failed: "
                           + lib.netsim_mask_error_string(err).decode())
    return mask, s_fin
