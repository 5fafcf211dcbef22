"""Binding of the Hopper FEC repair kernel (``csrc/fec_recover.cu``).

``fec_recover_call`` launches the CUDA kernel on tensors that lie on the
card and raises on anything else: there is no fallback here. The choice
between the kernel and its plain version (``ref.py``) is made by the
``repro_torch::fec_recover`` op in ``ops.py``, by device alone.
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

THREADS = 128           # threads a CTA, 4 warps
_OPERANDS = ("mask", "parity")


class Plan(NamedTuple):
    """Launch geometry of one call: lanes own ``vec`` 4 packets (else 1);
    a warp step covers ``per_step`` whole groups and a warp ``steps``
    steps of a row, or, when ``per_step`` is 0, a warp walks one group
    wider than 32 lanes."""
    vec: bool
    per_step: int
    steps: int      # 1, or 2 when vec and 4 when not
    threads: int    # whole warps


@functools.lru_cache(maxsize=None)
def plan(P: int, group: int, vec: bool) -> Plan:
    """The kernel's geometry for rows of P packets in groups of
    ``group``; ``vec`` when P and ``group`` are multiples of 4 and the
    mask is 16-byte aligned. A warp takes as many whole groups a step as
    its lanes hold and, where a row has four steps or more, several steps
    with their loads in flight together: 8 floats a lane, two 16-byte
    steps or four scalar ones (on an H100 at (4096, 1024): 0.0092 ms
    device for 2 steps against 0.0100 for 4 at G = 8, 0.0149 for 4
    against 0.0195 for 2 at G = 3)."""
    lanes = group // (4 if vec else 1)
    if lanes > 32:
        return Plan(vec, 0, 1, THREADS)
    gn = -(-P // group)
    per_step = min(32 // lanes, gn)
    steps = 1 if -(-gn // per_step) < 4 else (2 if vec else 4)
    return Plan(vec, per_step, steps, THREADS)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("fec_recover")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fec_recover_launch.argtypes = [ptr, ptr, ptr] + [i32] * 9 + [ptr]
    lib.fec_recover_launch.restype = i32
    lib.fec_recover_error_string.argtypes = [i32]
    lib.fec_recover_error_string.restype = ctypes.c_char_p
    return lib


def _refuse(operands):
    """Raise the CPU refusal, naming the first operand off the card."""
    name, t = next((n, t) for n, t in zip(_OPERANDS, operands)
                   if not t.is_cuda)
    raise ValueError(f"fec_recover_call runs on CUDA tensors only, and "
                     f"{name} lies on {t.device}; the plain version is "
                     f"ref.fec_recover_ref")


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, not "
                         f"on {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, not {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, not "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _fits(t, shape, index):
    return (t.get_device() == index and t.dtype is torch.float32
            and t.shape == shape and t.is_contiguous())


def fec_recover_call(mask, parity, *, group: int):
    """One launch of the FEC repair kernel.

    mask: (R, P) f32 delivery mask on the card; parity: (R, Gn) f32
    parity delivery mask with Gn = ceil(P / group); both contiguous. R
    is the cohort size C for one scenario and S*C for a sweep. No
    padding: the kernel counts packets past P as delivered.

    The input contract is the engine's: 0/1 masks. The kernel counts a
    packet as lost when ``!(m >= 0.5)``, which is the reference's sum of
    ``1 - m`` for 0/1 masks only; a NaN entry leaves its group as the
    reference leaves it.

    Returns the repaired (R, P) f32 mask.
    """
    global LAUNCHES
    if not (mask.is_cuda and parity.is_cuda):
        _refuse((mask, parity))
    if mask.dim() != 2 or parity.dim() != 2:
        raise ValueError(f"mask and parity must be 2-d, not "
                         f"{tuple(mask.shape)} and {tuple(parity.shape)}")
    if group < 1:
        raise ValueError(f"group must be positive, not {group}")
    R, P = mask.shape
    gn = -(-P // group)
    index = mask.get_device()
    # one pass over the common case; _check names the first fault
    if not (_fits(mask, (R, P), index) and _fits(parity, (R, gn), index)):
        _check("mask", mask, (R, P), mask.device)
        _check("parity", parity, (R, gn), mask.device)
    out = torch.empty_like(mask)
    if R == 0 or P == 0:
        return out
    pl = plan(P, group, P % 4 == 0 and group % 4 == 0
              and mask.data_ptr() % 16 == 0)
    lib = _lib()
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    LAUNCHES += 1
    err = lib.fec_recover_launch(mask.data_ptr(), parity.data_ptr(),
                                 out.data_ptr(), R, P, gn, group, pl.vec,
                                 pl.per_step, pl.steps, pl.threads, index,
                                 stream)
    if err:
        raise RuntimeError("fec_recover kernel launch failed: "
                           + lib.fec_recover_error_string(err).decode())
    return out
