"""Binding of the Hopper TRA aggregation kernel (``csrc/tra_agg.cu``).

``tra_agg_call`` (one aggregate) and ``tra_agg_batched_call`` (S
scenarios in one launch) launch the CUDA kernel on tensors that lie on
the card and raise on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
the ``repro_torch::tra_agg`` ops in ``ops.py``, by device alone.
``LAUNCHES`` counts the kernel launches of this process, through either
entry.

The binding's contract, in order: the first statement of each entry
refuses any operand that is not a CUDA tensor, with a ``ValueError``
that names CUDA, before the counter moves and before the library is
built or loaded; then one pass checks device, dtype, shape and
contiguity, and only when it finds a fault does ``_check`` run per
operand to name it; then ``plan`` sets the geometry. A failed launch
raises ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (DENOM_EPS, MAX_SCENARIOS,
                                       scenario_ptr as _at)

LAUNCHES = 0

CHUNK = 16              # the most clients a chunk (kChunk in the .cu)
MAX_ROWS = 32           # the most packet rows a CTA (kMaxRows in the .cu)
TILE = 1024             # the floats of a CTA's tile of a wider row (kTile)
SMEM_BUDGET = 40 * 1024     # dynamic shared memory a CTA, under the 48 KB
                            # a CTA gets without an opt-in
_OPERANDS = ("x", "mask", "w")


class Plan(NamedTuple):
    """Launch geometry of one call: ``rows`` whole packet rows a CTA, or
    ``tiles`` CTAs of TILE floats a row, each thread over 4 floats."""
    rows: int
    tiles: int
    threads: int    # whole warps
    chunk: int      # clients whose loads are in flight together
    smem: int       # dynamic shared memory, bytes: the chunk's rows


@functools.lru_cache(maxsize=None)
def plan(S: int, C: int, P: int, F: int) -> Plan:
    """The kernel's geometry for S scenarios of (C, P, F) uploads;
    raises ``ValueError`` on what it cannot take. Rows under 256 floats
    share a CTA, so that a warp has work; rows past TILE floats are cut
    into tiles. Any S: the binding launches past MAX_SCENARIOS in
    chunks, each with this plan."""
    if F > TILE:
        rows, tiles, span = 1, -(-F // TILE), TILE
    else:
        rows = max(1, min(MAX_ROWS, P, 256 // F))
        tiles, span = 1, rows * F
    if -(-P // rows) * tiles > 2 ** 31 - 1:
        raise ValueError(f"P={P}, F={F} needs more CTAs than a grid has")
    threads = max(32, -(-span // 128) * 32)
    chunk = max(1, min(CHUNK, C, SMEM_BUDGET // (16 * threads)))
    return Plan(rows, tiles, threads, chunk, chunk * 16 * threads)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("tra_agg")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tra_agg_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32,
                                   ctypes.c_float, i32, i32, i32, i32, i32,
                                   i32, i32, ptr]
    lib.tra_agg_launch.restype = i32
    lib.tra_agg_error_string.argtypes = [i32]
    lib.tra_agg_error_string.restype = ctypes.c_char_p
    return lib


def _refuse(entry, operands):
    """Raise the CPU refusal, naming the first operand off the card."""
    name, t = next((n, t) for n, t in zip(_OPERANDS, operands)
                   if not t.is_cuda)
    raise ValueError(f"{entry} runs on CUDA tensors only, and {name} lies "
                     f"on {t.device}; the plain version is ref.tra_agg_ref")


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


def _launch(lead, x, m, w, eps):
    """Check the operands of S = ``lead[0]`` scenarios (one, with no
    scenario axis, when ``lead`` is empty) and launch the kernel once a
    chunk of at most MAX_SCENARIOS scenarios, each launch counted."""
    global LAUNCHES
    C, P, F = x.shape[-3:]
    S = lead[0] if lead else 1
    index = x.get_device()
    xs, ms, ws = (*lead, C, P, F), (*lead, C, P), (*lead, C)
    # one pass over the common case; _check names the first fault
    if not (_fits(x, xs, index) and _fits(m, ms, index)
            and _fits(w, ws, index)):
        for name, t, shape in (("x", x, xs), ("mask", m, ms), ("w", w, ws)):
            _check(name, t, shape, x.device)
    out = x.new_empty((*lead, P, F))
    if S == 0 or P == 0 or F == 0:
        return out
    pl = plan(S, C, P, F)
    vec = F % 4 == 0 and x.data_ptr() % 16 == 0
    lib = _lib()
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    for s0 in range(0, S, MAX_SCENARIOS):
        LAUNCHES += 1
        err = lib.tra_agg_launch(_at(x, s0), _at(m, s0), _at(w, s0),
                                 _at(out, s0), min(MAX_SCENARIOS, S - s0),
                                 C, P, F, eps, pl.rows, pl.tiles, pl.threads,
                                 pl.chunk, pl.smem, vec, index, stream)
        if err:
            raise RuntimeError("tra_agg kernel launch failed: "
                               + lib.tra_agg_error_string(err).decode())
    return out


def tra_agg_call(x, mask, w, *, eps: float = DENOM_EPS):
    """One launch: x (C, P, F) f32, mask (C, P) f32, w (C,) f32, all
    contiguous on the card -> the (P, F) f32 debiased aggregate. Any P
    and F."""
    if not (x.is_cuda and mask.is_cuda and w.is_cuda):
        _refuse("tra_agg_call", (x, mask, w))
    if x.dim() != 3:
        raise ValueError(f"x must be (C, P, F), not {tuple(x.shape)}")
    return _launch((), x, mask, w, eps)


def tra_agg_batched_call(x, mask, w, *, eps: float = DENOM_EPS):
    """One launch for S scenarios (one a chunk past MAX_SCENARIOS): the
    operands of ``tra_agg_call`` with a leading S -> (S, P, F), bitwise S
    single calls."""
    if not (x.is_cuda and mask.is_cuda and w.is_cuda):
        _refuse("tra_agg_batched_call", (x, mask, w))
    if x.dim() != 4:
        raise ValueError(f"x must be (S, C, P, F), not {tuple(x.shape)}")
    return _launch((x.shape[0],), x, mask, w, eps)
