"""Binding of the Hopper robust-aggregation kernel (``csrc/robust_agg.cu``).

``robust_agg_call`` (one scenario) and ``robust_agg_batched_call`` (S
scenarios in one launch) launch the CUDA kernel on tensors that lie on
the card and raise on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
the ``repro_torch::robust_agg`` ops in ``ops.py``, by device alone.
``LAUNCHES`` and ``BATCHED_LAUNCHES`` count the launches of this
process through each entry: one a call, and for S past MAX_SCENARIOS
(the grid's y limit) one a chunk of at most MAX_SCENARIOS scenarios,
launched in turn, each scenario's outputs bitwise those of its own
single launch.

The binding's contract, in order: the first statement of each entry
refuses any operand that is not a CUDA tensor, with a ``ValueError``
that names CUDA, before a counter moves and before the library is
built or loaded; then ``plan`` refuses a shape the kernel cannot take;
then one pass checks device, dtype, shape and contiguity of every
operand, and only when it finds a fault does ``_check`` run per operand
to name it. A failed launch raises ``RuntimeError``.
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
BATCHED_LAUNCHES = 0

CHUNK = 16                  # the most clients a chunk (kChunk in the .cu)
TRIM_SLOTS = (1, 2, 4, 8, 16)   # the kernel's trim list lengths (its K)
PASSES = -1                 # slots of the k-pass instance (kPass in the .cu)
MAX_F = 1024                # the widest packet: one CTA, a thread a float
# dynamic shared memory a CTA may opt into on an H100 (232,448 bytes),
# beside the kernel's 896 static bytes
SMEM_LIMIT = 232448 - 896
_OPERANDS = ("x", "m", "q", "w_or_den", "screen", "trim_gate", "ef", "g",
             "w_pos")


class Plan(NamedTuple):
    """Launch geometry of one call, beside a CTA per (packet row,
    scenario) of one thread per float."""
    chunk: int      # clients whose loads are in flight together
    slots: int      # the trim: 0 off, trim_k rounded up to a list length
                    # (<= 16), or PASSES for trim_k passes over a column
    smem: int       # dynamic shared memory, bytes: the chunk's rows (a
                    # float a thread), and the k-pass column where it
                    # fits beside them
    threads: int    # F rounded up to whole warps
    column: bool    # the k-pass column lies in device memory instead


@functools.lru_cache(maxsize=None)
def plan(S: int, C: int, P: int, F: int, trim_k: int, ef: bool) -> Plan:
    """The kernel's geometry for S scenarios of (C, P, F) uploads, with
    or without EF; raises ``ValueError`` on what it cannot take. Any
    S >= 1: the binding launches past MAX_SCENARIOS in chunks, each with
    this plan."""
    if not 1 <= F <= MAX_F or min(S, C, P) < 1:
        raise ValueError(f"unsupported packet shape S={S}, C={C}, P={P}, "
                         f"F={F}: S, C, P > 0 and F in [1, {MAX_F}]")
    if trim_k < 0:
        raise ValueError(f"trim_k must be >= 0, not {trim_k}")
    chunk = min(CHUNK, C)
    threads = -(-F // 32) * 32
    rows = chunk * threads * 4 * (2 if ef else 1)
    if trim_k <= TRIM_SLOTS[-1]:
        slots = next(k for k in TRIM_SLOTS if k >= trim_k) if trim_k else 0
        return Plan(chunk, slots, rows, threads, False)
    # trim_k > 16: k passes over a (C, F + 1) column, in shared memory
    # where it fits beside the chunk's rows
    col = C * (F + 1) * 4
    if rows + col <= SMEM_LIMIT:
        return Plan(chunk, PASSES, rows + col, threads, False)
    return Plan(chunk, PASSES, rows, threads, True)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("robust_agg")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.robust_agg_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, i32, i32, i32,
        i32, ptr]
    lib.robust_agg_launch.restype = i32
    lib.robust_agg_error_string.argtypes = [i32]
    lib.robust_agg_error_string.restype = ctypes.c_char_p
    return lib


def _refuse(entry, operands):
    """Raise the CPU refusal, naming the first operand off the card."""
    name, t = next((n, t) for n, t in zip(_OPERANDS, operands)
                   if t is not None and not t.is_cuda)
    raise ValueError(f"{entry} runs on CUDA tensors only, and {name} lies "
                     f"on {t.device}; the plain version is ref.robust_ref")


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


def _launch(lead, x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos,
            trim_k, per_coord):
    """Check the operands of S = ``lead[0]`` scenarios (one, with no
    scenario axis, when ``lead`` is empty) and launch the kernel once a
    chunk of at most MAX_SCENARIOS scenarios, each launch counted under
    the entry that asked for it."""
    global LAUNCHES, BATCHED_LAUNCHES
    C, P, F = x.shape[-3:]
    S = lead[0] if lead else 1
    pl = plan(S, C, P, F, trim_k, ef is not None)
    trim = trim_k > 0
    if trim and (g is None or w_pos is None):
        raise ValueError("trim_k > 0 needs g and w_pos")
    index = x.get_device()
    xs, ms, cs = (*lead, C, P, F), (*lead, C, P), (*lead, C)
    ws = cs if per_coord else lead
    # one pass over the common case; _check names the first fault
    if not (_fits(x, xs, index) and _fits(m, ms, index)
            and _fits(q, cs, index) and _fits(w_or_den, ws, index)
            and _fits(screen, lead, index) and _fits(trim_gate, lead, index)
            and (ef is None or _fits(ef, xs, index))
            and (not trim or (_fits(g, cs, index)
                              and _fits(w_pos, cs, index)))):
        named = [("x", x, xs), ("ef", ef, xs), ("m", m, ms), ("q", q, cs),
                 ("w_or_den", w_or_den, ws), ("screen", screen, lead),
                 ("trim_gate", trim_gate, lead)]
        if trim:
            named += [("g", g, cs), ("w_pos", w_pos, cs)]
        for name, t, shape in named:
            if t is not None:
                _check(name, t, shape, x.device)
    agg = x.new_empty((*lead, P, F))
    ef_out = None if ef is None else torch.empty_like(ef)
    # the k-pass column of each CTA, where it does not fit shared memory
    column = x.new_empty((S, P, C, F + 1)) if pl.column else None
    if not trim:
        g = w_pos = None
    lib = _lib()
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    for s0 in range(0, S, MAX_SCENARIOS):
        if lead:
            BATCHED_LAUNCHES += 1
        else:
            LAUNCHES += 1
        err = lib.robust_agg_launch(
            _at(x, s0), _at(ef, s0), _at(m, s0), _at(q, s0), _at(g, s0),
            _at(w_pos, s0), _at(w_or_den, s0), _at(screen, s0),
            _at(trim_gate, s0), _at(agg, s0), _at(ef_out, s0),
            _at(column, s0), min(MAX_SCENARIOS, S - s0), C, P, F,
            int(per_coord), trim_k, DENOM_EPS, pl.chunk, pl.slots, pl.smem,
            pl.threads, index, stream)
        if err:
            raise RuntimeError("robust_agg kernel launch failed: "
                               + lib.robust_agg_error_string(err).decode())
    return agg, ef_out


def robust_agg_call(x, m, q, w_or_den, screen, trim_gate, *, ef=None,
                    g=None, w_pos=None, trim_k: int = 0, per_coord: bool):
    """One launch of the robust-aggregation kernel for one scenario.

    x: (C, P, F) f32 uploads after fault injection, on the card, F in
    [1, 1024], any ``trim_k >= 0``; ef: matching tensor or None; m: (C, P)
    delivery mask; q: (C,) debias scales with the clip factor folded in;
    ``w_or_den``: raw weights (C,) when ``per_coord``, else the ready
    scalar denominator (); ``screen`` / ``trim_gate``: () f32 gates;
    ``g`` (C,) trim estimate scales and ``w_pos`` (C,) weight > 0
    validity, needed when ``trim_k > 0``.

    Returns (agg (P, F) f32, ef_out (C, P, F) f32 | None).
    """
    if not (x.is_cuda and m.is_cuda and q.is_cuda and w_or_den.is_cuda
            and screen.is_cuda and trim_gate.is_cuda
            and (ef is None or ef.is_cuda) and (g is None or g.is_cuda)
            and (w_pos is None or w_pos.is_cuda)):
        _refuse("robust_agg_call",
                (x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos))
    if x.dim() != 3:
        raise ValueError(f"x must be (C, P, F), not {tuple(x.shape)}")
    return _launch((), x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos,
                   trim_k, per_coord)


def robust_agg_batched_call(x, m, q, w_or_den, screen, trim_gate, *,
                            ef=None, g=None, w_pos=None, trim_k: int = 0,
                            per_coord: bool):
    """One launch of the robust-aggregation kernel for S scenarios: the
    operands of ``robust_agg_call`` with a leading S (gates (S,),
    ``w_or_den`` (S, C) when ``per_coord``, else (S,)).

    Returns (agg (S, P, F) f32, ef_out (S, C, P, F) | None), bitwise
    equal to S single calls. Any S >= 1: past MAX_SCENARIOS, one launch a
    chunk.
    """
    if not (x.is_cuda and m.is_cuda and q.is_cuda and w_or_den.is_cuda
            and screen.is_cuda and trim_gate.is_cuda
            and (ef is None or ef.is_cuda) and (g is None or g.is_cuda)
            and (w_pos is None or w_pos.is_cuda)):
        _refuse("robust_agg_batched_call",
                (x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos))
    if x.dim() != 4:
        raise ValueError(f"x must be (S, C, P, F), not {tuple(x.shape)}")
    return _launch((x.shape[0],), x, m, q, w_or_den, screen, trim_gate, ef, g,
                   w_pos, trim_k, per_coord)
