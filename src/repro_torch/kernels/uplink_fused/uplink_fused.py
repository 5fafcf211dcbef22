"""Binding of the Hopper uplink megakernel (``csrc/uplink_fused.cu``).

``uplink_fused_call`` (one scenario) and ``uplink_fused_batched_call``
(S scenarios in one launch) launch the CUDA kernel on tensors that lie
on the card and raise on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
the ``repro_torch::uplink_fused`` ops in ``ops.py``, by device alone.
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
MAX_THREADS = 256           # the most threads a CTA (kMaxWarps * 32)
SMEM_BUDGET = 40 * 1024     # dynamic shared memory a CTA, under the 48 KB
                            # a CTA gets without an opt-in
# packet rows of a launch from which a thread takes 4 floats (two CTAs an
# SM of the H100's 132); below it a thread takes one, so that a small
# launch has 8 warps a CTA. With the masked norms, whose sum order the
# floats a thread set, only one scenario's rows count, so that a batched
# launch gives the bits of its single launches.
WIDE_ROWS = 264
_DTYPES = (torch.float32, torch.bfloat16)
_OPERANDS = ("x", "m", "q", "w_or_den", "ef")


class Plan(NamedTuple):
    """Launch geometry of one call: ``tiles`` CTAs of ``threads`` per
    (packet row, scenario), each thread over ``floats`` floats of its
    tile."""
    threads: int    # whole warps
    tiles: int      # CTAs a packet row: ceil(F / (floats * threads))
    floats: int     # a thread's floats: 4 from WIDE_ROWS rows on, else 1
    chunk: int      # clients whose loads are in flight together
    smem: int       # dynamic shared memory, bytes: the chunk's rows


@functools.lru_cache(maxsize=None)
def plan(S: int, C: int, P: int, F: int, ef: bool, bf16: bool,
         ssq: bool) -> Plan:
    """The kernel's geometry for S scenarios of (C, P, F) uploads in f32
    or bf16, with or without EF and the masked norms; raises
    ``ValueError`` on what it cannot take. Any F >= 1: a row wider than
    one CTA's floats is split over ``tiles`` CTAs. Any S >= 1: the
    binding launches past MAX_SCENARIOS in chunks, each with this plan."""
    if min(S, P, F) < 1 or C < 0:
        raise ValueError(f"unsupported packet shape S={S}, C={C}, P={P}, "
                         f"F={F}: S, P, F > 0")
    floats = 4 if (P if ssq else S * P) >= WIDE_ROWS else 1
    groups = -(-F // floats)
    threads = min(MAX_THREADS, -(-groups // 32) * 32)
    tiles = -(-groups // threads)
    if P * tiles > 2 ** 31 - 1:
        raise ValueError(f"P * tiles = {P * tiles} CTAs past the grid")
    row = floats * threads * (2 if bf16 else 4) * (2 if ef else 1)
    chunk = max(1, min(CHUNK, C, SMEM_BUDGET // row))
    return Plan(threads, tiles, floats, chunk, chunk * row)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("uplink_fused")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.uplink_fused_launch.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i32, i32, i32, ctypes.c_float, i32, i32, i32, i32,
        i32, i32, i32, ptr]
    lib.uplink_fused_launch.restype = i32
    lib.uplink_fused_error_string.argtypes = [i32]
    lib.uplink_fused_error_string.restype = ctypes.c_char_p
    return lib


def _refuse(entry, operands):
    """Raise the CPU refusal, naming the first operand off the card."""
    name, t = next((n, t) for n, t in zip(_OPERANDS, operands)
                   if t is not None and not t.is_cuda)
    raise ValueError(f"{entry} runs on CUDA tensors only, and {name} lies "
                     f"on {t.device}; the plain version is ref.uplink_ref")


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


def _launch(lead, x, m, q, w_or_den, ef, want_ssq, per_coord):
    """Check the operands of S = ``lead[0]`` scenarios (one, with no
    scenario axis, when ``lead`` is empty) and launch the kernel once a
    chunk of at most MAX_SCENARIOS scenarios, each launch counted under
    the entry that asked for it."""
    global LAUNCHES, BATCHED_LAUNCHES
    C, P, F = x.shape[-3:]
    S = lead[0] if lead else 1
    dt = x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, not {dt}")
    bf16 = dt is torch.bfloat16
    pl = plan(S, C, P, F, ef is not None, bf16, want_ssq)
    index = x.get_device()
    f32 = torch.float32
    xs, ms, cs = (*lead, C, P, F), (*lead, C, P), (*lead, C)
    ws = cs if per_coord else lead
    # one pass over the common case; _check names the first fault
    if not (_fits(x, xs, dt, index) and _fits(m, ms, f32, index)
            and _fits(q, cs, f32, index) and _fits(w_or_den, ws, f32, index)
            and (ef is None or _fits(ef, xs, dt, index))):
        for name, t, shape, dtype in (
                ("x", x, xs, dt), ("ef", ef, xs, dt), ("m", m, ms, f32),
                ("q", q, cs, f32), ("w_or_den", w_or_den, ws, f32)):
            if t is not None:
                _check(name, t, shape, dtype, x.device)
    agg = x.new_empty((*lead, P, F), dtype=f32)
    ef_out = None if ef is None else torch.empty_like(ef)
    ssq = x.new_empty((*lead, C, P * pl.tiles), dtype=f32) \
        if want_ssq else None
    # whole, aligned 4-float groups in every row: 16-byte copies (8 in bf16)
    align = 8 if bf16 else 16
    vec = (pl.floats == 4 and F % 4 == 0 and x.data_ptr() % align == 0
           and (ef is None or ef.data_ptr() % align == 0))
    lib = _lib()
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    # a chunk's scenarios start a whole scenario on: the vec alignment
    # of the first holds for every chunk
    for s0 in range(0, S, MAX_SCENARIOS):
        if lead:
            BATCHED_LAUNCHES += 1
        else:
            LAUNCHES += 1
        err = lib.uplink_fused_launch(
            _at(x, s0), _at(ef, s0), _at(m, s0), _at(q, s0),
            _at(w_or_den, s0), _at(agg, s0), _at(ef_out, s0),
            _at(ssq, s0), min(MAX_SCENARIOS, S - s0), C, P, F, bf16,
            per_coord, DENOM_EPS, pl.chunk, pl.threads, pl.tiles,
            pl.floats, pl.smem, vec, index, stream)
        if err:
            raise RuntimeError("uplink_fused kernel launch failed: "
                               + lib.uplink_fused_error_string(err).decode())
    return agg, ef_out, ssq


def uplink_fused_call(x, m, q, w_or_den, *, ef=None, want_ssq=False,
                      per_coord: bool):
    """One launch of the fused uplink kernel for one scenario.

    x: (C, P, F) packetised unmasked uploads on the card, float32 or
    bfloat16 (the stream dtype), any F >= 1; ef: matching tensor or
    None; m: (C, P) f32 delivery mask; q: (C,) f32 pre-folded debias
    scales; ``w_or_den``: raw weights (C,) f32 when ``per_coord``, else
    the ready scalar denominator () f32.

    Returns (agg (P, F) f32, ef_out (C, P, F) stream dtype | None,
    ssq (C, P * tiles) f32 per-(packet, tile) partials | None: sum over
    the last axis for the masked squared norms).
    """
    if not (x.is_cuda and m.is_cuda and q.is_cuda and w_or_den.is_cuda
            and (ef is None or ef.is_cuda)):
        _refuse("uplink_fused_call", (x, m, q, w_or_den, ef))
    if x.dim() != 3:
        raise ValueError(f"x must be (C, P, F), not {tuple(x.shape)}")
    return _launch((), x, m, q, w_or_den, ef, want_ssq, per_coord)


def uplink_fused_batched_call(x, m, q, w_or_den, *, ef=None,
                              want_ssq=False, per_coord: bool):
    """One launch of the fused uplink kernel for S scenarios: the
    operands of ``uplink_fused_call`` with a leading S (``w_or_den`` is
    (S, C) when ``per_coord``, else (S,) ready denominators).

    Returns (agg (S, P, F) f32, ef_out (S, C, P, F) | None, ssq
    (S, C, P * tiles) partials | None), bitwise equal to S single calls.
    Any S >= 1: past MAX_SCENARIOS, one launch a chunk.
    """
    if not (x.is_cuda and m.is_cuda and q.is_cuda and w_or_den.is_cuda
            and (ef is None or ef.is_cuda)):
        _refuse("uplink_fused_batched_call", (x, m, q, w_or_den, ef))
    if x.dim() != 4:
        raise ValueError(f"x must be (S, C, P, F), not {tuple(x.shape)}")
    return _launch((x.shape[0],), x, m, q, w_or_den, ef, want_ssq,
                   per_coord)
