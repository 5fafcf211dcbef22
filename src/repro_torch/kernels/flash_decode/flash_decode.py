"""Binding of the Hopper flash-decode kernel (``csrc/flash_decode.cu``).

``flash_decode_call`` launches the CUDA kernel on tensors that lie on
the card and raises on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
the ``repro_torch::flash_decode`` op in ``ops.py``, by device alone.
``LAUNCHES`` counts the launches of this process: one a call, whether
it runs one pass or two, and for B or KV past MAX_GRID one a chunk of
at most MAX_GRID batch rows and MAX_GRID kv heads (``n_chunks``).
``plan`` is the launch geometry, plain Python so the CPU tests reach
it, cached on its arguments.

The binding's contract, in order: the first statement refuses any
operand that is not a CUDA tensor, with a ``ValueError`` that names
CUDA, before the counter moves and before the library is built or
loaded; then the shape checks and one pass over device, dtype, shape
and contiguity, with ``_check`` naming the first fault. A failed
launch raises ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.uplink_fused.uplink_fused import _check

LAUNCHES = 0
MAX_DH = 256
HEADS = 16              # query heads a tiled CTA holds: the MMA's M
ROWS_MAX_G = 2          # G up to this runs the row loop (kind "rows")
ROWS_CTAS_PER_SM = 8    # the row loop's splits aim at this many CTAs an SM
SMEM_PER_SM = 233_472   # bytes of shared memory on an H100 SM
SMEM_PER_CTA = 232_448  # the most one CTA may ask for
SMEM_RESERVED = 1_024   # the runtime's own share of each CTA's
MAX_STAGES = 4
TILE_ROWS = {"simt": 32, "mma": 64}
KINDS = {"rows": 0, "simt": 1, "mma": 2}
# the most batch rows, and kv heads, of one launch (grid.y and grid.z's
# limit; MAX_GRID in the .cu): a call past it is cut into chunks
MAX_GRID = 65535
_OPERANDS = ("q", "k", "v", "bias")


class Plan(NamedTuple):
    kind: str           # "rows" (G <= ROWS_MAX_G), "simt" (f32 tiles) or
    #                     "mma" (bf16 tiles on tensor cores)
    heads: int          # query heads a CTA holds
    n_hc: int           # head chunks: ceil(G / heads)
    tile: int           # rows of a tile (0 for "rows")
    stages: int         # ring slots of tiles in shared memory (0: "rows")
    smem: int           # dynamic shared memory of a pass-1 CTA, bytes
    ctas_per_sm: int    # pass-1 CTAs an SM is planned to hold at once
    cpl: int            # "rows": 16-byte chunks of a row per lane, 1 or 2
    lpr: int            # "rows": lanes that read one row, a power of two
    n_splits: int       # T splits, each one CTA per (head chunk, kv, b)
    split_len: int      # rows of a split; the last may hold fewer


def _tile_smem(kind: str, dh: int, stages: int) -> int:
    """Dynamic shared memory of a tiled CTA, as ``csrc/flash_decode.cu``
    carves it (``simt_smem``, ``mma_smem``): the K and V rings, rows an
    odd number of 16-byte chunks apart, then the kind's own buffers."""
    rows = TILE_ROWS[kind]
    if kind == "simt":
        sstride = (dh // 4) | 1
        extra = 4 * (8 * HEADS * (rows + 1) + HEADS * (rows + 4)
                     + 3 * HEADS)
    else:
        sstride = 2 * ((dh // 8 + 1) // 2) + 1
        extra = 2 * HEADS * (rows + 8) + 4 * 2 * 4 * HEADS
    return 2 * stages * rows * sstride * 16 + extra


@functools.lru_cache(maxsize=None)
def plan(B: int, KV: int, G: int, dh: int, T: int, elem_bytes: int,
         t_blk: int, n_sms: int) -> Plan:
    """Launch geometry for q (B, KV, G, dh) against T cache rows of
    ``elem_bytes``-byte elements. G <= ROWS_MAX_G runs the row loop;
    otherwise a CTA holds all G heads (chunks of 16 past 16) and a ring
    of tiles: the most stages, up to MAX_STAGES, that let 2 CTAs share
    an SM, else 1. The T splits fill about one wave of CTAs over ``n_sms``
    SMs (the row loop: about ROWS_CTAS_PER_SM CTAs an SM), none shorter
    than ``t_blk`` rows, none empty."""
    cpl = lpr = stages = tile = 0
    if G <= ROWS_MAX_G:
        kind, heads, per_sm = "rows", G, ROWS_CTAS_PER_SM
        ch = dh * elem_bytes // 16
        cpl = -(-ch // 32)
        lpr = 1
        while lpr < -(-ch // cpl):
            lpr *= 2
        smem = 4 * 4 * G * (2 + dh)
    else:
        kind = "mma" if elem_bytes == 2 else "simt"
        heads, tile = min(G, HEADS), TILE_ROWS[kind]
        fixed = _tile_smem(kind, dh, 0)
        slot = _tile_smem(kind, dh, 1) - fixed
        for per_sm in (2, 1):
            room = min(SMEM_PER_SM // per_sm - SMEM_RESERVED, SMEM_PER_CTA)
            stages = min(MAX_STAGES, (room - fixed) // slot)
            if stages >= 2:
                break
        smem = _tile_smem(kind, dh, stages)
    n_hc = -(-G // heads)
    if kind == "rows":
        want = -(-per_sm * n_sms // (B * KV * n_hc))
    else:   # one whole wave: a second, ragged one measured slower
        want = per_sm * n_sms // (B * KV * n_hc)
    n_splits = max(1, min(T // max(t_blk, 1), want))
    split_len = -(-T // n_splits)
    return Plan(kind, heads, n_hc, tile, stages, smem, per_sm, cpl, lpr,
                -(-T // split_len), split_len)


def n_chunks(B: int, KV: int) -> int:
    """Launches of one call: one a chunk of at most MAX_GRID batch rows
    and MAX_GRID kv heads."""
    return -(-B // MAX_GRID) * -(-KV // MAX_GRID)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [ptr] * 8 + [i32] * 13 + [
        ctypes.c_float, i32, ptr]
    lib.flash_decode_launch.restype = i32
    lib.flash_decode_error_string.argtypes = [i32]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _n_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_decode_call(q, k, v, bias, *, t_blk: int = 512):
    """One launch of the flash-decode kernel.

    q: (B, KV, G, dh) f32; k, v: (B, T, KV, dh) f32 or bf16, one dtype;
    bias: (T,) f32 additive mask; all contiguous on the card. Any T >= 1:
    ``t_blk`` is the shortest T split (it tunes, it does not restrict).
    dh a multiple of 16 / sizeof(k's dtype), up to 256; any B, KV >= 1
    (past MAX_GRID the call is cut into chunks, each (b, kv) slice
    computed as in a launch that holds it). Returns the (B, KV, G, dh)
    attention output in f32.
    """
    global LAUNCHES
    if not (q.is_cuda and k.is_cuda and v.is_cuda and bias.is_cuda):
        name, t = next((n, t) for n, t in zip(_OPERANDS, (q, k, v, bias))
                       if not t.is_cuda)
        raise ValueError(f"flash_decode_call runs on CUDA tensors only, and "
                         f"{name} lies on {t.device}; the plain version is "
                         f"ref.flash_decode_ref")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, dh) and k (B, T, KV, dh), "
                         f"not {tuple(q.shape)} and {tuple(k.shape)}")
    kd = k.dtype
    if kd not in (torch.float32, torch.bfloat16):
        raise TypeError(f"k, v must be float32 or bfloat16, not {kd}")
    B, KV, G, dh = q.shape
    T = k.shape[1]
    elem = k.element_size()
    if dh % (16 // elem) or not 0 < dh <= MAX_DH or T < 1 or min(
            B, KV, G) < 1:
        raise ValueError(f"unsupported shape B={B}, KV={KV}, G={G}, dh={dh}"
                         f", T={T}: dh a multiple of {16 // elem} up to "
                         f"{MAX_DH}, T >= 1, B, KV, G >= 1")
    dev = q.device
    kv_shape = (B, T, KV, dh)
    # one pass over the common case; _check names the first fault
    if (k.device != dev or v.device != dev or bias.device != dev
            or q.dtype != torch.float32 or v.dtype != kd
            or bias.dtype != torch.float32 or k.shape != kv_shape
            or v.shape != kv_shape or bias.shape != (T,)
            or not (q.is_contiguous() and k.is_contiguous()
                    and v.is_contiguous() and bias.is_contiguous())):
        _check("q", q, (B, KV, G, dh), torch.float32, dev)
        _check("k", k, kv_shape, kd, dev)
        _check("v", v, kv_shape, kd, dev)
        _check("bias", bias, (T,), torch.float32, dev)
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("q, k and v must be 16-byte aligned")
    pl = plan(B, KV, G, dh, T, elem, t_blk, _n_sms(dev.index))
    out = torch.empty((B, KV, G, dh), dtype=torch.float32, device=dev)
    parts = (None, None, None)
    if pl.n_splits > 1:
        # one buffer cut into acc (B, KV, n_splits, G, dh), then m and l
        # (B, KV, n_splits, G): acc first, so its rows stay 16-byte
        # aligned. The pointers go as numbers: no view is made. The
        # caching allocator hands the buffer out again only in this
        # stream's order, after the kernel.
        n = B * KV * pl.n_splits * G
        buf = torch.empty(n * (dh + 2), dtype=torch.float32, device=dev)
        acc = buf.data_ptr()
        parts = (acc + 4 * n * dh, acc + 4 * n * (dh + 1), acc)
    lib = _lib()
    # the current stream's handle, without building a Stream object (a
    # few microseconds a call)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    LAUNCHES += n_chunks(B, KV)
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), *parts,
        B, T, KV, G, dh, pl.n_splits, pl.split_len, KINDS[pl.kind], pl.n_hc,
        pl.stages, pl.cpl, pl.lpr, elem == 2, dh ** -0.5, dev.index, stream)
    if err:
        raise RuntimeError("flash_decode kernel launch failed: "
                           + lib.flash_decode_error_string(err).decode())
    return out
