"""Binding of the Hopper flash-decode kernel (``csrc/flash_decode.cu``).

``flash_decode_call`` launches the CUDA kernel on tensors that lie on
the card and raises on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
the ``repro_torch::flash_decode`` op in ``ops.py``, by device alone.
``LAUNCHES`` counts the calls that launch it in this process (one per
call, whether the call runs one pass or two). ``plan`` is the launch
geometry, plain Python so the CPU tests reach it.
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
CTAS_PER_SM = 8         # pass 1 aims at about this many CTAs on each SM


class Plan(NamedTuple):
    gmax: int           # query heads a CTA holds: 1, 2, 4 or 8
    n_hc: int           # head chunks: ceil(G / gmax)
    cpl: int            # 16-byte chunks of a row per lane: 1 or 2
    lpr: int            # lanes that read one row: a power of two <= 32
    n_splits: int       # T splits, each one CTA per (head chunk, kv, b)
    split_len: int      # rows of a split; the last may hold fewer


def plan(B: int, KV: int, G: int, dh: int, T: int, elem_bytes: int,
         t_blk: int, n_sms: int) -> Plan:
    """Launch geometry for q (B, KV, G, dh) against T cache rows of
    ``elem_bytes``-byte elements: a 16-byte chunk is 16 / elem_bytes
    elements, a row dh / that many chunks. The T splits are enough for
    about ``CTAS_PER_SM`` CTAs on each of ``n_sms`` SMs, none shorter than
    ``t_blk`` rows, and none empty."""
    ch = dh * elem_bytes // 16
    cpl = -(-ch // 32)
    lpr = 1
    while lpr < -(-ch // cpl):
        lpr *= 2
    gmax = 1
    while gmax < min(G, 8):
        gmax *= 2
    n_hc = -(-G // gmax)
    want = -(-CTAS_PER_SM * n_sms // (B * KV * n_hc))
    n_splits = max(1, min(T // max(t_blk, 1), want))
    split_len = -(-T // n_splits)
    return Plan(gmax, n_hc, cpl, lpr, -(-T // split_len), split_len)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_decode")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_launch.argtypes = [ptr] * 8 + [i32] * 12 + [
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
    dh a multiple of 16 / sizeof(k's dtype), up to 256. Returns the
    (B, KV, G, dh) attention output in f32.
    """
    global LAUNCHES
    if not q.is_cuda:
        raise ValueError("flash_decode_call runs on CUDA tensors only; the "
                         "plain version is ref.flash_decode_ref")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, dh) and k (B, T, KV, dh), "
                         f"not {tuple(q.shape)} and {tuple(k.shape)}")
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"k, v must be float32 or bfloat16, not {k.dtype}")
    B, KV, G, dh = q.shape
    T = k.shape[1]
    elem = k.element_size()
    if dh % (16 // elem) or not 0 < dh <= MAX_DH or T < 1 or min(
            B, KV, G) < 1 or max(B, KV) > 65535:
        raise ValueError(f"unsupported shape B={B}, KV={KV}, G={G}, dh={dh}"
                         f", T={T}: dh a multiple of {16 // elem} up to "
                         f"{MAX_DH}, T >= 1, B and KV in [1, 65535]")
    dev = q.device
    _check("q", q, (B, KV, G, dh), torch.float32, dev)
    _check("k", k, (B, T, KV, dh), k.dtype, dev)
    _check("v", v, (B, T, KV, dh), k.dtype, dev)
    _check("bias", bias, (T,), torch.float32, dev)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    pl = plan(B, KV, G, dh, T, elem, t_blk, _n_sms(dev.index))
    out = torch.empty((B, KV, G, dh), dtype=torch.float32, device=dev)
    parts = (None, None, None)
    if pl.n_splits > 1:
        parts = (torch.empty((B, KV, pl.n_splits, G), device=dev),
                 torch.empty((B, KV, pl.n_splits, G), device=dev),
                 torch.empty((B, KV, pl.n_splits, G, dh), device=dev))
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES += 1
    err = lib.flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), *(None if t is None else t.data_ptr() for t in parts),
        B, T, KV, G, dh, pl.n_splits, pl.split_len, pl.gmax, pl.n_hc,
        pl.cpl, pl.lpr, int(k.dtype == torch.bfloat16), dh ** -0.5,
        dev.index, stream)
    if err:
        raise RuntimeError("flash_decode kernel launch failed: "
                           + lib.flash_decode_error_string(err).decode())
    return out
