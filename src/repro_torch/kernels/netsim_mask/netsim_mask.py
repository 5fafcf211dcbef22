"""Binding of the Hopper Gilbert–Elliott mask kernel
(``csrc/netsim_mask.cu``).

``netsim_mask_call`` launches the CUDA kernel on tensors that lie on the
card and raises on anything else: there is no fallback here. The choice
between the kernel and its plain version (``ref.py``) is made by the
``repro_torch::netsim_mask`` op in ``ops.py``, by device alone.
``LAUNCHES`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.uplink_fused.uplink_fused import _check

LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("netsim_mask")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.netsim_mask_launch.argtypes = [ptr] * 9 + [i32, i32, i32, ptr]
    lib.netsim_mask_launch.restype = i32
    lib.netsim_mask_error_string.argtypes = [i32]
    lib.netsim_mask_error_string.restype = ctypes.c_char_p
    return lib


def netsim_mask_call(u_t, u_e, s0, p_gb, p_bg, h_g, h_b):
    """One launch of the Gilbert–Elliott mask kernel.

    u_t, u_e: (R, P) f32 uniforms on the card; s0: (R,) int32 states;
    p_gb, p_bg, h_g, h_b: (R,) f32, all contiguous. R is the cohort
    size C for one scenario and S*C for a sweep.

    Returns (mask (R, P) f32 with 1 = delivered, s_final (R,) int32).
    """
    global LAUNCHES
    if not u_t.is_cuda:
        raise ValueError("netsim_mask_call runs on CUDA tensors only; "
                         "the plain version is ref.ge_mask_ref")
    if u_t.dim() != 2:
        raise ValueError(f"u_t must be (R, P), not {tuple(u_t.shape)}")
    R, P = u_t.shape
    dev = u_t.device
    _check("u_t", u_t, (R, P), torch.float32, dev)
    _check("u_e", u_e, (R, P), torch.float32, dev)
    _check("s0", s0, (R,), torch.int32, dev)
    for name, t in (("p_gb", p_gb), ("p_bg", p_bg), ("h_g", h_g),
                    ("h_b", h_b)):
        _check(name, t, (R,), torch.float32, dev)
    mask = torch.empty((R, P), dtype=torch.float32, device=dev)
    s_fin = torch.empty((R,), dtype=torch.int32, device=dev)
    if R == 0 or P == 0:
        s_fin.copy_(s0)
        return mask, s_fin
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES += 1
    err = lib.netsim_mask_launch(
        u_t.data_ptr(), u_e.data_ptr(), s0.data_ptr(), p_gb.data_ptr(),
        p_bg.data_ptr(), h_g.data_ptr(), h_b.data_ptr(), mask.data_ptr(),
        s_fin.data_ptr(), R, P, dev.index, stream)
    if err:
        raise RuntimeError("netsim_mask kernel launch failed: "
                           + lib.netsim_mask_error_string(err).decode())
    return mask, s_fin
