"""Binding of the Hopper q-FedAvg reweighting kernel
(``csrc/qfed_reweight.cu``).

``qfed_reweight_call`` launches the CUDA kernel on tensors that lie on
the card and raises on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
the ``repro_torch::qfed_reweight`` op in ``ops.py``, by device alone.
``LAUNCHES`` counts the kernel launches of this process.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.uplink_fused.uplink_fused import _check

LAUNCHES = 0
BLOCK_ROWS = 8       # packet rows per CTA: one ssq partial each


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("qfed_reweight")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qfed_reweight_launch.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                         i32, i32, ptr]
    lib.qfed_reweight_launch.restype = i32
    lib.qfed_reweight_error_string.argtypes = [i32]
    lib.qfed_reweight_error_string.restype = ctypes.c_char_p
    return lib


def qfed_reweight_call(dw, fq):
    """One launch of the reweighting kernel.

    dw: (C, P, F) f32 pseudo-gradients on the card; fq: (C,) f32 = F_k^q;
    both contiguous. C is the cohort for one step and S*C for a vmapped
    batch. Returns (delta (C, P, F) f32, ssq partials (C, G) f32 with
    G = ceil(P / BLOCK_ROWS), to be summed over G).
    """
    global LAUNCHES
    if not dw.is_cuda:
        raise ValueError("qfed_reweight_call runs on CUDA tensors only; "
                         "the plain version is ref.qfed_reweight_ref")
    if dw.dim() != 3:
        raise ValueError(f"dw must be (C, P, F), not {tuple(dw.shape)}")
    C, P, F = dw.shape
    if C > 65535:
        raise ValueError(f"at most 65535 clients in one launch, not {C}")
    dev = dw.device
    _check("dw", dw, (C, P, F), torch.float32, dev)
    _check("fq", fq, (C,), torch.float32, dev)
    G = -(-P // BLOCK_ROWS)
    delta = torch.empty_like(dw)
    ssq = torch.zeros((C, G), dtype=torch.float32, device=dev)
    if C == 0 or P == 0 or F == 0:
        return delta, ssq
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    LAUNCHES += 1
    err = lib.qfed_reweight_launch(dw.data_ptr(), fq.data_ptr(),
                                   delta.data_ptr(), ssq.data_ptr(), C, P,
                                   F, BLOCK_ROWS, dev.index, stream)
    if err:
        raise RuntimeError("qfed_reweight kernel launch failed: "
                           + lib.qfed_reweight_error_string(err).decode())
    return delta, ssq
