"""Binding of the Hopper q-FedAvg reweighting kernel
(``csrc/qfed_reweight.cu``).

``qfed_reweight_call`` launches the CUDA kernel on tensors that lie on
the card and raises on anything else: there is no fallback here. The
choice between the kernel and its plain version (``ref.py``) is made by
the ``repro_torch::qfed_reweight`` op in ``ops.py``, by device alone.
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

UNROLL = 4              # units a thread has in flight (kUnroll in the .cu)
MAX_CLUSTER = 8         # CTAs a client at most: the portable cluster size
ONE_STEP = 1024 * UNROLL    # units of a row one CTA takes in one step
MAX_THREADS = 512       # a CTA's threads where a row takes several steps
SPAN = MAX_THREADS * UNROLL * 4     # units a CTA takes before K doubles
_OPERANDS = ("dw", "fq")


class Plan(NamedTuple):
    """Launch geometry of one call: each client's row over a cluster of
    ``cluster`` CTAs, all on grid.x, in float4 units where ``vec``."""
    vec: bool       # 16-byte units: D % 4 == 0 and both rows aligned
    cluster: int    # K CTAs a client: 1, 2, 4 or 8
    threads: int    # a CTA's, whole warps
    ctas: int       # C * K


@functools.lru_cache(maxsize=None)
def plan(C: int, D: int, aligned: bool) -> Plan:
    """The kernel's geometry for C rows of D floats; ``aligned`` when dw
    and delta start on 16-byte boundaries. A row that one CTA of at most
    1,024 threads takes in one step of UNROLL units a thread stays in
    one CTA: the cluster's exchange costs more than the spread gains
    (on an H100 at (10, 36, 256): 0.0024 ms device with K = 1 and 576
    threads against 0.0025-0.0027 with K = 2, 4 or 8). A longer row goes
    over K CTAs of at most MAX_THREADS, K doubling while a CTA would
    take more than SPAN units, up to 8 (at (16, 1024, 256): 0.0088-0.0091
    ms with K = 8 against 0.0158 with K = 2). K and the CTA size follow
    D alone, so a row's sum order does not depend on C: a vmapped call,
    its scenarios folded into C, gives each row its single call's bits.
    Raises ``ValueError`` where C * K CTAs exceed a grid."""
    vec = aligned and D % 4 == 0
    units = D // 4 if vec else D
    K, cap = 1, 1024
    if units > ONE_STEP:
        cap = MAX_THREADS
        while K < MAX_CLUSTER and K * SPAN < units:
            K *= 2
    part = -(-units // K)
    threads = min(cap, max(32, -(-part // (32 * UNROLL)) * 32))
    if C * K > 2 ** 31 - 1:
        raise ValueError(f"{C} clients of {D} floats need more CTAs than "
                         f"a grid has")
    return Plan(vec, K, threads, C * K)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("qfed_reweight")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.qfed_reweight_launch.argtypes = [ptr, ptr, ptr, ptr, i32,
                                         ctypes.c_longlong, i32, i32, i32,
                                         i32, ptr]
    lib.qfed_reweight_launch.restype = i32
    lib.qfed_reweight_error_string.argtypes = [i32]
    lib.qfed_reweight_error_string.restype = ctypes.c_char_p
    return lib


def _refuse(operands):
    """Raise the CPU refusal, naming the first operand off the card."""
    name, t = next((n, t) for n, t in zip(_OPERANDS, operands)
                   if not t.is_cuda)
    raise ValueError(f"qfed_reweight_call runs on CUDA tensors only, and "
                     f"{name} lies on {t.device}; the plain version is "
                     f"ref.qfed_reweight_ref")


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


def qfed_reweight_call(dw, fq):
    """One launch of the reweighting kernel.

    dw: (C, P, F) f32 pseudo-gradients on the card; fq: (C,) f32 = F_k^q;
    both contiguous. C is the cohort for one step and S*C for a vmapped
    batch; any C, P and F. Returns (delta (C, P, F) f32, ssq (C,) f32 =
    ||dw_k||^2), as the reference's ``qfed_reweight_call`` does.
    """
    global LAUNCHES
    if not (dw.is_cuda and fq.is_cuda):
        _refuse((dw, fq))
    if dw.dim() != 3:
        raise ValueError(f"dw must be (C, P, F), not {tuple(dw.shape)}")
    C, P, F = dw.shape
    index = dw.get_device()
    # one pass over the common case; _check names the first fault
    if not (_fits(dw, (C, P, F), index) and _fits(fq, (C,), index)):
        _check("dw", dw, (C, P, F), dw.device)
        _check("fq", fq, (C,), dw.device)
    delta = torch.empty_like(dw)
    ssq = dw.new_empty((C,))
    if C == 0:
        return delta, ssq
    D = P * F
    pl = plan(C, D, dw.data_ptr() % 16 == 0 and delta.data_ptr() % 16 == 0)
    lib = _lib()
    # the current stream's handle, without building a Stream object
    stream = torch._C._cuda_getCurrentRawStream(index)
    LAUNCHES += 1
    err = lib.qfed_reweight_launch(dw.data_ptr(), fq.data_ptr(),
                                   delta.data_ptr(), ssq.data_ptr(), C, D,
                                   pl.vec, pl.cluster, pl.threads, index,
                                   stream)
    if err:
        raise RuntimeError("qfed_reweight kernel launch failed: "
                           + lib.qfed_reweight_error_string(err).decode())
    return delta, ssq
