"""Asynchronous / buffered server aggregation (FedBuff-style).

The deadline delivery model (``netsim/delivery.py``) says when each
upload lands; the sync server binarizes that against ``deadline_s`` and
drops every straggler. The other two modes keep late uploads:

    sync        a missed deadline drops the whole upload (the engine's
                step of the earlier slices, bit for bit).
    semi_sync   uploads landing within ``grace_s`` after the deadline
                still aggregate this round, weighted by w(tau_g) with
                the fractional staleness tau_g = (secs - deadline) /
                deadline; later ones drop.
    async       on-time uploads aggregate this round; late ones wait in
                a K-slot arrival buffer (``EngineState.buf``) with the
                whole staleness tau = ceil(secs / deadline) - 1 and
                join the aggregate of the round they land in,
                discounted by w(tau).

    w(tau) = 1 / (1 + tau)^alpha        (``staleness_weight``)

The buffered vectors are stored already debias-scaled, so the discount
multiplies the same per-client scale the uplink kernel gives on-time
clients.

The mode, ``traced`` and ``buffer_k`` are static (the step's structure);
with ``traced=True`` the mode rides ``ScenarioCtx.srv_mode`` as a
one-hot, so a mode x loss-rate grid is one batched step. The exponent
and the grace window (``SWEEP_VARYING_SRV_FIELDS``) always ride the
context.

The buffer is kept sorted by due round. Overflow is deterministic: of
the existing entries followed by this round's candidates, a stable sort
by due round keeps the K earliest, so on ties existing slots win, then
cohort order. The reference (``repro/core/async_agg.py``) sorts with
XLA, whose CPU sort compares a denormal due time as 0; ``torch.sort``
compares it as the number it is, as the numpy oracle does. The engine's
due times are whole round indices or ``EMPTY_DUE``, so it never meets
one.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

MODES = ("sync", "semi_sync", "async")

# the due round of an empty slot or a gated-off candidate: an f32 value
# no round index reaches, so empty slots sort after every live entry
# and never test ready
EMPTY_DUE = float(np.float32(3.0e9))


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Server aggregation mode knobs (``FLConfig.srv``)."""
    mode: str = "sync"          # static: one of MODES
    # traced=True builds all three modes into the step and takes the
    # mode from ScenarioCtx.srv_mode (one-hot), so one sweep can vary it
    traced: bool = False
    buffer_k: int = 8           # static: arrival-buffer slots
    # scenario knobs (SWEEP_VARYING_SRV_FIELDS)
    staleness_alpha: float = 0.5  # w(tau) = (1 + tau)^(-alpha)
    grace_s: float = 30.0         # semi_sync window after the deadline

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown server mode {self.mode!r} (one of "
                             f"{MODES})")
        if self.buffer_k < 1:
            raise ValueError(f"buffer_k must be >= 1, got {self.buffer_k}")


# AsyncConfig fields a scenario may vary without changing the step (the
# mode joins them when traced=True)
SWEEP_VARYING_SRV_FIELDS = ("staleness_alpha", "grace_s")


def mode_onehot(mode: str) -> np.ndarray:
    """(len(MODES),) f32 one-hot for ``ScenarioCtx.srv_mode``."""
    v = np.zeros(len(MODES), np.float32)
    v[MODES.index(mode)] = 1.0
    return v


def staleness_weight(tau, alpha) -> torch.Tensor:
    """w(tau) = 1 / (1 + tau)^alpha, tau clamped at 0: exactly 1.0 at
    tau = 0 and for alpha = 0, finite for every finite tau."""
    tau = torch.as_tensor(tau, dtype=torch.float32)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=tau.device)
    return torch.pow(1.0 + torch.clamp(tau, min=0.0), -alpha)


class ArrivalBuffer(NamedTuple):
    """The K-slot in-flight upload buffer, sorted by ``due``. Zero-size
    ((0, 0) and (0,)) when the step carries no buffer."""
    vec: torch.Tensor  # (K, D_up) debias-scaled loss-masked contributions
    due: torch.Tensor  # (K,) f32 absolute round of arrival
    w: torch.Tensor    # (K,) denominator weight of the contribution
    tau: torch.Tensor  # (K,) whole rounds of staleness (f32)


def init_arrival_buffer(k: int, d_up: int, device=None) -> ArrivalBuffer:
    return ArrivalBuffer(vec=torch.zeros((k, d_up), device=device),
                         due=torch.full((k,), EMPTY_DUE, device=device),
                         w=torch.zeros((k,), device=device),
                         tau=torch.zeros((k,), device=device))


def empty_arrival_buffer(device=None) -> ArrivalBuffer:
    """The zero-size placeholder carried when the buffer is off."""
    return ArrivalBuffer(vec=torch.zeros((0, 0), device=device),
                         due=torch.zeros((0,), device=device),
                         w=torch.zeros((0,), device=device),
                         tau=torch.zeros((0,), device=device))


def fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32, as XLA's CPU backend fuses a
    multiply-add inside the reference's jitted step: the float64 product
    of two floats is exact, and the sum is rounded once."""
    return (a.double() * b.double() + c.double()).float()


def weighted_row_sum(w, vec) -> torch.Tensor:
    """sum_i w_i * vec_i over the rows of ``vec`` ((K, D) or (K,)), as
    XLA compiles the reference's ``(w[:, None] * vec).sum(axis=0)`` in a
    jitted step: row by row from zero, each step a fused multiply-add.
    Elementwise work, never a matmul."""
    w64, v64 = w.double(), vec.double()
    acc = torch.zeros_like(vec[0])
    for i in range(vec.shape[0]):
        # fma(w_i, vec_i, acc): addcmul's float64 product is exact
        acc = torch.addcmul(acc.double(), w64[i], v64[i]).float()
    return acc


def buffer_pop_ready(buf: ArrivalBuffer, t, alpha
                     ) -> Tuple[torch.Tensor, torch.Tensor, ArrivalBuffer]:
    """Drain every entry due at round ``t`` (an f32 scalar tensor).

    Returns ``(num (D_up,), den (), cleared buffer)`` with num = sum of
    w(tau_i) * vec_i and den = sum of w(tau_i) * w_i over the ready
    entries, as one ``weighted_row_sum``; an empty buffer gives exact
    zeros.
    """
    ready = buf.due <= t
    w_tau = staleness_weight(buf.tau, alpha) * ready.float()
    # both sums in one pass: w rides as the last column of vec
    both = weighted_row_sum(w_tau, torch.cat([buf.vec, buf.w[:, None]], 1))
    num, den = both[:-1], both[-1]
    keep = (~ready).float()
    cleared = ArrivalBuffer(vec=buf.vec * keep[:, None],
                            due=torch.where(ready, EMPTY_DUE, buf.due),
                            w=buf.w * keep, tau=buf.tau * keep)
    return num, den, cleared


def buffer_insert(buf: ArrivalBuffer, vec, due, w, tau,
                  live) -> ArrivalBuffer:
    """Insert this round's candidates (cohort-shaped, gated by the (C,)
    bool ``live``) into the K-slot buffer: a stable sort of the existing
    entries followed by the candidates by due round keeps the K
    earliest; on ties existing slots win, then cohort order."""
    K = buf.due.shape[0]
    live_f = live.float()
    all_due = torch.cat([buf.due, torch.where(live, due, EMPTY_DUE)])
    order = torch.argsort(all_due, stable=True)[:K]
    all_vec = torch.cat([buf.vec, vec * live_f[:, None]])
    return ArrivalBuffer(
        vec=all_vec.index_select(0, order),
        due=all_due.index_select(0, order),
        w=torch.cat([buf.w, w * live_f]).index_select(0, order),
        tau=torch.cat([buf.tau, tau * live_f]).index_select(0, order))
