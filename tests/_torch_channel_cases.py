"""Cases and torch transcriptions of the channel kernels' schemes.

``ge_case`` and ``fec_case`` make the numpy operands of the
Gilbert–Elliott mask and of the FEC repair from a seed, with the edges
planted: NaN uniforms and a NaN mask entry, rows whose flip rates are 0
and 1, uniforms equal to their thresholds, rows that start all BAD. The
CPU tests (which also run the JAX reference) and the card tests (which
import no JAX) draw the same cases from here.

``scan_mask`` and ``ballot_fec`` transcribe, step for step in torch,
what ``src/repro_torch/csrc/netsim_mask.cu`` and ``fec_recover.cu`` do
on the card: the 2-bit transition maps, their composition table, the
shuffle scan over a segment of lanes and the carry from step to step;
the group-aligned warp steps, the ``!(m >= 0.5)`` ballots and their
popcounts, and past 32 lanes a warp per group with the fix-up of the one
loss. The CPU tests hold them bitwise against the reference, so the
kernels' algebra is checked where the kernels cannot run.
"""
from __future__ import annotations

import numpy as np
import torch

SEEDS = (0, 1, 12345)
MASK_P = (1, 31, 32, 33, 36, 100, 1024)
FEC_G = (1, 3, 8, 32, 33, 40)
GE_VARIANTS = ("random", "all_bad", "rates_0_1", "at_threshold")


def ge_case(R, P, seed, variant="random"):
    """(u_t, u_e, s0, p_gb, p_bg, h_g, h_b) as numpy arrays, R >= 2 rows
    of P packets. Every variant plants a NaN transition uniform in row 0
    and a NaN emission uniform in row 1. ``all_bad`` starts every row
    BAD; ``rates_0_1`` sets each row's (p_gb, p_bg) to one of (0, 0), (0,
    1), (1, 0), (1, 1); ``at_threshold`` makes every transition uniform
    equal to a flip rate (p_gb at even packets, p_bg at odd ones) and
    every emission uniform equal to a loss rate, so that the strict < of
    the flip and the >= of delivery decide each packet."""
    rng = np.random.default_rng(seed)
    u_t = rng.random((R, P)).astype(np.float32)
    u_e = rng.random((R, P)).astype(np.float32)
    s0 = (rng.random(R) < 0.4).astype(np.int32)
    p_gb = rng.uniform(0.0, 0.3, R).astype(np.float32)
    p_bg = rng.uniform(0.05, 0.6, R).astype(np.float32)
    h_g = rng.uniform(0.0, 0.1, R).astype(np.float32)
    h_b = rng.uniform(0.5, 1.0, R).astype(np.float32)
    if variant == "all_bad":
        s0[:] = 1
    elif variant == "rates_0_1":
        p_gb = (np.arange(R) // 2 % 2).astype(np.float32)
        p_bg = (np.arange(R) % 2).astype(np.float32)
    elif variant == "at_threshold":
        even = np.arange(P) % 2 == 0
        u_t = np.where(even, p_gb[:, None], p_bg[:, None]).astype(np.float32)
        u_e = np.where(even, h_g[:, None], h_b[:, None]).astype(np.float32)
    elif variant != "random":
        raise ValueError(variant)
    u_t[0, P // 2] = np.nan
    u_e[1, P - 1] = np.nan
    return u_t, u_e, s0, p_gb, p_bg, h_g, h_b


def fec_case(R, P, G, seed):
    """(mask, parity) as numpy arrays, R >= 3 rows: a 0/1 mask with about
    one loss a group (half the packets where G = 1), parities delivered
    at 70%; row 0 carries a NaN in its first group beside a real loss
    (two "lost": no repair), row 1 a NaN as its first group's only loss
    with that group's parity delivered (one "lost": the NaN stays), row 2
    a NaN alone in a group whose parity is lost."""
    rng = np.random.default_rng(seed)
    gn = -(-P // G)
    p_loss = min(0.5, 1.0 / min(G, P) + 0.05)
    mask = (rng.random((R, P)) > p_loss).astype(np.float32)
    par = (rng.random((R, gn)) > 0.3).astype(np.float32)
    first = min(G, P)
    mask[:3, :first] = 1.0
    mask[0, 0] = np.nan
    if first > 1:
        mask[0, first - 1] = 0.0
    mask[1, first - 1] = np.nan
    par[1, 0] = 1.0
    mask[2, 0] = np.nan
    par[2, 0] = 0.0
    return mask, par


# ---------------------------------------------------------------------------
# netsim_mask.cu: a segment of `lanes` lanes a row, V packets a lane
# ---------------------------------------------------------------------------
IDENTITY = 2            # GOOD -> GOOD, BAD -> BAD


def _compose_table():
    t = 0
    for b in range(4):
        for a in range(4):
            r0 = (b >> (a & 1)) & 1
            r1 = (b >> ((a >> 1) & 1)) & 1
            t |= (r0 | (r1 << 1)) << ((b * 4 + a) * 2)
    return t


COMPOSE = _compose_table()


def compose(later, earlier):
    """The map ``later`` after ``earlier`` (int64 tensors of 2-bit maps),
    read from the kernel's table."""
    return (COMPOSE >> ((later * 4 + earlier) * 2)) & 3


def apply(m, s):
    return (m >> s) & 1


def _shfl_up(x, off):
    """__shfl_up_sync over the last axis (a segment): lane i reads lane
    i - off, and lanes below ``off`` read their own value."""
    if off >= x.shape[-1]:
        return x
    return torch.cat([x[..., :off], x[..., :-off]], dim=-1)


def scan_mask(u_t, u_e, s0, p_gb, p_bg, h_g, h_b, *, lanes, vec):
    """The kernel's scheme on (R, P) f32 tensors: returns (mask, s_fin)
    as the card computes them with a segment of ``lanes`` lanes a row
    and 4 packets a lane when ``vec`` (else 1)."""
    V = 4 if vec else 1
    R, P = u_t.shape
    span = lanes * V
    steps = -(-P // span)
    pad = steps * span - P
    ut = torch.nn.functional.pad(u_t, (0, pad)).reshape(R, steps, lanes, V)
    ue = torch.nn.functional.pad(u_e, (0, pad)).reshape(R, steps, lanes, V)
    valid = (torch.arange(steps * span) < P).reshape(steps, lanes, V)
    gb, bg = p_gb[:, None, None], p_bg[:, None, None]
    hg, hb = h_g[:, None], h_b[:, None]
    lane = torch.arange(lanes)
    carry = (s0 == 1).long()
    out = torch.empty((R, steps, lanes, V), dtype=torch.float32)
    for k in range(steps):
        m = torch.where(valid[k], (ut[:, k] < gb).long()
                        | ((~(ut[:, k] < bg)).long() << 1), IDENTITY)
        own = torch.full((R, lanes), IDENTITY, dtype=torch.long)
        for j in range(V):
            own = compose(m[..., j], own)
        incl, off = own, 1
        while off < lanes:
            before = _shfl_up(incl, off)
            incl = torch.where(lane >= off, compose(incl, before), incl)
            off <<= 1
        excl = _shfl_up(incl, 1)
        excl = torch.where(lane == 0, IDENTITY, excl)
        s = apply(excl, carry[:, None])
        for j in range(V):
            s = apply(m[..., j], s)
            out[:, k, :, j] = (ue[:, k, :, j]
                               >= torch.where(s == 1, hb, hg)).float()
        carry = apply(incl[:, lanes - 1], carry)
    return out.reshape(R, -1)[:, :P], carry.to(torch.int32)


# ---------------------------------------------------------------------------
# fec_recover.cu: whole groups a warp step, or a warp a group past 32 lanes
# ---------------------------------------------------------------------------
def _popc(x):
    return sum(((x >> b) & 1) for b in range(32))


def _ballot(bits):
    """__ballot_sync over the last axis of 32 lanes: an int64 word."""
    return (bits.long() << torch.arange(32)).sum(-1)


def ballot_fec(mask, parity, group, *, vec):
    """The kernel's scheme on (R, P) and (R, Gn) f32 tensors, 4 packets a
    lane when ``vec`` (else 1); returns the repaired mask as the card
    computes it."""
    V = 4 if vec else 1
    R, P = mask.shape
    gn = parity.shape[1]
    gl = group // V
    lane = torch.arange(32)
    out = mask.clone()
    if gl <= 32:
        per_step = min(32 // gl, gn)
        gi = lane // gl
        in_step = gi < per_step
        shift = torch.where(in_step, gi * gl, 0)
        gmask = torch.where(in_step, (((1 << gl) - 1) << shift)
                            & 0xFFFFFFFF, 0)
        for k in range(-(-gn // per_step)):
            g = k * per_step + gi
            p0 = g * group + (lane - gi * gl) * V
            nv = torch.where(in_step & (g < gn),
                             (P - p0).clamp(0, V), 0)
            idx = p0[:, None] + torch.arange(V)             # (32, V)
            take = torch.arange(V) < nv[:, None]
            v = torch.where(take, mask[:, idx.clamp(0, max(P - 1, 0))], 1.0)
            lost = torch.zeros((R, 32), dtype=torch.long)
            for j in range(V):
                word = _ballot(take[:, j] & ~(v[..., j] >= 0.5))   # (R,)
                lost += _popc(word[:, None] & gmask)
            par = parity[:, g.clamp(0, gn - 1)]
            repair = (lost == 1) & (par > 0.5)
            v = torch.where(repair[..., None] & (v < 0.5), 1.0, v)
            rows, lanes_, js = torch.nonzero(take.expand(R, 32, V),
                                             as_tuple=True)
            out[rows, idx[lanes_, js]] = v[rows, lanes_, js]
        return out
    for g in range(gn):
        lo, hi = g * group, min((g + 1) * group, P)
        lost = torch.zeros(R, dtype=torch.long)
        own = torch.full((R, 32), -1, dtype=torch.long)
        own_v = torch.zeros((R, 32))
        for base in range(lo, hi, 32 * V):
            p0 = base + lane * V
            nv = (hi - p0).clamp(0, V)
            for j in range(V):
                take = j < nv
                v = torch.where(take, mask[:, (p0 + j).clamp(0, P - 1)],
                                1.0)
                bits = take & ~(v >= 0.5)
                lost += _popc(_ballot(bits))
                own = torch.where(bits, p0 + j, own)
                own_v = torch.where(bits, v, own_v)
        fix = ((lost[:, None] == 1) & (own >= 0) & (own_v < 0.5)
               & (parity[:, g, None] > 0.5))
        rows, lanes_ = torch.nonzero(fix, as_tuple=True)
        out[rows, own[rows, lanes_]] = 1.0
    return out
