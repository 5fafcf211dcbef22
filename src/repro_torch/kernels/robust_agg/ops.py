"""Engine-facing entry point of the defended uplink step.

``robust_uplink_round`` is the uplink when the fault model is on
(``FaultConfig.enabled``): EF re-inject, the per-packet finite screen
(bad packets quarantined as if lost, for all four debias modes),
per-client norm clipping, the weighted or coordinate-wise trimmed-mean
aggregate, the new EF rows, the masked squared norms and the
per-client quarantine counts.

Structure, as in the reference (``repro/kernels/robust_agg/ops.py``): a
torch prepass computes the finite bits, the screened mask, the screened
norms, the clip factor, the kept fraction and the quarantine counts;
then one ``repro_torch::robust_agg`` op computes the aggregate and the
EF rows. On a CUDA tensor the op launches the Hopper kernel
(``robust_agg.robust_agg_call``); on a CPU tensor it runs the plain
version (``ref.robust_ref``). Nothing else picks the path. So the
defended uplink reads the (C, P, F) uploads twice (prepass and kernel)
where the undefended one reads them once.

Under ``torch.func.vmap`` (the sweep's scenario axis) the op's batching
rule calls ``repro_torch::robust_agg_batched``: one launch of the
kernel's scenario grid for all S scenarios, bitwise S single calls.

Every gate is a scenario knob; with the gates off the expressions are
bitwise the undefended ``uplink_fused`` math.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.tra import DEBIAS_MODES
from repro_torch.kernels.common import DENOM_EPS
from repro_torch.kernels.robust_agg.ref import robust_ref
from repro_torch.kernels.robust_agg.robust_agg import (
    robust_agg_batched_call, robust_agg_call)
from repro_torch.kernels.uplink_fused.ops import (_pack_rows,
                                                  debias_client_scale)


class RobustUplinkOut(NamedTuple):
    agg: torch.Tensor                 # (d_up,) defended aggregate
    ef_rows: Optional[torch.Tensor]   # (C, d_up) new EF rows, or None
    ssq: Optional[torch.Tensor]       # (C,) screened masked sq norms
    qcnt: torch.Tensor                # (C,) quarantined-packet counts
    pk_ok: torch.Tensor               # (C, P) per-packet finite bits
    s_clip: torch.Tensor              # (C,) norm-clip factors (1 = off)
    kept: Optional[torch.Tensor]      # (C,) screened kept fraction
    #                                   (per_client_rate mode only)


def _plain(x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos, trim_k,
           per_coord):
    agg, ef_out, _ = robust_ref(x, m, q, w_or_den, ef=ef, screen=screen,
                                trim_gate=trim_gate, g=g, w_pos=w_pos,
                                trim_k=trim_k, per_coord=per_coord)
    return agg, torch.empty(0) if ef_out is None else ef_out


def _outputs(agg, ef_out):
    return agg, torch.empty(0, device=agg.device) if ef_out is None \
        else ef_out


@torch.library.custom_op("repro_torch::robust_agg", mutates_args=(),
                         device_types="cpu")
def robust_agg_op(x: torch.Tensor, m: torch.Tensor, q: torch.Tensor,
                  w_or_den: torch.Tensor, screen: torch.Tensor,
                  trim_gate: torch.Tensor, ef: Optional[torch.Tensor],
                  g: Optional[torch.Tensor], w_pos: Optional[torch.Tensor],
                  trim_k: int, per_coord: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scenario's defended aggregate: (agg (P, F) f32, ef_out
    (C, P, F) f32 or empty). Operands as in
    ``robust_agg.robust_agg_call``."""
    return _plain(x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos,
                  trim_k, per_coord)


@robust_agg_op.register_kernel("cuda")
def _robust_agg_cuda(x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos,
                     trim_k, per_coord):
    return _outputs(*robust_agg_call(
        x, m, q, w_or_den, screen, trim_gate, ef=ef, g=g, w_pos=w_pos,
        trim_k=trim_k, per_coord=per_coord))


@torch.library.custom_op("repro_torch::robust_agg_batched", mutates_args=(),
                         device_types="cpu")
def robust_agg_batched_op(x: torch.Tensor, m: torch.Tensor, q: torch.Tensor,
                          w_or_den: torch.Tensor, screen: torch.Tensor,
                          trim_gate: torch.Tensor, ef: Optional[torch.Tensor],
                          g: Optional[torch.Tensor],
                          w_pos: Optional[torch.Tensor], trim_k: int,
                          per_coord: bool
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """S scenarios' defended aggregate: ``robust_agg_op`` with a leading
    S on every operand and output."""
    return _plain(x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos,
                  trim_k, per_coord)


@robust_agg_batched_op.register_kernel("cuda")
def _robust_agg_batched_cuda(x, m, q, w_or_den, screen, trim_gate, ef, g,
                             w_pos, trim_k, per_coord):
    return _outputs(*robust_agg_batched_call(
        x, m, q, w_or_den, screen, trim_gate, ef=ef, g=g, w_pos=w_pos,
        trim_k=trim_k, per_coord=per_coord))


@robust_agg_op.register_vmap
def _robust_agg_vmap(info, in_dims, x, m, q, w_or_den, screen, trim_gate,
                     ef, g, w_pos, trim_k, per_coord):
    B = info.batch_size

    def lead(t, d):
        if t is None:
            return None
        t = t.unsqueeze(0).expand(B, *t.shape) if d is None \
            else t.movedim(d, 0)
        return t.contiguous()

    args = [lead(t, d) for t, d in zip(
        (x, m, q, w_or_den, screen, trim_gate, ef, g, w_pos), in_dims)]
    agg, ef_out = robust_agg_batched_op(*args, trim_k, per_coord)
    return (agg, ef_out), (0, 0 if ef is not None else None)


def _f32(v, device):
    if isinstance(v, torch.Tensor):
        return v.float()
    return torch.tensor(v, dtype=torch.float32, device=device)


class RobustPrepass(NamedTuple):
    """The prepass's per-client reductions and the kernel's operands."""
    args: tuple            # robust_agg_op's tensors, in its order
    trim_k: int
    per_coord: bool
    ssq: torch.Tensor      # (C,) screened masked squared norms
    qcnt: torch.Tensor     # (C,) quarantined-packet counts
    pk_ok: torch.Tensor    # (C, P) per-packet finite bits
    s_clip: torch.Tensor   # (C,) norm-clip factors
    kept: Optional[torch.Tensor]   # (C,) screened kept fraction


def robust_prepass(xp, pkt_mask, weights, *, mode: str, d_up: int,
                   screen, clip_norm, trim_gate, trim_k: int = 0,
                   ef_rows=None, sufficient=None, loss_rate=None,
                   mult=None) -> RobustPrepass:
    """The torch prepass of ``robust_uplink_round`` (same operands): the
    finite bits, the screened mask and norms, the clip factor, the kept
    fraction and the quarantine counts, and from them the operands of
    one ``robust_agg_op`` call."""
    if mode not in DEBIAS_MODES:
        raise ValueError(f"unknown debias mode {mode!r}")
    C, P, F_ = xp.shape
    dev = xp.device
    screen, clip_norm, trim_gate = (_f32(v, dev) for v in
                                    (screen, clip_norm, trim_gate))
    ef = ef_rows is not None
    x32 = xp.float()
    ef_p = _pack_rows(ef_rows, P, F_).float() if ef else None
    x_eff = x32 + ef_p if ef else x32
    fin = torch.isfinite(x_eff)
    pk_ok = fin.all(-1).float()                         # (C, P)
    scr = screen > 0.5
    x_san = torch.where(scr & ~fin, 0.0, x_eff)
    m = pkt_mask.float()
    m_eff = torch.where(scr, m * pk_ok, m)
    # quarantine counts: delivered-but-bad packets, whatever the screen
    # gate (the counts observe faults even when undefended)
    qcnt = (m * (1.0 - pk_ok)).sum(-1)
    # screened masked squared norms (q-FedAvg's h_k and the clip)
    ssq = ((x_san * x_san).sum(-1) * m_eff).sum(-1)
    cn2 = clip_norm * clip_norm
    s_clip = torch.where(
        ssq > cn2, clip_norm / torch.sqrt(torch.clamp(ssq, min=DENOM_EPS)),
        1.0)
    kept = None
    if mode == "per_client_rate":
        pad = P * F_ - d_up
        pcnt = torch.full((P,), float(F_), device=dev)
        pcnt[-1] = F_ - pad
        kept = (m_eff @ pcnt) / d_up
    q_c = debias_client_scale(weights, mode=mode, kept=kept,
                              sufficient=sufficient, loss_rate=loss_rate,
                              mult=mult)
    q_full = q_c * s_clip
    per_coord = mode == "per_coord_count"
    w_or_den = weights if per_coord \
        else torch.clamp(weights.sum(), min=DENOM_EPS)
    g = w_pos = None
    if trim_k > 0:
        # per-client estimate scale: the debias without the data weights
        # (the trimmed mean is unweighted), with the clip applied
        g = debias_client_scale(
            torch.ones((C,), device=dev), mode=mode, kept=kept,
            sufficient=sufficient, loss_rate=loss_rate, mult=mult) * s_clip
        w_pos = (weights > 0.0).float()
    args = (x32.contiguous(), m.contiguous(), q_full.float().contiguous(),
            w_or_den.float().contiguous(), screen, trim_gate,
            None if ef_p is None else ef_p.contiguous(),
            None if g is None else g.float().contiguous(),
            None if w_pos is None else w_pos.contiguous())
    return RobustPrepass(args, trim_k, per_coord, ssq, qcnt, pk_ok, s_clip,
                         kept)


def robust_uplink_round(xp, pkt_mask, weights, *, mode: str, d_up: int,
                        screen, clip_norm, trim_gate, trim_k: int = 0,
                        ef_rows=None, sufficient=None, loss_rate=None,
                        mult=None, want_ssq: bool = False
                        ) -> RobustUplinkOut:
    """One defended uplink step over a packetised cohort.

    The operands of ``uplink_fused.ops.uplink_round``: xp (C, P, F)
    unmasked uploads after fault injection, pkt_mask (C, P), weights
    (C,) (they enter the denominator); plus the defense knobs:
    ``screen`` () gate, ``clip_norm`` () threshold (``faults.CLIP_OFF``
    = off), ``trim_gate`` () gate and the static ``trim_k``. ``kept`` is
    computed here from the screened mask (quarantined packets debias
    like lost ones).

    The trimmed mean is an unweighted robust location estimate of the
    per-client debiased updates: the weights only gate validity
    (weight > 0), so a byzantine client must out-vote the cohort, not
    out-weigh it.
    """
    pre = robust_prepass(xp, pkt_mask, weights, mode=mode, d_up=d_up,
                         screen=screen, clip_norm=clip_norm,
                         trim_gate=trim_gate, trim_k=trim_k,
                         ef_rows=ef_rows, sufficient=sufficient,
                         loss_rate=loss_rate, mult=mult)
    # the main pass: aggregate and EF tiles (the kernel on the card)
    agg, ef_out = robust_agg_op(*pre.args, trim_k, pre.per_coord)
    C, P, F_ = xp.shape
    new_ef_rows = ef_out.reshape(C, P * F_)[:, :d_up] \
        if ef_rows is not None else None
    return RobustUplinkOut(
        agg=agg.reshape(-1)[:d_up], ef_rows=new_ef_rows,
        ssq=pre.ssq if want_ssq else None, qcnt=pre.qcnt, pk_ok=pre.pk_ok,
        s_clip=pre.s_clip, kept=pre.kept)
