"""The port's round step as it stood before the downlink, recovery and
loss-budget subsystems came in, frozen for the defaults lock in
``tests/test_torch_recovery.py``: with the downlink off, one_shot
recovery and the controller off, today's step must compute exactly this.

Only the state type is local (the six carries of that step); the step
reads the scenario context by field name, so today's ``ScenarioCtx``
serves it unchanged.
"""
from typing import Dict, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import client_updates as cu
from repro_torch.core.selection import select_from_uniforms
from repro_torch.core.tra import flatten_clients, unflatten_like
from repro_torch.kernels.robust_agg import ops as robust_ops
from repro_torch.kernels.netsim_mask import ops as netsim_ops
from repro_torch.kernels.uplink_fused import ops as uplink_ops
from repro_torch.netsim import faults as faults_mod
from repro_torch.netsim.bandwidth import logbw_round_step
from repro_torch.netsim.channel import ge_transition_probs
from repro_torch.netsim.delivery import (deadline_delivered,
                                         round_upload_seconds)
from repro_torch.netsim.state import NetSimState
from repro_torch.network.packets import n_packets


class LegacyState(NamedTuple):
    params: Dict[str, torch.Tensor]
    ef_mem: torch.Tensor
    lam: torch.Tensor
    net: NetSimState
    echo_mem: torch.Tensor
    rep_mem: torch.Tensor


def make_legacy_round_step(cfg, cohort: int):
    """Build ``step(ctx, state, t) -> (state, logs)`` for one round.
    N, the padded set length and the model size come from the tensors'
    shapes, so the same step serves any same-shaped scenario, and the
    sweep vmaps it as it is."""
    tra_cfg = cfg.tra
    hyper = cfg.hyper()
    algo = cfg.algo
    ef = cfg.error_feedback
    C = cohort
    steps, bs = cfg.local_steps, cfg.batch_size
    Fp = tra_cfg.packet_floats
    debias = tra_cfg.debias
    local = cu.LOCAL_FNS[algo]
    train = torch.func.vmap(lambda p, x, y: local(p, x, y, hyper),
                            in_dims=(None, 0, 0))
    ns = cfg.netsim
    use_ge = ns.channel == "gilbert_elliott"
    use_bw = ns.bw_ar1
    use_dl = ns.deadline
    # the fault model: faults.enabled is its one static switch, and
    # defense.trim_k (the trimmed mean's extent) is static too
    use_faults = cfg.faults.enabled
    trim_k = cfg.defense.trim_k

    def step(ctx, state: LegacyState, t: int):
        dd = ctx.data
        N = dd.counts.shape[0]
        params = state.params
        old_vec = flatten_clients(params, 1)[0]
        D_up = old_vec.shape[0]
        P = n_packets(D_up, Fp)
        n_batch = C * steps * bs
        # the GE channel's emission draws are a second (C, P) block
        # after the transition draws
        n_tra = 2 * C * P if use_ge else C * P
        # one threefry invocation covers the whole round
        key = prng.fold_in(ctx.base_key, t)
        u_all = prng.uniform(key, (N + n_batch + n_tra,),
                             minval=1e-12, maxval=1.0)
        u_sel = u_all[:N]
        u_idx = u_all[N:N + n_batch].reshape(C, steps, bs)
        u_tra = u_all[N + n_batch:N + n_batch + C * P].reshape(C, P)

        ids = select_from_uniforms(u_sel, None, ctx.eligible, C)
        counts = dd.counts[ids]                              # (C,)
        c3 = counts[:, None, None]
        idx = torch.minimum((u_idx * c3).to(torch.int32), c3 - 1)
        # direct (client, sample) gather: never materialises the
        # cohort's full padded datasets
        cid = ids[:, None, None]
        X = dd.train_x[cid, idx]                     # (C, steps, bs, d)
        Y = dd.train_y[cid, idx]                     # (C, steps, bs)
        w = counts.float()
        weights = w / w.sum()
        suff = ctx.sufficient[ids]

        uploads, aux = train(params, X, Y)
        flat = flatten_clients(uploads, C)                   # (C, D)

        # client faults: what the cohort actually uploads. Their own fold
        # of the round key leaves the round's draws untouched; zero rates
        # pass ``flat`` through bitwise.
        flat_clean = flat
        if use_faults:
            fkey = prng.fold_in(key, faults_mod.FAULT_FOLD)
            flat = faults_mod.inject_client_faults(
                fkey, flat, state.echo_mem[ids], fail_rate=ctx.f_fail,
                flip_rate=ctx.f_flip, echo_rate=ctx.f_echo)

        pad = P * Fp - D_up
        xp = F.pad(flat, (0, pad)).reshape(C, P, Fp)
        lr_c = ctx.loss_rate if ctx.loss_rate.dim() == 0 \
            else ctx.loss_rate[ids]
        lr_col = lr_c if lr_c.dim() == 0 else lr_c[:, None]
        net_channel, net_logbw = state.net.channel, state.net.logbw
        if use_ge:
            # bursty loss: each cohort client's channel walks P packet
            # steps and its final state goes back into the carry.
            # Sufficient clients retransmit (all-ones mask), but their
            # channel still advances.
            u_emit = u_all[N + n_batch + C * P:].reshape(C, P)
            p_gb, p_bg = ge_transition_probs(
                lr_c, ctx.burst_len, ctx.good_loss, ctx.bad_loss)
            ge_mask, s_fin = netsim_ops.ge_packet_mask(
                u_tra, u_emit, net_channel[ids], p_gb, p_bg,
                ctx.good_loss, ctx.bad_loss)
            net_channel = net_channel.index_copy(0, ids, s_fin)
            pkt_mask = torch.where(suff.bool()[:, None], 1.0, ge_mask)
        elif tra_cfg.enabled:
            lost = (u_tra < lr_col) & ~suff.bool()[:, None]
            pkt_mask = 1.0 - lost.float()
        else:
            pkt_mask = torch.ones((C, P), device=xp.device)

        if use_bw:
            # time passes for every client: one AR(1) step on all N
            net_logbw = logbw_round_step(key, net_logbw, ctx.bw_rho)
        arrival = None
        if use_dl:
            # sync deadline: retransmitters push ~P/(1-r) packets, TRA
            # one-shots push P; a miss drops the whole upload, while its
            # weight stays in the denominator
            retransmit = suff.bool() if tra_cfg.enabled \
                else torch.ones((C,), dtype=torch.bool, device=xp.device)
            secs = round_upload_seconds(P, Fp, torch.exp(net_logbw[ids]),
                                        lr_c, retransmit)
            delivered = deadline_delivered(secs, ctx.deadline_s)
            pkt_mask = pkt_mask * delivered[:, None]
            arrival = delivered

        # packet faults: damage in flight to the packets the channel and
        # the deadline deliver (a lost packet never reaches the server,
        # so EF recycling stays clean). Zero rates pass ``xp`` through.
        if use_faults:
            xp = faults_mod.inject_packet_faults(
                fkey, xp, pkt_mask, corrupt_rate=ctx.f_corrupt,
                corrupt_scale=ctx.f_cscale, bitflip_rate=ctx.f_bitflip)

        kept = None
        if debias == "per_client_rate" and not use_faults:
            # coordinate-weighted kept fraction (last packet partial); the
            # fault path computes it from the screened mask instead
            pcnt = torch.full((P,), float(Fp), device=xp.device)
            pcnt[-1] = Fp - pad
            kept = (pkt_mask @ pcnt) / D_up

        if algo == "qfedavg":
            eps = 1e-10
            fq = torch.pow(aux["loss0"] + eps, cfg.q)
            w_agg = torch.ones(C, device=xp.device)
            mult, want_ssq = fq, True
        else:
            w_agg, mult, want_ssq = weights, None, False

        if use_faults:
            # defended uplink: finite-screen quarantine (bad packets as if
            # lost), norm clip, trimmed mean; off gates are bitwise the
            # undefended expressions
            rob = robust_ops.robust_uplink_round(
                xp, pkt_mask, w_agg, mode=debias, d_up=D_up,
                screen=ctx.d_screen, clip_norm=ctx.d_clip,
                trim_gate=ctx.d_trim, trim_k=trim_k,
                ef_rows=state.ef_mem[ids] if ef else None,
                sufficient=suff, loss_rate=lr_c, mult=mult,
                want_ssq=want_ssq)
            agg, new_ef_rows, ssq = rob.agg, rob.ef_rows, rob.ssq
        else:
            agg, new_ef_rows, ssq = uplink_ops.uplink_round(
                xp, pkt_mask, w_agg, mode=debias, d_up=D_up,
                ef_rows=state.ef_mem[ids] if ef else None, kept=kept,
                sufficient=suff, loss_rate=lr_c, mult=mult,
                want_ssq=want_ssq)
        new_ef = state.ef_mem.index_copy(0, ids, new_ef_rows) if ef \
            else state.ef_mem

        if algo == "qfedavg":
            # delta_k = F_k^q dw_k;  h_k = q F^(q-1)||dw||^2 + L F^q
            h = cfg.q * torch.pow(aux["loss0"] + eps, cfg.q - 1) * ssq \
                + cfg.lipschitz * fq
            # debiased SUM of deltas = debiased mean * C
            new_vec = old_vec - agg * C / torch.clamp(h.sum(), min=1e-8)
        else:  # fedavg: weighted mean of the uploaded models
            new_vec = agg
        new_params = unflatten_like(new_vec, params)
        # the echo memory records what each client genuinely computed
        echo_new = state.echo_mem.index_copy(0, ids, flat_clean) \
            if use_faults else state.echo_mem
        logs = {"loss": aux["loss0"].mean(), "ids": ids}
        if use_faults:
            # per-cohort-slot quarantined-packet counts
            logs["quarantine"] = rob.qcnt
        if use_dl:
            # per-cohort-slot arrival: 1 landed on time, 0 dropped
            logs["arrival"] = arrival
        net = NetSimState(net_channel, net_logbw, state.net.down)
        return LegacyState(new_params, new_ef, state.lam, net, echo_new,
                           state.rep_mem), logs

    return step
