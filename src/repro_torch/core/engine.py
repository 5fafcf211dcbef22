"""Round engine: one federated round as a step over device tensors.

Everything a round needs lives on the engine's device for the whole
run: the staged training data, the eligibility and sufficiency masks,
the PRNG root and the per-client state (error-feedback memory, AFL
weights, the network simulator's channel states and bandwidth levels).
One round is:

  * PRNG         — one uniform block from ``fold_in(base_key, t)``,
                   keyed on the absolute round index: N selection draws,
                   then C·steps·bs batch draws, then C·P TRA draws, and
                   under the Gilbert–Elliott channel C·P emission draws
                   (the reference's layout, bit for bit),
  * selection    — uniform Gumbel-top-k over the eligibility mask,
  * local train  — FedAvg / q-FedAvg SGD, ``torch.func.vmap``ped over
                   the cohort,
  * faults       — with ``faults.enabled``, client faults (echo
                   replay, sign flip, NaN failure) on the trained
                   uploads, from ``fold_in(round key, FAULT_FOLD)``,
  * loss channel — the i.i.d. packet-loss mask, or the Gilbert–Elliott
                   chain of each cohort client (``kernels/netsim_mask``,
                   the CUDA kernel on the card), with the sufficiency
                   override; then the AR(1) bandwidth step for all N
                   clients and the sync deadline drop; with faults on,
                   packet faults (corruption, bit flips) on what is
                   delivered,
  * TRA uplink   — ONE ``uplink_round`` call: EF re-inject, debias
                   aggregate, new EF rows and the q-FedAvg norms (the
                   CUDA megakernel on the card); with faults on, ONE
                   ``robust_uplink_round`` call instead: the finite
                   screen, norm clip and trimmed mean as gates (the
                   robust-aggregation kernel on the card),
  * server step  — FedAvg's weighted mean or q-FedAvg's h-normalised
                   step.

Scenario-varying inputs ride a ``ScenarioCtx`` argument, never the
step's closure, so ``core/sweep.py`` can stack S scenarios behind a
leading axis and ``torch.func.vmap`` the same step over them: the
kernels batch through their ops' vmap rules. Static structure
(algorithm, debias mode, cohort size, local steps, batch size, TRA
on/off, error feedback, the netsim model selection, ``faults.enabled``
and ``defense.trim_k``) stays in the closure and must be shared across
a sweep.

This slice ports the reference's round with: fedavg and qfedavg,
uniform selection, the sync server, the iid and Gilbert–Elliott
channels, the AR(1) bandwidth walk, the deadline, and the fault model
with its defenses. No telemetry, one-shot recovery, no downlink model,
no reputation memory. ``run_block`` is a
Python loop over the same step ``run_single`` runs, so the block and
per-round paths agree by construction.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import client_updates as cu
from repro_torch.core.selection import select_from_uniforms
from repro_torch.core.tra import flatten_clients, unflatten_like
from repro_torch.data.synthetic import DeviceDataset, stage_on_device
from repro_torch.kernels.netsim_mask import ops as netsim_ops
from repro_torch.kernels.robust_agg import ops as robust_ops
from repro_torch.kernels.uplink_fused import ops as uplink_ops
from repro_torch.netsim.bandwidth import logbw_round_step
from repro_torch.netsim.channel import ge_transition_probs
from repro_torch.netsim import faults as faults_mod
from repro_torch.netsim.delivery import (deadline_delivered,
                                         round_upload_seconds)
from repro_torch.netsim.state import NetSimState, init_net_state
from repro_torch.network.packets import n_packets

ENGINE_ALGOS = ("fedavg", "qfedavg")


class EngineState(NamedTuple):
    """Per-run state threaded through the rounds."""
    params: Dict[str, torch.Tensor]   # model parameters, leaf order
    ef_mem: torch.Tensor   # (N, D) error-feedback memory, or (0,)
    lam: torch.Tensor      # (N,) AFL mixture weights (always allocated)
    net: NetSimState       # channel states + log-bandwidth levels
    # fault-model carries; (0,) when faults.enabled is False:
    # the last genuine upload of each client, what an echo replays
    echo_mem: torch.Tensor  # (N, D) f32, or (0,)
    # the reputation memory of the reputation_aware selection policy,
    # which is not ported: always (0,)
    rep_mem: torch.Tensor   # (0,)


class ScenarioCtx(NamedTuple):
    """The scenario's inputs to every round, on the engine's device.
    Under the sweep engine every field gains a leading scenario axis
    (the dataset only when the scenarios' datasets differ)."""
    base_key: torch.Tensor   # (2,) PRNG root of the fold_in chain
    loss_rate: torch.Tensor  # () f32 nominal drop rate, or (N,) per client
    eligible: torch.Tensor   # (N,) bool selection mask
    sufficient: torch.Tensor  # (N,) f32 1-bit sufficiency reports
    data: DeviceDataset      # staged train set
    # netsim knobs (read only when their model is on)
    burst_len: torch.Tensor  # () f32 E[bad sojourn] in packets (GE)
    good_loss: torch.Tensor  # () f32 GOOD-state per-packet loss (GE)
    bad_loss: torch.Tensor   # () f32 BAD-state per-packet loss (GE)
    bw_rho: torch.Tensor     # () f32 AR(1) round-to-round correlation
    deadline_s: torch.Tensor  # () f32 per-round upload deadline
    # fault rates and defense gates (read only when faults.enabled)
    f_corrupt: torch.Tensor  # () f32 P(packet Gaussian-corrupted)
    f_cscale: torch.Tensor   # () f32 corruption noise stddev
    f_bitflip: torch.Tensor  # () f32 P(packet single-bit flip)
    f_fail: torch.Tensor     # () f32 P(client NaN device failure)
    f_flip: torch.Tensor     # () f32 P(client sign-flip byzantine)
    f_echo: torch.Tensor     # () f32 P(client stale-echo replay)
    d_screen: torch.Tensor   # () f32 gate: finite-screen quarantine
    d_clip: torch.Tensor     # () f32 clip norm (faults.CLIP_OFF = off)
    d_trim: torch.Tensor     # () f32 gate: trimmed-mean aggregation


# the ScenarioCtx fields that come from NetSimConfig fields of one name
CTX_NETSIM_FIELDS = ("burst_len", "good_loss", "bad_loss", "bw_rho",
                     "deadline_s")
# the ScenarioCtx fields of the fault model, from ``fault_knobs``
CTX_FAULT_FIELDS = ("f_corrupt", "f_cscale", "f_bitflip", "f_fail",
                    "f_flip", "f_echo", "d_screen", "d_clip", "d_trim")


def fault_knobs(flt, dfn) -> Dict[str, float]:
    """The CTX_FAULT_FIELDS values of one scenario's fault and defense
    configs: the rates as they are, the gates as 1.0 / 0.0 and the clip
    as ``faults.clip_knob``."""
    return {"f_corrupt": flt.corrupt_rate, "f_cscale": flt.corrupt_scale,
            "f_bitflip": flt.bitflip_rate, "f_fail": flt.fail_rate,
            "f_flip": flt.flip_rate, "f_echo": flt.echo_rate,
            "d_screen": 1.0 if dfn.screen else 0.0,
            "d_clip": faults_mod.clip_knob(dfn),
            "d_trim": 1.0 if dfn.trim else 0.0}

# FLConfig fields a scenario may vary without changing the step's
# structure; everything else must agree across a sweep.
SWEEP_VARYING_FIELDS = ("seed", "selection", "eligible_ratio")
SWEEP_VARYING_TRA_FIELDS = ("loss_rate", "threshold_mbps")
SWEEP_VARYING_NETSIM_FIELDS = ("burst_len", "good_loss", "bad_loss",
                               "bw_rho", "deadline_s", "down_loss",
                               "down_deadline_s")
SWEEP_VARYING_SEL_FIELDS = ("threshold_mbps", "temperature", "explore")


def static_signature(cfg):
    """The config with its scenario knobs normalised away. Two configs
    build the same round step, and may share a sweep, iff their
    signatures are equal."""
    tra = dataclasses.replace(
        cfg.tra, **{f: 0.0 for f in SWEEP_VARYING_TRA_FIELDS})
    ns = dataclasses.replace(
        cfg.netsim, **{f: 0.0 for f in SWEEP_VARYING_NETSIM_FIELDS})
    sel = dataclasses.replace(
        cfg.sel, **{f: 0.0 for f in SWEEP_VARYING_SEL_FIELDS})
    flt = dataclasses.replace(
        cfg.faults,
        **{f: 0.0 for f in faults_mod.SWEEP_VARYING_FAULT_FIELDS})
    dfn = dataclasses.replace(cfg.defense, **faults_mod.DEF_NEUTRAL)
    return dataclasses.replace(cfg, tra=tra, netsim=ns, sel=sel,
                               faults=flt, defense=dfn, seed=0,
                               selection="all", eligible_ratio=1.0)


def _static_key(cfg):
    """Hashable key of the step's structure: the signature with the
    round and evaluation schedule normalised away too (they drive the
    block loop, never the step)."""
    return dataclasses.astuple(dataclasses.replace(
        static_signature(cfg), n_rounds=0, eval_every=0, engine="scan"))


def validate_round_config(cfg) -> None:
    """Raise for configurations the reference refuses and for those
    this slice has not ported."""
    if cfg.algo not in ENGINE_ALGOS:
        raise NotImplementedError(
            f"algo {cfg.algo!r} is not ported to repro_torch yet "
            f"(ported: {ENGINE_ALGOS})")
    if cfg.sel.traced or cfg.sel.policy != "uniform":
        raise NotImplementedError(
            "only the uniform selection policy is ported to repro_torch")
    ns = cfg.netsim
    if ns.down_channel != "off":
        raise NotImplementedError(
            f"netsim down_channel={ns.down_channel!r}: the downlink model "
            f"is not ported to repro_torch yet")
    if ns.channel != "iid" and not cfg.tra.enabled:
        raise ValueError(
            f"netsim channel={ns.channel!r} models lossy TRA uploads "
            f"and requires tra.enabled=True (with TRA off, uploads are "
            f"reliable and the channel would be silently inert)")
    dfn = cfg.defense
    if not cfg.faults.enabled and (dfn.screen or dfn.clip or dfn.trim
                                   or dfn.trim_k > 0):
        raise ValueError(
            "defenses (screen/clip/trim/trim_k) require "
            "faults.enabled=True: the robust uplink is only built with "
            "the fault model (enable it with zero rates for a fault-free "
            "defended run)")
    if dfn.trim and dfn.trim_k < 1:
        raise ValueError(
            "defense.trim=True needs trim_k >= 1 (the static per-side "
            "trim count)")
    if dfn.trim_k > 0 and cfg.tra.debias == "per_coord_count":
        raise ValueError(
            "trimmed-mean aggregation replaces the weighted mean and "
            "cannot compose with per_coord_count's per-coordinate "
            "denominators (use another debias mode, or trim_k=0)")


def init_engine_state(cfg, params, n_clients: int, *, base_key=None,
                      loss_rate=None, upload_mbps=None,
                      netsim=None) -> EngineState:
    """Fresh state for one scenario (the sweep stacks S of them).
    ``params`` are copied, so the caller's tensors stay untouched. The
    netsim carry starts from the scenario's PRNG root, loss rate and
    static speed draw; the defaults rebuild them from ``cfg``."""
    params = {k: v.detach().clone() for k, v in params.items()}
    dev = next(iter(params.values())).device
    D = sum(v.numel() for v in params.values())
    if base_key is None:
        base_key = prng.PRNGKey(cfg.seed, device=dev)
    if loss_rate is None:
        loss_rate = torch.tensor(cfg.tra.loss_rate, dtype=torch.float32,
                                 device=dev)
    return EngineState(
        params=params,
        ef_mem=torch.zeros((n_clients, D), device=dev)
        if cfg.error_feedback else torch.zeros((0,), device=dev),
        lam=torch.ones((n_clients,), device=dev) / n_clients,
        net=init_net_state(cfg.netsim if netsim is None else netsim,
                           n_clients, device=dev, base_key=base_key,
                           loss_rate=loss_rate, upload_mbps=upload_mbps),
        echo_mem=torch.zeros((n_clients, D), device=dev)
        if cfg.faults.enabled else torch.zeros((0,), device=dev),
        rep_mem=torch.zeros((0,), device=dev))


def make_round_step(cfg, cohort: int):
    """Build ``step(ctx, state, t) -> (state, logs)`` for one round.
    N, the padded set length and the model size come from the tensors'
    shapes, so the same step serves any same-shaped scenario, and the
    sweep vmaps it as it is."""
    validate_round_config(cfg)
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

    def step(ctx: ScenarioCtx, state: EngineState, t: int):
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
        return EngineState(new_params, new_ef, state.lam, net, echo_new,
                           state.rep_mem), logs

    return step


class RoundScanEngine:
    """Round executor for one (config, dataset, network) scenario.

    Callers own the ``EngineState`` and thread it through
    ``run_single`` / ``run_block``; use the returned state.
    """

    def __init__(self, cfg, data, sufficient: np.ndarray,
                 eligible: np.ndarray, *,
                 upload_mbps: Optional[np.ndarray] = None,
                 packet_loss: Optional[np.ndarray] = None, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dd = stage_on_device(data, self.device)
        self.n_clients = int(self.dd.counts.shape[0])
        eligible = np.asarray(eligible, bool)
        n_eligible = int(eligible.sum())
        if n_eligible == 0:
            raise ValueError("no eligible clients")
        self.cohort = min(cfg.clients_per_round, n_eligible)
        if cfg.tra.per_client_loss:
            if packet_loss is None:
                raise ValueError("tra.per_client_loss needs the trace "
                                 "draw (pass nets.packet_loss)")
            loss_rate = np.asarray(packet_loss, np.float32)
        else:
            loss_rate = np.float32(cfg.tra.loss_rate)
        if (cfg.netsim.bw_ar1 or cfg.netsim.deadline) \
                and upload_mbps is None:
            raise ValueError("netsim bandwidth/deadline models need "
                             "the trace draw (pass nets.upload_mbps)")
        self._upload_mbps = None if upload_mbps is None \
            else np.asarray(upload_mbps, np.float32)
        dev = self.device
        self._step = make_round_step(cfg, self.cohort)   # validates cfg
        self.ctx = ScenarioCtx(
            base_key=prng.PRNGKey(cfg.seed, device=dev),
            loss_rate=torch.tensor(loss_rate, device=dev),
            eligible=torch.tensor(eligible, device=dev),
            sufficient=torch.tensor(np.asarray(sufficient, np.float32),
                                    device=dev),
            data=self.dd,
            **{f: torch.tensor(getattr(cfg.netsim, f), dtype=torch.float32,
                               device=dev) for f in CTX_NETSIM_FIELDS},
            **{f: torch.tensor(v, dtype=torch.float32, device=dev)
               for f, v in fault_knobs(cfg.faults, cfg.defense).items()})

    def init_state(self, params) -> EngineState:
        return init_engine_state(self.cfg, params, self.n_clients,
                                 base_key=self.ctx.base_key,
                                 loss_rate=self.ctx.loss_rate,
                                 upload_mbps=self._upload_mbps)

    def run_single(self, state: EngineState, t: int
                   ) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
        """One round at absolute index ``t``."""
        return self._step(self.ctx, state, t)

    def run_block(self, state: EngineState, t0: int, k: int
                  ) -> Tuple[EngineState, Dict[str, np.ndarray]]:
        """Rounds [t0, t0+k); logs come to the host once, at the end.
        Returns (state, {"loss": (k,), "ids": (k, C)[, "quarantine":
        (k, C)][, "arrival": (k, C)]})."""
        logs = []
        for t in range(t0, t0 + k):
            state, lg = self._step(self.ctx, state, t)
            logs.append(lg)
        return state, {name: torch.stack([lg[name] for lg in logs])
                       .cpu().numpy() for name in logs[0]}
