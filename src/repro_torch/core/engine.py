"""Round engine: one federated round as a step over device tensors.

Everything a round needs lives on the engine's device for the whole
run: the staged training data, the eligibility and sufficiency masks,
the PRNG root and the per-client state (error-feedback memory, AFL
weights, the network simulator's channel states and bandwidth levels).
One round is:

  * PRNG         — one uniform block from ``fold_in(base_key, t)``,
                   keyed on the absolute round index: N selection draws,
                   then C·steps·bs batch draws, then C·P TRA draws, and
                   under the Gilbert–Elliott channel C·P emission draws,
                   with recovery built in C·P ARQ and C·Gn parity draws,
                   and with the downlink on C·P (i.i.d.) or 2·C·P (GE)
                   broadcast draws (the reference's layout, bit for bit),
  * selection    — weighted Gumbel-top-k over the eligibility mask
                   (``core/selection.py``): uniform, or scored by one
                   policy, or with ``sel.traced`` by the scenario's
                   policy one-hot; the scores read the carries before
                   this round's training,
  * downlink     — with ``down_channel`` on, the broadcast loses packets
                   (i.i.d., or each client's second Gilbert–Elliott
                   chain through ``kernels/netsim_mask``) and each
                   client fills the holes from its last-received model
                   (``stale_model``) or with zeros,
  * local train  — the algorithm's client (FedAvg, q-FedAvg, AFL,
                   pFedMe, Per-FedAvg or SCAFFOLD), ``torch.func.vmap``ped
                   over the cohort, from the shared model or, under
                   downlink loss, from each client's own effective model;
                   SCAFFOLD uploads ``dw ++ dc``, 2·D floats,
  * faults       — with ``faults.enabled``, client faults (echo
                   replay, sign flip, NaN failure) on the trained
                   uploads, from ``fold_in(round key, FAULT_FOLD)``,
  * loss channel — the i.i.d. packet-loss mask, or the Gilbert–Elliott
                   chain of each cohort client (``kernels/netsim_mask``,
                   the CUDA kernel on the card); with recovery built in,
                   the one_shot / FEC (``kernels/fec_recover``, the CUDA
                   kernel on the card) / ARQ masks mixed by the policy
                   one-hot or the loss-budget controller's per-client
                   level; then the sufficiency override, the AR(1)
                   bandwidth step for all N
                   clients and the deadline: under the sync server a miss
                   drops the whole upload, under semi_sync an upload
                   landing in the grace window counts this round,
                   staleness-discounted, and under async a late upload
                   waits in the arrival buffer (``core/async_agg.py``),
                   with the mode traced as a one-hot when ``srv.traced``;
                   with faults on, packet faults (corruption, bit flips)
                   on what is delivered,
  * TRA uplink   — ONE ``uplink_round`` call: EF re-inject, debias
                   aggregate, new EF rows and the q-FedAvg norms (the
                   CUDA megakernel on the card); with faults on, ONE
                   ``robust_uplink_round`` call instead: the finite
                   screen, norm clip and trimmed mean as gates (the
                   robust-aggregation kernel on the card); the non-sync
                   modes fold the arrival weights into the aggregation
                   weights, and async pops the buffer's due entries into
                   the aggregate and pushes this round's late uploads,
  * server step  — the weighted mean (FedAvg, Per-FedAvg, and AFL with
                   its mixture weights), pFedMe's beta mix, q-FedAvg's
                   h-normalised step or SCAFFOLD's model and control-
                   variate steps; AFL's weights ascend on the new model's
                   losses; then the stale-model and controller carries
                   and the selection scores' memories (norms, losses,
                   lateness, reputation) at the cohort.

Scenario-varying inputs ride a ``ScenarioCtx`` argument, never the
step's closure, so ``core/sweep.py`` can stack S scenarios behind a
leading axis and ``torch.func.vmap`` the same step over them: the
kernels batch through their ops' vmap rules. Static structure
(algorithm, debias mode, cohort size, local steps, batch size, TRA
on/off, error feedback, the netsim model selection, ``faults.enabled``,
``defense.trim_k``, the selection policy unless traced, the recovery
policy unless traced, the FEC group, ``lossbudget.enabled``, the server
mode unless traced, ``srv.buffer_k`` and the telemetry level) stays in
the closure and must be shared across a sweep.

This port runs the reference's round with: all six algorithms, all
eight selection policies (static or traced), the three server modes
(static or traced), the iid and Gilbert–Elliott channels, the AR(1)
bandwidth walk, the deadline, the fault model with its defenses, the
downlink model, the recovery policies and the loss-budget controller.
With ``cfg.telemetry`` at "scalars" or "full" the step also logs the
reference's ``"tele/..."`` keys and, at "full", carries the per-client
aggregates (``core/telemetry.py``); at "off" it runs not one op for them.
With uniform selection, the sync server, the downlink off, one_shot
recovery, the controller off and telemetry off, the step is the one of
the earlier slices, bit for bit. ``run_block`` is a Python loop over the
same step ``run_single`` runs, so the block and per-round paths agree by
construction.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import async_agg as async_mod
from repro_torch.core import client_updates as cu
from repro_torch.core import lossbudget as bud_mod
from repro_torch.core.mlp import mlp_weighted_loss
from repro_torch.core import selection as sel_mod
from repro_torch.core import telemetry as tele_mod
from repro_torch.core.async_agg import ArrivalBuffer
from repro_torch.core.telemetry import TelemetryState
from repro_torch.core.tra import flatten_clients, unflatten_like
from repro_torch.data.synthetic import DeviceDataset, stage_on_device
from repro_torch.kernels.common import DENOM_EPS
from repro_torch.kernels.fec_recover import ops as fec_ops
from repro_torch.kernels.netsim_mask import ops as netsim_ops
from repro_torch.kernels.robust_agg import ops as robust_ops
from repro_torch.kernels.robust_agg import robust_agg
from repro_torch.kernels.uplink_fused import ops as uplink_ops
from repro_torch.netsim.bandwidth import logbw_round_step
from repro_torch.netsim.channel import ge_transition_probs
from repro_torch.netsim import faults as faults_mod
from repro_torch.netsim import recovery as rec_mod
from repro_torch.netsim.delivery import (MAX_LATENESS, arrival_lateness,
                                         deadline_delivered,
                                         grace_staleness,
                                         round_upload_seconds)
from repro_torch.netsim.state import NetSimState, init_net_state
from repro_torch.network.packets import n_packets
from repro_torch.network.trace import log_upload_speeds

ENGINE_ALGOS = ("fedavg", "qfedavg", "pfedme", "perfedavg", "afl",
                "scaffold")


class EngineState(NamedTuple):
    """Per-run state threaded through the rounds."""
    params: Dict[str, torch.Tensor]   # model parameters, leaf order
    ef_mem: torch.Tensor   # (N, D_up) error-feedback memory, or (0,)
    lam: torch.Tensor      # (N,) AFL mixture weights (always allocated)
    net: NetSimState       # channel states + log-bandwidth levels
    # fault-model carries; (0,) when faults.enabled is False:
    # the last genuine upload of each client, what an echo replays
    echo_mem: torch.Tensor  # (N, D_up) f32, or (0,)
    # the cumulative quarantined-packet fraction of each client, which
    # the reputation_aware selection policy reads; (0,) unless faults
    # are on and that policy (or traced selection) needs it
    rep_mem: torch.Tensor   # (N,) f32, or (0,)
    # each client's last-received model, the stale fallback under
    # downlink loss; (0,) unless the downlink is on with the stale fallback
    stale_model: torch.Tensor  # (N, D) f32, or (0,)
    # the loss-budget controller's carries (core/lossbudget.py): each
    # client's recovery level (0 one_shot, 1 fec, 2 arq) and its
    # realized-loss EMA; (0,) unless lossbudget.enabled
    bud_level: torch.Tensor    # (N,) f32, or (0,)
    bud_loss: torch.Tensor     # (N,) f32, or (0,)
    # SCAFFOLD's control variates, (0,) for the other algorithms (last,
    # so that the carries of the earlier steps keep their positions)
    c_global: torch.Tensor     # (D,) the server variate, or (0,)
    c_i: torch.Tensor          # (N, D) the client variates, or (0,)
    # the selection scores' memories (core/selection.py), scattered at
    # the cohort each round and read by the next round's selection: the
    # last masked squared update norm (gradient_norm), the last train
    # loss (loss_aware) and the last rounds late against the deadline
    # (staleness_aware); (0,) unless the policy, or traced selection,
    # needs them
    gnorm_mem: torch.Tensor    # (N,) f32, or (0,)
    loss_mem: torch.Tensor     # (N,) f32, or (0,)
    stale_mem: torch.Tensor    # (N,) f32, or (0,)
    # the async server's K-slot in-flight upload buffer
    # (core/async_agg.py): late uploads ride the rounds sorted by their
    # arrival round and join the round they land in, staleness-
    # discounted; zero-size unless srv.mode is async or srv.traced
    buf: ArrivalBuffer
    # the telemetry's cumulative per-client aggregates
    # (core/telemetry.py): (N,) each at TelemetryConfig(level="full"),
    # (0,) otherwise (last, so that the older carries keep their
    # positions)
    tele: TelemetryState


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
    # selection knobs (the policy is static, or this one-hot when traced)
    sel_threshold: torch.Tensor  # () f32 bandwidth_threshold cut (Mbps)
    sel_temp: torch.Tensor   # () f32 softmax temperature on the score
    sel_explore: torch.Tensor  # () f32 0 = pure policy, 1 = uniform
    sel_policy: torch.Tensor  # (len(POLICIES),) f32 one-hot
    sel_logbw: torch.Tensor  # (N,) f32 static log upload speeds for the
    #                          bandwidth score, or (0,) without the draw
    sel_qid: torch.Tensor    # (N,) int32 bandwidth quartile of each
    #                          client in that draw (telemetry's
    #                          part_quartile), or (0,) without the draw
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
    # downlink knobs (read only when the downlink is on)
    down_loss: torch.Tensor  # () f32 nominal downlink drop rate
    down_deadline_s: torch.Tensor  # () f32 broadcast deadline (<= 0 off)
    # recovery and loss-budget knobs (read only when built in)
    rec_policy: torch.Tensor  # (3,) f32 one-hot over RECOVERY_POLICIES
    rec_retries: torch.Tensor  # () f32 ARQ retry budget m
    rec_backoff: torch.Tensor  # () f32 ARQ per-resend time cost
    bud_budget: torch.Tensor  # () f32 realized-loss EMA ceiling
    bud_ema: torch.Tensor    # () f32 EMA coefficient beta
    bud_div: torch.Tensor    # () f32 update-norm divergence gate
    # server-mode knobs (the mode is static, or this one-hot when traced)
    srv_mode: torch.Tensor   # (3,) f32 one-hot over async_agg.MODES
    stale_alpha: torch.Tensor  # () f32 staleness discount exponent
    grace_s: torch.Tensor    # () f32 semi_sync grace window (seconds)


# the ScenarioCtx fields that come from NetSimConfig fields of one name
CTX_NETSIM_FIELDS = ("burst_len", "good_loss", "bad_loss", "bw_rho",
                     "deadline_s", "down_loss", "down_deadline_s")
# the ScenarioCtx fields of the fault model, from ``fault_knobs``
CTX_FAULT_FIELDS = ("f_corrupt", "f_cscale", "f_bitflip", "f_fail",
                    "f_flip", "f_echo", "d_screen", "d_clip", "d_trim")
# the ScenarioCtx fields of recovery and the controller
CTX_REC_FIELDS = ("rec_policy", "rec_retries", "rec_backoff", "bud_budget",
                  "bud_ema", "bud_div")
# the ScenarioCtx fields of the selection policy's knobs
CTX_SEL_FIELDS = ("sel_threshold", "sel_temp", "sel_explore", "sel_policy")
# the ScenarioCtx fields of the server mode
CTX_SRV_FIELDS = ("srv_mode", "stale_alpha", "grace_s")
# every ScenarioCtx field past the data, the masks and the static log
# speeds: ``scenario_knobs``
CTX_KNOB_FIELDS = CTX_NETSIM_FIELDS + CTX_FAULT_FIELDS + CTX_REC_FIELDS \
    + CTX_SEL_FIELDS + CTX_SRV_FIELDS


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


def scenario_knobs(cfg, ns=None, flt=None, dfn=None, rec=None, bud=None,
                   sel=None, srv=None) -> Dict[str, np.ndarray]:
    """The CTX_KNOB_FIELDS values of one scenario as float32 arrays: its
    netsim, fault, defense, recovery, loss-budget, selection and server
    configs, each defaulting to ``cfg``'s."""
    ns = cfg.netsim if ns is None else ns
    rec = cfg.recovery if rec is None else rec
    bud = cfg.lossbudget if bud is None else bud
    sel = cfg.sel if sel is None else sel
    srv = cfg.srv if srv is None else srv
    knobs = {f: getattr(ns, f) for f in CTX_NETSIM_FIELDS}
    knobs.update(fault_knobs(cfg.faults if flt is None else flt,
                             cfg.defense if dfn is None else dfn))
    knobs.update(rec_policy=rec_mod.recovery_onehot(rec.policy),
                 rec_retries=rec.retries, rec_backoff=rec.backoff,
                 bud_budget=bud.budget, bud_ema=bud.ema,
                 bud_div=bud.div_gate, sel_threshold=sel.threshold_mbps,
                 sel_temp=sel.temperature, sel_explore=sel.explore,
                 sel_policy=sel_mod.policy_onehot(sel.policy),
                 srv_mode=async_mod.mode_onehot(srv.mode),
                 stale_alpha=srv.staleness_alpha, grace_s=srv.grace_s)
    return {f: np.asarray(knobs[f], np.float32) for f in CTX_KNOB_FIELDS}


# FLConfig fields a scenario may vary without changing the step's
# structure; everything else must agree across a sweep.
SWEEP_VARYING_FIELDS = ("seed", "selection", "eligible_ratio")
SWEEP_VARYING_TRA_FIELDS = ("loss_rate", "threshold_mbps")
SWEEP_VARYING_NETSIM_FIELDS = ("burst_len", "good_loss", "bad_loss",
                               "bw_rho", "deadline_s", "down_loss",
                               "down_deadline_s")
SWEEP_VARYING_SEL_FIELDS = sel_mod.SWEEP_VARYING_SEL_FIELDS
SWEEP_VARYING_REC_FIELDS = rec_mod.SWEEP_VARYING_REC_FIELDS
SWEEP_VARYING_BUD_FIELDS = bud_mod.SWEEP_VARYING_BUD_FIELDS
SWEEP_VARYING_SRV_FIELDS = async_mod.SWEEP_VARYING_SRV_FIELDS


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
    if sel.traced:
        # the policy rides ScenarioCtx.sel_policy: traced configs share
        # one step across all eight policies
        sel = dataclasses.replace(sel, policy="uniform")
    srv = dataclasses.replace(
        cfg.srv, **{f: 0.0 for f in SWEEP_VARYING_SRV_FIELDS})
    if srv.traced:
        # the mode rides ScenarioCtx.srv_mode: traced configs share one
        # step across all three modes
        srv = dataclasses.replace(srv, mode="sync")
    flt = dataclasses.replace(
        cfg.faults,
        **{f: 0.0 for f in faults_mod.SWEEP_VARYING_FAULT_FIELDS})
    dfn = dataclasses.replace(cfg.defense, **faults_mod.DEF_NEUTRAL)
    rec = dataclasses.replace(
        cfg.recovery, **{f: 0.0 for f in SWEEP_VARYING_REC_FIELDS})
    if rec.traced:
        # the policy rides ScenarioCtx.rec_policy: traced configs share
        # one step across all three policies
        rec = dataclasses.replace(rec, policy="one_shot")
    bud = dataclasses.replace(
        cfg.lossbudget, **{f: 0.0 for f in SWEEP_VARYING_BUD_FIELDS})
    return dataclasses.replace(cfg, tra=tra, netsim=ns, sel=sel, srv=srv,
                               faults=flt, defense=dfn, recovery=rec,
                               lossbudget=bud, seed=0, selection="all",
                               eligible_ratio=1.0)


def _static_key(cfg):
    """Hashable key of the step's structure: the signature with the
    round and evaluation schedule normalised away too (they drive the
    block loop, never the step)."""
    return dataclasses.astuple(dataclasses.replace(
        static_signature(cfg), n_rounds=0, eval_every=0, engine="scan"))


def static_logbw(upload_mbps, device) -> torch.Tensor:
    """``ScenarioCtx.sel_logbw``: the (N,) f32 log upload speeds of the
    bandwidth score, or (0,) without a trace draw. The log is taken on
    the host, so every device scores the same bits."""
    if upload_mbps is None:
        return torch.zeros((0,), device=device)
    return log_upload_speeds(upload_mbps).to(device)


def static_quartiles(upload_mbps, device) -> torch.Tensor:
    """``ScenarioCtx.sel_qid``: ``telemetry.bandwidth_quartiles`` of the
    static log speeds, taken on the host, or (0,) without a trace draw."""
    if upload_mbps is None:
        return torch.zeros((0,), dtype=torch.int32, device=device)
    return tele_mod.bandwidth_quartiles(
        log_upload_speeds(upload_mbps)).to(device)


def validate_device_config(cfg, device) -> None:
    """Raise for a configuration that runs on the CPU but not on the
    card; called where an engine learns its device, before any round.
    The defended uplink's kernel screens a packet row (an AND over its
    floats) inside one CTA of one thread a float, so on the card the
    packets of a run with faults are at most ``robust_agg.MAX_F`` wide;
    the plain version takes any width."""
    if torch.device(device).type == "cuda" and cfg.faults.enabled \
            and cfg.tra.packet_floats > robust_agg.MAX_F:
        raise ValueError(
            f"tra.packet_floats={cfg.tra.packet_floats} with "
            f"faults.enabled=True runs on the CPU only: the card's robust "
            f"aggregation screens a packet inside one CTA, at most "
            f"{robust_agg.MAX_F} floats wide")


def validate_round_config(cfg) -> None:
    """Raise for configurations the reference refuses."""
    if cfg.algo not in ENGINE_ALGOS:
        raise ValueError(f"unknown algo {cfg.algo!r} (one of "
                         f"{ENGINE_ALGOS})")
    ns = cfg.netsim
    # a static policy whose score source the configuration lacks; traced
    # selection scores such a policy as zeros (uniform) instead
    policy = None if cfg.sel.traced else cfg.sel.policy
    if policy == "netsim_state" and ns.channel != "gilbert_elliott":
        raise ValueError(
            "selection policy 'netsim_state' scores the Gilbert-Elliott "
            "channel state and requires netsim.channel='gilbert_elliott' "
            "(with the iid channel there is no state to prefer)")
    if policy == "staleness_aware" and not ns.deadline:
        raise ValueError(
            "selection policy 'staleness_aware' scores observed deadline "
            "lateness and requires netsim.deadline=True (without a "
            "deadline nothing is ever late)")
    if policy == "reputation_aware" and not cfg.faults.enabled:
        raise ValueError(
            "selection policy 'reputation_aware' scores quarantine counts "
            "and requires faults.enabled=True (without the fault path "
            "nothing is ever quarantined)")
    if policy == "recovery_pressure" and not cfg.lossbudget.enabled:
        raise ValueError(
            "selection policy 'recovery_pressure' scores the loss-budget "
            "controller's escalation state and requires "
            "lossbudget.enabled=True (without the controller there is no "
            "pressure signal)")
    srv = cfg.srv
    if (srv.traced or srv.mode != "sync") and not ns.deadline:
        raise ValueError(
            "server modes semi_sync/async (and srv.traced, which includes "
            "them) schedule uploads by arrival time and require "
            "netsim.deadline=True")
    if (srv.traced or srv.mode == "async") \
            and cfg.tra.debias == "per_coord_count":
        raise ValueError(
            "the async arrival buffer composes with scalar-denominator "
            "debias modes only; per_coord_count keeps per-coordinate "
            "denominators that cannot be re-weighted after the fact (use "
            "semi_sync, or another debias mode)")
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
    rec = cfg.recovery
    if (rec.traced or rec.policy != "one_shot") and not cfg.tra.enabled:
        raise ValueError(
            "recovery policies act on the lossy TRA uplink mask and "
            "require tra.enabled=True (with TRA off, uploads are reliable "
            "and there is nothing to recover)")
    if cfg.lossbudget.enabled and not rec.traced:
        raise ValueError(
            "the loss-budget controller mixes recovery policies per client "
            "and requires recovery.traced=True (all three policies must be "
            "built into the step)")


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
    # SCAFFOLD uploads (dw ++ dc) on one TRA stream, so its EF and echo
    # memories cover the 2·D vector
    scaffold = cfg.algo == "scaffold"
    up_dim = 2 * D if scaffold else D
    ns = cfg.netsim if netsim is None else netsim

    def per_client(on, cols=()):
        return torch.zeros((n_clients, *cols), device=dev) if on \
            else torch.zeros((0,), device=dev)

    sel = cfg.sel

    def score_mem(policy):
        return per_client(sel.traced or sel.policy == policy)

    if base_key is None:
        base_key = prng.PRNGKey(cfg.seed, device=dev)
    if loss_rate is None:
        loss_rate = torch.tensor(cfg.tra.loss_rate, dtype=torch.float32,
                                 device=dev)
    return EngineState(
        params=params,
        ef_mem=per_client(cfg.error_feedback, (up_dim,)),
        lam=torch.ones((n_clients,), device=dev) / n_clients,
        net=init_net_state(ns, n_clients, device=dev, base_key=base_key,
                           loss_rate=loss_rate, upload_mbps=upload_mbps),
        echo_mem=per_client(cfg.faults.enabled, (up_dim,)),
        rep_mem=per_client(cfg.faults.enabled and (
            sel.traced or sel.policy == "reputation_aware")),
        # every client starts having received the initial broadcast
        stale_model=flatten_clients(params, 1).expand(n_clients, D).clone()
        if ns.down_channel != "off" and ns.down_fallback == "stale"
        else torch.zeros((0,), device=dev),
        bud_level=per_client(cfg.lossbudget.enabled),
        bud_loss=per_client(cfg.lossbudget.enabled),
        c_global=torch.zeros((D if scaffold else 0,), device=dev),
        c_i=per_client(scaffold, (D,)),
        gnorm_mem=score_mem("gradient_norm"),
        loss_mem=score_mem("loss_aware"),
        stale_mem=score_mem("staleness_aware"),
        buf=async_mod.init_arrival_buffer(cfg.srv.buffer_k, up_dim, dev)
        if cfg.srv.traced or cfg.srv.mode == "async"
        else async_mod.empty_arrival_buffer(dev),
        tele=tele_mod.init_telemetry_state(cfg.telemetry, n_clients, dev))


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
    scaffold = algo == "scaffold"
    if scaffold:
        # SCAFFOLD's client also takes the server variate (shared) and
        # its own variate (the cohort's rows), both flat
        def local(p, x, y, cg_vec, ci_vec):
            return cu.scaffold_local(p, x, y, unflatten_like(cg_vec, p),
                                     unflatten_like(ci_vec, p), hyper)
        train = torch.func.vmap(local, in_dims=(None, 0, 0, None, 0))
        # under downlink loss each client trains from its own parameters
        train_own = torch.func.vmap(local, in_dims=(0, 0, 0, None, 0))
    else:
        local_fn = cu.LOCAL_FNS[algo]
        train = torch.func.vmap(lambda p, x, y: local_fn(p, x, y, hyper),
                                in_dims=(None, 0, 0))
        train_own = torch.func.vmap(
            lambda p, x, y: local_fn(p, x, y, hyper))
    # AFL's losses of the new model on each cohort client's staged data
    afl_losses = torch.func.vmap(mlp_weighted_loss, in_dims=(None, 0, 0, 0))
    ns = cfg.netsim
    use_ge = ns.channel == "gilbert_elliott"
    use_bw = ns.bw_ar1
    use_dl = ns.deadline
    # the fault model: faults.enabled is its one static switch, and
    # defense.trim_k (the trimmed mean's extent) is static too
    use_faults = cfg.faults.enabled
    trim_k = cfg.defense.trim_k
    # recovery: the policy (or "traced") and the FEC group are static;
    # use_rec builds all three policies in, the one_shot default none
    use_rec = cfg.recovery.traced or cfg.recovery.policy != "one_shot"
    rec_group = cfg.recovery.group
    n_pol = len(rec_mod.RECOVERY_POLICIES)
    use_bud = cfg.lossbudget.enabled
    # the downlink: channel and fallback are static; "off" broadcasts
    # the shared model losslessly
    use_down = ns.down_channel != "off"
    down_ge = ns.down_channel == "gilbert_elliott"
    down_stale = ns.down_fallback == "stale"
    # selection: the policy (or "traced") is static; each memory is
    # built in when its policy, or traced selection, reads it
    traced_sel = cfg.sel.traced
    policy = cfg.sel.policy
    need_gnorm = traced_sel or policy == "gradient_norm"
    need_loss = traced_sel or policy == "loss_aware"
    need_stale = traced_sel or policy == "staleness_aware"
    need_rep = use_faults and (traced_sel or policy == "reputation_aware")
    # the server mode: the mode (or "traced") and buffer_k are static;
    # the staleness exponent and the grace window ride the context.
    # use_buf builds the arrival buffer in, nonsync the arrival weights
    traced_srv = cfg.srv.traced
    srv_mode = cfg.srv.mode
    use_buf = traced_srv or srv_mode == "async"
    nonsync = traced_srv or srv_mode != "sync"
    # the telemetry level is static: "off" builds none of it in
    tele_cfg = cfg.telemetry
    tele_on = tele_cfg.level != "off"

    def step(ctx: ScenarioCtx, state: EngineState, t: int):
        dd = ctx.data
        N = dd.counts.shape[0]
        params = state.params
        old_vec = flatten_clients(params, 1)[0]
        D_model = old_vec.shape[0]
        D_up = 2 * D_model if scaffold else D_model
        P = n_packets(D_up, Fp)
        n_batch = C * steps * bs
        # the GE channel's emission draws are a second (C, P) block
        # after the transition draws
        n_tra = 2 * C * P if use_ge else C * P
        # recovery and downlink blocks come after. Threefry uniforms are
        # not prefix-stable in the total count: the default steps stay
        # bitwise because their total is unchanged, and a traced
        # recovery cell equals its static run because both draw the ARQ
        # and the parity blocks.
        gn = rec_mod.fec_groups(P, rec_group) if use_rec else 0
        n_rec = C * P + C * gn if use_rec else 0
        # the broadcast is the model, D_model floats (SCAFFOLD's control
        # variate goes losslessly, as the reference's simplification)
        P_dn = n_packets(D_model, Fp)
        n_down = (2 * C * P_dn if down_ge else C * P_dn) if use_down else 0
        # one threefry invocation covers the whole round
        key = prng.fold_in(ctx.base_key, t)
        u_all = prng.uniform(key, (N + n_batch + n_tra + n_rec + n_down,),
                             minval=1e-12, maxval=1.0)
        u_sel = u_all[:N]
        u_idx = u_all[N:N + n_batch].reshape(C, steps, bs)
        u_tra = u_all[N + n_batch:N + n_batch + C * P].reshape(C, P)
        off = N + n_batch + n_tra
        if use_rec:
            u_arq = u_all[off:off + C * P].reshape(C, P)
            u_par = u_all[off + C * P:off + n_rec].reshape(C, gn)
            off += n_rec
        if use_down:
            u_dt = u_all[off:off + C * P_dn].reshape(C, P_dn)
            u_de = u_all[off + C * P_dn:off + 2 * C * P_dn] \
                .reshape(C, P_dn) if down_ge else None

        # selection reads the carries as the previous round left them,
        # before this round's training, as a real server would; the
        # uniform policy's logits are None (the uniform expression)
        scores = dict(
            temperature=ctx.sel_temp, explore=ctx.sel_explore,
            threshold_mbps=ctx.sel_threshold,
            logbw=state.net.logbw if use_bw else ctx.sel_logbw,
            gnorm_mem=state.gnorm_mem, loss_mem=state.loss_mem,
            channel=state.net.channel, stale_mem=state.stale_mem,
            rep_mem=state.rep_mem, bud_level=state.bud_level,
            bud_loss=state.bud_loss)
        if traced_sel:
            logits = sel_mod.traced_policy_logits(ctx.sel_policy, **scores,
                                                  n_clients=N)
        else:
            logits = sel_mod.policy_logits(policy, **scores)
        ids = sel_mod.select_from_uniforms(u_sel, logits, ctx.eligible, C)
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

        # downlink: the broadcast model loses packets on each client's
        # channel, and a client fills a lost packet's coordinates from
        # its last-received model ("stale") or with zeros, then trains
        # from that effective model
        net_down = state.net.down
        sc_args = (state.c_global, state.c_i[ids]) if scaffold else ()
        dn_frac = None      # the realized downlink loss (telemetry)
        if use_down:
            if down_ge:
                dp_gb, dp_bg = ge_transition_probs(
                    ctx.down_loss, ctx.burst_len, ctx.good_loss,
                    ctx.bad_loss)
                dmask, ds_fin = netsim_ops.ge_packet_mask(
                    u_dt, u_de, net_down[ids], dp_gb, dp_bg, ctx.good_loss,
                    ctx.bad_loss)
                net_down = net_down.index_copy(0, ids, ds_fin)
            else:
                dmask = (u_dt >= ctx.down_loss).float()
            if use_bw or use_dl:
                # broadcast deadline: the whole model misses when pushing
                # P_dn packets at the client's carried bandwidth overruns
                # it; <= 0 disables
                dsecs = round_upload_seconds(
                    P_dn, Fp, torch.exp(state.net.logbw[ids]),
                    ctx.down_loss,
                    torch.zeros((C,), dtype=torch.bool, device=u_dt.device))
                dok = torch.where(ctx.down_deadline_s > 0.0,
                                  deadline_delivered(dsecs,
                                                     ctx.down_deadline_s),
                                  1.0)
                dmask = dmask * dok[:, None]
            coord_dn = dmask[:, :, None].expand(C, P_dn, Fp) \
                .reshape(C, P_dn * Fp)[:, :D_model]
            stale_rows = state.stale_model[ids] if down_stale \
                else torch.zeros((C, D_model), device=u_dt.device)
            eff_vec = coord_dn * old_vec[None, :] \
                + (1.0 - coord_dn) * stale_rows
            if tele_on:
                dn_frac = tele_mod.one_minus_mean01(dmask)
            uploads, aux = train_own(unflatten_like(eff_vec, params), X, Y,
                                     *sc_args)
        else:
            uploads, aux = train(params, X, Y, *sc_args)
        if scaffold:
            dc = flatten_clients(uploads["dc"], C)           # (C, D)
            flat = torch.cat([flatten_clients(uploads["dw"], C), dc], 1)
        else:
            flat = flatten_clients(uploads, C)               # (C, D)

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

        def apply_recovery(base_mask):
            """All three policies on the channel mask, mixed by a 0/1
            one-hot (1*x + 0*y + 0*z == x bitwise for finite masks): the
            scenario's policy, or the controller's per-client level.
            Returns the mask, the one-hot, the realized loss and, with
            telemetry on, the packet fractions FEC and ARQ recovered
            (else None)."""
            par_mask = rec_mod.fec_parity_mask(u_par, lr_col)
            mask_fec = fec_ops.fec_recover(base_mask, par_mask,
                                           group=rec_group)
            mask_arq = rec_mod.arq_residual_mask(base_mask, u_arq, lr_col,
                                                 ctx.rec_retries)
            oh = bud_mod.controller_policy_onehot(state.bud_level[ids]) \
                if use_bud else ctx.rec_policy[None, :].expand(C, n_pol)
            mask_eff = oh[:, 0:1] * base_mask + oh[:, 1:2] * mask_fec \
                + oh[:, 2:3] * mask_arq
            # realized loss 1 - mean: as XLA compiles the reference, the
            # mean multiplies the exact count by the f32 reciprocal of P,
            # fused with the subtraction (one rounding, from float64)
            realized = (1.0 - base_mask.sum(dim=1).double()
                        * float(np.float32(1.0 / P))).float()
            fracs = (tele_mod.xla_mean(mask_fec - base_mask),
                     tele_mod.xla_mean(mask_arq - base_mask)) if tele_on \
                else (None, None)
            return mask_eff, oh, realized, fracs

        rec_oh = realized_c = None
        fec_frac = arq_frac = None
        if use_ge:
            # bursty loss: each cohort client's channel walks P packet
            # steps and its final state goes back into the carry.
            # Sufficient clients retransmit (all-ones mask), but their
            # channel still advances.
            u_emit = u_all[N + n_batch + C * P:N + n_batch + n_tra] \
                .reshape(C, P)
            p_gb, p_bg = ge_transition_probs(
                lr_c, ctx.burst_len, ctx.good_loss, ctx.bad_loss)
            ge_mask, s_fin = netsim_ops.ge_packet_mask(
                u_tra, u_emit, net_channel[ids], p_gb, p_bg,
                ctx.good_loss, ctx.bad_loss)
            net_channel = net_channel.index_copy(0, ids, s_fin)
            if use_rec:
                ge_mask, rec_oh, realized_c, (fec_frac, arq_frac) = \
                    apply_recovery(ge_mask)
            pkt_mask = torch.where(suff.bool()[:, None], 1.0, ge_mask)
        elif tra_cfg.enabled and use_rec:
            mask_eff, rec_oh, realized_c, (fec_frac, arq_frac) = \
                apply_recovery((u_tra >= lr_col).float())
            pkt_mask = torch.where(suff.bool()[:, None], 1.0, mask_eff)
        elif tra_cfg.enabled:
            lost = (u_tra < lr_col) & ~suff.bool()[:, None]
            pkt_mask = 1.0 - lost.float()
        else:
            pkt_mask = torch.ones((C, P), device=xp.device)
        # with recovery built in, the group_rate debias divides by the
        # post-recovery residual rate; a one_shot row mixes to r exactly
        lr_deb = rec_mod.residual_rate_mixed(
            rec_oh, lr_c, ctx.rec_retries, rec_group) if use_rec else lr_c

        if use_bw:
            # time passes for every client: one AR(1) step on all N
            net_logbw = logbw_round_step(key, net_logbw, ctx.bw_rho)
        # the loss channel's mask alone: the async buffer stores late
        # uploads under it
        loss_mask = pkt_mask
        a_c = None          # per-client arrival weight on w_agg
        arrival = lateness = None
        if use_dl:
            # arrival times: retransmitters push ~P/(1-r) packets, TRA
            # one-shots push P
            retransmit = suff.bool() if tra_cfg.enabled \
                else torch.ones((C,), dtype=torch.bool, device=xp.device)
            if use_rec:
                # each policy pays its airtime: FEC 1 + 1/G sends, ARQ
                # the expected retries; retransmitters pay 1/(1-r)
                sends_pol = rec_oh[:, 0] * 1.0 \
                    + rec_oh[:, 1] * rec_mod.fec_sends(rec_group) \
                    + rec_oh[:, 2] * rec_mod.arq_sends(
                        lr_c, ctx.rec_retries, ctx.rec_backoff)
                secs = rec_mod.recovery_upload_seconds(
                    P, Fp, torch.exp(net_logbw[ids]), lr_c, retransmit,
                    sends_pol)
            else:
                secs = round_upload_seconds(
                    P, Fp, torch.exp(net_logbw[ids]), lr_c, retransmit)
            delivered = deadline_delivered(secs, ctx.deadline_s)
            if need_stale or nonsync or tele_on:
                lateness = arrival_lateness(secs, ctx.deadline_s)
            if not nonsync:
                # sync: a miss drops the whole upload, while its weight
                # stays in the denominator
                pkt_mask = pkt_mask * delivered[:, None]
                arrival = delivered
            else:
                ontime = delivered
                late = 1.0 - ontime
                # semi_sync: a straggler landing within the grace window
                # counts this round, discounted by its fractional
                # staleness; later ones drop, and their weight leaves
                # the denominator too
                within = torch.where(
                    ctx.deadline_s > 0.0,
                    deadline_delivered(secs, ctx.deadline_s + ctx.grace_s),
                    0.0)
                a_semi = ontime + late * within * async_mod.staleness_weight(
                    grace_staleness(secs, ctx.deadline_s), ctx.stale_alpha)
                # async: on-time uploads count now, late ones land w(tau)-
                # discounted tau rounds later; an infeasible upload
                # (lateness pinned at MAX_LATENESS) is never buffered and
                # logs 0
                feasible = (lateness < MAX_LATENESS).float()
                a_async_log = ontime + late * feasible \
                    * async_mod.staleness_weight(lateness, ctx.stale_alpha)
                if traced_srv:
                    # each mode's expression as its static step computes
                    # it, picked by where() on the one-hot
                    is_sync = ctx.srv_mode[0] > 0.5
                    is_semi = ctx.srv_mode[1] > 0.5
                    is_async = ctx.srv_mode[2] > 0.5
                    pkt_mask = torch.where(
                        is_sync, loss_mask * delivered[:, None],
                        torch.where(is_semi, loss_mask * within[:, None],
                                    loss_mask))
                    a_c = torch.where(
                        is_sync, torch.ones_like(ontime),
                        torch.where(is_semi, a_semi, ontime))
                    arrival = torch.where(
                        is_sync, delivered,
                        torch.where(is_semi, a_semi, a_async_log))
                elif srv_mode == "semi_sync":
                    pkt_mask = loss_mask * within[:, None]
                    a_c = arrival = a_semi
                else:
                    a_c, arrival = ontime, a_async_log

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
        elif algo == "afl":
            w_agg, mult, want_ssq = state.lam[ids], None, False
        else:
            w_agg, mult, want_ssq = weights, None, False
        # gradient_norm scores the next round's cohort by the masked norms
        # this same uplink pass computes; the controller reads them as its
        # divergence signal
        want_ssq = want_ssq or need_gnorm or use_bud
        # the non-sync modes fold the arrival weight into the aggregation
        # weights: a zero-weight straggler leaves the numerator and the
        # denominator (EF and the norms take no weights, so a buffered
        # upload is not counted twice through EF); sync multiplies by
        # nothing
        w_up = w_agg if a_c is None else w_agg * a_c

        if use_faults:
            # defended uplink: finite-screen quarantine (bad packets as if
            # lost), norm clip, trimmed mean; off gates are bitwise the
            # undefended expressions
            rob = robust_ops.robust_uplink_round(
                xp, pkt_mask, w_up, mode=debias, d_up=D_up,
                screen=ctx.d_screen, clip_norm=ctx.d_clip,
                trim_gate=ctx.d_trim, trim_k=trim_k,
                ef_rows=state.ef_mem[ids] if ef else None,
                sufficient=suff, loss_rate=lr_deb, mult=mult,
                want_ssq=want_ssq)
            agg, new_ef_rows, ssq = rob.agg, rob.ef_rows, rob.ssq
            kept = rob.kept
        else:
            agg, new_ef_rows, ssq = uplink_ops.uplink_round(
                xp, pkt_mask, w_up, mode=debias, d_up=D_up,
                ef_rows=state.ef_mem[ids] if ef else None, kept=kept,
                sufficient=suff, loss_rate=lr_deb, mult=mult,
                want_ssq=want_ssq)
        new_ef = state.ef_mem.index_copy(0, ids, new_ef_rows) if ef \
            else state.ef_mem

        # the async buffer: pop the entries due this round into the
        # aggregate, push this round's late uploads
        new_buf = state.buf
        den_ready = None
        if use_buf:
            t_f = torch.tensor(float(t), device=agg.device)
            num_ready, den_ready, popped = async_mod.buffer_pop_ready(
                state.buf, t_f, ctx.stale_alpha)
            # the kernel's aggregate is num / den with the scalar den =
            # max(sum w_up, eps); ready entries extend both sides (the
            # numerator one fused multiply-add, as XLA compiles the
            # reference's). With nothing due, the kernel's output stays
            # as it is (the recombination would round num / den through
            # a multiply).
            den_on = w_up.sum()
            agg_buf = async_mod.fma(agg, torch.clamp(den_on, min=DENOM_EPS),
                                    num_ready) \
                / torch.clamp(den_on + den_ready, min=DENOM_EPS)
            use_ready = den_ready > 0.0
            if traced_srv:
                use_ready = use_ready & is_async
            agg = torch.where(use_ready, agg_buf, agg)
            # the candidates: the debias-scaled loss-masked upload (the
            # scale the kernel gives on-time clients), due ``lateness``
            # rounds from now; an upload that never arrives stays out
            q_full = uplink_ops.debias_client_scale(
                w_agg, mode=debias, kept=kept, sufficient=suff,
                loss_rate=lr_deb, mult=mult)
            coord_mask = loss_mask[:, :, None].expand(C, P, Fp) \
                .reshape(C, P * Fp)[:, :D_up]
            base_rows = flat + state.ef_mem[ids] if ef else flat
            if use_faults:
                # the buffer launders no corrupted data: the norm clip
                # applies to buffered contributions, a quarantined
                # arrival is refused, and candidates are sanitised so a
                # NaN in a lost packet cannot ride through 0 * NaN; all
                # behind the traced gates, bitwise off when they are off
                scr_on = ctx.d_screen > 0.5
                q_full = q_full * rob.s_clip
                base_rows = torch.where(scr_on & ~torch.isfinite(base_rows),
                                        0.0, base_rows)
            contrib = base_rows * coord_mask * q_full[:, None]
            cand_live = (lateness > 0.0) & (lateness < MAX_LATENESS)
            if use_faults:
                cand_live = cand_live & ~(scr_on & (rob.qcnt > 0.0))
            if traced_srv:
                cand_live = cand_live & is_async
            new_buf = async_mod.buffer_insert(
                popped, contrib, t_f + lateness, w_agg, lateness, cand_live)

        c_global, c_i, lam = state.c_global, state.c_i, state.lam
        if scaffold:
            new_vec = old_vec + agg[:D_model]
            c_global = c_global + (C / N) * agg[D_model:]
            # each client's variate moves by its own dc, not the delivered
            c_i = c_i.index_copy(0, ids, c_i[ids] + dc)
        elif algo == "qfedavg":
            # delta_k = F_k^q dw_k;  h_k = q F^(q-1)||dw||^2 + L F^q
            h = cfg.q * torch.pow(aux["loss0"] + eps, cfg.q - 1) * ssq \
                + cfg.lipschitz * fq
            # debiased SUM of deltas = debiased mean * C
            new_vec = old_vec - agg * C / torch.clamp(h.sum(), min=1e-8)
        elif algo == "pfedme":
            new_vec = (1 - cfg.pfedme_beta) * old_vec \
                + cfg.pfedme_beta * agg
        else:  # fedavg, perfedavg, afl: weighted mean of uploaded models
            new_vec = agg
        if nonsync:
            # a server step with nothing on time, in grace or due from the
            # buffer is the identity, never 0/0 nor a zeroed model; sync
            # keeps its all-stragglers collapse, the baseline the other
            # modes fix
            den_tot = w_up.sum() if den_ready is None \
                else w_up.sum() + den_ready
            has_arrivals = den_tot > 0.0
            if traced_srv:
                has_arrivals = has_arrivals | is_sync
            new_vec = torch.where(has_arrivals, new_vec, old_vec)
        new_params = unflatten_like(new_vec, params)
        if algo == "afl":
            # projected gradient ascent on the clients' losses (minimax)
            # at the new model, over each cohort client's first staged
            # samples, the padding masked out
            L = min(64, dd.train_x.shape[1])
            msk = (torch.arange(L, device=counts.device)[None, :]
                   < counts[:, None]).float()
            losses = afl_losses(new_params, dd.train_x[ids, :L],
                                dd.train_y[ids, :L], msk)
            lam = torch.clamp(lam.index_add(0, ids, cfg.afl_lr_lambda
                                            * losses), min=0.0)
            lam = lam / lam.sum()
        # the echo memory records what each client genuinely computed
        echo_new = state.echo_mem.index_copy(0, ids, flat_clean) \
            if use_faults else state.echo_mem
        # after this round a client's local model is its effective model:
        # what it resumes from when its next broadcast drops packets
        stale_new = state.stale_model.index_copy(0, ids, eff_vec) \
            if use_down and down_stale else state.stale_model
        # the controller: the policy used this round was read from the
        # carried level; the level and EMA written here drive the next
        bud_level, bud_loss = state.bud_level, state.bud_loss
        n_esc = lv = None
        if use_bud:
            lv, ema_new, n_esc = bud_mod.controller_update(
                bud_level[ids], bud_loss[ids], realized_c, ssq,
                budget=ctx.bud_budget, beta=ctx.bud_ema,
                div_gate=ctx.bud_div)
            bud_level = bud_level.index_copy(0, ids, lv)
            bud_loss = bud_loss.index_copy(0, ids, ema_new)
        # the selection scores' memories, for the next round's selection
        gnorm_new = state.gnorm_mem.index_copy(0, ids, ssq) if need_gnorm \
            else state.gnorm_mem
        loss_new = state.loss_mem.index_copy(0, ids, aux["loss0"]) \
            if need_loss else state.loss_mem
        late_new = state.stale_mem.index_copy(0, ids, lateness) \
            if need_stale and use_dl else state.stale_mem
        # the reputation accumulates each round's quarantined fraction
        rep_new = state.rep_mem.index_add(0, ids, rob.qcnt / P) \
            if need_rep else state.rep_mem
        logs = {"loss": aux["loss0"].mean(), "ids": ids}
        if use_faults:
            # per-cohort-slot quarantined-packet counts
            logs["quarantine"] = rob.qcnt
        if use_dl:
            # per-cohort-slot arrival weight: 1 landed on time at full
            # weight, 0 dropped, the discount of a semi_sync or async
            # straggler
            logs["arrival"] = arrival
        # telemetry: the round's "tele/..." keys and, at "full", the
        # per-client aggregates, read from signals the round computed
        new_tele = state.tele
        if tele_on:
            tele_scale = uplink_ops.debias_client_scale(
                w_agg, mode=debias, kept=kept, sufficient=suff,
                loss_rate=lr_deb, mult=mult)
            tlogs, new_tele = tele_mod.round_telemetry(
                tele_cfg, state.tele, ids=ids, n_clients=N,
                pkt_mask=pkt_mask, loss_mask=loss_mask, old_vec=old_vec,
                new_vec=new_vec, scale=tele_scale,
                qid=ctx.sel_qid,
                ef_new_rows=new_ef_rows if ef else None,
                arrival=arrival if use_dl else None,
                lateness=lateness if use_dl else None,
                qcnt=rob.qcnt if use_faults else None,
                buf_due=new_buf.due if use_buf else None,
                buf_empty_due=async_mod.EMPTY_DUE, down_frac=dn_frac,
                fec_frac=fec_frac, arq_frac=arq_frac, bud_escal=n_esc,
                bud_level=tele_mod.xla_mean(lv) if use_bud else None)
            logs.update(tlogs)
        net = NetSimState(net_channel, net_logbw, net_down)
        return EngineState(new_params, new_ef, lam, net, echo_new,
                           rep_new, stale_new, bud_level, bud_loss,
                           c_global, c_i, gnorm_new, loss_new,
                           late_new, new_buf, new_tele), logs

    return step


# step cache shared across engine instances: scenario-varying values ride
# the ScenarioCtx argument, so every engine (and server) with the same
# static config and cohort reuses one step. The registry
# (core/telemetry.REGISTRY) logs every lookup's key fingerprint, and the
# TimedPrograms book each dispatch's host time against it.
_STEP_CACHE: Dict[Any, Any] = {}


def _run_rounds(step, ctx, state, t0: int, k: int):
    """Rounds [t0, t0+k) through ``step``; the logs stacked on the
    device, (k, ...) a key (a leading scenario axis stays first)."""
    logs = []
    for t in range(t0, t0 + k):
        state, lg = step(ctx, state, t)
        logs.append(lg)
    dim = 1 if logs[0]["loss"].dim() == 1 else 0
    return state, {name: torch.stack([lg[name] for lg in logs], dim=dim)
                   for name in logs[0]}


def cached_step(cfg, cohort: int):
    """(step, single, block) for ``cfg`` at ``cohort``: the round step,
    and its one-round and block dispatchers wrapped in
    ``telemetry.TimedProgram``, built on the first lookup of the key
    ``(_static_key(cfg), cohort)`` and reused after it."""
    # validate before the lookup: the key normalises the sweep-varying
    # fields away, so an invalid config could hit a valid cached step
    validate_round_config(cfg)
    key = (_static_key(cfg), cohort)
    hit = key in _STEP_CACHE
    fp = tele_mod.REGISTRY.record_lookup("engine", key, hit=hit)
    if not hit:
        step = make_round_step(cfg, cohort)
        single = tele_mod.TimedProgram(step, "engine", fp)
        block = tele_mod.TimedProgram(
            lambda ctx, state, t0, k: _run_rounds(step, ctx, state, t0, k),
            "engine", fp)
        _STEP_CACHE[key] = (step, single, block)
    return _STEP_CACHE[key]


def gumbel_topk_select(key: torch.Tensor, eligible: torch.Tensor,
                       k: int) -> torch.Tensor:
    """A uniform sample of ``k`` clients without replacement from the
    eligible set, on ``key``'s device (Gumbel-top-k, uniform weights):
    ``selection.select_clients`` with no scores."""
    return sel_mod.select_clients(key, None, eligible, k)


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
        validate_device_config(cfg, self.device)
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
        if (cfg.sel.traced or cfg.sel.policy == "bandwidth_threshold") \
                and upload_mbps is None:
            raise ValueError(
                "the bandwidth_threshold selection score (and the traced "
                "policy family, which includes it) needs the trace draw "
                "(pass nets.upload_mbps)")
        self._upload_mbps = None if upload_mbps is None \
            else np.asarray(upload_mbps, np.float32)
        dev = self.device
        self._step, self._single, self._block = cached_step(cfg,
                                                            self.cohort)
        self.ctx = ScenarioCtx(
            base_key=prng.PRNGKey(cfg.seed, device=dev),
            loss_rate=torch.tensor(loss_rate, device=dev),
            eligible=torch.tensor(eligible, device=dev),
            sufficient=torch.tensor(np.asarray(sufficient, np.float32),
                                    device=dev),
            data=self.dd,
            sel_logbw=static_logbw(self._upload_mbps, dev),
            sel_qid=static_quartiles(self._upload_mbps, dev),
            **{f: torch.tensor(v, device=dev)
               for f, v in scenario_knobs(cfg).items()})

    def init_state(self, params) -> EngineState:
        return init_engine_state(self.cfg, params, self.n_clients,
                                 base_key=self.ctx.base_key,
                                 loss_rate=self.ctx.loss_rate,
                                 upload_mbps=self._upload_mbps)

    def run_single(self, state: EngineState, t: int
                   ) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
        """One round at absolute index ``t``."""
        return self._single(self.ctx, state, t)

    def run_block(self, state: EngineState, t0: int, k: int
                  ) -> Tuple[EngineState, Dict[str, np.ndarray]]:
        """Rounds [t0, t0+k); logs come to the host once, at the end.
        Returns (state, {"loss": (k,), "ids": (k, C)[, "quarantine":
        (k, C)][, "arrival": (k, C)][, "tele/...": (k, ...)]}): with
        telemetry on, one key a ``tele/`` signal built into the step,
        (k,) for a scalar, (k, 4) for ``tele/part_quartile`` and (k,
        stale_bins) for ``tele/stale_hist``."""
        state, logs = self._block(self.ctx, state, t0, k)
        return state, {name: v.cpu().numpy() for name, v in logs.items()}
