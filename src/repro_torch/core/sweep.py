"""Multi-scenario sweep engine: a paper grid as one batched round step.

A *scenario* is everything that may vary without changing the step's
structure: the PRNG seed, the TRA loss rate, the eligibility and
sufficiency masks, the dataset draw, the netsim knobs (burst length,
emission rates, bandwidth correlation, deadline, downlink loss rate and
deadline), the fault rates and the defense gates, the ARQ retries and
backoff, the recovery policy itself when traced, the loss-budget
controller's budget, EMA and divergence gate, the selection threshold,
temperature and exploration (and the selection policy itself when
traced, so a policy x loss-rate grid is one batched step a round), and
the server's staleness exponent and grace window (and the server mode
itself when traced, so a sync / semi_sync / async x loss-rate grid is
one batched step a round too).
``SweepEngine`` stacks S scenarios behind a leading axis:
``ScenarioCtx`` fields become (S, ...) tensors, per-scenario
``EngineState``s are stacked, and the data is one shared (N, M, D) set
or a stacked (S, N, M, D) one.
``torch.func.vmap`` over the SAME round step that ``RoundScanEngine``
runs then plays every scenario's round at once: each PyTorch launch
carries S scenarios' work, and the kernels batch through their ops'
vmap rules — one batched uplink (or, with faults on, robust-aggregation)
launch, one Gilbert–Elliott mask launch per chain (uplink, downlink) and
one FEC repair launch per round for the whole grid.

Static structure (algorithm, debias mode, cohort size, local steps,
batch size, TRA on/off, error feedback, netsim model selection,
``faults.enabled``, ``defense.trim_k``, the selection policy unless
traced, the recovery policy unless traced, the FEC group,
``lossbudget.enabled``, the server mode unless traced,
``srv.buffer_k`` and the telemetry level) must be shared across a sweep;
the constructor and ``from_configs`` check that and raise on a mixed
grid. A grid is one step: ``core/telemetry.REGISTRY`` logs one "sweep"
lookup a ``SweepEngine``, and ``programs_for("sweep")`` counts the steps
built.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import telemetry as tele_mod
from repro_torch.core import tra as tra_mod
from repro_torch.core.async_agg import AsyncConfig
from repro_torch.core.engine import (CTX_KNOB_FIELDS,
                                     SWEEP_VARYING_BUD_FIELDS,
                                     SWEEP_VARYING_FIELDS,
                                     SWEEP_VARYING_NETSIM_FIELDS,
                                     SWEEP_VARYING_REC_FIELDS,
                                     SWEEP_VARYING_SEL_FIELDS,
                                     SWEEP_VARYING_SRV_FIELDS,
                                     SWEEP_VARYING_TRA_FIELDS, EngineState,
                                     ScenarioCtx, _run_rounds, _static_key,
                                     init_engine_state, make_round_step,
                                     scenario_knobs, static_logbw,
                                     static_quartiles, static_signature,
                                     validate_device_config,
                                     validate_round_config)
from repro_torch.core.lossbudget import LossBudgetConfig
from repro_torch.core.mlp import mlp_init
from repro_torch.core.selection import SelectionConfig
from repro_torch.data.synthetic import (DeviceDataset, FederatedDataset,
                                        stage_on_device,
                                        stage_scenarios_on_device)
from repro_torch.device import resolve_device
from repro_torch.netsim.config import NetSimConfig
from repro_torch.netsim.faults import (SWEEP_VARYING_DEF_FIELDS,
                                       SWEEP_VARYING_FAULT_FIELDS,
                                       DefenseConfig, FaultConfig)
from repro_torch.netsim.recovery import RecoveryConfig
from repro_torch.network.trace import (eligible_mask_device,
                                       sample_networks,
                                       stage_network_scenarios)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of a paper grid (host-side description)."""
    seed: int
    loss_rate: float
    sufficient: np.ndarray        # (N,) 0/1 sufficiency reports
    eligible: np.ndarray          # (N,) bool selection mask
    data: FederatedDataset        # this scenario's dataset draw
    # this cell's netsim knobs (None -> the sweep config's cfg.netsim);
    # the model selection must agree across a sweep
    netsim: Optional[NetSimConfig] = None
    # per-client trace draws, needed when tra.per_client_loss or a
    # netsim bandwidth/deadline model is on
    packet_loss: Optional[np.ndarray] = None   # (N,) drop rates
    upload_mbps: Optional[np.ndarray] = None   # (N,) speeds
    # this cell's fault rates and defense gates (None -> the sweep
    # config's); faults.enabled and defense.trim_k must agree
    faults: Optional[FaultConfig] = None
    defense: Optional[DefenseConfig] = None
    # this cell's recovery knobs (None -> the sweep config's): retries
    # and backoff may vary, the policy only with recovery.traced; traced
    # and group must agree
    recovery: Optional[RecoveryConfig] = None
    # this cell's loss-budget knobs (None -> the sweep config's);
    # enabled must agree
    lossbudget: Optional[LossBudgetConfig] = None
    # this cell's selection knobs (None -> the sweep config's): the
    # threshold, temperature and exploration may vary, the policy only
    # with sel.traced; traced must agree
    sel: Optional[SelectionConfig] = None
    # this cell's server knobs (None -> the sweep config's): the
    # staleness exponent and grace window may vary, the mode only with
    # srv.traced; traced and buffer_k must agree
    srv: Optional[AsyncConfig] = None


def scenario_from_config(cfg, data: FederatedDataset,
                         nets=None) -> Scenario:
    """A Scenario derived the way ``FederatedServer`` derives its engine
    inputs (same network draw from the scenario seed, same sufficiency
    report and eligibility), so sweep cells match single runs."""
    rng = np.random.default_rng(cfg.seed)
    if nets is None:
        nets = sample_networks(rng, data.n_clients)
    sufficient = tra_mod.sufficiency_report(nets, cfg.tra.threshold_mbps)
    eligible = eligible_mask_device(
        torch.tensor(np.asarray(nets.upload_mbps), dtype=torch.float32),
        cfg.selection, eligible_ratio=cfg.eligible_ratio,
        threshold_mbps=cfg.tra.threshold_mbps).numpy()
    return Scenario(seed=cfg.seed, loss_rate=cfg.tra.loss_rate,
                    sufficient=sufficient, eligible=eligible, data=data,
                    netsim=cfg.netsim, packet_loss=nets.packet_loss,
                    upload_mbps=nets.upload_mbps, faults=cfg.faults,
                    defense=cfg.defense, recovery=cfg.recovery,
                    lossbudget=cfg.lossbudget, sel=cfg.sel, srv=cfg.srv)


# the sweep's step cache: one batched step a key (the static config, the
# cohort and whether the dataset is stacked), every lookup logged in
# core/telemetry.REGISTRY under "sweep"
_SWEEP_CACHE: Dict[Any, Any] = {}


def _ctx_dims(data_batched: bool) -> ScenarioCtx:
    """The vmap in_dims of a stacked ScenarioCtx: every field on its
    leading scenario axis, the dataset only when it is stacked."""
    data_dim = 0 if data_batched else None
    return ScenarioCtx(
        base_key=0, loss_rate=0, eligible=0, sufficient=0,
        data=DeviceDataset(data_dim, data_dim, data_dim), sel_logbw=0,
        sel_qid=0, **{f: 0 for f in CTX_KNOB_FIELDS})


def cached_sweep_step(cfg, cohort: int, data_batched: bool):
    """(step, block) of the batched round: ``make_round_step`` vmapped
    over the scenario axis, and its block dispatcher wrapped in
    ``telemetry.TimedProgram``, built on the first lookup of its key."""
    validate_round_config(cfg)
    key = (_static_key(cfg), cohort, data_batched)
    hit = key in _SWEEP_CACHE
    fp = tele_mod.REGISTRY.record_lookup("sweep", key, hit=hit)
    if not hit:
        vstep = torch.func.vmap(make_round_step(cfg, cohort),
                                in_dims=(_ctx_dims(data_batched), 0, None))
        _SWEEP_CACHE[key] = (vstep, tele_mod.TimedProgram(
            lambda ctx, states, t0, k: _run_rounds(vstep, ctx, states, t0,
                                                   k), "sweep", fp))
    return _SWEEP_CACHE[key]


def _netsim_models(ns: NetSimConfig):
    return (ns.channel, ns.bw_ar1, ns.deadline, ns.down_channel,
            ns.down_fallback)


class SweepEngine:
    """Batched executor for S same-shaped scenarios.

    Callers own the stacked ``EngineState`` and thread it through
    ``run_block``; use the returned state. ``device`` None means the
    card, and raises without one (pass ``device="cpu"`` for the CPU).
    """

    def __init__(self, cfg, scenarios: Sequence[Scenario], *, device=None):
        if not scenarios:
            raise ValueError("empty sweep")
        self.device = dev = resolve_device(device)
        validate_device_config(cfg, dev)
        self.cfg = cfg
        self.scenarios = list(scenarios)
        self.n_scenarios = len(self.scenarios)
        if all(s.data is self.scenarios[0].data for s in self.scenarios):
            # seed / rate grids usually share one dataset draw: stage it
            # once and broadcast it through the vmap
            self.dd = stage_on_device(self.scenarios[0].data, dev)
        else:
            self.dd = stage_scenarios_on_device(
                [s.data for s in self.scenarios], dev)
        # counts is (N,) when the dataset is shared, (S, N) when stacked
        self.data_batched = self.dd.counts.dim() == 2
        self.n_clients = int(self.dd.counts.shape[-1])
        n_elig = [int(np.asarray(s.eligible).sum()) for s in self.scenarios]
        if min(n_elig) == 0:
            raise ValueError("a scenario has no eligible clients")
        cohorts = {min(cfg.clients_per_round, ne) for ne in n_elig}
        if len(cohorts) != 1:
            # the cohort is a static shape
            raise ValueError(f"scenarios disagree on cohort size: "
                             f"{sorted(cohorts)}")
        self.cohort = cohorts.pop()
        nsims = self._nsims = [
            s.netsim if s.netsim is not None else cfg.netsim
            for s in self.scenarios]
        for i, ns in enumerate(nsims):
            if _netsim_models(ns) != _netsim_models(cfg.netsim):
                raise ValueError(
                    f"scenario {i} selects different netsim models than "
                    f"the sweep config; only {SWEEP_VARYING_NETSIM_FIELDS}"
                    f" may vary per cell")
        flts = [s.faults if s.faults is not None else cfg.faults
                for s in self.scenarios]
        dfns = [s.defense if s.defense is not None else cfg.defense
                for s in self.scenarios]
        for i, (fl, df) in enumerate(zip(flts, dfns)):
            if fl.enabled != cfg.faults.enabled \
                    or df.trim_k != cfg.defense.trim_k:
                raise ValueError(
                    f"scenario {i} differs from the sweep config in a "
                    f"static fault field (faults.enabled, defense.trim_k); "
                    f"only faults.{SWEEP_VARYING_FAULT_FIELDS} and "
                    f"defense.{SWEEP_VARYING_DEF_FIELDS} may vary per cell")
        recs = [s.recovery if s.recovery is not None else cfg.recovery
                for s in self.scenarios]
        for i, rc in enumerate(recs):
            if rc.traced != cfg.recovery.traced \
                    or rc.group != cfg.recovery.group \
                    or not (cfg.recovery.traced
                            or rc.policy == cfg.recovery.policy):
                raise ValueError(
                    f"scenario {i} differs from the sweep config in a "
                    f"static recovery field (policy, traced, group); only "
                    f"recovery.{SWEEP_VARYING_REC_FIELDS} may vary per "
                    f"cell (the policy itself only with recovery.traced)")
        buds = [s.lossbudget if s.lossbudget is not None else cfg.lossbudget
                for s in self.scenarios]
        for i, bc in enumerate(buds):
            if bc.enabled != cfg.lossbudget.enabled:
                raise ValueError(
                    f"scenario {i} differs from the sweep config in the "
                    f"static field lossbudget.enabled; only lossbudget."
                    f"{SWEEP_VARYING_BUD_FIELDS} may vary per cell")
        sels = [s.sel if s.sel is not None else cfg.sel
                for s in self.scenarios]
        for i, sc in enumerate(sels):
            if sc.traced != cfg.sel.traced \
                    or not (cfg.sel.traced or sc.policy == cfg.sel.policy):
                raise ValueError(
                    f"scenario {i} differs from the sweep config in a "
                    f"static selection field (policy, traced); only sel."
                    f"{SWEEP_VARYING_SEL_FIELDS} may vary per cell (the "
                    f"policy itself only with sel.traced)")
        srvs = [s.srv if s.srv is not None else cfg.srv
                for s in self.scenarios]
        for i, sv in enumerate(srvs):
            if sv.traced != cfg.srv.traced \
                    or sv.buffer_k != cfg.srv.buffer_k \
                    or not (cfg.srv.traced or sv.mode == cfg.srv.mode):
                raise ValueError(
                    f"scenario {i} differs from the sweep config in a "
                    f"static server field (mode, traced, buffer_k); only "
                    f"srv.{SWEEP_VARYING_SRV_FIELDS} may vary per cell (the "
                    f"mode itself only with srv.traced)")
        if cfg.tra.per_client_loss:
            if any(s.packet_loss is None for s in self.scenarios):
                raise ValueError("tra.per_client_loss needs per-client "
                                 "rates on every Scenario (packet_loss)")
            loss_rate = np.stack([np.asarray(s.packet_loss, np.float32)
                                  for s in self.scenarios])
        else:
            loss_rate = np.asarray([s.loss_rate for s in self.scenarios],
                                   np.float32)
        if (cfg.netsim.bw_ar1 or cfg.netsim.deadline) \
                and any(s.upload_mbps is None for s in self.scenarios):
            raise ValueError("netsim bandwidth/deadline models need "
                             "per-client speeds on every Scenario "
                             "(upload_mbps)")
        have_speeds = all(s.upload_mbps is not None for s in self.scenarios)
        if (cfg.sel.traced or cfg.sel.policy == "bandwidth_threshold") \
                and not have_speeds:
            raise ValueError(
                "the bandwidth_threshold selection score (and the traced "
                "policy family) needs per-client speeds on every Scenario "
                "(upload_mbps)")
        self._vstep, self._block = cached_sweep_step(
            cfg, self.cohort, self.data_batched)
        knobs = [scenario_knobs(cfg, *per) for per in
                 zip(nsims, flts, dfns, recs, buds, sels, srvs)]

        self.ctx = ScenarioCtx(
            base_key=torch.stack([prng.PRNGKey(s.seed, device=dev)
                                  for s in self.scenarios]),
            loss_rate=torch.tensor(loss_rate, device=dev),
            eligible=torch.tensor(np.stack(
                [np.asarray(s.eligible, bool) for s in self.scenarios]),
                device=dev),
            sufficient=torch.tensor(np.stack(
                [np.asarray(s.sufficient, np.float32)
                 for s in self.scenarios]), device=dev),
            data=self.dd,
            sel_logbw=torch.stack([static_logbw(s.upload_mbps, dev)
                                   for s in self.scenarios])
            if have_speeds else torch.zeros((self.n_scenarios, 0),
                                            device=dev),
            sel_qid=torch.stack([static_quartiles(s.upload_mbps, dev)
                                 for s in self.scenarios])
            if have_speeds else torch.zeros((self.n_scenarios, 0),
                                            dtype=torch.int32, device=dev),
            **{f: torch.tensor(np.stack([k[f] for k in knobs]), device=dev)
               for f in CTX_KNOB_FIELDS})

    @classmethod
    def from_configs(cls, cfgs: Sequence, datas, nets=None, *,
                     device=None) -> "SweepEngine":
        """A sweep of S per-scenario configs. Seeds, loss rates,
        eligibility and the netsim knobs may differ; the static
        structure must agree, or this raises.

        ``datas`` is one shared ``FederatedDataset`` or a length-S
        sequence; ``nets`` one shared ``ClientNetworks``, a length-S
        sequence, or None to sample from each scenario's seed (the
        ``FederatedServer`` default)."""
        cfgs = list(cfgs)
        S = len(cfgs)
        if S == 0:
            raise ValueError("empty config grid")
        sig0 = static_signature(cfgs[0])
        for i, c in enumerate(cfgs[1:], 1):
            if static_signature(c) != sig0:
                raise ValueError(
                    f"config {i} differs from config 0 in a static field; "
                    f"only {SWEEP_VARYING_FIELDS}, tra."
                    f"{SWEEP_VARYING_TRA_FIELDS}, netsim."
                    f"{SWEEP_VARYING_NETSIM_FIELDS}, sel."
                    f"{SWEEP_VARYING_SEL_FIELDS}, faults."
                    f"{SWEEP_VARYING_FAULT_FIELDS}, defense."
                    f"{SWEEP_VARYING_DEF_FIELDS}, recovery."
                    f"{SWEEP_VARYING_REC_FIELDS}, lossbudget."
                    f"{SWEEP_VARYING_BUD_FIELDS} and srv."
                    f"{SWEEP_VARYING_SRV_FIELDS} (and the selection or "
                    f"recovery policy or the server mode when traced) may "
                    f"vary in one sweep")
        if isinstance(datas, FederatedDataset):
            datas = [datas] * S
        if len(datas) != S:
            raise ValueError(f"expected {S} datasets, got {len(datas)}")
        if nets is None or not isinstance(nets, (list, tuple)):
            nets = [nets] * S
        if len(nets) != S:
            raise ValueError(f"expected {S} networks, got {len(nets)}")
        nets = [n if n is not None
                else sample_networks(np.random.default_rng(c.seed),
                                     d.n_clients)
                for c, d, n in zip(cfgs, datas, nets)]
        eligible = stage_network_scenarios(
            nets, [c.selection for c in cfgs],
            eligible_ratios=[c.eligible_ratio for c in cfgs],
            thresholds_mbps=[c.tra.threshold_mbps for c in cfgs]).numpy()
        scen = [Scenario(seed=c.seed, loss_rate=c.tra.loss_rate,
                         sufficient=tra_mod.sufficiency_report(
                             n, c.tra.threshold_mbps),
                         eligible=eligible[i], data=d, netsim=c.netsim,
                         packet_loss=n.packet_loss,
                         upload_mbps=n.upload_mbps, faults=c.faults,
                         defense=c.defense, recovery=c.recovery,
                         lossbudget=c.lossbudget, sel=c.sel, srv=c.srv)
                for i, (c, d, n) in enumerate(zip(cfgs, datas, nets))]
        return cls(cfgs[0], scen, device=device)

    # -- state --------------------------------------------------------------
    def init_states(self, params=None) -> EngineState:
        """Stacked per-scenario initial states. ``params`` is a list of
        S parameter dicts (e.g. the reference's weights through
        ``convert.params_from_jax``); None draws each scenario's
        ``mlp_init(PRNGKey(seed))``, as ``FederatedServer`` does."""
        dev = self.device
        if params is None:
            params = [mlp_init(prng.PRNGKey(s.seed, device=dev))
                      for s in self.scenarios]
        if len(params) != self.n_scenarios:
            raise ValueError(f"expected {self.n_scenarios} parameter "
                             f"sets, got {len(params)}")
        states = [init_engine_state(
            self.cfg, {k: v.to(dev) for k, v in p.items()}, self.n_clients,
            base_key=self.ctx.base_key[i], loss_rate=self.ctx.loss_rate[i],
            upload_mbps=s.upload_mbps, netsim=self._nsims[i])
            for i, (s, p) in enumerate(zip(self.scenarios, params))]
        return _stack_states(states)

    # -- execution ----------------------------------------------------------
    def run_block(self, states: EngineState, t0: int, k: int
                  ) -> Tuple[EngineState, Dict[str, np.ndarray]]:
        """Rounds [t0, t0+k) of all scenarios, one batched step per
        round; logs come to the host once, demuxed scenario-major.
        Returns (states, {"loss": (S, k), "ids": (S, k, C)[,
        "quarantine": (S, k, C)][, "arrival": (S, k, C)][, "tele/...":
        (S, k, ...)]})."""
        states, logs = self._block(self.ctx, states, t0, k)
        return states, {name: v.cpu().numpy() for name, v in logs.items()}

    def run(self, n_rounds: Optional[int] = None, params=None
            ) -> Tuple[EngineState, Dict[str, np.ndarray]]:
        """Whole-grid convenience: init, then every round in one block."""
        r = self.cfg.n_rounds if n_rounds is None else n_rounds
        return self.run_block(self.init_states(params), 0, r)


def _stack_states(states: Sequence[EngineState]) -> EngineState:
    """S states stacked field by field; the nested carries (the params
    dict, the netsim state, the arrival buffer and the telemetry's
    aggregates) leaf by leaf."""
    s0 = states[0]
    nested = ("net", "buf", "tele")
    fields = {name: torch.stack([getattr(s, name) for s in states])
              for name in EngineState._fields
              if name not in ("params",) + nested}
    fields.update({name: type(getattr(s0, name))(
        *(torch.stack(list(f)) for f in
          zip(*(getattr(s, name) for s in states)))) for name in nested})
    return EngineState(
        params={k: torch.stack([s.params[k] for s in states])
                for k in s0.params}, **fields)
