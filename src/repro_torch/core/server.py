"""Federated server orchestration (thread Server of Algorithm 1).

Execution is delegated to the round engine (``core/engine.py``): the
whole round — client selection, vmapped local training over the cohort,
simulated lossy (TRA) or reliable uploads, and the debiased aggregate
fused with the error-feedback update in one kernel call — runs on the
server's device. ``run`` steps blocks of rounds between evaluation
boundaries; ``run_round`` runs the same step once per call, so the two
paths give the same result. ``run_grid`` runs a grid of same-shaped
scenario configs as one batched step per round (``core/sweep.py``).
Both take ``events=``, a JSONL path or an open ``EventWriter``
(``utils/events.py``), and stream the per-round telemetry records
(``core/telemetry.py``) there as blocks flush.

Eligibility (the paper's comparison axis):
  "all"        every client eligible (TRA's fair selection)
  "ratio"      top-X% of clients by upload speed (the paper's 70/80/90%)
  "threshold"  speed >= threshold_mbps (OpenMined-style 2 Mbps)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import client_updates as cu
from repro_torch.core import telemetry as tele_mod
from repro_torch.core import tra as tra_mod
from repro_torch.core.async_agg import AsyncConfig
from repro_torch.core.engine import (RoundScanEngine, _static_key,
                                     validate_device_config)
from repro_torch.core.fairness import FairnessReport, fairness_report
from repro_torch.core.lossbudget import LossBudgetConfig
from repro_torch.core.mlp import mlp_accuracy, mlp_init
from repro_torch.core.selection import SelectionConfig
from repro_torch.core.sweep import SweepEngine
from repro_torch.core.telemetry import TelemetryConfig
from repro_torch.core.tra import TRAConfig
from repro_torch.data.synthetic import (FederatedDataset, padded_eval_set,
                                        sample_batches)
from repro_torch.device import resolve_device
from repro_torch.netsim.config import NetSimConfig
from repro_torch.netsim.faults import DefenseConfig, FaultConfig
from repro_torch.netsim.recovery import RecoveryConfig
from repro_torch.network.trace import (ClientNetworks, eligible_by_ratio,
                                       eligible_by_threshold,
                                       eligible_mask_device, sample_networks)
from repro_torch.utils.events import EventWriter, fingerprint_of


@dataclasses.dataclass
class FLConfig:
    """The reference's top-level run configuration, for all six
    algorithms, the three server modes and the telemetry levels."""
    algo: str = "fedavg"  # fedavg|qfedavg|pfedme|perfedavg|afl|scaffold
    n_rounds: int = 100
    clients_per_round: int = 10
    local_steps: int = 20
    batch_size: int = 32
    lr: float = 0.1
    selection: str = "all"            # all|ratio|threshold
    eligible_ratio: float = 1.0       # for selection="ratio"
    # how the draw is weighted among the eligible: the score-based
    # policy family (core/selection.py), all eight policies, static or
    # traced; ``selection`` above gates eligibility
    sel: SelectionConfig = dataclasses.field(
        default_factory=SelectionConfig)
    tra: TRAConfig = dataclasses.field(default_factory=TRAConfig)
    # stateful network simulator: Gilbert-Elliott bursty loss, AR(1)
    # bandwidth walk, deadline delivery (the default is the iid channel
    # with both models off)
    netsim: NetSimConfig = dataclasses.field(default_factory=NetSimConfig)
    # server aggregation mode (core/async_agg.py): sync (the default),
    # semi_sync (a staleness-discounted grace window after the deadline)
    # or async (late uploads wait in a K-slot arrival buffer and land
    # discounted in the round they arrive); the non-sync modes need
    # netsim.deadline=True
    srv: AsyncConfig = dataclasses.field(default_factory=AsyncConfig)
    # uplink fault injection (netsim/faults.py) and the robust-aggregation
    # defenses against it (kernels/robust_agg); both off by default
    faults: FaultConfig = dataclasses.field(default_factory=FaultConfig)
    defense: DefenseConfig = dataclasses.field(
        default_factory=DefenseConfig)
    # loss-recovery policy family (netsim/recovery.py): one_shot (TRA,
    # the default), fec or arq; traced=True makes the policy a scenario
    # knob
    recovery: RecoveryConfig = dataclasses.field(
        default_factory=RecoveryConfig)
    # adaptive loss-budget controller (core/lossbudget.py); off by
    # default, and it needs recovery.traced
    lossbudget: LossBudgetConfig = dataclasses.field(
        default_factory=LossBudgetConfig)
    # device-resident telemetry (core/telemetry.py): "off" (the default)
    # builds none of it into the step; "scalars" logs the per-round
    # "tele/..." keys; "full" also carries per-client aggregates
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    # algorithm hyper-parameters (paper / source-code defaults)
    q: float = 1.0                    # q-FedAvg fairness exponent
    # q-FedAvg Lipschitz estimate (1.0 restores the paper's behaviour
    # with 10 local steps; see docs/EXPERIMENTS.md)
    lipschitz: float = 1.0
    pfedme_lam: float = 15.0
    pfedme_K: int = 5
    pfedme_eta: float = 0.05
    pfedme_beta: float = 1.0          # server mixing
    perfed_alpha: float = 0.01
    perfed_beta: float = 0.1
    afl_lr_lambda: float = 0.1
    # EF-TRA: clients keep their dropped coordinates and re-inject them
    # into the next upload
    error_feedback: bool = False
    seed: int = 0
    eval_every: int = 10
    # "scan" runs blocks of rounds between evaluations; "per_round"
    # runs one round per call (both run the same step)
    engine: str = "scan"

    def hyper(self) -> Dict[str, float]:
        return {
            "lr": self.lr, "lipschitz": self.lipschitz,
            "lam": self.pfedme_lam, "K": self.pfedme_K,
            "eta": self.pfedme_eta, "alpha": self.perfed_alpha,
            "beta_maml": self.perfed_beta,
        }


@dataclasses.dataclass
class RoundLog:
    round: int
    train_loss: float
    report: Optional[FairnessReport] = None
    # pFedMe / Per-FedAvg: the report of the per-client adapted models
    personalized: Optional[FairnessReport] = None


class FederatedServer:
    """Runs LT-FL on the paper's MLP / synthetic setting.

    ``device`` None means the card; without one the constructor raises
    (pass ``device="cpu"`` to run on the CPU). ``init_params`` replaces
    the seeded ``mlp_init`` draw, e.g. with the reference's weights
    (``convert.params_from_jax``)."""

    def __init__(self, cfg: FLConfig, data: FederatedDataset,
                 nets: Optional[ClientNetworks] = None, *, device=None,
                 init_params: Optional[Dict[str, torch.Tensor]] = None):
        if cfg.engine not in ("scan", "per_round"):
            raise ValueError(f"unknown engine {cfg.engine!r}")
        self.device = resolve_device(device)
        validate_device_config(cfg, self.device)
        self.cfg = cfg
        self.data = data
        self.rng = np.random.default_rng(cfg.seed)
        self.nets = nets if nets is not None else sample_networks(
            self.rng, data.n_clients)
        self.sufficient = tra_mod.sufficiency_report(
            self.nets, cfg.tra.threshold_mbps)
        dev = self.device
        self.eval_X, self.eval_Y, self.eval_W = (
            torch.from_numpy(a).to(dev) for a in padded_eval_set(data))
        elig = eligible_mask_device(
            torch.tensor(self.nets.upload_mbps, dtype=torch.float32,
                         device=dev),
            cfg.selection, eligible_ratio=cfg.eligible_ratio,
            threshold_mbps=cfg.tra.threshold_mbps)
        self.engine = RoundScanEngine(cfg, data, self.sufficient,
                                      elig.cpu().numpy(),
                                      upload_mbps=self.nets.upload_mbps,
                                      packet_loss=self.nets.packet_loss,
                                      device=dev)
        if init_params is None:
            init_params = mlp_init(prng.PRNGKey(cfg.seed, device=dev))
        self._state = self.engine.init_state(
            {k: v.to(dev) for k, v in init_params.items()})
        self._eval_fn = torch.func.vmap(mlp_accuracy,
                                        in_dims=(None, 0, 0, 0))
        self.history: List[RoundLog] = []

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return self._state.params

    @property
    def _ef_mem(self) -> np.ndarray:
        return self._state.ef_mem.cpu().numpy()

    @property
    def _c_global(self) -> np.ndarray:
        return self._state.c_global.cpu().numpy()

    @property
    def _c_i(self) -> np.ndarray:
        return self._state.c_i.cpu().numpy()

    @property
    def _lambda(self) -> np.ndarray:
        return self._state.lam.cpu().numpy()      # AFL state

    # -- selection ----------------------------------------------------------
    def eligible_mask(self) -> np.ndarray:
        """(N,) bool eligibility of ``cfg.selection`` on the host."""
        cfg = self.cfg
        if cfg.selection == "all":
            return np.ones(self.data.n_clients, bool)
        if cfg.selection == "ratio":
            return eligible_by_ratio(self.nets, cfg.eligible_ratio)
        if cfg.selection == "threshold":
            return eligible_by_threshold(self.nets, cfg.tra.threshold_mbps)
        raise ValueError(cfg.selection)

    def select(self) -> np.ndarray:
        """A host-side uniform cohort from the server's numpy generator
        (the engine selects on the device)."""
        elig = np.flatnonzero(self.eligible_mask())
        n = min(self.cfg.clients_per_round, len(elig))
        return self.rng.choice(elig, n, replace=False)

    # -- public API ---------------------------------------------------------
    def _open_events(self, events):
        """(writer, owned): an EventWriter passes through, a path is
        opened and stamped. The caller closes an owned writer."""
        if events is None or isinstance(events, EventWriter):
            return events, False
        cfg = self.cfg
        return EventWriter(
            events,
            config_fingerprint=fingerprint_of(_static_key(cfg)),
            meta={"n_clients": self.data.n_clients,
                  "n_rounds": cfg.n_rounds, "algo": cfg.algo,
                  "engine": cfg.engine,
                  "telemetry_level": cfg.telemetry.level},
            device=self.device), True

    def run_round(self, t: int) -> RoundLog:
        cfg = self.cfg
        self._state, ys = self.engine.run_single(self._state, t)
        self._last_ys = ys
        log = RoundLog(t, float(ys["loss"]))
        if (t + 1) % cfg.eval_every == 0 or t == cfg.n_rounds - 1:
            log.report = self.evaluate()
            if cfg.algo in cu.PERSONALIZE_FNS:
                log.personalized = self.evaluate_personalized()
        self.history.append(log)
        return log

    def run(self, events=None) -> List[RoundLog]:
        """Run all rounds. ``events`` (None, a JSONL path or an open
        ``EventWriter``) streams the typed per-round telemetry records
        as blocks flush, then, at level="full", each client's
        aggregates (a ``client_stats`` event), then the program-timing
        ledger (``program`` events)."""
        cfg = self.cfg
        writer, own = self._open_events(events)
        try:
            if cfg.engine == "per_round":
                for t in range(cfg.n_rounds):
                    self.run_round(t)
                    if writer is not None:
                        logs1 = {k: v.cpu().numpy()[None]
                                 for k, v in self._last_ys.items()}
                        for rec in tele_mod.records_from_logs(logs1, t0=t):
                            writer.write_round(rec)
            else:
                # blocks of rounds, cut at evaluation boundaries
                t = 0
                while t < cfg.n_rounds:
                    t1 = min((t // cfg.eval_every + 1) * cfg.eval_every,
                             cfg.n_rounds)
                    self._state, logs = self.engine.run_block(
                        self._state, t, t1 - t)
                    for i, loss in enumerate(logs["loss"]):
                        self.history.append(RoundLog(t + i, float(loss)))
                    if writer is not None:
                        for rec in tele_mod.records_from_logs(logs, t0=t):
                            writer.write_round(rec)
                    if t1 % cfg.eval_every == 0 or t1 == cfg.n_rounds:
                        self.history[-1].report = self.evaluate()
                        if cfg.algo in cu.PERSONALIZE_FNS:
                            self.history[-1].personalized = \
                                self.evaluate_personalized()
                    t = t1
            if writer is not None:
                if cfg.telemetry.level == "full":
                    writer.write("client_stats", {
                        "scenario": 0,
                        **tele_mod.final_client_stats(self._state.tele)})
                writer.write_program_stats(tele_mod.REGISTRY.stats())
        finally:
            if own and writer is not None:
                writer.close()
        return self.history

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, params=None) -> FairnessReport:
        p = self.params if params is None else params
        with torch.no_grad():
            acc, correct, n = self._eval_fn(p, self.eval_X, self.eval_Y,
                                            self.eval_W)
        return fairness_report(acc.cpu().numpy(), n.cpu().numpy(),
                               correct.cpu().numpy())

    def evaluate_personalized(self) -> FairnessReport:
        """Adapt the global model to every client, then evaluate
        (pFedMe's 'P' model, Per-FedAvg's test-time step). The batches
        come from the server's numpy generator, ``pfedme_K`` of them a
        client, as the reference draws them."""
        cfg = self.cfg
        X, Y = sample_batches(self.rng, self.data,
                              np.arange(self.data.n_clients), cfg.pfedme_K,
                              cfg.batch_size)
        dev = self.device
        hyper = cfg.hyper()
        fn = cu.PERSONALIZE_FNS[cfg.algo]
        per = torch.func.vmap(lambda p, x, y: fn(p, x, y, hyper),
                              in_dims=(None, 0, 0))(
            self.params, torch.from_numpy(X).to(dev),
            torch.from_numpy(Y).to(dev))
        with torch.no_grad():
            acc, correct, n = torch.func.vmap(mlp_accuracy)(
                per, self.eval_X, self.eval_Y, self.eval_W)
        return fairness_report(acc.cpu().numpy(), n.cpu().numpy(),
                               correct.cpu().numpy())


# ---------------------------------------------------------------------------
# grid execution: S scenario configs -> one batched round step
# ---------------------------------------------------------------------------
def _stacked_eval_sets(datas: Sequence[FederatedDataset], device):
    """Per-scenario padded eval sets, padded again to a common length
    and stacked: (S, N, M, ...), the mask keeps the padding out."""
    sets = [padded_eval_set(d) for d in datas]
    M = max(x.shape[1] for x, _, _ in sets)

    def _pad(a):
        return np.pad(a, ((0, 0), (0, M - a.shape[1]))
                      + ((0, 0),) * (a.ndim - 2))

    return tuple(torch.from_numpy(np.stack([_pad(a[i]) for a in sets]))
                 .to(device) for i in range(3))


def run_grid(cfgs: Sequence[FLConfig], datas, nets=None, *, device=None,
             init_params=None, events=None) -> List[List[RoundLog]]:
    """Run a grid of same-shaped scenario configs as one batched round
    step per round (``core/sweep.SweepEngine``) and demux per-scenario
    histories.

    Mirrors ``FederatedServer.run`` for each scenario: the same block
    boundaries, the same evaluation schedule, fairness reports at
    evaluation boundaries. ``datas`` / ``nets`` broadcast as in
    ``SweepEngine.from_configs``. ``device`` None means the card (raises
    without one); ``init_params`` is an optional list of S parameter
    dicts in place of each scenario's seeded ``mlp_init``.

    ``events`` (None, a JSONL path or an open ``EventWriter``) streams
    the per-scenario telemetry records (scenario-major within each
    block), then, at level="full", each scenario's per-client aggregates
    and the program-timing ledger.
    """
    engine = SweepEngine.from_configs(cfgs, datas, nets, device=device)
    cfg = engine.cfg
    S = engine.n_scenarios
    if events is None or isinstance(events, EventWriter):
        writer, own = events, False
    else:
        writer, own = EventWriter(
            events,
            config_fingerprint=fingerprint_of(_static_key(cfg)),
            meta={"n_scenarios": S, "n_rounds": cfg.n_rounds,
                  "algo": cfg.algo, "engine": "sweep",
                  "telemetry_level": cfg.telemetry.level},
            device=engine.device), True
    X, Y, W = _stacked_eval_sets([s.data for s in engine.scenarios],
                                 engine.device)
    eval_fn = torch.func.vmap(torch.func.vmap(mlp_accuracy,
                                              in_dims=(None, 0, 0, 0)))
    states = engine.init_states(init_params)
    histories: List[List[RoundLog]] = [[] for _ in range(S)]
    try:
        t = 0
        while t < cfg.n_rounds:
            t1 = min((t // cfg.eval_every + 1) * cfg.eval_every,
                     cfg.n_rounds)
            states, logs = engine.run_block(states, t, t1 - t)
            for s in range(S):
                for i in range(t1 - t):
                    histories[s].append(
                        RoundLog(t + i, float(logs["loss"][s, i])))
            if writer is not None:
                for rec in tele_mod.records_from_logs(logs, t0=t):
                    writer.write_round(rec)
            if t1 % cfg.eval_every == 0 or t1 == cfg.n_rounds:
                with torch.no_grad():
                    acc, correct, n = eval_fn(states.params, X, Y, W)
                acc, correct, n = (a.cpu().numpy()
                                   for a in (acc, correct, n))
                for s in range(S):
                    histories[s][-1].report = fairness_report(
                        acc[s], n[s], correct[s])
            t = t1
        if writer is not None:
            if cfg.telemetry.level == "full":
                stats = tele_mod.final_client_stats(states.tele)
                for s in range(S):
                    writer.write("client_stats", {
                        "scenario": s,
                        **{k: v[s] for k, v in stats.items()}})
            writer.write_program_stats(tele_mod.REGISTRY.stats())
    finally:
        if own and writer is not None:
            writer.close()
    return histories
