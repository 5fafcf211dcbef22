"""Round engine: one federated round as a step over device tensors.

Everything a round needs lives on the engine's device for the whole
run: the staged training data, the eligibility and sufficiency masks,
the PRNG root and the per-client state (error-feedback memory, AFL
weights). One round is:

  * PRNG         — one uniform block from ``fold_in(base_key, t)``,
                   keyed on the absolute round index: N selection draws,
                   then C·steps·bs batch draws, then C·P TRA draws
                   (the reference's layout, bit for bit),
  * selection    — uniform Gumbel-top-k over the eligibility mask,
  * local train  — FedAvg / q-FedAvg SGD, ``torch.func.vmap``ped over
                   the cohort,
  * TRA uplink   — the i.i.d. packet-loss mask with the sufficiency
                   override, then ONE ``uplink_round`` call: EF
                   re-inject, debias aggregate, new EF rows and the
                   q-FedAvg norms (the CUDA megakernel on the card),
  * server step  — FedAvg's weighted mean or q-FedAvg's h-normalised
                   step.

This slice ports the reference's round at its default configuration:
iid channel, uniform selection, sync server, no faults, no telemetry,
one-shot recovery, no downlink model. ``run_block`` is a Python loop
over the same step ``run_single`` runs, so the block and per-round
paths agree by construction.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.core import client_updates as cu
from repro_torch.core.selection import select_from_uniforms
from repro_torch.core.tra import flatten_clients, unflatten_like
from repro_torch.data.synthetic import DeviceDataset, stage_on_device
from repro_torch.kernels.uplink_fused import ops as uplink_ops
from repro_torch.network.packets import n_packets

ENGINE_ALGOS = ("fedavg", "qfedavg")


class EngineState(NamedTuple):
    """Per-run state threaded through the rounds."""
    params: Dict[str, torch.Tensor]   # model parameters, leaf order
    ef_mem: torch.Tensor   # (N, D) error-feedback memory, or (0,)
    lam: torch.Tensor      # (N,) AFL mixture weights (always allocated)


class ScenarioCtx(NamedTuple):
    """The scenario's inputs to every round, on the engine's device."""
    base_key: torch.Tensor   # (2,) PRNG root of the fold_in chain
    loss_rate: torch.Tensor  # () f32 nominal drop rate, or (N,) per client
    eligible: torch.Tensor   # (N,) bool selection mask
    sufficient: torch.Tensor  # (N,) f32 1-bit sufficiency reports
    data: DeviceDataset      # staged train set


def validate_round_config(cfg) -> None:
    """Raise for the configurations this slice has not ported."""
    if cfg.algo not in ENGINE_ALGOS:
        raise NotImplementedError(
            f"algo {cfg.algo!r} is not ported to repro_torch yet "
            f"(ported: {ENGINE_ALGOS})")
    if cfg.sel.traced or cfg.sel.policy != "uniform":
        raise NotImplementedError(
            "only the uniform selection policy is ported to repro_torch")


def init_engine_state(cfg, params, n_clients: int) -> EngineState:
    """Fresh state for one run. ``params`` are copied: the step updates
    the EF memory in place, and the caller's tensors stay untouched."""
    params = {k: v.detach().clone() for k, v in params.items()}
    dev = next(iter(params.values())).device
    D = sum(v.numel() for v in params.values())
    return EngineState(
        params=params,
        ef_mem=torch.zeros((n_clients, D), device=dev)
        if cfg.error_feedback else torch.zeros((0,), device=dev),
        lam=torch.ones((n_clients,), device=dev) / n_clients)


def make_round_step(cfg, cohort: int):
    """Build ``step(ctx, state, t) -> (state, logs)`` for one round."""
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

    def step(ctx: ScenarioCtx, state: EngineState, t: int):
        dd = ctx.data
        N = dd.counts.shape[0]
        params = state.params
        old_vec = flatten_clients(params, 1)[0]
        D_up = old_vec.shape[0]
        P = n_packets(D_up, Fp)
        n_batch = C * steps * bs
        # one threefry invocation covers the whole round
        key = prng.fold_in(ctx.base_key, t)
        u_all = prng.uniform(key, (N + n_batch + C * P,),
                             minval=1e-12, maxval=1.0)
        u_sel = u_all[:N]
        u_idx = u_all[N:N + n_batch].reshape(C, steps, bs)
        u_tra = u_all[N + n_batch:].reshape(C, P)

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

        pad = P * Fp - D_up
        xp = F.pad(flat, (0, pad)).reshape(C, P, Fp)
        lr_c = ctx.loss_rate if ctx.loss_rate.dim() == 0 \
            else ctx.loss_rate[ids]
        lr_col = lr_c if lr_c.dim() == 0 else lr_c[:, None]
        if tra_cfg.enabled:
            lost = (u_tra < lr_col) & ~suff.bool()[:, None]
            pkt_mask = 1.0 - lost.float()
        else:
            pkt_mask = torch.ones((C, P), device=xp.device)

        kept = None
        if debias == "per_client_rate":
            # coordinate-weighted kept fraction (last packet partial)
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

        agg, new_ef_rows, ssq = uplink_ops.uplink_round(
            xp, pkt_mask, w_agg, mode=debias, d_up=D_up,
            ef_rows=state.ef_mem[ids] if ef else None, kept=kept,
            sufficient=suff, loss_rate=lr_c, mult=mult, want_ssq=want_ssq)
        if ef:
            # in place: the (N, D) memory is never copied per round
            state.ef_mem.index_copy_(0, ids, new_ef_rows)

        if algo == "qfedavg":
            # delta_k = F_k^q dw_k;  h_k = q F^(q-1)||dw||^2 + L F^q
            h = cfg.q * torch.pow(aux["loss0"] + eps, cfg.q - 1) * ssq \
                + cfg.lipschitz * fq
            # debiased SUM of deltas = debiased mean * C
            new_vec = old_vec - agg * C / torch.clamp(h.sum(), min=1e-8)
        else:  # fedavg: weighted mean of the uploaded models
            new_vec = agg
        new_params = unflatten_like(new_vec, params)
        logs = {"loss": aux["loss0"].mean(), "ids": ids}
        return EngineState(new_params, state.ef_mem, state.lam), logs

    return step


class RoundScanEngine:
    """Round executor for one (config, dataset, network) scenario.

    Callers own the ``EngineState`` and thread it through
    ``run_single`` / ``run_block``; the EF memory it holds is updated in
    place, so use the returned state and drop the old one.
    """

    def __init__(self, cfg, data, sufficient: np.ndarray,
                 eligible: np.ndarray, *,
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
        dev = self.device
        self.ctx = ScenarioCtx(
            base_key=prng.PRNGKey(cfg.seed, device=dev),
            loss_rate=torch.tensor(loss_rate, device=dev),
            eligible=torch.tensor(eligible, device=dev),
            sufficient=torch.tensor(np.asarray(sufficient, np.float32),
                                    device=dev),
            data=self.dd)
        self._step = make_round_step(cfg, self.cohort)   # validates cfg

    def init_state(self, params) -> EngineState:
        return init_engine_state(self.cfg, params, self.n_clients)

    def run_single(self, state: EngineState, t: int
                   ) -> Tuple[EngineState, Dict[str, torch.Tensor]]:
        """One round at absolute index ``t``."""
        return self._step(self.ctx, state, t)

    def run_block(self, state: EngineState, t0: int, k: int
                  ) -> Tuple[EngineState, Dict[str, np.ndarray]]:
        """Rounds [t0, t0+k); logs come to the host once, at the end.
        Returns (state, {"loss": (k,), "ids": (k, C)})."""
        losses, ids = [], []
        for t in range(t0, t0 + k):
            state, logs = self._step(self.ctx, state, t)
            losses.append(logs["loss"])
            ids.append(logs["ids"])
        return state, {"loss": torch.stack(losses).cpu().numpy(),
                       "ids": torch.stack(ids).cpu().numpy()}
