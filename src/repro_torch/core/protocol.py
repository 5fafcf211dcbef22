"""The paper's protocol layer driven as a per-round host loop.

The counterpart of the reference's seed round loop
(``benchmarks/engine_bench.py::_rounds_per_sec_host_loop``): each round
picks its cohort with numpy's ``rng.choice``, draws the minibatches with
``sample_batches``, moves them to the device, derives the round's key
from ``hash((seed, t))``, trains the cohort under ``torch.func.vmap`` and
aggregates through the protocol layer's public functions:

  FedAvg    ``flatten_clients`` -> ``tra.simulate_uploads`` ->
            ``tra.aggregate`` (one ``tra_agg`` launch) -> ``unflatten_like``
  q-FedAvg  ``flatten_clients`` -> ``qfed_reweight`` (one launch) ->
            w - sum_k delta_k / sum_k h_k

The engine (``core/engine.py``) runs the same FedAvg round as one
device-resident step through the uplink megakernel; this loop keeps the
host in every round, as the seed did.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import tra as tra_mod
from repro_torch.core.client_updates import fedavg_local, qfedavg_local
from repro_torch.core.mlp import Params, mlp_init
from repro_torch.core.server import FLConfig
from repro_torch.data.synthetic import FederatedDataset, sample_batches
from repro_torch.device import resolve_device
from repro_torch.kernels.qfed_reweight.ops import qfed_reweight
from repro_torch.network.packets import flatten_update

ALGOS = ("fedavg", "qfedavg")


class RoundInputs(NamedTuple):
    """One round's host-side draws: the cohort, its minibatches
    (X (C, steps, bs, d), Y (C, steps, bs)), the normalised sample-count
    weights, the cohort's sufficiency bits and the round key's seed."""
    t: int
    ids: np.ndarray
    X: np.ndarray
    Y: np.ndarray
    weights: np.ndarray
    sufficient: np.ndarray
    key_seed: int


class RoundRecord(NamedTuple):
    """What a round reports: its cohort, mean initial loss and, for
    FedAvg, the (C, P) packet mask and (C,) kept fractions."""
    t: int
    ids: np.ndarray
    loss: float
    pkt_mask: Optional[torch.Tensor]
    kept: Optional[torch.Tensor]


def round_inputs(cfg: FLConfig, data: FederatedDataset,
                 sufficient: np.ndarray) -> Iterator[RoundInputs]:
    """The host draws of rounds 0 .. cfg.n_rounds - 1 from ``cfg.seed``,
    in the reference loop's order: cohort, batches, weights, key."""
    rng = np.random.default_rng(cfg.seed)
    C = cfg.clients_per_round
    for t in range(cfg.n_rounds):
        ids = rng.choice(data.n_clients, C, replace=False)
        X, Y = sample_batches(rng, data, ids, cfg.local_steps,
                              cfg.batch_size)
        w = data.samples_per_client[ids].astype(np.float32)
        yield RoundInputs(t, ids, X, Y, w / w.sum(),
                          np.asarray(sufficient, np.float32)[ids],
                          hash((cfg.seed, t)) % (2 ** 31))


def tra_round(params: Params, X, Y, weights, sufficient, key,
              cfg: FLConfig
              ) -> Tuple[Params, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One FedAvg + TRA round on the device of ``params``.

    Returns (new params, mean initial loss, pkt_mask (C, P), kept (C,)).
    """
    hyper = cfg.hyper()
    C = X.shape[0]
    uploads, aux = torch.func.vmap(
        lambda x, y: fedavg_local(params, x, y, hyper))(X, Y)
    flat = tra_mod.flatten_clients(uploads, C)
    masked, pkt_mask, kept = tra_mod.simulate_uploads(
        key, flat, sufficient, cfg.tra.loss_rate, cfg.tra.packet_floats)
    agg = tra_mod.aggregate(masked, pkt_mask, weights, sufficient, kept,
                            cfg.tra)
    return (tra_mod.unflatten_like(agg, params), aux["loss0"].mean(),
            pkt_mask, kept)


def qfed_round(params: Params, X, Y, cfg: FLConfig
               ) -> Tuple[Params, torch.Tensor]:
    """One q-FedAvg server step (lossless) on the device of ``params``:
    the cohort's pseudo-gradients, one ``qfed_reweight`` launch and
    w - sum_k delta_k / sum_k h_k. Returns (new params, mean initial
    loss)."""
    hyper = cfg.hyper()
    C = X.shape[0]
    dws, aux = torch.func.vmap(
        lambda x, y: qfedavg_local(params, x, y, hyper))(X, Y)
    delta, h = qfed_reweight(tra_mod.flatten_clients(dws, C), aux["loss0"],
                             cfg.q, cfg.lipschitz)
    w_vec, unravel = flatten_update(params)
    return unravel(w_vec - delta.sum(0) / h.sum()), aux["loss0"].mean()


def step(params: Params, inp: RoundInputs, cfg: FLConfig, device
         ) -> Tuple[Params, RoundRecord]:
    """Run round ``inp`` of ``cfg.algo`` from ``params``: the host draws
    go to ``device``, then one round of the protocol layer."""
    X = torch.from_numpy(inp.X).to(device)
    Y = torch.from_numpy(inp.Y).to(device)
    if cfg.algo == "fedavg":
        params, loss, pkt_mask, kept = tra_round(
            params, X, Y, torch.from_numpy(inp.weights).to(device),
            torch.from_numpy(inp.sufficient).to(device),
            prng.PRNGKey(inp.key_seed, device=device), cfg)
    else:
        params, loss = qfed_round(params, X, Y, cfg)
        pkt_mask = kept = None
    return params, RoundRecord(inp.t, inp.ids, float(loss), pkt_mask, kept)


def run_host_loop(cfg: FLConfig, data: FederatedDataset,
                  sufficient: np.ndarray, *, device=None
                  ) -> Tuple[Params, List[RoundRecord]]:
    """Run ``cfg.n_rounds`` rounds of ``cfg.algo`` (``fedavg`` with TRA,
    or ``qfedavg``'s server step) as the per-round host loop.

    ``sufficient`` is the (N,) 0/1 sufficiency report: ones reproduce
    the reference loop, where nothing is lost; ``tra.sufficiency_report``
    of the clients' networks lets insufficient clients lose packets.
    ``device`` None means the card (raises without one). Each round
    reads its loss back to the host, as the reference loop does.
    """
    if cfg.algo not in ALGOS:
        raise ValueError(f"the host loop runs {ALGOS}, not {cfg.algo!r}")
    dev = resolve_device(device)
    params = mlp_init(prng.PRNGKey(cfg.seed, device=dev))
    records = []
    for inp in round_inputs(cfg, data, sufficient):
        params, rec = step(params, inp, cfg, dev)
        records.append(rec)
    return params, records
