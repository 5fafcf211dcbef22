"""The full-duplex recovery grid on the PyTorch port: one batched sweep.

docs/EXPERIMENTS.md's recovery-policy x loss-rate recipe: FedAvg, N=20
clients, C=12, 4 local steps of 16, TRA on the Gilbert-Elliott uplink
(burst 8) at loss {0.1, 0.3}, a 30% Gilbert-Elliott downlink with the
stale-model fallback, 40 rounds, and the recovery policy {one_shot, fec,
arq} traced, so the 6 cells are one ``run_grid`` call: every round is
one vmapped round step for all cells, with one batched uplink launch,
two Gilbert-Elliott mask launches (uplink and downlink) and one FEC
repair launch on the card. Prints each cell's final sample accuracy,
average and worst-10% accuracy, and its mean and bottom-quartile eval
loss.

Runs on the card by default; pass --device cpu to run on the CPU (the
kernels' plain versions then stand in).

Run:  PYTHONPATH=src python examples/recovery_grid_torch.py [--device cpu]
                                                            [--rounds 40]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.mlp import mlp_weighted_loss
from repro_torch.core.server import FLConfig, run_grid
from repro_torch.core.sweep import SweepEngine
from repro_torch.core.tra import TRAConfig
from repro_torch.data.synthetic import generate_synthetic, padded_eval_set
from repro_torch.netsim.config import NetSimConfig
from repro_torch.netsim.recovery import RECOVERY_POLICIES, RecoveryConfig
from repro_torch.network.trace import ClientNetworks


def grid(n_rounds):
    base = FLConfig(algo="fedavg", n_rounds=n_rounds, clients_per_round=12,
                    local_steps=4, batch_size=16, eval_every=10 ** 6, seed=1,
                    tra=TRAConfig(enabled=True, loss_rate=0.3),
                    netsim=NetSimConfig(channel="gilbert_elliott",
                                        burst_len=8.0,
                                        down_channel="gilbert_elliott",
                                        down_fallback="stale",
                                        down_loss=0.3))
    return [dataclasses.replace(
        base, tra=TRAConfig(enabled=True, loss_rate=rate),
        recovery=RecoveryConfig(policy=policy, traced=True))
        for policy in RECOVERY_POLICIES for rate in (0.1, 0.3)]


def inputs():
    n = 20
    data = generate_synthetic(np.random.default_rng(0), n_clients=n,
                              alpha=0.5, beta=0.5)
    return data, ClientNetworks(np.linspace(0.5, 20.0, n), np.full(n, 0.05))


def eval_losses(params, data):
    """Each client's weighted loss on its padded eval set."""
    dev = next(iter(params.values())).device
    X, Y, W = (torch.from_numpy(a).to(dev) for a in padded_eval_set(data))
    with torch.no_grad():
        return torch.func.vmap(mlp_weighted_loss, in_dims=(None, 0, 0, 0))(
            params, X, Y, W).cpu().numpy()


def mean_and_bottom_quartile(losses):
    k = max(1, losses.size // 4)
    return float(losses.mean()), float(np.sort(losses)[-k:].mean())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args()

    data, nets = inputs()
    cfgs = grid(args.rounds)
    t0 = time.perf_counter()
    histories = run_grid(cfgs, data, nets, device=args.device)
    secs = time.perf_counter() - t0
    # the same cells once more through the sweep, for the final weights
    states, _ = SweepEngine.from_configs(cfgs, data, nets,
                                         device=args.device).run()
    print("policy    loss  sample acc  avg acc  worst10%  mean eval loss  "
          "bottom-quartile")
    for i, (cfg, hist) in enumerate(zip(cfgs, histories)):
        rep = hist[-1].report
        mean, bq = mean_and_bottom_quartile(
            eval_losses({k: v[i] for k, v in states.params.items()}, data))
        print(f"{cfg.recovery.policy:8s}  {cfg.tra.loss_rate:4.1f}  "
              f"{rep.sample_average * 100:9.2f}%  {rep.average * 100:6.2f}%  "
              f"{rep.worst10 * 100:7.2f}%  {mean:14.4f}  {bq:15.4f}")
    print(f"\n{len(cfgs)} cells x {args.rounds} rounds through run_grid in "
          f"{secs:.2f} s (first use of the batched step included)")


if __name__ == "__main__":
    main()
