"""The sync / semi_sync / async server grid on the PyTorch port.

docs/EXPERIMENTS.md's straggler-tolerance grid: the three server modes x
loss rate {0.1, 0.3} (6 cells) of FedAvg with EF and TRA group_rate
debias on the Gilbert-Elliott channel (burst 8), N = 20 clients with
upload speeds from 0.5 to 20 Mbps, C = 8, 40 rounds, under a 0.1 s
deadline that the slowest clients can never meet. ``srv.traced`` makes
the mode a scenario knob, so ``run_grid`` plays the whole grid as one
batched round step a round: one batched uplink launch and one
Gilbert-Elliott mask launch on the card. The async cells keep a K = 16
arrival buffer with staleness exponent 0.5; semi_sync gives a 0.2 s
grace window.

Prints each cell's final accuracy (sample average) and the arrival mass
of the slowest quarter of the clients: the sum of their per-round
arrival weights (1 on time, 0 dropped, the staleness discount of a
late upload), and its share of all arrival mass. Sync gives them none;
async keeps them. ``run_grid`` keeps the losses and the reports; the
arrival weights come from a second run of the same grid through the
``SweepEngine`` (the same step on the same inputs).

Runs on the card by default; pass --device cpu to run on the CPU (the
kernels' plain versions then stand in).

Run:  PYTHONPATH=src python examples/async_grid_torch.py
          [--device cpu] [--rounds 40]
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core.async_agg import MODES, AsyncConfig
from repro_torch.core.server import FLConfig, run_grid
from repro_torch.core.sweep import SweepEngine
from repro_torch.core.tra import TRAConfig
from repro_torch.data.synthetic import generate_synthetic
from repro_torch.netsim.config import NetSimConfig
from repro_torch.network.trace import ClientNetworks

N_CLIENTS = 20
LOSS_RATES = (0.1, 0.3)
DEADLINE_S = 0.1


def inputs():
    """The grid's dataset (seed 1) and its ordered speeds."""
    data = generate_synthetic(np.random.default_rng(1), n_clients=N_CLIENTS,
                              alpha=0.5, beta=0.5)
    return data, ClientNetworks(np.linspace(0.5, 20.0, N_CLIENTS),
                                np.full(N_CLIENTS, 0.05))


def grid(n_rounds):
    """The 6 traced cells, mode-major."""
    base = FLConfig(algo="fedavg", n_rounds=n_rounds, clients_per_round=8,
                    eval_every=10 ** 6, error_feedback=True,
                    tra=TRAConfig(enabled=True),
                    netsim=NetSimConfig(channel="gilbert_elliott",
                                        burst_len=8.0, deadline=True,
                                        deadline_s=DEADLINE_S))
    return [dataclasses.replace(
        base, srv=AsyncConfig(mode=m, traced=True, buffer_k=16,
                              staleness_alpha=0.5, grace_s=0.2),
        tra=dataclasses.replace(base.tra, loss_rate=rate))
        for m in MODES for rate in LOSS_RATES]


def slow_quartile(upload_mbps):
    """The slowest quarter of the clients."""
    return np.argsort(upload_mbps)[:len(upload_mbps) // 4]


def arrival_mass(ids, arrival, n_clients):
    """(N,) sum of each client's arrival weights over the rounds."""
    mass = np.zeros(n_clients)
    np.add.at(mass, np.asarray(ids).ravel(), np.asarray(arrival).ravel())
    return mass


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
    _, logs = SweepEngine.from_configs(cfgs, data, nets,
                                       device=args.device).run()
    slow = slow_quartile(nets.upload_mbps)
    print("mode       loss  accuracy  slow-25% arrival mass  share")
    for i, (cfg, hist) in enumerate(zip(cfgs, histories)):
        mass = arrival_mass(logs["ids"][i], logs["arrival"][i], N_CLIENTS)
        print(f"{cfg.srv.mode:10s} {cfg.tra.loss_rate:4.1f}  "
              f"{hist[-1].report.sample_average * 100:7.2f}%  "
              f"{mass[slow].sum():21.3f}  {mass[slow].sum() / mass.sum():5.3f}")
    print(f"\n{len(cfgs)} cells x {args.rounds} rounds through run_grid in "
          f"{secs:.2f} s (first use of the batched step included)")


if __name__ == "__main__":
    main()
