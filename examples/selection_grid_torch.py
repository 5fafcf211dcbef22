"""The selection-policy x loss-rate grid on the PyTorch port.

docs/EXPERIMENTS.md's selection-bias grid: every selection policy x
loss rate {0.1, 0.2, 0.3} (24 cells) of FedAvg with TRA group_rate
debias on the Gilbert-Elliott channel, N = 30 clients on the FCC draw
(seed 2026), C = 10, 60 rounds. ``sel.traced`` makes the policy a
scenario knob, so ``run_grid`` plays the whole grid as one batched
round step a round: one batched uplink launch and one Gilbert-Elliott
mask launch on the card. Temperatures: 0.05 for the two 0/1 scores
(bandwidth_threshold is the paper's hard threshold), 0.5 for the other
scores, 1.0 for uniform. Policies whose score source this grid lacks
(the deadline, the fault model, the controller) score zeros and sample
uniformly.

Prints each cell's final accuracy (sample average), the variance of
the clients' accuracies, and the bottom bandwidth quartile's share of
the cohort slots. ``run_grid`` keeps the losses and the reports; the
cohorts come from a second run of the same grid through the
``SweepEngine`` (the same step on the same inputs, so the same cohorts).

Runs on the card by default; pass --device cpu to run on the CPU (the
kernels' plain versions then stand in).

Run:  PYTHONPATH=src python examples/selection_grid_torch.py
          [--device cpu] [--rounds 60]
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core.selection import POLICIES, SelectionConfig
from repro_torch.core.server import FLConfig, run_grid
from repro_torch.core.sweep import SweepEngine
from repro_torch.core.tra import TRAConfig
from repro_torch.data.synthetic import generate_synthetic
from repro_torch.netsim.config import NetSimConfig
from repro_torch.network.trace import sample_networks

N_CLIENTS = 30
LOSS_RATES = (0.1, 0.2, 0.3)
TEMPERATURES = {"uniform": 1.0, "bandwidth_threshold": 0.05,
                "netsim_state": 0.05}       # the score policies: 0.5


def inputs():
    """The grid's dataset (seed 7) and FCC network draw (seed 2026)."""
    data = generate_synthetic(np.random.default_rng(7), n_clients=N_CLIENTS,
                              alpha=0.5, beta=0.5)
    return data, sample_networks(np.random.default_rng(2026), N_CLIENTS)


def grid(n_rounds):
    """The 24 traced cells, policy-major."""
    base = FLConfig(algo="fedavg", n_rounds=n_rounds, clients_per_round=10,
                    local_steps=10, eval_every=10 ** 6,
                    tra=TRAConfig(enabled=True, debias="group_rate"),
                    netsim=NetSimConfig(channel="gilbert_elliott"))
    return [dataclasses.replace(
        base, sel=SelectionConfig(policy=p, traced=True,
                                  temperature=TEMPERATURES.get(p, 0.5)),
        tra=dataclasses.replace(base.tra, loss_rate=rate))
        for p in POLICIES for rate in LOSS_RATES]


def bottom_quartile_share(ids, upload_mbps):
    """The share of cohort slots (over rounds) that went to the slowest
    quarter of the clients."""
    n = len(upload_mbps)
    bottom = np.argsort(upload_mbps)[:n // 4]
    return float(np.isin(ids, bottom).mean())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=60)
    args = ap.parse_args()

    data, nets = inputs()
    cfgs = grid(args.rounds)
    t0 = time.perf_counter()
    histories = run_grid(cfgs, data, nets, device=args.device)
    secs = time.perf_counter() - t0
    _, logs = SweepEngine.from_configs(cfgs, data, nets,
                                       device=args.device).run()
    print("policy               loss  accuracy  variance  bottom-25% share")
    for i, (cfg, hist) in enumerate(zip(cfgs, histories)):
        rep = hist[-1].report
        share = bottom_quartile_share(logs["ids"][i], nets.upload_mbps)
        print(f"{cfg.sel.policy:20s} {cfg.tra.loss_rate:4.1f}  "
              f"{rep.sample_average * 100:7.2f}%  {rep.variance:8.1f}  "
              f"{share:6.3f}")
    print(f"\n{len(cfgs)} cells x {args.rounds} rounds through run_grid in "
          f"{secs:.2f} s (first use of the batched step included)")


if __name__ == "__main__":
    main()
