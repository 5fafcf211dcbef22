"""The bursty-loss grid on the PyTorch port: one batched sweep.

docs/EXPERIMENTS.md's burst-length x loss-rate grid (seeds {0, 1, 2} x
loss rate {0.1, 0.2, 0.3} x burst length {2, 8, 16}: 27 cells) of
FedAvg with TRA group_rate debias on the Gilbert-Elliott channel, run
through one ``run_grid`` call: every round is one vmapped round step
for all 27 cells, with one batched uplink launch and one
Gilbert-Elliott mask launch on the card. Prints the final sample
accuracy per cell and its mean and spread over seeds.

Runs on the card by default; pass --device cpu to run on the CPU (the
kernels' plain versions then stand in).

Run:  PYTHONPATH=src python examples/bursty_grid_torch.py [--device cpu]
                                                          [--rounds 60]
"""
import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core.server import FLConfig, run_grid
from repro_torch.core.tra import TRAConfig
from repro_torch.data.synthetic import generate_synthetic
from repro_torch.netsim.config import NetSimConfig


def grid(n_rounds):
    base = FLConfig(algo="fedavg", n_rounds=n_rounds, clients_per_round=10,
                    local_steps=10, eval_every=10 ** 6,
                    tra=TRAConfig(enabled=True, debias="group_rate"),
                    netsim=NetSimConfig(channel="gilbert_elliott"))
    return [dataclasses.replace(
        base, seed=seed, tra=dataclasses.replace(base.tra, loss_rate=rate),
        netsim=dataclasses.replace(base.netsim, burst_len=burst))
        for seed in (0, 1, 2) for rate in (0.1, 0.2, 0.3)
        for burst in (2.0, 8.0, 16.0)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=60)
    args = ap.parse_args()

    data = generate_synthetic(np.random.default_rng(7), n_clients=30,
                              alpha=1.0, beta=1.0)
    cfgs = grid(args.rounds)
    t0 = time.perf_counter()
    histories = run_grid(cfgs, data, device=args.device)
    secs = time.perf_counter() - t0
    by_cell = {}
    for cfg, hist in zip(cfgs, histories):
        acc = hist[-1].report.sample_average
        print(cfg.seed, cfg.tra.loss_rate, cfg.netsim.burst_len,
              f"{acc:.4f}")
        by_cell.setdefault((cfg.tra.loss_rate, cfg.netsim.burst_len),
                           []).append(acc)
    print("\nrate  burst  mean acc  std over seeds")
    for (rate, burst), accs in sorted(by_cell.items()):
        print(f"{rate:4.1f}  {burst:5.1f}  {np.mean(accs) * 100:7.2f}%  "
              f"{np.std(accs) * 100:6.2f}")
    print(f"\n{len(cfgs)} cells x {args.rounds} rounds in {secs:.2f} s "
          f"(first use of the batched step included)")


if __name__ == "__main__":
    main()
