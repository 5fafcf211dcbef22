"""The corruption-tolerance grid on the PyTorch port: one batched sweep.

docs/EXPERIMENTS.md's fault-rate x defense recipe: FedAvg, N=20 clients,
C=12, TRA at 30% loss on the Gilbert-Elliott channel (burst 8) with a
60 s deadline, and three cells of one sweep: fault-free, 10% Gaussian
packet corruption + 10% NaN device failures undefended, and the same
faults with screen + clip + trimmed mean. Every round is one vmapped
round step for the three cells, with one batched robust-aggregation
launch and one Gilbert-Elliott mask launch on the card. Prints each
cell's final sample accuracy, its mean and bottom-quartile eval loss
and its quarantined packets.

Runs on the card by default; pass --device cpu to run on the CPU (the
kernels' plain versions then stand in).

Run:  PYTHONPATH=src python examples/fault_grid_torch.py [--device cpu]
                                                         [--rounds 40]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.mlp import mlp_weighted_loss
from repro_torch.core.server import FLConfig
from repro_torch.core.sweep import SweepEngine
from repro_torch.core.tra import TRAConfig
from repro_torch.data.synthetic import generate_synthetic, stage_on_device
from repro_torch.netsim.config import NetSimConfig
from repro_torch.netsim.faults import DefenseConfig, FaultConfig
from repro_torch.network.trace import ClientNetworks

CELLS = ("fault-free", "faulted, undefended", "faulted, screen+clip+trim")


def grid(n_rounds):
    base = FLConfig(algo="fedavg", n_rounds=n_rounds, clients_per_round=12,
                    local_steps=4, batch_size=16, eval_every=10 ** 6, seed=1,
                    tra=TRAConfig(enabled=True, loss_rate=0.3),
                    netsim=NetSimConfig(channel="gilbert_elliott",
                                        burst_len=8.0, deadline=True,
                                        deadline_s=60.0))
    faults = FaultConfig(enabled=True, corrupt_rate=0.1, corrupt_scale=0.5,
                         fail_rate=0.1)
    defense = DefenseConfig(screen=True, clip=True, clip_norm=20.0,
                            trim=True, trim_k=2)
    return [dataclasses.replace(base, faults=FaultConfig(enabled=True),
                                defense=DefenseConfig(trim_k=2)),
            dataclasses.replace(base, faults=faults,
                                defense=DefenseConfig(trim_k=2)),
            dataclasses.replace(base, faults=faults, defense=defense)]


def per_client_losses(params, data):
    """Each client's weighted loss over its first 64 training samples."""
    dev = next(iter(params.values())).device
    dd = stage_on_device(data, dev)
    L = min(64, dd.train_x.shape[1])
    msk = (torch.arange(L, device=dev)[None, :]
           < dd.counts[:, None]).float()
    with torch.no_grad():
        return torch.func.vmap(mlp_weighted_loss, in_dims=(None, 0, 0, 0))(
            params, dd.train_x[:, :L], dd.train_y[:, :L], msk).cpu().numpy()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=40)
    args = ap.parse_args()

    n = 20
    data = generate_synthetic(np.random.default_rng(0), n_clients=n,
                              alpha=0.5, beta=0.5)
    nets = ClientNetworks(np.linspace(0.5, 20.0, n), np.full(n, 0.05))
    t0 = time.perf_counter()
    eng = SweepEngine.from_configs(grid(args.rounds), data, nets,
                                   device=args.device)
    states, logs = eng.run()
    secs = time.perf_counter() - t0
    q = n // 4
    print("cell                        mean loss  bottom-quartile  "
          "quarantined")
    for i, name in enumerate(CELLS):
        losses = per_client_losses(
            {k: v[i] for k, v in states.params.items()}, data)
        print(f"{name:27s} {losses.mean():9.4f}  "
              f"{np.sort(losses)[-q:].mean():15.4f}  "
              f"{int(logs['quarantine'][i].sum()):11d}")
    print(f"\n3 cells x {args.rounds} rounds in {secs:.2f} s "
          f"(first use of the batched step included)")


if __name__ == "__main__":
    main()
