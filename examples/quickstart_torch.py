"""Quickstart on the PyTorch port: loss-tolerant FL on one GPU.

Trains the paper's MLP on Synthetic(1,1) three ways and prints the
fairness comparison, as examples/quickstart.py does for the JAX
package:
  1. threshold-based selection (70% eligible ratio)  — the baseline the
     paper criticises,
  2. TRA with 10% packet loss                         — the paper's fix,
  3. ideal lossless full participation                — the upper bound.

Each round's uplink runs the CUDA megakernel. Runs on the card by
default; pass --device cpu to run on the CPU (the kernel's plain
version then stands in).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.server import FederatedServer, FLConfig
from repro_torch.core.tra import TRAConfig
from repro_torch.data.synthetic import generate_synthetic
from repro_torch.network.trace import sample_networks

ROUNDS = 50


def run(label, data, nets, device, **kw):
    cfg = FLConfig(algo="qfedavg", n_rounds=ROUNDS, clients_per_round=10,
                   local_steps=10, eval_every=10 ** 6, **kw)
    server = FederatedServer(cfg, data, nets, device=device)
    server.run()
    rep = server.evaluate()
    print(f"{label:28s} acc={rep.average*100:5.1f}%  "
          f"worst10%={rep.worst10*100:5.1f}%  var={rep.variance:6.0f}")
    return rep


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    data = generate_synthetic(rng, n_clients=30, alpha=1.0, beta=1.0)
    nets = sample_networks(rng, data.n_clients)
    print(f"cohort: {data.n_clients} clients, "
          f"{(nets.upload_mbps < 2).sum()} below the 2 Mbps threshold\n")
    biased = run("threshold (70% eligible)", data, nets, args.device,
                 selection="ratio", eligible_ratio=0.7,
                 tra=TRAConfig(enabled=False))
    tra = run("TRA, 10% packet loss", data, nets, args.device,
              selection="all", tra=TRAConfig(enabled=True, loss_rate=0.1))
    run("ideal lossless", data, nets, args.device, selection="all",
        tra=TRAConfig(enabled=False))

    assert tra.worst10 >= biased.worst10, "TRA should lift the worst clients"
    print("\nTRA recovers most of the fairness the threshold threw away.")


if __name__ == "__main__":
    main()
