"""How sensitive is one federated round to float noise in its input?

Runs the quickstart's TRA configuration (q-FedAvg, N=30, C=10, 10 local
steps of 32, 10% loss) on the PyTorch port, on the CPU. At every round it runs the
step from the same state once as is and ``--trials`` times with every
parameter scaled by (1 + 1e-7 * z), z standard normal from a fixed
seed. It prints the largest parameter gap after that one round. Most
rounds carry a 1e-7 perturbation through at the 1e-7 level. A round
where a ReLU pre-activation sits within float noise of zero jumps far
above that. Past such a round, runs whose float work is summed in
another order (the JAX reference, the card, another BLAS) part for
good.

Run:  PYTHONPATH=src python tools/torch_sensitivity_probe.py [--rounds 20]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.server import FederatedServer, FLConfig
from repro_torch.core.tra import TRAConfig
from repro_torch.data.synthetic import generate_synthetic
from repro_torch.network.trace import sample_networks


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--trials", type=int, default=4)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    data = generate_synthetic(rng, n_clients=30, alpha=1.0, beta=1.0)
    nets = sample_networks(rng, data.n_clients)
    cfg = FLConfig(algo="qfedavg", n_rounds=args.rounds,
                   clients_per_round=10, local_steps=10,
                   selection="all", tra=TRAConfig(enabled=True,
                                                  loss_rate=0.1))
    server = FederatedServer(cfg, data, nets, device="cpu")
    engine = server.engine
    state = engine.init_state(server.params)
    gen = torch.Generator().manual_seed(0)
    print("round  max |param gap| after one round from 1e-7 perturbations")
    for t in range(args.rounds):
        outs = []
        for _ in range(args.trials):
            noisy = {k: v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))
                     for k, v in state.params.items()}
            outs.append(engine.run_single(
                state._replace(params=noisy, ef_mem=state.ef_mem.clone()),
                t)[0])
        state, _ = engine.run_single(state, t)
        gap = max(float((a.params[k] - state.params[k]).abs().max())
                  for a in outs for k in state.params)
        print(f"{t:5d}  {gap:.3e}")


if __name__ == "__main__":
    main()
