"""Paper §5 'Personalization' on the PyTorch port: TRA-pFedMe against
biased pFedMe (Fig. 9), as examples/personalization_pfedme.py runs it
for the JAX package.

pFedMe trains personalized models theta_i around a global model w via
Moreau envelopes. Threshold selection degrades the GLOBAL model badly
while personalized accuracy is resilient; TRA recovers the global model
at a small personalized cost.

Each round's uplink runs the CUDA megakernel. Runs on the card by
default; pass --device cpu to run on the CPU (the kernel's plain
version then stands in).

Run:  PYTHONPATH=src python examples/personalization_pfedme_torch.py
      [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.server import FederatedServer, FLConfig
from repro_torch.core.tra import TRAConfig
from repro_torch.data.synthetic import generate_synthetic
from repro_torch.network.trace import sample_networks


def run(label, data, nets, device, **kw):
    cfg = FLConfig(algo="pfedme", n_rounds=40, clients_per_round=10,
                   local_steps=10, eval_every=10 ** 6, **kw)
    s = FederatedServer(cfg, data, nets, device=device)
    s.run()
    g = s.evaluate()
    p = s.evaluate_personalized()
    print(f"{label:26s} global={g.average*100:5.1f}%  "
          f"personalized={p.average*100:5.1f}%")
    return g, p


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()

    rng = np.random.default_rng(1)
    data = generate_synthetic(rng, n_clients=30, alpha=0.5, beta=0.5)
    nets = sample_networks(rng, data.n_clients)
    gb, pb = run("pFedMe, biased 70%", data, nets, args.device,
                 selection="ratio", eligible_ratio=0.7,
                 tra=TRAConfig(enabled=False))
    gt, pt = run("TRA-pFedMe, 10% loss", data, nets, args.device,
                 selection="all", tra=TRAConfig(enabled=True, loss_rate=0.1))
    print(f"\nglobal model gain from TRA: "
          f"{(gt.average-gb.average)*100:+.1f}pp "
          f"(personalized cost: {(pt.average-pb.average)*100:+.1f}pp)")


if __name__ == "__main__":
    main()
