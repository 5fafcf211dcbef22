"""The paper's protocol layer as a per-round host loop, on the PyTorch port.

The counterpart of the reference's seed loop
(benchmarks/engine_bench.py::_rounds_per_sec_host_loop): Synthetic(1,1),
N = 100 clients, C = 10 a round, seed 7, the MLP at full width
(60 -> 128 -> 10, D = 9,098, P = 36 packets of 256 floats). Each round
picks the cohort with numpy, draws its batches, trains it under vmap and
aggregates through tra.simulate_uploads and tra.aggregate, one launch of
the tra_agg kernel on the card.

Both of the reference's settings run: 1 local step of 8 (dispatch-bound)
and 10 steps of 32 (the paper's), each twice: with every client
sufficient, as in the reference, so nothing is lost, and with the
clients' sufficiency report at the 2 Mbps threshold, so insufficient
clients lose 10% of their packets and the debias acts. --algo qfedavg
runs q-FedAvg's server step instead (one qfed_reweight launch a round).
Runs on the card by default; pass --device cpu to run on the CPU (the
kernels' plain versions then stand in).

Run:  PYTHONPATH=src python examples/protocol_round_torch.py [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.protocol import ALGOS, run_host_loop
from repro_torch.core.server import FLConfig
from repro_torch.core.tra import TRAConfig, sufficiency_report
from repro_torch.data.synthetic import generate_synthetic
from repro_torch.network.trace import sample_networks

N_CLIENTS = 100
CPR = 10
SEED = 7
SETTINGS = ((1, 8), (10, 32))     # (local steps, batch size)


def config(algo, rounds, local_steps, batch_size):
    return FLConfig(algo=algo, n_rounds=rounds, clients_per_round=CPR,
                    local_steps=local_steps, batch_size=batch_size,
                    eval_every=10 ** 6, seed=SEED,
                    tra=TRAConfig(enabled=True, loss_rate=0.1))


def dataset():
    """The reference bench's dataset, then the clients' networks from
    the same generator."""
    rng = np.random.default_rng(SEED)
    data = generate_synthetic(rng, n_clients=N_CLIENTS, alpha=1.0,
                              beta=1.0)
    return data, sample_networks(rng, N_CLIENTS)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=50)
    ap.add_argument("--algo", choices=ALGOS, default="fedavg")
    args = ap.parse_args()

    data, nets = dataset()
    report = sufficiency_report(nets)
    suffs = {"all": np.ones(N_CLIENTS, np.float32), "report": report}
    print(f"{N_CLIENTS} clients, {int(report.sum())} sufficient at the "
          f"2 Mbps threshold; {args.algo}, {args.rounds} rounds")
    for steps, bs in SETTINGS:
        # q-FedAvg's step is lossless: the report changes nothing there
        for name in suffs if args.algo == "fedavg" else ("all",):
            cfg = config(args.algo, args.rounds, steps, bs)
            # warm-up: the first vmap of the local step is slow
            run_host_loop(dataclasses.replace(cfg, n_rounds=2), data,
                          suffs[name], device=args.device)
            t0 = time.perf_counter()
            params, recs = run_host_loop(cfg, data, suffs[name],
                                         device=args.device)
            if params["w1"].is_cuda:
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            lost = "" if recs[0].pkt_mask is None else ", packets lost " \
                f"{np.mean([float(1 - r.pkt_mask.mean()) for r in recs]):.4f}"
            print(f"{steps:2d} x {bs:2d}, sufficiency {name:6s}: "
                  f"{args.rounds / secs:7.1f} rounds/s, first / last loss "
                  f"{recs[0].loss:.4f} / {recs[-1].loss:.4f}{lost}")


if __name__ == "__main__":
    main()
