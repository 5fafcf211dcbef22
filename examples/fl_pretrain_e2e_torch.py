"""END-TO-END DRIVER, port: federated pre-training of a ~100M-param
transformer for a few hundred steps with the TRA protocol in the loop
(``examples/fl_pretrain_e2e.py`` on ``repro_torch``).

A 4-client cohort collaboratively trains a widened reduced StableLM on
a synthetic token stream; clients 0 and 1 are 'insufficient' (20%
packet loss on every upload), aggregation uses the per-coordinate
debias. Loss must decrease and stay finite through packet loss — the
paper's core claim at the systems level.

Run:  PYTHONPATH=src python examples/fl_pretrain_e2e_torch.py [--steps 200]
on the card; ``--device cpu`` runs it on the CPU (slowly at this width:
try ``--steps 30 --seq 32``).
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import prng
from repro_torch.configs.base import TrainConfig, get_config
from repro_torch.core.tra import TRAConfig
from repro_torch.device import resolve_device
from repro_torch.launch.fl_train import make_fl_train_step
from repro_torch.models import transformer as T

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--clients", type=int, default=4)
ap.add_argument("--batch", type=int, default=4)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--device", default=None,
                help="torch device; default the card (raises without one)")
args = ap.parse_args()
dev = resolve_device(args.device)

# ~100M params: widen the reduced config
cfg = dataclasses.replace(
    get_config("stablelm-3b").reduced(),
    n_layers=4, d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=32_000)
n_params = cfg.n_params()
print(f"model: {n_params/1e6:.1f}M params, cohort={args.clients} clients "
      f"on {dev}")

tcfg = TrainConfig(lr=3e-4)
tra = TRAConfig(loss_rate=0.2, debias="per_coord_count")
C = args.clients
params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
step, opt = make_fl_train_step(cfg, tcfg, tra, C)
opt_state = opt.init(params)
sufficient = torch.tensor([0.0, 0.0] + [1.0] * (C - 2), device=dev)

# synthetic "language": per-client Markov streams with distinct stats —
# heterogeneous data so federation actually matters
rng = np.random.default_rng(0)
trans = rng.dirichlet(np.full(64, 0.1), size=(C, 64))   # per-client bigram
cum = np.cumsum(trans, axis=-1)                          # (C, 64, 64)
start = time.time()
losses = []
for i in range(args.steps):
    toks = np.zeros((C, args.batch, args.seq + 1), np.int64)
    t = rng.integers(0, 64, (C, args.batch))
    u = rng.random((args.seq + 1, C, args.batch))
    cidx = np.arange(C)[:, None]
    for s in range(args.seq + 1):
        toks[..., s] = t
        # vectorized categorical draw from each client's bigram row
        t = (cum[cidx, t] < u[s][..., None]).sum(-1)
    batch = {"tokens": torch.tensor(toks[..., :-1], dtype=torch.int32,
                                    device=dev),
             "labels": torch.tensor(toks[..., 1:], dtype=torch.int32,
                                    device=dev)}
    params, opt_state, m = step(params, opt_state, batch, sufficient,
                                prng.PRNGKey(i, dev))
    losses.append(float(m["loss"]))
    if i % 20 == 0 or i == args.steps - 1:
        print(f"step {i:4d} loss={losses[-1]:7.4f} "
              f"({time.time()-start:6.1f}s)", flush=True)

assert np.isfinite(losses).all(), "NaN in federated training"
assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.9, \
    "loss failed to decrease"
print(f"\nOK: {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f} "
      f"with 20% packet loss on half the cohort")
