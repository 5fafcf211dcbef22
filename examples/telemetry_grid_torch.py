"""The selection-bias grid with full telemetry on the PyTorch port.

docs/EXPERIMENTS.md's "Inspecting runs with flstat": the selection-bias
grid (``examples/selection_grid_torch.py``: every selection policy x
loss rate {0.1, 0.2, 0.3}, 24 traced cells of FedAvg with TRA
group_rate debias on the Gilbert-Elliott channel, N = 30 clients on the
FCC draw, C = 10, 60 rounds) with ``TelemetryConfig(level="full")``,
through ``run_grid(..., events=PATH)``. The grid is one batched round
step a round; the telemetry rides its logs and leaves the device once a
block. The JSONL stream holds one ``round`` event a cell and round, a
``client_stats`` event a cell and the program-timing ledger.

Reads the stream back and prints each cell's mean cohort share per
bandwidth quartile (``tele/part_quartile``, slowest..fastest: the
paper's Fig. 3 selection-bias signal). Under ``uniform`` every quartile
holds about 0.25 of the cohort slots; under ``bandwidth_threshold`` the
slowest quartile starves. Then it prints how to render the stream.

Runs on the card by default; pass --device cpu to run on the CPU (the
kernels' plain versions then stand in).

Run:  PYTHONPATH=src python examples/telemetry_grid_torch.py
          [--device cpu] [--rounds 60] [--events build/telemetry_grid.jsonl]
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import selection_grid_torch as sel_example  # noqa: E402
from repro_torch.core.server import run_grid  # noqa: E402
from repro_torch.core.telemetry import TelemetryConfig  # noqa: E402
from repro_torch.utils.events import load_stream  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_EVENTS = os.path.join(ROOT, "build", "telemetry_grid.jsonl")


def grid(n_rounds):
    """The selection-bias grid's 24 cells at level="full"."""
    return [dataclasses.replace(c, telemetry=TelemetryConfig(level="full"))
            for c in sel_example.grid(n_rounds)]


def quartile_shares(rounds, n_cells):
    """(n_cells, 4) mean ``part_quartile`` of each cell over its rounds."""
    out = np.zeros((n_cells, 4))
    for s in range(n_cells):
        out[s] = np.mean([r.part_quartile for r in rounds
                          if r.scenario == s], axis=0)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--events", default=DEFAULT_EVENTS,
                    help="the JSONL event stream to write")
    args = ap.parse_args(argv)

    data, nets = sel_example.inputs()
    cfgs = grid(args.rounds)
    t0 = time.perf_counter()
    histories = run_grid(cfgs, data, nets, device=args.device,
                         events=args.events)
    secs = time.perf_counter() - t0
    _, rounds, _ = load_stream(args.events)
    shares = quartile_shares(rounds, len(cfgs))
    print("policy               loss  accuracy  cohort share by bandwidth "
          "quartile (slowest..fastest)")
    for i, (cfg, hist) in enumerate(zip(cfgs, histories)):
        acc = hist[-1].report.sample_average * 100
        print(f"{cfg.sel.policy:20s} {cfg.tra.loss_rate:4.1f}  {acc:7.2f}%  "
              + "  ".join(f"q{j}={x:.3f}" for j, x in enumerate(shares[i])))
    print(f"\n{len(cfgs)} cells x {args.rounds} rounds through run_grid in "
          f"{secs:.2f} s; {len(rounds)} round events in {args.events}")
    print(f"render it:  python tools/flstat.py {args.events}"
          f"   (--rounds, --scenario N, --programs, --json)")
    return shares


if __name__ == "__main__":
    main()
