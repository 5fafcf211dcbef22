"""Generic (non-federated) training launcher (the reference's
``repro/launch/train.py``).

``python -m repro_torch.launch.train --arch stablelm-3b --reduced --steps 20``

Runs on the card unless given ``--device cpu``; without a card it
raises. Params are f32 from a seeded generator on the device, batches
from ``np.random.default_rng(0)`` as in the reference (the same tokens).
The step updates params and optimizer state in place (donated), so a
full-width AdamW step fits one card. The FL driver with the paper's TRA
protocol is ``launch/fl_train.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import ModelConfig, TrainConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as tf


def synth_batch(cfg, batch: int, seq: int, rng: np.random.Generator,
                device=None):
    """Uniform random tokens and labels (int32), drawn as the reference
    draws them; the VLM patches and audio frames likewise (f32)."""
    def ints():
        return torch.tensor(rng.integers(0, cfg.vocab, (batch, seq)),
                            dtype=torch.int32, device=device)

    out = {"tokens": ints(), "labels": ints()}
    if cfg.family == "vlm":
        out["patches"] = torch.tensor(
            0.02 * rng.standard_normal((batch, cfg.n_patches, cfg.d_model)),
            dtype=torch.float32, device=device)
    if cfg.family == "audio":
        out["frames"] = torch.tensor(
            0.02 * rng.standard_normal((batch, cfg.encoder_seq,
                                        cfg.d_model)),
            dtype=torch.float32, device=device)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class TrainResult:
    cfg: ModelConfig
    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]            # host time of each step, synchronized
    params: Any
    opt_state: Any


def run(argv=None) -> TrainResult:
    """Parse the reference's flags (and ``--device``), train, print the
    reference's lines; the run's losses, norms, step times and state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(lr=args.lr, remat=args.remat)
    rng = np.random.default_rng(0)
    params = tf.init_params(
        cfg, torch.Generator(device=dev).manual_seed(tcfg.seed))
    step_fn, opt = make_train_step(cfg, tcfg)
    opt_state = opt.init(params)

    seq = args.seq
    if cfg.family == "vlm":
        seq = max(seq, cfg.n_patches + 16)
    res = TrainResult(cfg, [], [], [], params, opt_state)
    for i in range(args.steps):
        batch = synth_batch(cfg, args.batch,
                            seq - (cfg.n_patches if cfg.family == "vlm"
                                   else 0), rng, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        gnorm = float(metrics["grad_norm"])
        _sync(dev)
        res.step_s.append(time.perf_counter() - t0)
        res.losses.append(loss)
        res.grad_norms.append(gnorm)
        print(f"step {i:4d} loss={loss:8.4f} gnorm={gnorm:7.3f} "
              f"({res.step_s[-1]:.2f}s)", flush=True)
        if not np.isfinite(loss):
            raise FloatingPointError(f"step {i}: loss diverged ({loss})")
    res.params, res.opt_state = params, opt_state
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, step=args.steps)
        print("saved", args.checkpoint)
    return res


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
