"""Serving launcher: sequential prefill + greedy decode using the KV cache
(the reference's ``repro/launch/serve.py``), for the dense family.

``python -m repro_torch.launch.serve --arch qwen1.5-4b --reduced --tokens 16``

Runs on the card unless given ``--device cpu``; without a card it
raises. Params and cache are f32, as the reference's launcher keeps
them; the params are drawn from a seeded generator on the device, the
prompt from ``np.random.default_rng(0)`` as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import decode as decode_mod
from repro_torch.models import transformer as tf


def prefill_into_cache(cfg, params, tokens, cache):
    """Sequential prefill via decode steps (the reference's: correct for
    every family; chunked prefill is a serving optimisation)."""
    logits = None
    for i in range(tokens.shape[1]):
        logits, cache = decode_mod.decode_step(cfg, params,
                                               tokens[:, i:i + 1], cache, i)
    return logits, cache


@dataclasses.dataclass
class ServeResult:
    cfg: ModelConfig
    tokens: torch.Tensor            # (B, 1 + new tokens) int32
    prefill_logits: torch.Tensor    # (B, vocab) f32, the last prompt step
    prefill_s: float
    decode_s: float
    params: dict                    # the model, kept for a caller's checks
    cache: dict                     # the KV cache after the last step

    @property
    def tok_per_s(self) -> float:
        return (self.tokens.shape[1] - 1) * self.tokens.shape[0] \
            / self.decode_s


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv=None) -> ServeResult:
    """Parse the reference's flags (and ``--device``), build the model,
    prefill the prompt, decode greedily, print the reference's lines."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device; default the card (raises without "
                         "one)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(0)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    max_seq = args.prompt_len + args.tokens + 1
    cache = decode_mod.init_cache(cfg, args.batch, max_seq, torch.float32,
                                  device=dev)
    prompt = torch.tensor(rng.integers(0, cfg.vocab,
                                       (args.batch, args.prompt_len)),
                          dtype=torch.int32, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill_into_cache(cfg, params, prompt, cache)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    print(f"prefill {args.prompt_len} tokens: {prefill_s:.2f}s")

    serve_step = make_serve_step(cfg)
    tok = logits.argmax(-1).int()[:, None]
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.tokens):
        tok, cache = serve_step(params, cache, {"tokens": tok},
                                args.prompt_len + i)
        tok = tok.reshape(args.batch, 1)
        out.append(tok)
    _sync(dev)
    res = ServeResult(cfg, torch.cat(out, 1), logits, prefill_s,
                      time.perf_counter() - t0, params, cache)
    print(f"decoded {args.tokens} tokens x {args.batch} seqs in "
          f"{res.decode_s:.2f}s ({res.tok_per_s:.1f} tok/s)")
    print("sample:", res.tokens[0].cpu().numpy()[:12])
    if not bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
        raise RuntimeError("a generated token lies outside the vocabulary")
    return res


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
