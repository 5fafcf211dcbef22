"""Serving example, port: batched greedy decoding with a KV cache
(``examples/serve_batched.py`` on ``repro_torch``) for the dense
family: MHA, QKV bias, GQA and gemma3's local:global band. The
reference's other families (MoE, hybrid-SSM, xLSTM) wait for their
port (ROADMAP Queue 1 item 8.2).

Run:  PYTHONPATH=src python examples/serve_batched_torch.py
on the card; ``--device cpu`` runs it on the CPU.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import decode as D
from repro_torch.models import transformer as T

BATCH, PROMPT, NEW = 2, 8, 12

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None,
                help="torch device; default the card (raises without one)")
dev = resolve_device(ap.parse_args().device)

for arch in ("qwen1.5-4b", "stablelm-3b", "starcoder2-15b", "gemma3-27b"):
    cfg = get_config(arch).reduced()
    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    cache = D.init_cache(cfg, BATCH, PROMPT + NEW + 1, torch.float32,
                         device=dev)
    rng = np.random.default_rng(0)
    prompt = torch.tensor(rng.integers(0, cfg.vocab, (BATCH, PROMPT)),
                          dtype=torch.int32, device=dev)
    serve = make_serve_step(cfg)

    logits = None
    for i in range(PROMPT):
        logits, cache = D.decode_step(cfg, params, prompt[:, i:i + 1],
                                      cache, i)
    # the one-pass prefill gives the same last-position logits
    pre = make_prefill_step(cfg)(params, {"tokens": prompt})
    assert torch.allclose(pre, logits, rtol=2e-4, atol=2e-5)
    tok = logits.argmax(-1).int().reshape(BATCH, 1)
    t0 = time.time()
    out = []
    for i in range(NEW):
        nxt, cache = serve(params, cache, {"tokens": tok}, PROMPT + i)
        tok = nxt.reshape(BATCH, 1)
        out.append(nxt)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    gen = torch.stack(out, 1).cpu().numpy()
    assert np.isfinite(gen).all() and (gen >= 0).all()
    print(f"{arch:16s} [{cfg.family:6s}] {NEW} tokens x {BATCH} seqs "
          f"in {dt:5.2f}s -> {gen[0][:8]}")
print("\nOK: decode path works across the dense family")
