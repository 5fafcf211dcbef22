#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the main
path (the quickstart's federated rounds) through the kernels, compares
the card's run with the CPU's, times the kernels, and ends with a
one-line JSON verdict. Any failed check exits non-zero; with no card it
exits non-zero at once and prints no result.

Phases:
  1. setup      card name and power limit, TF32 off, kernel build
  2. kernels    uplink_fused vs uplink_ref: every debias mode x EF x
                ssq, f32 and bf16, at the main-path shape and a tiling
                shape
  3. main path  the quickstart's three configurations (threshold 70%,
                TRA 10%, lossless), q-FedAvg, 50 rounds, N=30, C=10,
                with every launch count set to 0 just before and read
                just after
  4. parity     the TRA configuration for 5 rounds on the card and on
                the CPU from one seed: equal cohorts, close params
  5. timings    kernel, plain version and library call (CUDA events,
                median of 100 after warm-up), the byte bound, and a
                profile of main-path rounds
"""
from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.core.server import FederatedServer, FLConfig  # noqa: E402
from repro_torch.core.tra import DEBIAS_MODES, TRAConfig  # noqa: E402
from repro_torch.data.synthetic import generate_synthetic  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.common import DENOM_EPS  # noqa: E402
from repro_torch.kernels.uplink_fused import uplink_fused as uf  # noqa: E402
from repro_torch.kernels.uplink_fused import ops as uplink_ops  # noqa: E402
from repro_torch.kernels.uplink_fused.ref import uplink_ref  # noqa: E402
from repro_torch.network.trace import sample_networks  # noqa: E402

# H100 SXM HBM3 rate (NVIDIA data sheet); the byte bound divides by it
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12         # non-tensor-core fp32 peak, same sheet
MAIN_SHAPE = (10, 36, 256)      # C, P, F of the quickstart round
TILE_SHAPE = (64, 1024, 256)
ROUNDS = 50
PARITY_ROUNDS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------
def setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[setup] card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"[setup] kernels built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, (secs, log) in _build.BUILD_LOG.items():
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[setup] nvcc {name}: {secs:.2f} s; " + " | ".join(info),
              flush=True)
    return card


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------
def uplink_inputs(shape, seed, dev, *, mode, use_ef, stream_dtype):
    """Kernel operands as ``ops.uplink_round`` prepares them: packetised
    uploads with a partial last packet, EF, mask, pre-folded scales."""
    C, P, F = shape
    rng = np.random.default_rng(seed)
    d_up = P * F - 11

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    x = torch.zeros((C, P * F), device=dev)
    x[:, :d_up] = t(rng.normal(size=(C, d_up)))
    ef = torch.zeros((C, P * F), device=dev)
    ef[:, :d_up] = t(rng.normal(size=(C, d_up)))
    m = t(rng.random((C, P)) > 0.4)
    w = t(rng.random(C) + 0.1)
    suff = t(rng.random(C) > 0.5)
    mult = t(rng.random(C) + 0.5)
    pcnt = torch.full((P,), float(F), device=dev)
    pcnt[-1] = F - 11
    kept = (m @ pcnt) / d_up
    q = uplink_ops.debias_client_scale(w, mode=mode, kept=kept, sufficient=suff,
                                       loss_rate=0.4, mult=mult)
    per_coord = mode == "per_coord_count"
    wd = w if per_coord else torch.clamp(w.sum(), min=DENOM_EPS)
    x = x.reshape(C, P, F).to(stream_dtype)
    ef = ef.reshape(C, P, F).to(stream_dtype) if use_ef else None
    return x, ef, m, q.contiguous(), wd.contiguous(), per_coord


def check_kernels(dev):
    """Every mode x EF x ssq x dtype at both shapes; returns the largest
    |agg_kernel - agg_plain| seen."""
    max_err = {"agg": 0.0, "ssq_rel": 0.0}
    cases = list(itertools.product(
        (MAIN_SHAPE, TILE_SHAPE), (torch.float32, torch.bfloat16),
        DEBIAS_MODES, (False, True), (False, True)))
    for n, (shape, dtype, mode, use_ef, want_ssq) in enumerate(cases):
        x, ef, m, q, wd, pc = uplink_inputs(shape, n, dev, mode=mode,
                                            use_ef=use_ef,
                                            stream_dtype=dtype)
        agg, ef_out, ssq = uf.uplink_fused_call(
            x, m, q, wd, ef=ef, want_ssq=want_ssq, per_coord=pc)
        torch.cuda.synchronize()
        r_agg, r_ef, r_ssq = uplink_ref(x, m, q, wd, ef=ef,
                                        want_ssq=want_ssq, per_coord=pc)
        torch.cuda.synchronize()
        case = (f"shape={shape} dtype={dtype} mode={mode} ef={use_ef} "
                f"ssq={want_ssq}")
        # fp32 sums in another order than the einsum's
        torch.testing.assert_close(agg, r_agg, rtol=1e-5, atol=1e-6,
                                   msg=lambda e: f"agg {case}: {e}")
        max_err["agg"] = max(max_err["agg"],
                             float((agg - r_agg).abs().max()))
        if use_ef:
            # element-wise, one rounding: bitwise
            if not torch.equal(ef_out, r_ef.to(dtype)):
                fail(f"ef_out not bitwise: {case}")
        elif ef_out is not None:
            fail(f"ef_out without EF: {case}")
        if want_ssq:
            ssq_sum = ssq.sum(dim=-1)
            torch.testing.assert_close(ssq_sum, r_ssq, rtol=1e-5, atol=0.0,
                                       msg=lambda e: f"ssq {case}: {e}")
            max_err["ssq_rel"] = max(
                max_err["ssq_rel"],
                float(((ssq_sum - r_ssq).abs() / r_ssq.abs()).max()))
        elif ssq is not None:
            fail(f"ssq without want_ssq: {case}")
    print(f"[kernels] uplink_fused: {len(cases)} cases match uplink_ref "
          f"(agg rtol 1e-5 atol 1e-6, EF bitwise, ssq rtol 1e-5); "
          f"max |agg err| {max_err['agg']:.3e}, "
          f"max ssq rel err {max_err['ssq_rel']:.3e}", flush=True)
    return max_err["agg"]


# ---------------------------------------------------------------------------
# phases 3 and 4
# ---------------------------------------------------------------------------
def quickstart_inputs():
    rng = np.random.default_rng(0)
    data = generate_synthetic(rng, n_clients=30, alpha=1.0, beta=1.0)
    nets = sample_networks(rng, data.n_clients)
    return data, nets


def quickstart_cfg(label, n_rounds):
    kw = {"threshold": dict(selection="ratio", eligible_ratio=0.7,
                            tra=TRAConfig(enabled=False)),
          "tra": dict(selection="all",
                      tra=TRAConfig(enabled=True, loss_rate=0.1)),
          "lossless": dict(selection="all", tra=TRAConfig(enabled=False)),
          }[label]
    return FLConfig(algo="qfedavg", n_rounds=n_rounds, clients_per_round=10,
                    local_steps=10, eval_every=10 ** 6, **kw)


def run_main_path(card):
    data, nets = quickstart_inputs()
    reports = {}
    uf.LAUNCHES = 0
    for label in ("threshold", "tra", "lossless"):
        before = uf.LAUNCHES
        server = FederatedServer(quickstart_cfg(label, ROUNDS), data, nets,
                                 device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = server.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rep = server.evaluate()
        reports[label] = rep
        losses = [h.train_loss for h in hist]
        if len(losses) != ROUNDS or not all(map(math.isfinite, losses)):
            fail(f"{label}: bad loss trajectory {losses}")
        for k, v in server.params.items():
            if v.device.type != "cuda" or not bool(torch.isfinite(v).all()):
                fail(f"{label}: parameter {k} not finite on cuda")
        print(f"[main] {label:9s} acc={rep.average * 100:5.1f}% "
              f"worst10%={rep.worst10 * 100:5.1f}% var={rep.variance:6.0f} "
              f"loss {losses[0]:.4f}->{losses[-1]:.4f} "
              f"{ROUNDS / secs:.1f} rounds/s (first run includes warm-up) "
              f"launches={uf.LAUNCHES - before} | {card}", flush=True)
    launches = uf.LAUNCHES
    if launches != 3 * ROUNDS:
        fail(f"uplink_fused launched {launches} times on the main path, "
             f"expected {3 * ROUNDS}")
    # the quickstart's own check: TRA lifts the worst clients
    if reports["tra"].worst10 < reports["threshold"].worst10:
        fail("TRA's worst10% fell below threshold selection's")
    return launches


def check_card_vs_cpu():
    data, nets = quickstart_inputs()
    runs = {}
    for dev in ("cuda", "cpu"):
        server = FederatedServer(quickstart_cfg("tra", PARITY_ROUNDS), data,
                                 nets, device=dev)
        state = server.engine.init_state(server.params)
        state, logs = server.engine.run_block(state, 0, PARITY_ROUNDS)
        vec = np.concatenate([state.params[k].cpu().numpy().ravel()
                              for k in sorted(state.params)])
        runs[dev] = (logs, vec)
    (lg, vg), (lc, vc) = runs["cuda"], runs["cpu"]
    if not np.array_equal(lg["ids"], lc["ids"]):
        fail(f"cohorts differ between cuda and cpu:\n{lg['ids']}\n"
             f"{lc['ids']}")
    # fp32 matmuls and reductions sum in another order on the card
    np.testing.assert_allclose(vg, vc, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lg["loss"], lc["loss"], rtol=1e-5)
    print(f"[parity] cuda vs cpu, {PARITY_ROUNDS} TRA rounds: cohorts "
          f"equal, max |param diff| {np.abs(vg - vc).max():.3e}, "
          f"max |loss diff| {np.abs(lg['loss'] - lc['loss']).max():.3e}",
          flush=True)


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------
def median_ms(fn, reps=100, warmup=10):
    """Median of ``reps`` single-call times between two CUDA events,
    each call started on an idle card, so host-side launch cost counts."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, kernel_name, reps=20):
    """Mean device time of the kernel ``kernel_name`` over ``reps`` calls,
    read from torch.profiler; None where the profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total += ev.self_device_time_total
            count += ev.count
    return total / count / 1e3 if count and total > 0 else None


def time_uplink(shape, card):
    # the main path's call: q-FedAvg, group_rate, no EF, masked norms
    x, _, m, q, wd, _ = uplink_inputs(shape, 1234, "cuda", mode="group_rate",
                                      use_ef=False,
                                      stream_dtype=torch.float32)
    wm = m * q[:, None]

    def kernel():
        return uf.uplink_fused_call(x, m, q, wd, want_ssq=True,
                                    per_coord=False)

    def plain():
        return uplink_ref(x, m, q, wd, want_ssq=True, per_coord=False)

    def library():
        return torch.einsum("cpf,cp->pf", x, wm)

    # plain, kernel, kernel, plain: the order cancels drift
    p1, k1, k2, p2 = (median_ms(f) for f in (plain, kernel, kernel, plain))
    lib_ms = median_ms(library)
    dev_ms = device_ms(kernel, "uplink_fused_kernel")
    C, P, F = shape
    agg, _, ssq = kernel()
    n_bytes = sum(t.nbytes for t in (x, m, q, wd, agg, ssq))
    # per element x*wm, +, x*x, +; one division per output
    flops = 4 * C * P * F + P * F
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    ms = statistics.median([k1, k2])
    plain_ms = statistics.median([p1, p2])
    print(f"[time] uplink_fused C={C} P={P} F={F} f32: kernel {k1:.4f}/"
          f"{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, einsum {lib_ms:.4f} ms "
          f"(per call, CUDA events, median of 100); kernel device time "
          + (f"{dev_ms:.4f} ms" if dev_ms is not None else "not measured")
          + f" (torch.profiler); byte bound {bound_ms:.6f} ms "
          f"({n_bytes} B at 3.35 TB/s) | {card}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def profile_rounds(card, n=5):
    """Device busy share and top kernels over ``n`` main-path rounds."""
    data, nets = quickstart_inputs()
    server = FederatedServer(quickstart_cfg("tra", n), data, nets,
                             device="cuda")
    state = server.engine.init_state(server.params)
    state, _ = server.engine.run_block(state, 0, 2)   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = server.engine.run_block(state, 2, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        dt = ev.self_device_time_total
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    rows.sort(reverse=True)
    print(f"[profile] {n} TRA rounds: wall {wall_ms / n:.3f} ms/round, "
          f"device busy {busy / n:.3f} ms/round "
          f"({100 * busy / wall_ms:.1f}% of wall), {launches / n:.0f} "
          f"kernel launches/round | {card}", flush=True)
    for dt, cnt, key in rows[:8]:
        print(f"[profile]   {dt / n:8.4f} ms/round {cnt // n:5d}x/round "
              f"{key[:90]}", flush=True)


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    card = setup()
    max_err = check_kernels(torch.device("cuda"))
    launches = run_main_path(card)
    check_card_vs_cpu()
    main_t = time_uplink(MAIN_SHAPE, card)
    time_uplink(TILE_SHAPE, card)
    profile_rounds(card)

    summary = {"kernels": [{
        "name": "uplink_fused",
        "route": "cuda",
        "source": "src/repro_torch/csrc/uplink_fused.cu",
        "replaces": "src/repro/kernels/uplink_fused/uplink_fused.py:156",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_t["ms"],
        "plain_ms": main_t["plain_ms"],
        "bound_ms": main_t["bound_ms"],
        "bound_by": main_t["bound_by"],
        "library_ms": main_t["library_ms"],
    }]}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
