#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version on the card, drives the main
paths (the quickstart's federated rounds, and the paper's bursty-loss
grid as one scenario-batched sweep) through the kernels, compares the
card's runs with the CPU's, times the kernels, and ends with a one-line
JSON verdict. Any failed check exits non-zero; with no card it exits
non-zero at once and prints no result.

Phases:
  1. setup      card name and power limit, TF32 off, kernel builds
                (one nvcc per source, started together)
  2. kernels    uplink_fused vs uplink_ref: every debias mode x EF x
                ssq, f32 and bf16, at the main-path shape and a tiling
                shape; uplink_fused_batched the same at the grid's shape
                (S=27) and a tiling shape, and bitwise against S single
                launches; netsim_mask bitwise vs ge_mask_ref at the
                grid's shape (R=270, P=36) and a tiling shape
  3. main path  the quickstart's three configurations (threshold 70%,
                TRA 10%, lossless), q-FedAvg, 50 rounds, N=30, C=10,
                with every launch count set to 0 just before and read
                just after
  4. parity     the TRA configuration for 5 rounds on the card and on
                the CPU from one seed: equal cohorts, close params
  5. grid       the docs/EXPERIMENTS.md bursty grid (27 cells: seeds x
                loss rate x burst length, FedAvg, TRA group_rate, the
                Gilbert-Elliott channel) for 60 rounds through run_grid,
                counts set to 0 just before and read just after; the
                same cells as 27 sequential FederatedServer runs of 10
                rounds; the 9-cell q-FedAvg loss-rate grid for 20
                rounds; and the bursty grid for 5 rounds on the card
                and on the CPU: equal cohorts and channel states, and
                each round from the CPU's state at the parity tolerances
  6. timings    each kernel, its plain version and the library call
                (CUDA events, median of 100 after warm-up), device time
                from torch.profiler, the bound; and profiles of
                quickstart rounds and of grid rounds
"""
from __future__ import annotations

import dataclasses
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

from repro_torch.core.server import (FederatedServer, FLConfig,  # noqa: E402
                                     run_grid)
from repro_torch.core.sweep import SweepEngine  # noqa: E402
from repro_torch.core.tra import DEBIAS_MODES, TRAConfig  # noqa: E402
from repro_torch.data.synthetic import generate_synthetic  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.common import DENOM_EPS  # noqa: E402
from repro_torch.kernels.netsim_mask import netsim_mask as nm  # noqa: E402
from repro_torch.kernels.netsim_mask.ref import ge_mask_ref  # noqa: E402
from repro_torch.kernels.uplink_fused import uplink_fused as uf  # noqa: E402
from repro_torch.kernels.uplink_fused import ops as uplink_ops  # noqa: E402
from repro_torch.kernels.uplink_fused.ref import uplink_ref  # noqa: E402
from repro_torch.netsim.config import NetSimConfig  # noqa: E402
from repro_torch.network.trace import sample_networks  # noqa: E402

# H100 SXM HBM3 rate (NVIDIA data sheet); the byte bound divides by it
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12         # non-tensor-core fp32 peak, same sheet
MAIN_SHAPE = (10, 36, 256)      # C, P, F of the quickstart round
TILE_SHAPE = (64, 1024, 256)
GRID_SHAPE = (27, 10, 36, 256)  # S, C, P, F of the bursty grid's round
GRID_TILE_SHAPE = (8, 64, 1024, 256)
MASK_SHAPE = (270, 36)          # R = S * C, P of the bursty grid's round
MASK_TILE_SHAPE = (4096, 1024)
ROUNDS = 50
PARITY_ROUNDS = 5
GRID_ROUNDS = 60
SEQ_ROUNDS = 10
QFED_GRID_ROUNDS = 20


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def zero_counts():
    uf.LAUNCHES = uf.BATCHED_LAUNCHES = nm.LAUNCHES = 0


def counts():
    return {"uplink_fused": uf.LAUNCHES,
            "uplink_fused_batched": uf.BATCHED_LAUNCHES,
            "netsim_mask": nm.LAUNCHES}


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


def batched_inputs(shape, seed, dev, *, mode, use_ef, stream_dtype):
    """S scenarios' kernel operands, drawn on the card: packetised
    uploads with a partial last packet, EF, masks, pre-folded scales."""
    S, C, P, F = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    d_up = P * F - 11

    def rows():
        r = torch.randn((S, C, P * F), device=dev, generator=g)
        r[..., d_up:] = 0.0
        return r.reshape(S, C, P, F)

    x = rows()
    ef = rows()
    m = (torch.rand((S, C, P), device=dev, generator=g) > 0.4).float()
    w = torch.rand((S, C), device=dev, generator=g) + 0.1
    suff = (torch.rand((S, C), device=dev, generator=g) > 0.5).float()
    mult = torch.rand((S, C), device=dev, generator=g) + 0.5
    pcnt = torch.full((P,), float(F), device=dev)
    pcnt[-1] = F - 11
    kept = (m @ pcnt) / d_up
    q = uplink_ops.debias_client_scale(w, mode=mode, kept=kept,
                                       sufficient=suff, loss_rate=0.4,
                                       mult=mult)
    per_coord = mode == "per_coord_count"
    wd = w if per_coord else torch.clamp(w.sum(-1), min=DENOM_EPS)
    return (x.to(stream_dtype), ef.to(stream_dtype) if use_ef else None,
            m, q.contiguous(), wd.contiguous(), per_coord)


def check_batched_kernel(dev):
    """Every mode x EF x ssq x dtype at both batched shapes: against the
    plain version at the single kernel's tolerances, and bitwise against
    S single launches. Returns the largest |agg_kernel - agg_plain|."""
    max_err = 0.0
    cases = list(itertools.product(
        (GRID_SHAPE, GRID_TILE_SHAPE), (torch.float32, torch.bfloat16),
        DEBIAS_MODES, (False, True), (False, True)))
    for n, (shape, dtype, mode, use_ef, want_ssq) in enumerate(cases):
        x, ef, m, q, wd, pc = batched_inputs(shape, n, dev, mode=mode,
                                             use_ef=use_ef,
                                             stream_dtype=dtype)
        agg, ef_out, ssq = uf.uplink_fused_batched_call(
            x, m, q, wd, ef=ef, want_ssq=want_ssq, per_coord=pc)
        torch.cuda.synchronize()
        case = (f"shape={shape} dtype={dtype} mode={mode} ef={use_ef} "
                f"ssq={want_ssq}")
        for i in range(shape[0]):
            a, e, s = uf.uplink_fused_call(
                x[i], m[i], q[i], wd[i], ef=None if ef is None else ef[i],
                want_ssq=want_ssq, per_coord=pc)
            same = torch.equal(a, agg[i]) \
                and (e is None or torch.equal(e, ef_out[i])) \
                and (s is None or torch.equal(s, ssq[i]))
            if not same:
                fail(f"batched launch differs from single launch {i}: "
                     f"{case}")
        r_agg, r_ef, r_ssq = uplink_ref(x, m, q, wd, ef=ef,
                                        want_ssq=want_ssq, per_coord=pc)
        torch.cuda.synchronize()
        torch.testing.assert_close(agg, r_agg, rtol=1e-5, atol=1e-6,
                                   msg=lambda e: f"agg {case}: {e}")
        max_err = max(max_err, float((agg - r_agg).abs().max()))
        if use_ef and not torch.equal(ef_out, r_ef.to(dtype)):
            fail(f"batched ef_out not bitwise: {case}")
        if want_ssq:
            torch.testing.assert_close(ssq.sum(-1), r_ssq, rtol=1e-5,
                                       atol=0.0,
                                       msg=lambda e: f"ssq {case}: {e}")
    print(f"[kernels] uplink_fused_batched: {len(cases)} cases match "
          f"uplink_ref (agg rtol 1e-5 atol 1e-6, EF bitwise, ssq rtol "
          f"1e-5) and equal S single launches bitwise; max |agg err| "
          f"{max_err:.3e}", flush=True)
    return max_err


def mask_inputs(shape, seed, dev):
    R, P = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    u_t = torch.rand((R, P), device=dev, generator=g)
    u_e = torch.rand((R, P), device=dev, generator=g)
    s0 = (torch.rand((R,), device=dev, generator=g) < 0.3).to(torch.int32)
    p_gb = 0.3 * torch.rand((R,), device=dev, generator=g)
    p_bg = torch.rand((R,), device=dev, generator=g)
    h_g = torch.full((R,), 0.02, device=dev)
    h_b = torch.full((R,), 0.9, device=dev)
    return u_t, u_e, s0, p_gb, p_bg, h_g, h_b


def check_mask_kernel(dev):
    """netsim_mask bitwise against its plain version; returns 0.0, the
    largest difference, for the summary."""
    for n, shape in enumerate((MASK_SHAPE, MASK_TILE_SHAPE)):
        args = mask_inputs(shape, n, dev)
        mask, s_fin = nm.netsim_mask_call(*args)
        torch.cuda.synchronize()
        r_mask, r_s = ge_mask_ref(*args)
        if not (torch.equal(mask, r_mask) and torch.equal(s_fin, r_s)):
            fail(f"netsim_mask differs from ge_mask_ref at {shape}")
    print(f"[kernels] netsim_mask: masks and final states bitwise equal "
          f"to ge_mask_ref at R, P = {MASK_SHAPE} and {MASK_TILE_SHAPE}",
          flush=True)
    return 0.0


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
    zero_counts()
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
    got = counts()
    launches = got["uplink_fused"]
    if got != {"uplink_fused": 3 * ROUNDS, "uplink_fused_batched": 0,
               "netsim_mask": 0}:
        fail(f"quickstart launches {got}, expected {3 * ROUNDS} single "
             f"uplink launches and no other")
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
def grid_data():
    """docs/EXPERIMENTS.md's grid dataset."""
    return generate_synthetic(np.random.default_rng(7), n_clients=30,
                              alpha=1.0, beta=1.0)


def bursty_grid(n_rounds):
    """docs/EXPERIMENTS.md's bursty-loss grid: 27 cells."""
    base = FLConfig(algo="fedavg", n_rounds=n_rounds, clients_per_round=10,
                    local_steps=10, eval_every=10 ** 6,
                    tra=TRAConfig(enabled=True, debias="group_rate"),
                    netsim=NetSimConfig(channel="gilbert_elliott"))
    return [dataclasses.replace(
        base, seed=seed, tra=dataclasses.replace(base.tra, loss_rate=rate),
        netsim=dataclasses.replace(base.netsim, burst_len=burst))
        for seed in (0, 1, 2) for rate in (0.1, 0.2, 0.3)
        for burst in (2.0, 8.0, 16.0)]


def qfedavg_grid(n_rounds):
    """docs/EXPERIMENTS.md's q-FedAvg i.i.d. loss-rate grid: 9 cells."""
    base = FLConfig(algo="qfedavg", n_rounds=n_rounds, clients_per_round=10,
                    local_steps=10, eval_every=10 ** 6,
                    tra=TRAConfig(enabled=True, debias="group_rate"))
    return [dataclasses.replace(
        base, seed=seed, tra=dataclasses.replace(base.tra, loss_rate=rate))
        for seed in (0, 1, 2) for rate in (0.1, 0.3, 0.5)]


def check_histories(label, hists, n_rounds, n_cells):
    if len(hists) != n_cells:
        fail(f"{label}: {len(hists)} histories, expected {n_cells}")
    for h in hists:
        losses = [r.train_loss for r in h]
        if len(losses) != n_rounds or not all(map(math.isfinite, losses)):
            fail(f"{label}: bad loss trajectory {losses}")
        if h[-1].report is None or not math.isfinite(h[-1].report.average):
            fail(f"{label}: no final report")


def grid_params(states, n_cells):
    return np.concatenate([states.params[k].cpu().numpy().reshape(
        n_cells, -1) for k in sorted(states.params)], axis=1)


def to_device(states, dev):
    return type(states)(
        params={k: v.to(dev) for k, v in states.params.items()},
        ef_mem=states.ef_mem.to(dev), lam=states.lam.to(dev),
        net=type(states.net)(*(f.to(dev) for f in states.net)))


def check_grid_card_vs_cpu(data, n_cells):
    """The bursty grid for PARITY_ROUNDS rounds on the card and on the
    CPU from the same seeds. Free-running, cohorts and channel states
    must stay equal: they depend on the uniforms alone. Round by round
    from the CPU's state, the card's round must match the CPU's at the
    quickstart parity's tolerances. Free-running params are printed,
    not held: a cell whose ReLU unit sits within float noise of zero
    parts for good there, whatever computes it."""
    engs = {dev: SweepEngine.from_configs(bursty_grid(PARITY_ROUNDS), data,
                                          device=dev)
            for dev in ("cuda", "cpu")}
    free = {dev: e.init_states() for dev, e in engs.items()}
    forced = free["cpu"]
    worst_forced = worst_loss = 0.0
    for t in range(PARITY_ROUNDS):
        logs = {}
        for dev, eng in engs.items():
            free[dev], logs[dev] = eng.run_block(free[dev], t, 1)
        if not np.array_equal(logs["cuda"]["ids"], logs["cpu"]["ids"]):
            fail(f"grid cohorts differ between cuda and cpu at round {t}")
        if not torch.equal(free["cuda"].net.channel.cpu(),
                           free["cpu"].net.channel):
            fail(f"grid channel states differ between cuda and cpu at "
                 f"round {t}")
        on_card, lg = engs["cuda"].run_block(to_device(forced, "cuda"), t,
                                             1)
        forced, lc = engs["cpu"].run_block(forced, t, 1)
        vg, vc = grid_params(on_card, n_cells), grid_params(forced, n_cells)
        # fp32 matmuls and reductions sum in another order on the card
        np.testing.assert_allclose(vg, vc, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(lg["loss"], lc["loss"], rtol=1e-5)
        worst_forced = max(worst_forced, float(np.abs(vg - vc).max()))
        worst_loss = max(worst_loss,
                         float(np.abs(lg["loss"] - lc["loss"]).max()))
    drift = np.abs(grid_params(free["cuda"], n_cells)
                   - grid_params(free["cpu"], n_cells)).max(axis=1)
    print(f"[parity] bursty grid, cuda vs cpu, {PARITY_ROUNDS} rounds x "
          f"{n_cells} cells: cohorts and channel states equal every "
          f"round; round by round from the cpu state, max |param diff| "
          f"{worst_forced:.3e}, max |loss diff| {worst_loss:.3e}; "
          f"free-running max |param diff| per cell after "
          f"{PARITY_ROUNDS} rounds: median {np.median(drift):.1e}, "
          f"max {drift.max():.1e} ({int((drift > 1e-5).sum())} cells "
          f"above 1e-5)", flush=True)


def run_grid_phase(card):
    """The bursty grid through run_grid, the same cells one server at a
    time, the q-FedAvg grid, and the grid on the card vs the CPU.
    Returns the grid's launch counts."""
    data = grid_data()
    cfgs = bursty_grid(GRID_ROUNDS)
    # warm-up of the batched step (first use of vmap, cuBLAS batched
    # GEMMs, the kernels' libraries); its launches are not counted
    run_grid(bursty_grid(2), data)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    hists = run_grid(cfgs, data)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts()
    check_histories("bursty grid", hists, GRID_ROUNDS, len(cfgs))
    want = {"uplink_fused": 0, "uplink_fused_batched": GRID_ROUNDS,
            "netsim_mask": GRID_ROUNDS}
    if got != want:
        fail(f"bursty grid launches {got}, expected {want}")
    grid_rate = len(cfgs) * GRID_ROUNDS / secs
    worst = {(c.tra.loss_rate, c.netsim.burst_len): [] for c in cfgs}
    for c, h in zip(cfgs, hists):
        worst[(c.tra.loss_rate, c.netsim.burst_len)].append(
            h[-1].report.sample_average)
    print(f"[grid] bursty grid, {len(cfgs)} cells x {GRID_ROUNDS} rounds "
          f"through run_grid: {secs:.3f} s, {grid_rate:.1f} cell-rounds/s, "
          f"launches {got} | {card}", flush=True)
    for (rate, burst), accs in sorted(worst.items()):
        print(f"[grid]   rate={rate:.1f} burst={burst:4.1f} sample acc "
              f"over seeds {np.mean(accs) * 100:5.1f}% +- "
              f"{np.std(accs) * 100:4.1f}", flush=True)

    # the same cells as sequential single-scenario servers
    zero_counts()
    t0 = time.perf_counter()
    for c in bursty_grid(SEQ_ROUNDS):
        server = FederatedServer(c, data, device="cuda")
        server.run()
    torch.cuda.synchronize()
    seq_secs = time.perf_counter() - t0
    seq_rate = len(cfgs) * SEQ_ROUNDS / seq_secs
    print(f"[grid] the same 27 cells as sequential FederatedServer runs of "
          f"{SEQ_ROUNDS} rounds: {seq_secs:.3f} s, {seq_rate:.1f} "
          f"cell-rounds/s, launches {counts()}; sweep / sequential = "
          f"{grid_rate / seq_rate:.1f}x | {card}", flush=True)

    qcfgs = qfedavg_grid(QFED_GRID_ROUNDS)
    zero_counts()
    t0 = time.perf_counter()
    qh = run_grid(qcfgs, data)
    torch.cuda.synchronize()
    qsecs = time.perf_counter() - t0
    check_histories("q-FedAvg grid", qh, QFED_GRID_ROUNDS, len(qcfgs))
    if counts() != {"uplink_fused": 0,
                    "uplink_fused_batched": QFED_GRID_ROUNDS,
                    "netsim_mask": 0}:
        fail(f"q-FedAvg grid launches {counts()}")
    print(f"[grid] q-FedAvg iid grid, {len(qcfgs)} cells x "
          f"{QFED_GRID_ROUNDS} rounds: {qsecs:.3f} s, "
          f"{len(qcfgs) * QFED_GRID_ROUNDS / qsecs:.1f} cell-rounds/s, "
          f"launches {counts()} | {card}", flush=True)

    check_grid_card_vs_cpu(data, len(cfgs))
    return got, grid_rate, seq_rate


# ---------------------------------------------------------------------------
# phase 6
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


def bound(n_bytes, flops):
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / FP32_FLOP_PER_S * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def time_batched_uplink(shape, card):
    # the bursty grid's call: FedAvg, group_rate, no EF, no norms
    x, _, m, q, wd, _ = batched_inputs(shape, 4321, "cuda",
                                       mode="group_rate", use_ef=False,
                                       stream_dtype=torch.float32)
    wm = m * q[..., None]

    def kernel():
        return uf.uplink_fused_batched_call(x, m, q, wd, per_coord=False)

    def plain():
        return uplink_ref(x, m, q, wd, per_coord=False)

    def library():
        return torch.einsum("scpf,scp->spf", x, wm)

    p1, k1, k2, p2 = (median_ms(f) for f in (plain, kernel, kernel, plain))
    lib_ms = median_ms(library)
    dev_ms = device_ms(kernel, "uplink_fused_kernel")
    S, C, P, F = shape
    agg, _, _ = kernel()
    n_bytes = sum(t.nbytes for t in (x, m, q, wd, agg))
    # per element x*wm and +; one division per output
    bound_ms, bound_by = bound(n_bytes, 2 * S * C * P * F + S * P * F)
    print(f"[time] uplink_fused_batched S={S} C={C} P={P} F={F} f32: "
          f"kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
          f"einsum {lib_ms:.4f} ms (per call, CUDA events, median of "
          f"100); kernel device time "
          + (f"{dev_ms:.4f} ms" if dev_ms is not None else "not measured")
          + f" (torch.profiler); bound {bound_ms:.6f} ms by {bound_by} "
          f"({n_bytes} B at 3.35 TB/s) | {card}", flush=True)
    return {"ms": statistics.median([k1, k2]),
            "plain_ms": statistics.median([p1, p2]), "library_ms": lib_ms,
            "device_ms": dev_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def time_mask(shape, card):
    args = mask_inputs(shape, 99, "cuda")

    def kernel():
        return nm.netsim_mask_call(*args)

    def plain():
        return ge_mask_ref(*args)

    p1, k1, k2, p2 = (median_ms(f, reps=20 if shape[1] > 100 else 100)
                      for f in (plain, kernel, kernel, plain))
    dev_ms = device_ms(kernel, "netsim_mask_kernel")
    R, P = shape
    mask, s_fin = kernel()
    n_bytes = sum(t.nbytes for t in (*args, mask, s_fin))
    # per packet: one select of the flip rate, one comparison, one
    # select of the emission rate, one comparison
    bound_ms, bound_by = bound(n_bytes, 4 * R * P)
    print(f"[time] netsim_mask R={R} P={P}: kernel {k1:.4f}/{k2:.4f} ms, "
          f"plain {p1:.4f}/{p2:.4f} ms (per call, CUDA events, median); "
          f"no single PyTorch call computes it; kernel device time "
          + (f"{dev_ms:.4f} ms" if dev_ms is not None else "not measured")
          + f" (torch.profiler); bound {bound_ms:.6f} ms by {bound_by} "
          f"({n_bytes} B at 3.35 TB/s) | {card}", flush=True)
    return {"ms": statistics.median([k1, k2]),
            "plain_ms": statistics.median([p1, p2]), "library_ms": None,
            "device_ms": dev_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def print_profile(label, prof, wall_ms, n):
    rows = []
    for ev in prof.key_averages():
        dt = ev.self_device_time_total
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    rows.sort(reverse=True)
    print(f"[profile] {label}: wall {wall_ms / n:.3f} ms/round, "
          f"device busy {busy / n:.3f} ms/round "
          f"({100 * busy / wall_ms:.1f}% of wall), {launches / n:.0f} "
          f"kernel launches/round", flush=True)
    for dt, cnt, key in rows[:8]:
        print(f"[profile]   {dt / n:8.4f} ms/round {cnt // n:5d}x/round "
              f"{key[:90]}", flush=True)


def profile_grid(card, n=5):
    """Device busy share and top kernels over ``n`` bursty-grid rounds."""
    eng = SweepEngine.from_configs(bursty_grid(n + 2), grid_data())
    st = eng.init_states()
    st, _ = eng.run_block(st, 0, 2)                   # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, _ = eng.run_block(st, 2, n)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(f"{n} bursty-grid rounds (27 cells) | {card}", prof,
                  wall_ms, n)


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
    print_profile(f"{n} quickstart TRA rounds | {card}", prof, wall_ms, n)


# ---------------------------------------------------------------------------
def entry(name, source, replaces, launches, max_err, t):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    t_start = time.perf_counter()
    card = setup()
    dev = torch.device("cuda")
    max_err = check_kernels(dev)
    batched_err = check_batched_kernel(dev)
    mask_err = check_mask_kernel(dev)
    launches = run_main_path(card)
    check_card_vs_cpu()
    grid_counts, _, _ = run_grid_phase(card)
    main_t = time_uplink(MAIN_SHAPE, card)
    time_uplink(TILE_SHAPE, card)
    batched_t = time_batched_uplink(GRID_SHAPE, card)
    time_batched_uplink(GRID_TILE_SHAPE, card)
    mask_t = time_mask(MASK_SHAPE, card)
    time_mask(MASK_TILE_SHAPE, card)
    profile_rounds(card)
    profile_grid(card)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)

    summary = {"kernels": [
        entry("uplink_fused", "src/repro_torch/csrc/uplink_fused.cu",
              "src/repro/kernels/uplink_fused/uplink_fused.py:156",
              launches, max_err, main_t),
        entry("uplink_fused_batched", "src/repro_torch/csrc/uplink_fused.cu",
              "src/repro/kernels/uplink_fused/uplink_fused.py:221",
              grid_counts["uplink_fused_batched"], batched_err, batched_t),
        entry("netsim_mask", "src/repro_torch/csrc/netsim_mask.cu",
              "src/repro/kernels/netsim_mask/netsim_mask.py:66",
              grid_counts["netsim_mask"], mask_err, mask_t),
    ]}
    print(card)
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
