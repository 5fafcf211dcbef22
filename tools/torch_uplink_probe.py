#!/usr/bin/env python3
"""Time the port's uplink_fused and tra_agg kernels against another
checkout's, in turns, on one card.

    python3 tools/torch_uplink_probe.py                     # this one
    python3 tools/torch_uplink_probe.py --parent build/parent
    python3 tools/torch_uplink_probe.py --parent build/parent --plans

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit; it imports no JAX. ``--parent DIR`` names a checkout (for
example the parent commit, unpacked with ``mkdir -p build/parent && git
archive HEAD~ src | tar -x -C build/parent``) whose
``csrc/uplink_fused.cu`` and ``csrc/tra_agg.cu`` are built with
``nvcc`` into ``build/uplink_probe/`` beside this checkout's, and whose
bindings are loaded beside this checkout's, so both run in one process
on one card. Each case is then timed in turns: parent, change, change,
parent.

Cases (CASES): ``uplink_fused_call`` at the quickstart round's call (C =
10, P = 36, F = 256, q-FedAvg's group_rate with the masked norms, no
EF), through the binding alone and through the op's path (the binding,
then the sum of the norm partials, ``ops._outputs``); the bursty grid's
batched call (S = 27, no EF, no norms); the tiling shape (64, 1024,
256) with EF in f32 and in bf16; ``tra_agg_call`` at the host loop's
(10, 36, 256) and the reference's bench shape (16, 1024, 256). For each
it prints the call's time (median of 100 single calls between CUDA
events, each started on an idle card, so the binding's host work
counts), the kernel's device time (torch.profiler), the binding's host
time (host clock over 2,000 calls), ``einsum``'s time on the same
inputs, the byte bound at 3.35 TB/s and whether the two checkouts'
outputs agree: the aggregate, the EF rows and tra_agg's output bit for
bit, the masked norms (summed) within rtol 1e-5, the only output whose
sum order may differ. ``--plans`` also times this checkout's kernels
with one field of their launch plan changed (``time_plans``). Every
line ends with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12
KERNELS = ("uplink_fused", "tra_agg")
# (label, entry, shape, dtype, EF, masked norms, through the op's path)
CASES = (
    ("uplink_fused", "call", (10, 36, 256), torch.float32, False, True,
     False),
    ("uplink_fused op", "call", (10, 36, 256), torch.float32, False, True,
     True),
    ("uplink_fused_batched", "batched", (27, 10, 36, 256), torch.float32,
     False, False, False),
    ("uplink_fused", "call", (64, 1024, 256), torch.float32, True, False,
     False),
    ("uplink_fused", "call", (64, 1024, 256), torch.bfloat16, True, False,
     False),
    ("tra_agg", "tra", (10, 36, 256), torch.float32, False, False, False),
    ("tra_agg", "tra", (16, 1024, 256), torch.float32, False, False,
     False),
)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps=100, warmup=10):
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


def device_ms(fn, name, reps=20):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if name in ev.key
                and ev.device_type == torch.autograd.DeviceType.CUDA)
    return total / reps / 1e3 if total > 0 else None


def ms(v):
    """A device time, or "not measured" where the profiler saw none."""
    return "not measured" if v is None else f"{v:.4f}"


def host_us(fn, n=2000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def load_parent(root):
    """The parent checkout's uplink_fused and tra_agg bindings, each
    bound to a library built from the parent's own source."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "uplink_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in KERNELS:
        cu = os.path.join(root, "src", "repro_torch", "csrc", f"{name}.cu")
        so = str(out / f"parent_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the parent's {name}:\n{log}")
        print(f"[probe] parent {name}.cu built: "
              + " ".join(line.strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line),
              flush=True)
        libs[name] = ctypes.CDLL(so)
    mods = {}
    load = _build.load
    _build.load = libs.__getitem__
    try:
        for name in KERNELS:
            path = os.path.join(root, "src", "repro_torch", "kernels", name,
                                f"{name}.py")
            spec = importlib.util.spec_from_file_location(f"parent_{name}",
                                                          path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod._lib()              # sets the parent's argtypes, cached
            mods[name] = mod
    finally:
        _build.load = load
    return mods


def uplink_args(shape, dtype, use_ef):
    """The engine's operands (``ops.uplink_round``'s): group_rate scales
    with q-FedAvg's multipliers, a ready scalar denominator, uploads
    with a partial last packet."""
    from repro_torch.kernels.common import DENOM_EPS
    from repro_torch.kernels.uplink_fused import ops
    lead, (C, P, F) = shape[:-3], shape[-3:]
    g = torch.Generator(device="cuda").manual_seed(1234)
    x = torch.randn((*lead, C, P * F), device="cuda", generator=g)
    x[..., P * F - 11:] = 0.0
    ef = torch.randn((*lead, C, P * F), device="cuda", generator=g)
    m = (torch.rand((*lead, C, P), device="cuda", generator=g) > 0.4).float()
    w = torch.rand((*lead, C), device="cuda", generator=g) + 0.1
    suff = (torch.rand((*lead, C), device="cuda", generator=g) > 0.5).float()
    mult = torch.rand((*lead, C), device="cuda", generator=g) + 0.5
    q = ops.debias_client_scale(w, mode="group_rate", sufficient=suff,
                                loss_rate=0.4, mult=mult).contiguous()
    wd = torch.clamp(w.sum(-1), min=DENOM_EPS).contiguous()
    x = x.reshape(*lead, C, P, F).to(dtype)
    ef = ef.reshape(*lead, C, P, F).to(dtype) if use_ef else None
    return x, ef, m, q, wd


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def uplink_case(mods, label, entry, shape, dtype, use_ef, want_ssq, op,
                card):
    from repro_torch.kernels.uplink_fused import ops
    x, ef, m, q, wd = uplink_args(shape, dtype, use_ef)
    name = ("uplink_fused_batched_call" if entry == "batched"
            else "uplink_fused_call")

    def call(mod):
        out = getattr(mod, name)(x, m, q, wd, ef=ef, want_ssq=want_ssq,
                                 per_coord=False)
        return ops._outputs(*out) if op else out

    calls = {who: (lambda mod=mod: call(mod)) for who, mod in mods.items()}
    outs = {who: getattr(mod, name)(x, m, q, wd, ef=ef, want_ssq=want_ssq,
                                    per_coord=False)
            for who, mod in mods.items()}
    agg, ef_out, ssq = outs["change"]
    same = "no parent"
    if "parent" in outs:
        pa, pe, ps = outs["parent"]
        same = torch.equal(bits(agg), bits(pa)) and (
            ef_out is None or torch.equal(bits(ef_out), bits(pe)))
        if ssq is not None:
            a, b = ssq.sum(-1), ps.sum(-1)
            rel = float(((a - b).abs() / b.abs()).max())
            same = f"{same} (masked norms summed: max rel diff {rel:.3e})"
    wm = m * q[..., None]
    eq = "scpf,scp->spf" if entry == "batched" else "cpf,cp->pf"
    xf = x.float()
    n_bytes = sum(t.nbytes for t in (x, ef, m, q, wd, agg, ef_out, ssq)
                  if t is not None)
    report(f"{label} {tuple(shape)} {str(dtype)[6:]} ef={use_ef} "
           f"ssq={want_ssq}", calls, same, "uplink_fused_kernel",
           lambda: torch.einsum(eq, xf, wm), n_bytes, card)


def tra_case(mods, label, shape, card):
    from repro_torch.kernels.tra_agg import ops
    C, P, F = shape
    g = torch.Generator(device="cuda").manual_seed(66)
    x = torch.randn((C, P, F), device="cuda", generator=g)
    m = (torch.rand((C, P), device="cuda", generator=g) > 0.1).float()
    w = torch.rand((C,), device="cuda", generator=g) + 0.1
    suff = torch.rand((C,), device="cuda", generator=g) > 0.5
    x = x * m[..., None]
    # the host loop's call: group_rate pre-scales x, the mask is ones
    x, m = ops.debias_inputs(x, m, mode="group_rate",
                             nominal_rate=torch.tensor(0.1, device="cuda"),
                             sufficient=suff)
    x, m = x.contiguous(), m.contiguous()
    calls = {who: (lambda mod=mod: mod.tra_agg_call(x, m, w))
             for who, mod in mods.items()}
    outs = {who: fn() for who, fn in calls.items()}
    same = "no parent"
    if "parent" in outs:
        same = torch.equal(bits(outs["parent"]), bits(outs["change"]))
    wm = m * w[:, None]
    n_bytes = sum(t.nbytes for t in (x, m, w, outs["change"]))
    report(f"{label} {tuple(shape)} float32", calls, same,
           "tra_agg_kernel", lambda: torch.einsum("cpf,cp->pf", x, wm),
           n_bytes, card)


def report(label, calls, same, kernel, library, n_bytes, card):
    order = (("parent", "change", "change", "parent") if "parent" in calls
             else ("change", "change"))
    res = {k: {"call": [], "device": [], "host": []} for k in calls}
    for who in order:
        fn = calls[who]
        res[who]["call"].append(median_ms(fn))
        res[who]["device"].append(device_ms(fn, kernel))
        res[who]["host"].append(host_us(fn))
    lib_ms = median_ms(library)
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    for who in ("parent", "change"):
        if who not in res:
            continue
        r = res[who]
        print(f"[probe] {label} {who}: call "
              + " / ".join(f"{v:.4f}" for v in r["call"]) + " ms, device "
              + " / ".join(map(ms, r["device"])) + " ms, host "
              + " / ".join(f"{v:.2f}" for v in r["host"]) + " us | "
              + card, flush=True)
    print(f"[probe] {label}: einsum {lib_ms:.4f} ms a call; byte bound "
          f"{bound:.6f} ms ({n_bytes} B at 3.35 TB/s); parent and change "
          f"equal: {same} | {card}", flush=True)


def time_plans(uf, ta, card):
    """Device time of this checkout's kernels with one plan field changed:
    ``uplink_fused`` with a thread over 1 float and over 4 (whichever the
    plan did not pick), and with each packet row split over twice the
    CTAs (half the threads); ``tra_agg`` with four rows of 256 floats a
    CTA (256 threads) instead of one; each beside the plan as it is."""
    base_uf, base_ta = uf.plan, ta.plan

    def split2(S, C, P, F, ef, bf16, ssq):
        pl = base_uf(S, C, P, F, ef, bf16, ssq)
        if pl.threads < 64:
            return pl
        return pl._replace(threads=pl.threads // 2, tiles=2 * pl.tiles,
                           smem=pl.smem // 2)

    def other_floats(S, C, P, F, ef, bf16, ssq):
        pl = base_uf(S, C, P, F, ef, bf16, ssq)
        n = 5 - pl.floats                  # 1 <-> 4
        groups = -(-F // n)
        threads = min(uf.MAX_THREADS, -(-groups // 32) * 32)
        row = n * threads * (2 if bf16 else 4) * (2 if ef else 1)
        chunk = max(1, min(uf.CHUNK, C, uf.SMEM_BUDGET // row))
        return uf.Plan(threads, -(-groups // threads), n, chunk, chunk * row)

    def rows4(S, C, P, F):
        pl = base_ta(S, C, P, F)
        if F != 256 or P % 4:
            return pl
        chunk = min(pl.chunk, ta.SMEM_BUDGET // (16 * 256))
        return pl._replace(rows=4, threads=256, chunk=chunk,
                           smem=chunk * 16 * 256)

    try:
        for shape, ssq in (((10, 36, 256), True), ((10, 36, 256), False),
                           ((27, 10, 36, 256), False),
                           ((8, 64, 36, 256), False)):
            x, ef, m, q, wd = uplink_args(shape, torch.float32, False)
            entry = (uf.uplink_fused_batched_call if len(shape) == 4
                     else uf.uplink_fused_call)
            for name, fn in (("as planned", base_uf),
                             ("the other floats a thread", other_floats),
                             ("rows split", split2), ("as planned", base_uf)):
                uf.plan = fn
                t = device_ms(lambda: entry(x, m, q, wd, want_ssq=ssq,
                                            per_coord=False),
                              "uplink_fused_kernel")
                print(f"[probe] plan uplink_fused {shape} ssq={ssq} {name}: "
                      f"device {ms(t)} ms | {card}", flush=True)
        for shape in ((10, 36, 256), (16, 1024, 256)):
            g = torch.Generator(device="cuda").manual_seed(5)
            x = torch.randn(shape, device="cuda", generator=g)
            m = (torch.rand(shape[:2], device="cuda", generator=g)
                 > 0.1).float()
            w = torch.rand(shape[:1], device="cuda", generator=g) + 0.1
            for name, fn in (("as planned", base_ta), ("4 rows a CTA", rows4),
                             ("as planned", base_ta)):
                ta.plan = fn
                t = device_ms(lambda: ta.tra_agg_call(x, m, w),
                              "tra_agg_kernel")
                print(f"[probe] plan tra_agg {shape} {name}: device {ms(t)} "
                      f"ms | {card}", flush=True)
    finally:
        uf.plan, ta.plan = base_uf, base_ta


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a checkout whose kernels and bindings to time "
                         "against this one's, in turns")
    ap.add_argument("--plans", action="store_true",
                    help="also time this checkout's kernels with one plan "
                         "field changed (time_plans)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_uplink_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.tra_agg import tra_agg as ta
    from repro_torch.kernels.uplink_fused import uplink_fused as uf
    _build.build_all(KERNELS)
    for name in KERNELS:
        log = _build.BUILD_LOG.get(name, (0.0, ""))[1]
        print(f"[probe] change {name}.cu built: "
              + " ".join(line.strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line),
              flush=True)
    card = card_line()
    uplink, tra = {"change": uf}, {"change": ta}
    if args.parent:
        parent = load_parent(os.path.abspath(args.parent))
        uplink["parent"] = parent["uplink_fused"]
        tra["parent"] = parent["tra_agg"]
    for label, entry, shape, dtype, use_ef, want_ssq, op in CASES:
        if entry == "tra":
            tra_case(tra, label, shape, card)
        else:
            uplink_case(uplink, label, entry, shape, dtype, use_ef,
                        want_ssq, op, card)
    if args.plans:
        time_plans(uf, ta, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
