#!/usr/bin/env python3
"""Time the port's channel kernels, netsim_mask and fec_recover, against
another checkout's, in turns, on one card.

    python3 tools/torch_channel_probe.py                     # this one
    python3 tools/torch_channel_probe.py --parent build/parent
    python3 tools/torch_channel_probe.py --parent build/parent \\
        --change build/parent                      # the parent alone
    python3 tools/torch_channel_probe.py --plans   # geometry variants

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit; it imports no JAX. ``--parent DIR`` names a checkout (for
example the parent commit, unpacked with ``mkdir -p build/parent && git
archive HEAD~ src | tar -x -C build/parent``); ``--change DIR`` another
(this checkout by default). Each checkout's ``csrc/netsim_mask.cu`` and
``csrc/fec_recover.cu`` are built with ``nvcc`` into
``build/channel_probe/`` (one ``nvcc`` a source, all started together)
and its bindings are loaded beside the other's, so both run in one
process on one card. Each case is then timed in turns: parent, change,
change, parent.

Cases (CASES): ``netsim_mask_call`` at the bursty grid's (R, P) = (270,
36), the recovery grid's (72, 36) and the tiling shape (4096, 1024);
``fec_recover_call`` at the recovery grid's (R, P, G) = (72, 36, 8) and
the tiling shapes (4096, 1024, 8) and (4096, 1024, 3). For each it
prints the call's time (median of single calls between CUDA events,
each started on an idle card, so the binding's host work counts), the
kernel's device time (torch.profiler), the binding's host time (host
clock over 2,000 calls), the byte bound at 3.35 TB/s (each input read
once, each output written once) and whether the two checkouts' outputs
agree bit for bit, and the change's with the plain version. ``--plans``
also times the change's kernels with one field of their launch plan
changed (``time_plans``). Every line ends with the card's name and power
limit.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
KERNELS = ("netsim_mask", "fec_recover")
MASK_CASES = ((270, 36), (72, 36), (4096, 1024))
FEC_CASES = ((72, 36, 8), (4096, 1024, 8), (4096, 1024, 3))


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
    """Mean device time of the kernel ``name`` over the launches the
    profiler recorded (it can drop some), or None where it saw none."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key and ev.device_type == torch.autograd.DeviceType.CUDA:
            total += ev.self_device_time_total
            count += ev.count
    return total / count / 1e3 if count and total > 0 else None


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


def load_checkouts(roots):
    """``{tag: {kernel: binding module}}`` for each ``tag -> root``: the
    checkout's bindings, each bound to a library built from that
    checkout's own source."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "channel_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, root in roots.items():
        for name in KERNELS:
            cu = os.path.join(root, "src", "repro_torch", "csrc",
                              f"{name}.cu")
            so = str(out / f"{tag}_{name}.so")
            procs[tag, name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (tag, name), (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {tag}'s {name}:\n{log}")
        print(f"[probe] {tag} {name}.cu built: "
              + " ".join(line.strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line),
              flush=True)
        libs[tag, name] = ctypes.CDLL(so)
    mods = {}
    load = _build.load
    try:
        for tag, root in roots.items():
            mods[tag] = {}
            for name in KERNELS:
                _build.load = lambda n, tag=tag: libs[tag, n]
                path = os.path.join(root, "src", "repro_torch", "kernels",
                                    name, f"{name}.py")
                spec = importlib.util.spec_from_file_location(
                    f"{tag}_{name}", path)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                mod._lib()          # sets that checkout's argtypes, cached
                mods[tag][name] = mod
    finally:
        _build.load = load
    return mods


def mask_args(shape, seed=99):
    """The sweep's operands: uniforms, states BAD at 30%, per-row flip
    rates, the GE loss rates of the bursty grid."""
    R, P = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    u_t = torch.rand((R, P), device="cuda", generator=g)
    u_e = torch.rand((R, P), device="cuda", generator=g)
    s0 = (torch.rand((R,), device="cuda", generator=g) < 0.3).to(torch.int32)
    p_gb = 0.3 * torch.rand((R,), device="cuda", generator=g)
    p_bg = torch.rand((R,), device="cuda", generator=g)
    h_g = torch.full((R,), 0.02, device="cuda")
    h_b = torch.full((R,), 0.9, device="cuda")
    return u_t, u_e, s0, p_gb, p_bg, h_g, h_b


def fec_args(shape, seed=55):
    """A 0/1 mask with about one loss a group, parities delivered at 70%."""
    R, P, G = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    mask = (torch.rand((R, P), device="cuda", generator=g) > 1.0 / G).float()
    par = (torch.rand((R, -(-P // G)), device="cuda", generator=g)
           > 0.3).float()
    return mask, par


def mask_case(mods, shape, card):
    from repro_torch.kernels.netsim_mask.ref import ge_mask_ref
    args = mask_args(shape)
    calls = {tag: (lambda m=m: m["netsim_mask"].netsim_mask_call(*args))
             for tag, m in mods.items()}
    outs = {tag: fn() for tag, fn in calls.items()}
    mask, s_fin = outs["change"]
    same = "no parent"
    if "parent" in outs:
        pm, ps = outs["parent"]
        same = torch.equal(mask, pm) and torch.equal(s_fin, ps)
    rm, rs = ge_mask_ref(*args)
    plain = torch.equal(mask, rm) and torch.equal(s_fin, rs)
    n_bytes = sum(t.nbytes for t in (*args, mask, s_fin))
    report(f"netsim_mask (R, P) = {shape}", calls, same, plain,
           "netsim_mask_kernel", n_bytes, shape[1] > 100, card)


def fec_case(mods, shape, card):
    from repro_torch.kernels.fec_recover.ref import fec_recover_ref
    mask, par = fec_args(shape)
    G = shape[2]
    calls = {tag: (lambda m=m: m["fec_recover"].fec_recover_call(
        mask, par, group=G)) for tag, m in mods.items()}
    outs = {tag: fn() for tag, fn in calls.items()}
    same = "no parent"
    if "parent" in outs:
        same = torch.equal(outs["change"], outs["parent"])
    plain = torch.equal(outs["change"], fec_recover_ref(mask, par, G))
    n_bytes = sum(t.nbytes for t in (mask, par, outs["change"]))
    report(f"fec_recover (R, P, G) = {shape}", calls, same, plain,
           "fec_recover_kernel", n_bytes, shape[1] > 100, card)


def report(label, calls, same, plain, kernel, n_bytes, big, card):
    order = (("parent", "change", "change", "parent") if "parent" in calls
             else ("change", "change"))
    reps = 20 if big else 100
    res = {k: {"call": [], "device": [], "host": []} for k in calls}
    for who in order:
        fn = calls[who]
        res[who]["call"].append(median_ms(fn, reps=reps))
        res[who]["device"].append(device_ms(fn, kernel))
        res[who]["host"].append(host_us(fn))
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
    print(f"[probe] {label}: byte bound {bound:.7f} ms ({n_bytes} B at "
          f"3.35 TB/s); parent and change equal: {same}; change equals "
          f"the plain version: {plain} | {card}", flush=True)


def time_plans(nm, fc, card):
    """Device time of the change's kernels with one plan field changed,
    each beside the plan as it is: ``netsim_mask`` with each segment
    width, 1 packet a lane where the plan takes 4, and CTAs of 64 and
    256 threads; ``fec_recover`` with the other steps a warp the kernel
    has (1, or 2 with 16-byte loads and 4 without), 1 packet a lane
    where the plan takes 4, and CTAs of 64 and 256 threads."""
    base_nm, base_fc = nm.plan, fc.plan
    try:
        for shape in MASK_CASES:
            args = mask_args(shape)
            P = shape[1]
            want = base_nm(P, P % 4 == 0)
            variants = [("as planned", want)]
            variants += [(f"lanes {n}", want._replace(lanes=n))
                         for n in (4, 8, 16, 32) if n != want.lanes]
            if want.vec:
                variants.append(("1 packet a lane", base_nm(P, False)))
            variants += [(f"{t} threads", want._replace(threads=t))
                         for t in (64, 256)]
            variants.append(("as planned", want))
            nm.plan = base_nm
            ref = nm.netsim_mask_call(*args)
            for name, pl in variants:
                nm.plan = lambda P, vec, pl=pl: pl
                out = nm.netsim_mask_call(*args)
                t = device_ms(lambda: nm.netsim_mask_call(*args),
                              "netsim_mask_kernel")
                ok = all(torch.equal(a, b) for a, b in zip(out, ref))
                print(f"[probe] plan netsim_mask {shape} {name} {pl}: "
                      f"device {ms(t)} ms, bitwise as planned: {ok} | "
                      f"{card}", flush=True)
        for shape in FEC_CASES:
            mask, par = fec_args(shape)
            _, P, G = shape
            vec = P % 4 == 0 and G % 4 == 0
            want = base_fc(P, G, vec)
            variants = [("as planned", want)]
            if want.per_step:
                other = 1 if want.steps > 1 else (2 if want.vec else 4)
                variants.append((f"{other} steps a warp",
                                 want._replace(steps=other)))
            if want.vec:
                variants.append(("1 packet a lane", base_fc(P, G, False)))
            variants += [(f"{t} threads", want._replace(threads=t))
                         for t in (64, 256)]
            variants.append(("as planned", want))
            fc.plan = base_fc
            ref = fc.fec_recover_call(mask, par, group=G)
            for name, pl in variants:
                fc.plan = lambda P, group, vec, pl=pl: pl
                out = fc.fec_recover_call(mask, par, group=G)
                t = device_ms(lambda: fc.fec_recover_call(mask, par,
                                                          group=G),
                              "fec_recover_kernel")
                print(f"[probe] plan fec_recover {shape} {name} {pl}: "
                      f"device {ms(t)} ms, bitwise as planned: "
                      f"{torch.equal(out, ref)} | {card}", flush=True)
    finally:
        nm.plan, fc.plan = base_nm, base_fc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a checkout whose kernels and bindings to time "
                         "against the change's, in turns")
    ap.add_argument("--change", default=ROOT,
                    help="the checkout under test (default: this one)")
    ap.add_argument("--plans", action="store_true",
                    help="also time the change's kernels with one plan "
                         "field changed (time_plans)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_channel_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    card = card_line()
    roots = {"change": os.path.abspath(args.change)}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    print(f"[probe] change {roots['change']}, parent "
          f"{roots.get('parent')}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda} | {card}", flush=True)
    mods = load_checkouts(roots)
    for shape in MASK_CASES:
        mask_case(mods, shape, card)
    for shape in FEC_CASES:
        fec_case(mods, shape, card)
    if args.plans:
        time_plans(mods["change"]["netsim_mask"],
                   mods["change"]["fec_recover"], card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
