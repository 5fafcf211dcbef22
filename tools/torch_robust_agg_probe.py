#!/usr/bin/env python3
"""Time the port's robust_agg and packet_mask kernels against another
checkout's, in turns, on one card.

    python3 tools/torch_robust_agg_probe.py                     # this one
    python3 tools/torch_robust_agg_probe.py --parent build/parent
    python3 tools/torch_robust_agg_probe.py --parent build/parent --variants

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit; it imports no JAX. ``--parent DIR`` names a checkout (for
example the parent commit, unpacked with ``git archive HEAD~ src | tar
-x -C build/parent``) whose ``csrc/robust_agg.cu`` and
``csrc/packet_mask.cu`` are built with ``nvcc`` into
``build/robust_agg_probe/`` beside this checkout's, and whose bindings
are loaded beside this checkout's, so both run in one process on one
card. Each shape is then timed in turns: parent, change, change,
parent.

Shapes: robust_agg at the defended cell's call (C=12, P=36, F=256, the
gates on, trim 2, no EF; and trim 0), the fault grid's batched call
(S=9, per-scenario gates) and the tiling shape (64, 1024, 256) with EF
and trim 2; packet_mask at one upload (36, 256) in f32 and bf16 and at
the reference's bench shape (4096, 256) f32. For each it prints the
call's time (median of 100 single calls between CUDA events, each
started on an idle card, so the binding's host work counts), the
kernel's device time (torch.profiler), the binding's host time (host
clock over 2,000 calls), the one PyTorch call's time beside it
(``einsum`` of the aggregate, ``torch.mul``), the byte bound at 3.35
TB/s and whether the two checkouts' outputs agree bit for bit.

``--variants`` also times each checkout's robust_agg against the client
count (SWEEP_C at the recipe's P and F, trim 0 and 2: the slope is a
client's cost), and copies of this checkout's ``csrc/robust_agg.cu``
with one change each (VARIANTS) and the plan with chunks of 4 clients.
Every line ends with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import math
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

HBM_BYTES_PER_S = 3.35e12
ROBUST_SHAPES = (("robust_agg", (12, 36, 256), False, 2),
                 ("robust_agg", (12, 36, 256), False, 0),
                 ("robust_agg_batched", (9, 12, 36, 256), False, 2),
                 ("robust_agg", (64, 1024, 256), True, 2))
PM_SHAPES = (((36, 256), torch.float32), ((36, 256), torch.bfloat16),
             ((4096, 256), torch.float32))
KERNELS = ("robust_agg", "packet_mask")
# copies of this checkout's csrc/robust_agg.cu with one change each, to
# see where its device time goes (some give wrong outputs: they time only
# what is left)
VARIANTS = {
    "no_x_loads": [("    for (int j = 0; j < nc; ++j)\n      cp_async4(xr + "
                    "(size_t)j * ld, xg + j * plane);\n", "")],

    "no_chunk_barrier": [("    __syncthreads();  // the chunk's one barrier",
                          "")],
    "client_unroll_2": [
        ("    for (int j = 0; j < nc; ++j) {\n      const int c",
         "#pragma unroll 2\n    for (int j = 0; j < nc; ++j) {\n"
         "      const int c")],
}
# client counts at which each checkout's kernel is timed, trim 0 and 2
SWEEP_C = (1, 4, 8, 12, 16)


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
    """The parent checkout's robust_agg and packet_mask bindings, each
    bound to a library built from the parent's own source."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "robust_agg_probe"
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


def build_variants(src):
    """Libraries built from edited copies of ``src`` (VARIANTS)."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "robust_agg_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        cu = out / f"variant_{name}.cu"
        cu.write_text(text)
        so = str(out / f"variant_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.robust_agg_launch.argtypes = \
            _build.load("robust_agg").robust_agg_launch.argtypes
        lib.robust_agg_launch.restype = ctypes.c_int
        lib.robust_agg_error_string.argtypes = [ctypes.c_int]
        lib.robust_agg_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def time_variants(ra, card):
    """Device time of each VARIANT, and of this checkout's kernel with
    chunks of 4 clients (``chunk_4``), beside this checkout's kernel, at
    the defended cell's call (trim 2 and trim 0) and the grid's."""
    src = (os.path.join(os.path.dirname(ra.__file__), "..", "..", "csrc",
                        "robust_agg.cu"))
    with open(src) as f:
        libs = build_variants(f.read())
    base, base_plan = ra._lib, ra.plan

    def chunk_4(S, C, P, F, trim_k, ef):
        pl = base_plan(S, C, P, F, trim_k, ef)
        return pl._replace(chunk=min(4, pl.chunk))
    cases = [((12, 36, 256), 2), ((12, 36, 256), 0), ((9, 12, 36, 256), 2)]
    try:
        for shape, k in cases:
            args = robust_args(shape, False)
            x, m, q, wd, scr, trg, ef, g, w_pos = args
            entry = (ra.robust_agg_batched_call if x.dim() == 4
                     else ra.robust_agg_call)

            def call():
                return entry(x, m, q, wd, scr, trg, ef=ef, g=g, w_pos=w_pos,
                             trim_k=k, per_coord=False)
            for name in ("this", *libs, "chunk_4", "this"):
                ra._lib = (lambda lib=libs[name]: lib) if name in libs \
                    else base
                ra.plan = chunk_4 if name == "chunk_4" else base_plan
                print(f"[probe] variant {name} {shape} trim {k}: device "
                      f"{ms(device_ms(call, 'robust_agg_kernel'))} ms | "
                      f"{card}", flush=True)
    finally:
        ra._lib, ra.plan = base, base_plan


def time_sweep(mods, card):
    """Device time against the client count at the recipe's P and F, trim
    0 and 2, for each checkout: the slope is the cost of a client."""
    for k in (0, 2):
        for C in SWEEP_C:
            x, m, q, wd, scr, trg, ef, g, w_pos = robust_args((C, 36, 256),
                                                              False)
            times = [f"{label} " + ms(device_ms(
                lambda mod=mod: mod.robust_agg_call(
                    x, m, q, wd, scr, trg, ef=ef, g=g, w_pos=w_pos,
                    trim_k=k, per_coord=False), "robust_agg_kernel"))
                for label, mod in mods.items()]
            print(f"[probe] sweep C={C} P=36 F=256 trim {k}: device ms "
                  + ", ".join(times) + f" | {card}", flush=True)


def robust_args(shape, use_ef):
    """The engine's operands (``robust_prepass``) with NaN and Inf
    planted; the gates on (per scenario: odd ones on when batched)."""
    from repro_torch.kernels.robust_agg.ops import robust_prepass
    from repro_torch.netsim.faults import CLIP_OFF
    lead = shape[:-3]
    C, P, F = shape[-3:]
    S = lead[0] if lead else 1
    pres = []
    for s in range(S):
        g = torch.Generator(device="cuda").manual_seed(77 + s)
        x = torch.randn((C, P, F), device="cuda", generator=g)
        x[min(1, C - 1), 2, 3] = math.nan
        x[min(3, C - 1), 0, 0] = math.inf
        m = (torch.rand((C, P), device="cuda", generator=g) > 0.3).float()
        w = torch.rand((C,), device="cuda", generator=g) + 0.1
        suff = (torch.rand((C,), device="cuda", generator=g) > 0.5).float()
        ef = (torch.randn((C, P * F), device="cuda", generator=g)
              if use_ef else None)
        on = not lead or s % 2 == 1
        pres.append(robust_prepass(
            x, m, w, mode="group_rate", d_up=P * F, screen=float(on),
            clip_norm=5.0 if on else CLIP_OFF, trim_gate=float(on), trim_k=2,
            ef_rows=ef, sufficient=suff, loss_rate=0.3))
    args = pres[0].args
    if lead:
        args = tuple(None if a is None else torch.stack(
            [p.args[j] for p in pres]) for j, a in enumerate(args))
    return args


def robust_case(mods, name, shape, use_ef, trim_k, card):
    args = robust_args(shape, use_ef)
    x, m, q, wd, scr, trg, ef, g, w_pos = args
    kw = dict(ef=ef, g=g, w_pos=w_pos, trim_k=trim_k, per_coord=False)
    entry = f"{name}_call"
    wm = m * q[..., None]
    eq = "scpf,scp->spf" if x.dim() == 4 else "cpf,cp->pf"
    calls = {label: (lambda mod=mod: getattr(mod, entry)(
        x, m, q, wd, scr, trg, **kw)) for label, mod in mods.items()}
    outs = {label: fn() for label, fn in calls.items()}
    agg, ef_out = outs["change"]
    read = args if trim_k else args[:7]
    n_bytes = sum(t.nbytes for t in (*read, agg, ef_out) if t is not None)
    report(f"{name} {tuple(shape)} f32 trim {trim_k} ef={use_ef}", calls,
           outs,
           "robust_agg_kernel", lambda: torch.einsum(eq, x, wm),
           "einsum of the aggregate", n_bytes, card)


def pm_case(mods, shape, dtype, card):
    R, F = shape
    g = torch.Generator(device="cuda").manual_seed(67)
    x = torch.randn(shape, device="cuda", generator=g).to(dtype)
    x[0, :3] = torch.tensor([math.nan, math.inf, -0.0])
    m = (torch.rand((R,), device="cuda", generator=g) > 0.3).float()
    m[0] = 0.0
    m2 = m.to(dtype)[:, None]
    calls = {label: (lambda mod=mod: mod.packet_mask_call(x, m))
             for label, mod in mods.items()}
    outs = {label: (fn(),) for label, fn in calls.items()}
    n_bytes = 2 * x.nbytes + m.nbytes
    report(f"packet_mask {shape} {str(dtype)[6:]}", calls, outs,
           "packet_mask", lambda: torch.mul(x, m2), "torch.mul", n_bytes,
           card)


def bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def report(label, calls, outs, kernel, library, lib_name, n_bytes, card):
    same = "no parent"
    if "parent" in outs:
        same = all(a is None and b is None or torch.equal(bits(a), bits(b))
                   for a, b in zip(outs["parent"], outs["change"]))
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
    print(f"[probe] {label}: {lib_name} {lib_ms:.4f} ms a call; byte bound "
          f"{bound:.6f} ms ({n_bytes} B at 3.35 TB/s); parent and change "
          f"bitwise equal: {same} | {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a checkout whose kernels and bindings to time "
                         "against this one's, in turns")
    ap.add_argument("--variants", action="store_true",
                    help="also time edited copies of this checkout's "
                         "robust_agg.cu (VARIANTS)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_robust_agg_probe: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.packet_mask import packet_mask as pm
    from repro_torch.kernels.robust_agg import robust_agg as ra
    _build.build_all(KERNELS)
    for name in KERNELS:
        log = _build.BUILD_LOG.get(name, (0.0, ""))[1]
        print(f"[probe] change {name}.cu built: "
              + " ".join(line.strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line),
              flush=True)
    card = card_line()
    robust = {"change": ra}
    masks = {"change": pm}
    if args.parent:
        parent = load_parent(os.path.abspath(args.parent))
        robust["parent"] = parent["robust_agg"]
        masks["parent"] = parent["packet_mask"]
    for name, shape, use_ef, trim_k in ROBUST_SHAPES:
        robust_case(robust, name, shape, use_ef, trim_k, card)
    for shape, dtype in PM_SHAPES:
        pm_case(masks, shape, dtype, card)
    if args.variants:
        time_sweep(robust, card)
        time_variants(ra, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
