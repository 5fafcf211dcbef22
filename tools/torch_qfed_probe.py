#!/usr/bin/env python3
"""Time the port's q-FedAvg reweighting kernel, qfed_reweight, against
another checkout's, in turns, on one card.

    python3 tools/torch_qfed_probe.py                        # this one
    python3 tools/torch_qfed_probe.py --parent build/parent
    python3 tools/torch_qfed_probe.py --parent build/parent \\
        --change build/parent                      # the parent alone
    python3 tools/torch_qfed_probe.py --plans      # geometry variants
    python3 tools/torch_qfed_probe.py --variants   # edited sources

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit; it imports no JAX. ``--parent DIR`` names a checkout (for
example the parent commit, unpacked with ``mkdir -p build/parent && git
archive HEAD~ src | tar -x -C build/parent``); ``--change DIR`` another
(this checkout by default). Each checkout's ``csrc/qfed_reweight.cu`` is
built with ``nvcc`` into ``build/qfed_probe/`` (one ``nvcc`` a source,
started together) and its binding is loaded beside the other's, so both
run in one process on one card. Each case is then timed in turns:
parent, change, change, parent.

A call is what the checkout's ``repro_torch::qfed_reweight`` op runs on
the card: the binding, and where the binding returns per-block partials
(C, G), as the kernel did before it reduced the norms itself, the op's
sum over G. Cases (CASES): the q-FedAvg host loop's (C, P, F) = (10, 36,
256) and the reference's bench shape (16, 1024, 256). For each it prints
the call's time (median of single calls between CUDA events, each
started on an idle card, so the binding's host work counts), the device
time a call summed over every device op the call makes, and the number
of those ops (torch.profiler), the call's host time (host clock over
2,000 calls), the byte bound at 3.35 TB/s (dw and fq read once, delta
and the (C,) norms written once), ``torch.mul`` of dw by fq as a
yardstick for delta alone, whether the two checkouts give the same bits
and how the change holds against the plain version. ``--plans`` also
times the change's kernel with one field of its launch plan changed
(``time_plans``); ``--variants`` times edited copies of the change's
source, each with one part of the work taken out (``VARIANTS``: their
outputs are wrong by design), to show where a call's device time goes.
Every line ends with the card's name and power limit.
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
NAME = "qfed_reweight"
CASES = ((10, 36, 256), (16, 1024, 256))
# edits of csrc/qfed_reweight.cu, each taking one part of the work out
VARIANTS = {
    "no block sum": (("acc = block_sum(acc, red);", ""),),
    "no cluster exchange": (
        ("if (K > 1) cluster_arrive_relaxed();", ""),
        ("if (K == 1) {", "if (true) {")),
    "no delta stores": (("out[base + u * step] = scale(v[u], s);", ""),),
    "no dw loads": (("v[u] = in[base + u * step];", "v[u] = Unit{};"),),
    "no fq load": (("const float s = fq[c];", "const float s = 1.5f;"),),
    "no start barrier": (("if (K > 1) cluster_arrive_relaxed();", ""),
                         ("  cluster_wait();\n", "")),
    "rank 0 waits alone": ((
        "cluster.sync();",
        "asm volatile(\"barrier.cluster.arrive.release.aligned;\" ::: "
        "\"memory\"); if (rank) return; asm volatile(\"barrier.cluster."
        "wait.acquire.aligned;\" ::: \"memory\");"),),
}


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


def device_ms(fn, reps=20):
    """(device ms a call summed over every device op, device ops
    recorded a call) over ``reps`` calls, from torch.profiler: each op's
    mean over the events recorded, times its launches a call (the
    profiler can drop events); (None, 0) where it saw no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count:
            total += (ev.self_device_time_total / ev.count
                      * max(1, round(ev.count / reps)))
            count += ev.count
    if not total:
        return None, 0
    return total / 1e3, count / reps


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
    """``{tag: binding module}`` for each ``tag -> root``: the
    checkout's binding, bound to a library built from that checkout's
    own source."""
    from repro_torch.kernels import _build
    out = _build.BUILD_DIR.parent / "qfed_probe"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, root in roots.items():
        cu = os.path.join(root, "src", "repro_torch", "csrc", f"{NAME}.cu")
        so = str(out / f"{tag}_{NAME}.so")
        procs[tag] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for tag, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {tag}'s {NAME}:\n{log}")
        print(f"[probe] {tag} {NAME}.cu built: "
              + " ".join(line.strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line),
              flush=True)
        libs[tag] = ctypes.CDLL(so)
    mods = {}
    load = _build.load
    try:
        for tag, root in roots.items():
            _build.load = lambda n, tag=tag: libs[tag]
            path = os.path.join(root, "src", "repro_torch", "kernels", NAME,
                                f"{NAME}.py")
            spec = importlib.util.spec_from_file_location(f"{tag}_{NAME}",
                                                          path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mod._lib()              # sets that checkout's argtypes, cached
            mods[tag] = mod
    finally:
        _build.load = load
    return mods


def op_call(mod, dw, fq):
    """The checkout's op on the card: its binding, then the sum over G
    where the binding returns (C, G) partials."""
    delta, ssq = mod.qfed_reweight_call(dw, fq)
    return delta, (ssq.sum(dim=1) if ssq.dim() == 2 else ssq)


def case_args(shape, seed=68):
    C = shape[0]
    g = torch.Generator(device="cuda").manual_seed(seed)
    dw = torch.randn(shape, device="cuda", generator=g)
    fq = torch.rand((C,), device="cuda", generator=g) + 0.5
    return dw, fq


def rel_err(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())


def run_case(mods, shape, card):
    from repro_torch.kernels.qfed_reweight.ref import qfed_reweight_ref
    dw, fq = case_args(shape)
    fq3 = fq[:, None, None]
    calls = {tag: (lambda m=m: op_call(m, dw, fq)) for tag, m in mods.items()}
    outs = {tag: fn() for tag, fn in calls.items()}
    delta, ssq = outs["change"]
    again = calls["change"]()
    d_ref, s_ref = qfed_reweight_ref(dw, fq)
    same = "no parent"
    if "parent" in outs:
        pd, ps = outs["parent"]
        same = (f"delta {torch.equal(delta, pd)}, ssq "
                f"{torch.equal(ssq, ps)} (max rel diff "
                f"{rel_err(ssq, ps):.3e})")
    label = f"{NAME} (C, P, F) = {shape}"
    order = (("parent", "change", "change", "parent") if "parent" in calls
             else ("change", "change"))
    reps = 20 if shape[1] > 100 else 100
    res = {k: {"call": [], "device": [], "ops": [], "host": []}
           for k in calls}
    for who in order:
        fn = calls[who]
        res[who]["call"].append(median_ms(fn, reps=reps))
        t, n = device_ms(fn)
        res[who]["device"].append(t)
        res[who]["ops"].append(n)
        res[who]["host"].append(host_us(fn))
    for who in ("parent", "change"):
        if who not in res:
            continue
        r = res[who]
        print(f"[probe] {label} {who}: call "
              + " / ".join(f"{v:.4f}" for v in r["call"]) + " ms, device "
              + " / ".join(map(ms, r["device"])) + " ms in "
              + " / ".join(f"{v:g}" for v in r["ops"]) + " ops a call, host "
              + " / ".join(f"{v:.2f}" for v in r["host"]) + " us | "
              + card, flush=True)

    def mul():
        return torch.mul(dw, fq3)

    mul_call = median_ms(mul, reps=reps)
    mul_dev, _ = device_ms(mul)
    n_bytes = dw.nbytes + fq.nbytes + delta.nbytes + ssq.nbytes
    print(f"[probe] {label}: byte bound {n_bytes / HBM_BYTES_PER_S * 1e3:.7f}"
          f" ms ({n_bytes} B at 3.35 TB/s); torch.mul of delta alone call "
          f"{mul_call:.4f} ms, device {ms(mul_dev)} ms; parent and change "
          f"equal: {same}; change against the plain version: delta "
          f"bitwise {torch.equal(delta, d_ref)}, ssq max rel diff "
          f"{rel_err(ssq, s_ref):.3e}; two calls bitwise "
          f"{torch.equal(delta, again[0]) and torch.equal(ssq, again[1])}"
          f" | {card}", flush=True)


def time_plans(mod, card):
    """Device time of the change's kernel with its plan changed, each
    beside the plan as it is: every cluster size (CTAs a client) with
    CTAs of 128 to 1024 threads, and floats for float4 units."""
    base = mod.plan
    try:
        for shape in CASES:
            dw, fq = case_args(shape)
            C, P, F = shape
            want = base(C, P * F, True)
            variants = [("as planned", want)]
            variants += [(f"cluster {k}, {t} threads",
                          want._replace(cluster=k, threads=t, ctas=C * k))
                         for k in (1, 2, 4, 8)
                         for t in (128, 256, 288, 512, 576, 1024)
                         if (k, t) != (want.cluster, want.threads)]
            if want.vec:
                variants.append(("floats", want._replace(vec=False)))
            variants.append(("as planned", want))
            ref = op_call(mod, dw, fq)
            for name, pl in variants:
                mod.plan = lambda C, D, aligned, pl=pl: pl
                out = op_call(mod, dw, fq)
                t, n = device_ms(lambda: op_call(mod, dw, fq))
                print(f"[probe] plan {NAME} {shape} {name} {pl}: device "
                      f"{ms(t)} ms in {n:g} ops a call, delta bitwise as "
                      f"planned: {torch.equal(out[0], ref[0])}, ssq max rel "
                      f"diff {rel_err(out[1], ref[1]):.3e} | {card}",
                      flush=True)
                mod.plan = base
    finally:
        mod.plan = base


def time_variants(card):
    """Device time of edited copies of this checkout's kernel
    (VARIANTS), each beside the source as it is, at every case."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / f"{NAME}.cu").read_text()
    binding = (_build.CSRC.parent / "kernels" / NAME / f"{NAME}.py")
    roots = {"as it is": ROOT}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: {old!r} is not in "
                                   f"the source")
            text = text.replace(old, new)
        root = _build.BUILD_DIR.parent / "qfed_variants" / name.replace(
            " ", "_")
        (root / "src/repro_torch/csrc").mkdir(parents=True, exist_ok=True)
        (root / f"src/repro_torch/kernels/{NAME}").mkdir(parents=True,
                                                         exist_ok=True)
        (root / f"src/repro_torch/csrc/{NAME}.cu").write_text(text)
        (root / f"src/repro_torch/kernels/{NAME}/{NAME}.py").write_text(
            binding.read_text())
        roots[name] = str(root)
    mods = load_checkouts(roots)
    for shape in CASES:
        dw, fq = case_args(shape)
        for name in (*roots, "as it is"):
            mod = mods[name]
            t, n = device_ms(lambda: op_call(mod, dw, fq))
            print(f"[probe] variant {NAME} {shape} {name}: device {ms(t)} "
                  f"ms in {n:g} ops a call | {card}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="a checkout whose kernel and binding to time "
                         "against the change's, in turns")
    ap.add_argument("--change", default=ROOT,
                    help="the checkout under test (default: this one)")
    ap.add_argument("--plans", action="store_true",
                    help="also time the change's kernel with one plan "
                         "field changed (time_plans)")
    ap.add_argument("--variants", action="store_true",
                    help="also time edited copies of this checkout's "
                         "kernel (time_variants)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_qfed_probe: needs a CUDA card", file=sys.stderr)
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
    for shape in CASES:
        run_case(mods, shape, card)
    if args.plans:
        time_plans(mods["change"], card)
    if args.variants:
        time_variants(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
