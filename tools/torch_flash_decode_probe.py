#!/usr/bin/env python3
"""Time the port's flash-decode kernel, and variants of it, on one card.

    python3 tools/torch_flash_decode_probe.py             # this checkout
    python3 tools/torch_flash_decode_probe.py --root DIR  # another one
    python3 tools/torch_flash_decode_probe.py --variants  # design probes

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit; it imports no JAX. For each shape it prints the call's time
(median of 20 single calls between CUDA events, each started on an idle
card, so the binding's host work counts), the kernel's device time
(torch.profiler, summed over the flash_decode kernels of a call) and the
largest difference from the plain version, then the binding's host time
a call (host clock over 2,000 calls at the serving shapes, where the
host, not the card, sets the pace). ``--root DIR`` times the checkout
in DIR instead (for example a parent commit unpacked with
``git archive``), so two commits can be timed in turns in one session.

``--variants`` also builds copies of ``csrc/flash_decode.cu`` with one
change each (VARIANTS: the loads or the products taken out, which gives
wrong outputs and only times what is left; 8 warps on 128-row bf16
tiles; split high/low score accumulators; an L2 prefetch hint) into
``build/flash_decode_probe/`` and times them, and times the current
source under plans with one field changed (PLANS). Every line ends with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

SHAPES = (((2, 20, 1, 128, 25), torch.float32),      # the qwen1.5-4b serve
          ((2, 4, 12, 128, 25), torch.float32),      # the starcoder2 serve
          ((8, 20, 1, 128, 32768), torch.bfloat16),
          ((8, 4, 12, 128, 32768), torch.bfloat16),
          ((8, 4, 12, 128, 32768), torch.float32))
VARIANT_SHAPES = SHAPES[3:]
CP = "cp.async.cg.shared.global [%0], [%1], 16, %2;"
VARIANTS = {
    "no_loads": [("    cp_async16(ks + so, kg + off, live);\n"
                  "    cp_async16(vs + so, vg + off, live);\n", "")],
    "no_products": [("      if (s < nks) {", "      if (false) {"),
                    ("        if (j0 < nch) {", "        if (false) {"),
                    ("      if (c < nch) {\n        float4 kk[4];",
                     "      if (false) {\n        float4 kk[4];"),
                    ("    if (ct < nch && hg0 < gc) {", "    if (false) {")],
    "mma_8_warps": [("int MMA_WARPS = 4;", "int MMA_WARPS = 8;"),
                    ("flash_decode_mma<8, 4>", "flash_decode_mma<8, 2>"),
                    ("flash_decode_mma<16, 8>", "flash_decode_mma<16, 4>")],
    "mma_split_hilo": [
        ("    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};",
         "    float sc[2][4] = {};\n    float slo[2][4] = {};"),
        ("        mma_bf16(sc[0], ql[s], b0, b1);",
         "        mma_bf16(slo[0], ql[s], b0, b1);"),
        ("        mma_bf16(sc[1], ql[s], b2, b3);",
         "        mma_bf16(slo[1], ql[s], b2, b3);"),
        ("    // sc[n][e]: head gid",
         "    for (int n = 0; n < 2; ++n)\n"
         "      for (int e = 0; e < 4; ++e) sc[n][e] += slo[n][e];\n"
         "    // sc[n][e]: head gid")],
    "l2_prefetch": [(CP, CP.replace("global [", "global.L2::128B ["))],
}


def two_waves(fd, pl, dh, T):
    n = 2 * pl.n_splits
    return pl._replace(n_splits=n, split_len=-(-T // n))


def four_stages(fd, pl, dh, T):
    if pl.kind == "rows":
        return pl
    return pl._replace(stages=4, smem=fd._tile_smem(pl.kind, dh, 4))


PLANS = {"two_waves": two_waves, "four_stages": four_stages}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, reps=20, warmup=5):
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
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(ev.self_device_time_total for ev in prof.key_averages()
                if "flash_decode" in ev.key
                and ev.device_type == torch.autograd.DeviceType.CUDA)
    return total / reps / 1e3


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


def inputs(shape, dtype, ops):
    B, KV, G, dh, T = shape
    g = torch.Generator(device="cuda").manual_seed(77)
    q = torch.randn((B, KV, G, dh), device="cuda", generator=g)
    k, v = (torch.randn((B, T, KV, dh), device="cuda", generator=g)
            .to(dtype) for _ in range(2))
    return q, k, v, ops.decode_bias(T, T - 1, device="cuda")


def time_shapes(label, fd, ops, ref, shapes, card):
    for shape, dtype in shapes:
        q, k, v, bias = inputs(shape, dtype, ops)

        def call():
            return fd.flash_decode_call(q, k, v, bias)

        err = float((call() - ref(q, k, v, bias)).abs().max())
        ms = median_ms(call)
        print(f"[probe] {label} {shape} {str(dtype)[6:]}: device "
              f"{device_ms(call):.4f} ms, call {ms:.4f} ms, max |diff| vs "
              f"plain {err:.2e} | {card}", flush=True)


def build_variants(src, names):
    from repro_torch.kernels import _build
    out = os.path.join(_build.BUILD_DIR.parent, "flash_decode_probe")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in source")
            text = text.replace(old, new)
        cu = os.path.join(out, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             os.path.join(out, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_decode_launch.argtypes = [ptr] * 8 + [i32] * 13 + [
            ctypes.c_float, i32, ptr]
        lib.flash_decode_launch.restype = i32
        lib.flash_decode_error_string.argtypes = [i32]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".",
                    help="the checkout whose src/ to time")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_decode_probe: needs a CUDA card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, os.path.join(root, "src"))
    from repro_torch.kernels.flash_decode import flash_decode as fd
    from repro_torch.kernels.flash_decode import ops
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    label = os.path.basename(root) if args.root != "." else "this"
    time_shapes(label, fd, ops, flash_decode_ref, SHAPES, card)
    for shape, dtype in SHAPES[:2]:
        q, k, v, bias = inputs(shape, dtype, ops)
        us = host_us(lambda: fd.flash_decode_call(q, k, v, bias))
        print(f"[probe] {label} {shape} {str(dtype)[6:]}: binding host "
              f"time {us:.2f} us a call (host clock, 2,000 calls) | {card}",
              flush=True)
    if not args.variants:
        return 0
    src_path = os.path.join(root, "src", "repro_torch", "csrc",
                            "flash_decode.cu")
    with open(src_path) as f:
        libs = build_variants(f.read(), list(VARIANTS))
    base_lib, base_plan, rows_max_g = fd._lib, fd.plan, fd.ROWS_MAX_G
    try:
        for name, lib in libs.items():
            fd._lib = lambda lib=lib: lib
            time_shapes(f"variant {name}", fd, ops, flash_decode_ref,
                        VARIANT_SHAPES, card)
        fd._lib = base_lib
        for name, change in PLANS.items():
            fd.plan = (lambda B, KV, G, dh, T, *rest, change=change:
                       change(fd, base_plan(B, KV, G, dh, T, *rest), dh, T))
            time_shapes(f"plan {name}", fd, ops, flash_decode_ref,
                        VARIANT_SHAPES, card)
        fd.plan = base_plan
        fd.ROWS_MAX_G = 0
        fd.plan.cache_clear()
        time_shapes("plan tiles_at_g1", fd, ops, flash_decode_ref,
                    SHAPES[2:3], card)
    finally:
        fd._lib, fd.plan, fd.ROWS_MAX_G = base_lib, base_plan, rows_max_g
        fd.plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
