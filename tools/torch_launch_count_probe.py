#!/usr/bin/env python3
"""Tell a change of a quickstart round from events the profiler drops:
profile the round after ``chip_smoke.py``'s setup, after its phases
1-14 and after its phase 15, in one process on one card.

    python3 tools/torch_launch_count_probe.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit; it imports no JAX. At each point it profiles three times 5
rounds of the quickstart's TRA configuration (2 warm-up rounds first)
and prints, a round:

  * ``device``: the kernels and copies the profiler recorded on the card
    (phase 8's launch count);
  * ``runtime``: the CUDA runtime calls that start them (``cudaLaunch*``,
    ``cuLaunch*``, ``cudaMemcpy*``, ``cudaMemset*``), as the profiler
    recorded them on the host;
  * ``ops``: the aten ops the round dispatches, logged by a dispatch mode
    outside the profiler, and whether their sequence (and the port's
    kernel launch counts) equals the first point's.

Every kernel whose device count differs from the first profile's is
listed with both counts. Where the ops are the same sequence and the
runtime calls the same count while the device count falls, the round is
unchanged and the profiler lost device records. The last line says
which. About 12 minutes of command time.
"""
import collections
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as s  # noqa: E402

ROUNDS = 5
RUNTIME = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


def _server():
    data, nets = s.quickstart_inputs()
    server = s.FederatedServer(s.quickstart_cfg("tra", ROUNDS), data, nets,
                               device="cuda")
    state = server.engine.init_state(server.params)
    state, _ = server.engine.run_block(state, 0, 2)
    torch.cuda.synchronize()
    return server, state


def round_counts():
    """({kernel: launches} on the card, runtime calls) over ROUNDS."""
    server, state = _server()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = server.engine.run_block(state, 2, ROUNDS)
        torch.cuda.synchronize()
    device, runtime = collections.Counter(), 0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.self_device_time_total > 0:
                device[ev.key] += ev.count
        elif ev.key.startswith(RUNTIME):
            runtime += ev.count
    return device, runtime


def round_ops():
    """The aten ops ROUNDS rounds dispatch, in order, and the port's
    kernel launch counts (no profiler)."""
    server, state = _server()
    s.zero_counts()
    with s.OpLog() as log:
        server.engine.run_block(state, 2, ROUNDS)
        torch.cuda.synchronize()
    return log.ops + sorted(f"{k}={v}" for k, v in s.counts().items())


def report(label, base):
    runs = [round_counts() for _ in range(3)]
    ops = round_ops()
    print(f"[probe] {label}: a round: device "
          f"{[sum(d.values()) / ROUNDS for d, _ in runs]}, runtime "
          f"{[r / ROUNDS for _, r in runs]}, ops {len(ops) / ROUNDS}",
          flush=True)
    if base is None:
        return dict(device=runs[0][0], runtime=runs[0][1], ops=ops,
                    same=True)
    same_ops = ops == base["ops"]
    same_runtime = all(r == base["runtime"] for _, r in runs)
    print(f"[probe]    ops the same sequence as after setup: {same_ops}; "
          f"runtime calls the same count: {same_runtime}", flush=True)
    for d, _ in runs:
        for k in sorted(set(base["device"]) | set(d)):
            if base["device"].get(k, 0) != d.get(k, 0):
                print(f"[probe]    {base['device'].get(k, 0):5d} -> "
                      f"{d.get(k, 0):5d}  {k[:110]}", flush=True)
    base["same"] = base["same"] and same_ops and same_runtime
    return base


def main() -> int:
    sys.argv = sys.argv[:1]
    card = s.setup()
    base = report("after setup", None)
    s.run_phases_1_to_14(card)
    report("after phases 1-14", base)
    s.run_train_phase(card)
    report("after phase 15", base)
    print("[probe] verdict: " + (
        "the round is unchanged; a falling device count is the profiler's"
        if base["same"] else "the round changed: see the lines above"),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
