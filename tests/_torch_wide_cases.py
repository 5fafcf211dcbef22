"""Card cases shared by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``:
the scenario, batch and kv-head axes past 65,535 (grid.y and grid.z's
limit), where the bindings launch a chunk at a time, and the uplink at
SCAFFOLD's upload shape. Each function runs on ``dev`` (a CUDA device),
raises ``AssertionError`` on a mismatch and returns what the caller
reports. Imports no JAX.

The tolerances: past the limit every scenario, or (b, kv) slice, is
bitwise what a launch that holds it below the limit gives: the first
65,535 in one launch, the rest in their own, and a sample of scenarios
each in its own single launch; against the plain version at the kernel
tests' tolerances (uplink rtol 1e-5 / atol 1e-6, EF bitwise, ssq rtol
1e-5; robust 1e-6 with NaN by position; tra_agg 1e-6; flash_decode f32
2e-5, bf16 2e-2).
"""
import numpy as np
import torch

from repro_torch.kernels.common import DENOM_EPS
from repro_torch.kernels.flash_decode import flash_decode as fd
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.robust_agg import robust_agg as ra
from repro_torch.kernels.robust_agg.ref import robust_ref
from repro_torch.kernels.tra_agg import tra_agg as ta
from repro_torch.kernels.tra_agg.ref import tra_agg_ref
from repro_torch.kernels.uplink_fused import ops as uplink_ops
from repro_torch.kernels.uplink_fused import uplink_fused as uf
from repro_torch.kernels.uplink_fused.ref import uplink_ref

WIDE = 65536                    # one past the most a grid axis takes
HELD = 65535                    # the most one launch holds
SAMPLE = (0, 31337, HELD - 1, HELD)     # scenarios also run alone
SCAFFOLD_SHAPE = (10, 72, 256)  # SCAFFOLD's (dw ++ dc): 2 x 9,098 floats
SCAFFOLD_D_UP = 2 * 9098        # the last of the 72 packets 20 floats full


class RecordingLib:
    """Stands in for a kernel's library in the CPU tests of the chunked
    launches: records each launch's arguments and returns success."""
    def __init__(self, name):
        self.calls = []
        setattr(self, name, lambda *a: self.calls.append(a) or 0)


def _t(a, dev):
    return torch.tensor(np.asarray(a), device=dev)


def same_bits(a, b):
    """Equal bit for bit, a NaN compared by position."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan],
                                                            b[~nan])


def uplink_wide(dev, *, per_coord, use_ef, seed=0):
    """uplink_fused_batched at S = 65,536: returns (launches of the call,
    max |agg - plain|)."""
    S, C, P, F = WIDE, 2, 3, 8
    rng = np.random.default_rng(seed)
    x = _t(rng.normal(size=(S, C, P, F)).astype(np.float32), dev)
    ef = _t(rng.normal(size=(S, C, P, F)).astype(np.float32), dev) \
        if use_ef else None
    m = _t((rng.random((S, C, P)) > 0.4).astype(np.float32), dev)
    w = _t((rng.random((S, C)) + 0.1).astype(np.float32), dev)
    q = _t((rng.random((S, C)) + 0.5).astype(np.float32), dev)
    wd = w if per_coord else torch.clamp(w.sum(-1), min=DENOM_EPS)

    def call(s):
        return uf.uplink_fused_batched_call(
            x[s], m[s], q[s], wd[s], ef=None if ef is None else ef[s],
            want_ssq=True, per_coord=per_coord)

    before = uf.BATCHED_LAUNCHES
    agg, ef_out, ssq = call(slice(None))
    torch.cuda.synchronize()
    launches = uf.BATCHED_LAUNCHES - before
    assert launches == 2, launches
    parts = [call(slice(0, HELD)), call(slice(HELD, None))]
    for i, out in enumerate((agg, ef_out, ssq)):
        if out is not None:
            assert torch.equal(out, torch.cat([p[i] for p in parts])), i
    for s in SAMPLE:
        a, e, n = uf.uplink_fused_call(
            x[s], m[s], q[s], wd[s], ef=None if ef is None else ef[s],
            want_ssq=True, per_coord=per_coord)
        assert torch.equal(a, agg[s]) and torch.equal(n, ssq[s]), s
        if use_ef:
            assert torch.equal(e, ef_out[s]), s
    r_agg, r_ef, r_ssq = uplink_ref(x, m, q, wd, ef=ef, want_ssq=True,
                                    per_coord=per_coord)
    torch.testing.assert_close(agg, r_agg, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ssq.sum(-1), r_ssq, rtol=1e-5, atol=0.0)
    if use_ef:
        assert torch.equal(ef_out, r_ef)
    return launches, float((agg - r_agg).abs().max())


def robust_wide(dev, *, trim_k, use_ef, seed=1):
    """robust_agg_batched at S = 65,536, NaN and Inf planted in every
    scenario, the gates on in some: returns (launches, max |agg -
    plain| over the finite entries)."""
    S, C, P, F = WIDE, 5, 2, 32
    rng = np.random.default_rng(seed)
    xa = rng.normal(size=(S, C, P, F)).astype(np.float32)
    xa[:, 1, 0, 3] = np.nan
    xa[:, 3, 1, 0] = np.inf
    x = _t(xa, dev)
    ef = _t(rng.normal(size=(S, C, P, F)).astype(np.float32), dev) \
        if use_ef else None
    m = _t((rng.random((S, C, P)) > 0.3).astype(np.float32), dev)
    q = _t((rng.random((S, C)) + 0.5).astype(np.float32), dev)
    g = _t((rng.random((S, C)) + 0.5).astype(np.float32), dev)
    w = _t((rng.random((S, C)) + 0.1).astype(np.float32), dev)
    w_pos = (w > 0).float()
    wd = torch.clamp(w.sum(-1), min=DENOM_EPS)
    scr = _t((np.arange(S) % 3 != 0).astype(np.float32), dev)
    trg = _t((np.arange(S) % 2 == 0).astype(np.float32), dev)

    def call(s):
        return ra.robust_agg_batched_call(
            x[s], m[s], q[s], wd[s], scr[s], trg[s],
            ef=None if ef is None else ef[s], g=g[s], w_pos=w_pos[s],
            trim_k=trim_k, per_coord=False)

    before = ra.BATCHED_LAUNCHES
    agg, ef_out = call(slice(None))
    torch.cuda.synchronize()
    launches = ra.BATCHED_LAUNCHES - before
    assert launches == 2, launches
    parts = [call(slice(0, HELD)), call(slice(HELD, None))]
    assert same_bits(agg, torch.cat([p[0] for p in parts]))
    if use_ef:
        assert same_bits(ef_out, torch.cat([p[1] for p in parts]))
    for s in SAMPLE:
        a, e = ra.robust_agg_call(
            x[s], m[s], q[s], wd[s], scr[s], trg[s],
            ef=None if ef is None else ef[s], g=g[s], w_pos=w_pos[s],
            trim_k=trim_k, per_coord=False)
        assert same_bits(a, agg[s]), s
        if use_ef:
            assert same_bits(e, ef_out[s]), s
    r_agg, _, _ = robust_ref(x, m, q, wd, ef=ef, screen=scr, trim_gate=trg,
                             g=g, w_pos=w_pos, trim_k=trim_k,
                             per_coord=False)
    torch.testing.assert_close(agg, r_agg, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    fin = torch.isfinite(r_agg)
    return launches, float((agg[fin] - r_agg[fin]).abs().max())


def tra_wide(dev, seed=2):
    """tra_agg_batched at S = 65,536: returns (launches, max |out -
    plain|)."""
    S, C, P, F = WIDE, 3, 2, 8
    rng = np.random.default_rng(seed)
    x = _t(rng.normal(size=(S, C, P, F)).astype(np.float32), dev)
    m = _t((rng.random((S, C, P)) > 0.4).astype(np.float32), dev)
    w = _t((rng.random((S, C)) + 0.1).astype(np.float32), dev)
    before = ta.LAUNCHES
    out = ta.tra_agg_batched_call(x, m, w)
    torch.cuda.synchronize()
    launches = ta.LAUNCHES - before
    assert launches == 2, launches
    assert torch.equal(out, torch.cat([
        ta.tra_agg_batched_call(x[s], m[s], w[s])
        for s in (slice(0, HELD), slice(HELD, None))]))
    for s in SAMPLE:
        assert torch.equal(ta.tra_agg_call(x[s], m[s], w[s]), out[s]), s
    ref = tra_agg_ref(x, m, w)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    return launches, float((out - ref).abs().max())


def flash_wide(dev, *, axis, T, dtype, seed=3):
    """flash_decode with B (``axis`` "B") or KV ("KV") = 65,536, G = 1,
    dh = 32: each (b, kv) slice bitwise the launches that hold it below
    the limit. Returns (launches, max |out - plain|)."""
    B, KV = (WIDE, 1) if axis == "B" else (1, WIDE)
    dh = 32
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(B, KV, 1, dh)).astype(np.float32), dev)
    k, v = (_t(rng.normal(size=(B, T, KV, dh)).astype(np.float32),
               dev).to(dtype) for _ in range(2))
    bias = torch.zeros(T, device=dev)
    before = fd.LAUNCHES
    out = fd.flash_decode_call(q, k, v, bias)
    torch.cuda.synchronize()
    launches = fd.LAUNCHES - before
    assert launches == 2 == fd.n_chunks(B, KV), launches
    for s in (slice(0, HELD), slice(HELD, None)):
        if axis == "B":
            part = fd.flash_decode_call(q[s], k[s], v[s], bias)
            assert torch.equal(part, out[s])
        else:
            part = fd.flash_decode_call(
                q[:, s].contiguous(), k[:, :, s].contiguous(),
                v[:, :, s].contiguous(), bias)
            assert torch.equal(part, out[:, s])
    ref = flash_decode_ref(q, k, v, bias)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    return launches, float((out - ref).abs().max())


def uplink_scaffold(dev, *, mode, use_ef, dtype, seed=4):
    """uplink_fused at SCAFFOLD's (10, 72, 256), d_up = 2 x 9,098, against
    uplink_ref with the masked norms: returns max |agg - plain|."""
    C, P, F = SCAFFOLD_SHAPE
    d_up = SCAFFOLD_D_UP
    rng = np.random.default_rng(seed)
    x = torch.zeros((C, P * F), device=dev)
    x[:, :d_up] = _t(rng.normal(size=(C, d_up)).astype(np.float32), dev)
    ef = torch.zeros((C, P * F), device=dev)
    ef[:, :d_up] = _t(rng.normal(size=(C, d_up)).astype(np.float32), dev)
    m = _t((rng.random((C, P)) > 0.3).astype(np.float32), dev)
    w = _t((rng.random(C) + 0.1).astype(np.float32), dev)
    suff = _t((rng.random(C) > 0.5).astype(np.float32), dev)
    pcnt = torch.full((P,), float(F), device=dev)
    pcnt[-1] = F - (P * F - d_up)
    q = uplink_ops.debias_client_scale(
        w, mode=mode, kept=(m @ pcnt) / d_up, sufficient=suff,
        loss_rate=0.1, mult=None)
    per_coord = mode == "per_coord_count"
    wd = w if per_coord else torch.clamp(w.sum(), min=DENOM_EPS)
    x = x.reshape(C, P, F).to(dtype)
    ef = ef.reshape(C, P, F).to(dtype) if use_ef else None
    q = q.contiguous()
    before = uf.LAUNCHES
    agg, ef_out, ssq = uf.uplink_fused_call(x, m, q, wd, ef=ef,
                                            want_ssq=True,
                                            per_coord=per_coord)
    torch.cuda.synchronize()
    assert uf.LAUNCHES == before + 1
    r_agg, r_ef, r_ssq = uplink_ref(x, m, q, wd, ef=ef, want_ssq=True,
                                    per_coord=per_coord)
    torch.testing.assert_close(agg, r_agg, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ssq.sum(-1), r_ssq, rtol=1e-5, atol=0.0)
    if use_ef:
        assert torch.equal(ef_out, r_ef.to(dtype))
    return float((agg - r_agg).abs().max())
