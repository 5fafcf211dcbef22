"""The port's CUDA kernels and paths on the card.

Every test here is marked ``cuda`` and skips without a card. The file
imports no JAX, so it runs on a machine with the card and no JAX:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the uplink kernel against its plain version agg rtol 1e-5
/ atol 1e-6 (its fp32 client loop sums in another order), EF bitwise
in the stream dtype, ssq rtol 1e-5; the batched uplink against S single
launches bitwise; the Gilbert–Elliott mask against its plain version
bitwise; a grid on the card against the CPU: cohorts and channel states
bitwise, one round's params rtol 1e-4 / atol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.server import FLConfig, run_grid
from repro_torch.core.sweep import SweepEngine
from repro_torch.core.tra import DEBIAS_MODES, TRAConfig
from repro_torch.data.synthetic import generate_synthetic
from repro_torch.kernels.common import DENOM_EPS
from repro_torch.kernels.netsim_mask import netsim_mask as t_nm
from repro_torch.kernels.netsim_mask.ref import ge_mask_ref
from repro_torch.kernels.uplink_fused import ops as t_ops
from repro_torch.kernels.uplink_fused import uplink_fused as t_uf
from repro_torch.kernels.uplink_fused.ref import uplink_ref
from repro_torch.netsim.channel import ge_transition_probs
from repro_torch.netsim.config import NetSimConfig

S, C, P, F = 3, 6, 16, 32
D_UP = P * F - 11                       # partial last packet


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _uplink_case(seed, lead=()):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=lead + (C, D_UP)).astype(np.float32)
    pad = [(0, 0)] * (len(lead) + 1) + [(0, P * F - D_UP)]
    ef = np.pad(rng.normal(size=lead + (C, D_UP)).astype(np.float32), pad)
    pcnt = np.full((P,), F, np.float32)
    pcnt[-1] = F - (P * F - D_UP)
    mask = (rng.random(lead + (C, P)) > 0.4).astype(np.float32)
    return dict(xp=np.pad(flat, pad).reshape(lead + (C, P, F)),
                ef=ef.reshape(lead + (C, P, F)), mask=mask,
                w=(rng.random(lead + (C,)) + 0.1).astype(np.float32),
                suff=(rng.random(lead + (C,)) > 0.5).astype(np.float32),
                mult=(rng.random(lead + (C,)) + 0.5).astype(np.float32),
                kept=((mask @ pcnt) / np.float32(D_UP)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", DEBIAS_MODES)
@pytest.mark.parametrize("use_ef", [False, True])
def test_cuda_kernel_matches_plain(dev, dtype, mode, use_ef):
    t = {k: torch.tensor(v, device=dev) for k, v in _uplink_case(7).items()}
    q = t_ops.debias_client_scale(t["w"], mode=mode, kept=t["kept"],
                                  sufficient=t["suff"], loss_rate=0.4,
                                  mult=t["mult"])
    per_coord = mode == "per_coord_count"
    wd = t["w"] if per_coord else torch.clamp(t["w"].sum(), min=DENOM_EPS)
    x = t["xp"].to(dtype)
    ef = t["ef"].to(dtype) if use_ef else None
    before = t_uf.LAUNCHES
    agg, ef_out, ssq = t_uf.uplink_fused_call(
        x, t["mask"], q, wd, ef=ef, want_ssq=True, per_coord=per_coord)
    torch.cuda.synchronize()
    assert t_uf.LAUNCHES == before + 1
    r_agg, r_ef, r_ssq = uplink_ref(x, t["mask"], q, wd, ef=ef,
                                    want_ssq=True, per_coord=per_coord)
    torch.testing.assert_close(agg, r_agg, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ssq.sum(-1), r_ssq, rtol=1e-5, atol=0.0)
    if use_ef:
        assert torch.equal(ef_out, r_ef.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_coord", [False, True])
@pytest.mark.parametrize("use_ef", [False, True])
def test_cuda_batched_kernel_equals_single_launches(dev, dtype, per_coord,
                                                    use_ef):
    """One batched launch against S single launches: bitwise (each CTA
    does a single CTA's work in the same order); and against the plain
    version at the single kernel's tolerances."""
    sc = {k: torch.tensor(v, device=dev) for k, v in
          _uplink_case(11, (S,)).items()}
    x = sc["xp"].to(dtype)
    ef = sc["ef"].to(dtype) if use_ef else None
    q = sc["w"] * sc["mult"]
    wd = sc["w"] if per_coord else sc["w"].sum(-1)
    before = t_uf.BATCHED_LAUNCHES
    agg, ef_out, ssq = t_uf.uplink_fused_batched_call(
        x, sc["mask"], q, wd, ef=ef, want_ssq=True, per_coord=per_coord)
    torch.cuda.synchronize()
    assert t_uf.BATCHED_LAUNCHES == before + 1
    for i in range(S):
        a, e, s = t_uf.uplink_fused_call(
            x[i], sc["mask"][i], q[i], wd[i],
            ef=None if ef is None else ef[i], want_ssq=True,
            per_coord=per_coord)
        assert torch.equal(a, agg[i]) and torch.equal(s, ssq[i])
        if use_ef:
            assert torch.equal(e, ef_out[i])
    r_agg, r_ef, r_ssq = uplink_ref(x, sc["mask"], q, wd, ef=ef,
                                    want_ssq=True, per_coord=per_coord)
    torch.testing.assert_close(agg, r_agg, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ssq.sum(-1), r_ssq, rtol=1e-5, atol=0.0)
    if use_ef:
        assert torch.equal(ef_out, r_ef.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("R,P_", [(270, 36), (4096, 1024), (7, 129)])
def test_cuda_netsim_mask_matches_plain(dev, R, P_):
    rng = np.random.default_rng(R + P_)
    u_t, u_e = (torch.tensor(rng.random((R, P_)).astype(np.float32),
                             device=dev) for _ in range(2))
    s0 = torch.tensor((rng.random(R) < 0.4).astype(np.int32), device=dev)
    rates = torch.tensor(rng.uniform(0.05, 0.4, R).astype(np.float32),
                         device=dev)
    p_gb, p_bg = ge_transition_probs(rates, 6.0, 0.02, 0.9)
    p_bg = p_bg.to(dev).expand(R).contiguous()
    h_g = torch.full((R,), 0.02, device=dev)
    h_b = torch.full((R,), 0.9, device=dev)
    before = t_nm.LAUNCHES
    m, s = t_nm.netsim_mask_call(u_t, u_e, s0, p_gb, p_bg, h_g, h_b)
    torch.cuda.synchronize()
    assert t_nm.LAUNCHES == before + 1
    mr, sr = ge_mask_ref(u_t, u_e, s0, p_gb, p_bg, h_g, h_b)
    assert torch.equal(m, mr) and torch.equal(s, sr)


def _grid(n_rounds):
    base = FLConfig(algo="fedavg", n_rounds=n_rounds, clients_per_round=8,
                    local_steps=2, batch_size=8, eval_every=100,
                    tra=TRAConfig(enabled=True),
                    netsim=NetSimConfig(channel="gilbert_elliott"))
    return [dataclasses.replace(
        base, seed=s, tra=dataclasses.replace(base.tra, loss_rate=r),
        netsim=dataclasses.replace(base.netsim, burst_len=b))
        for s in (0, 1) for r in (0.1, 0.3) for b in (2.0, 8.0)]


@pytest.mark.cuda
def test_cuda_grid_launches_and_matches_cpu(dev):
    """A grid round on the card is one batched uplink launch and one
    mask launch; its first round matches the CPU's."""
    data = generate_synthetic(np.random.default_rng(0), n_clients=20)
    counts = (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES, t_nm.LAUNCHES)
    hist = run_grid(_grid(3), data)
    torch.cuda.synchronize()
    assert (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES, t_nm.LAUNCHES) == \
        (counts[0], counts[1] + 3, counts[2] + 3)
    assert len(hist) == 8 and all(np.isfinite(h[-1].train_loss)
                                  for h in hist)
    out = {}
    for d in ("cuda", "cpu"):
        eng = SweepEngine.from_configs(_grid(1), data, device=d)
        st, logs = eng.run()
        out[d] = (logs["ids"], st.net.channel.cpu().numpy(),
                  np.concatenate([st.params[k].cpu().numpy().reshape(8, -1)
                                  for k in sorted(st.params)], axis=1))
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=1e-4,
                               atol=1e-5)
