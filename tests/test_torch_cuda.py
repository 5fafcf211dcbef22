"""The port's CUDA kernels and paths on the card.

Every test here but two is marked ``cuda`` and skips without a card;
``flash_decode_call``'s CPU refusal and its chunk count run anywhere.
The file imports no JAX, so it runs on a machine with the card and no
JAX:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the uplink kernel against its plain version agg rtol 1e-5
/ atol 1e-6 (its fp32 client loop sums in another order), EF bitwise
in the stream dtype, ssq rtol 1e-5; the batched uplink against S single
launches bitwise; the Gilbert–Elliott mask against its plain version
bitwise; a grid on the card against the CPU: cohorts and channel states
bitwise, one round's params rtol 1e-4 / atol 1e-5. The robust kernel
against its plain version: agg rtol 1e-6 / atol 1e-6 with equal NaN
positions, EF bitwise (a NaN compared by position: the card writes its
own NaN payload); batched against S single launches bitwise; with the
gates off, bitwise the uplink kernel on finite inputs; a defended grid
round on the card against the CPU: cohorts and quarantine counts
bitwise, params rtol 1e-4 / atol 1e-5. The FEC repair kernel against its
plain version bit for bit (0/1 masks with NaN entries planted), its vmap
fold one launch and bitwise S single launches; recovery grid rounds on the card against
the CPU: cohorts and both channel chains bitwise, params rtol 1e-4 /
atol 1e-5. The protocol layer's kernels against their plain versions on
the card: packet_mask bitwise in f32 and bf16 with NaN, Inf and -0.0
planted, its vmap fold one launch and bitwise; tra_agg rtol 1e-6 / atol
1e-6 for every debias mode (the plain einsum sums in another order),
its scenario axis one launch, bitwise S single launches; qfed_reweight's
delta bitwise (one multiply), ssq and h rtol 1e-5 (the kernel sums in
its own fixed order) and ssq bitwise across two calls, also misaligned,
at C = 65,536 and at zero sizes, its vmap fold one launch, a call one
device op; two host-loop rounds on the card against the CPU: cohorts and
packet masks bitwise, params rtol 1e-4 / atol 1e-5. The flash-decode
kernel against its plain version: f32 rtol/atol 2e-5, K/V in bf16 2e-2
(the reference's own), over the reference's sweep, the serving slice's
shape, GQA up to G = 20, sliding windows, ragged T, whole T splits and
whole tiles masked first or last, split boundaries inside tiles; a
reduced serve on the card against the CPU from the same
params: greedy tokens equal, logits rtol 1e-4 / atol 1e-5 (f32 matmuls
sum in another order on the card), one launch per layer and step.
Past 65,535 scenarios (the batched uplink, robust and tra_agg kernels)
or batch rows and kv heads (flash_decode): every scenario or slice
bitwise the launches that hold it below the limit
(``tests/_torch_wide_cases.py``). The uplink at SCAFFOLD's (10, 72, 256)
at the uplink tolerances; two rounds of pFedMe, Per-FedAvg, AFL and
SCAFFOLD on the card against the CPU: cohorts equal, carries rtol 1e-4
/ atol 1e-5. The uplink with the masked norms on FedAvg weights (the
gradient_norm policy's traffic), single and at S = 24, at the uplink
tolerances; a traced selection grid (every policy x two loss rates) on
the card against the CPU: cohorts and channel states bitwise, a round
from the CPU's state within the grid tolerances. The traced server-mode
grid (sync / semi_sync / async) and async with faults on the card
against the CPU, each round from the CPU's state: cohorts, channel
states, quarantine counts, arrival bits and the buffer's due and tau
bitwise, arrival weights rtol 1e-6, params rtol 1e-4 / atol 1e-5; a
checkpoint round-trip on the card bitwise. Telemetry at level full on
the card against the CPU (a traced selection grid, a grid with EF, the
recovery policies under the i.i.d. downlink), each round from the CPU's
state: the same keys, the count keys and the carry's counts bitwise, the
norms rtol 1e-4, the means 1e-6; a stream stamped with the card; level
off dispatching the ops of the step frozen before the later subsystems.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import prng
from repro_torch.core import protocol
from repro_torch.core.server import FederatedServer, FLConfig, run_grid
from repro_torch.core.sweep import SweepEngine
from repro_torch.core.tra import DEBIAS_MODES, TRAConfig, sufficiency_report
from repro_torch.data.synthetic import generate_synthetic
from repro_torch.configs.base import get_config
from repro_torch.kernels.common import DENOM_EPS
from repro_torch.kernels.fec_recover import fec_recover as t_fc
from repro_torch.kernels.fec_recover import ops as t_fec_ops
from repro_torch.kernels.fec_recover.ref import fec_recover_ref
from repro_torch.kernels.flash_decode import flash_decode as t_fd
from repro_torch.kernels.flash_decode import ops as t_fd_ops
from repro_torch.kernels.flash_decode.ref import flash_decode_ref
from repro_torch.kernels.netsim_mask import netsim_mask as t_nm
from repro_torch.kernels.netsim_mask import ops as t_nm_ops
from repro_torch.kernels.netsim_mask.ref import ge_mask_ref
from repro_torch.kernels.packet_mask import packet_mask as t_pm
from repro_torch.kernels.packet_mask.ref import packet_mask_ref
from repro_torch.kernels.qfed_reweight import ops as t_qr_ops
from repro_torch.kernels.qfed_reweight import qfed_reweight as t_qr
from repro_torch.kernels.qfed_reweight.ref import qfed_reweight_ref
from repro_torch.kernels.robust_agg import robust_agg as t_ra
from repro_torch.kernels.robust_agg.ref import robust_ref
from repro_torch.kernels.tra_agg import ops as t_ta_ops
from repro_torch.kernels.tra_agg import tra_agg as t_ta
from repro_torch.kernels.tra_agg.ref import tra_agg_ref
from repro_torch.kernels.uplink_fused import ops as t_ops
from repro_torch.kernels.uplink_fused import uplink_fused as t_uf
from repro_torch.kernels.uplink_fused.ref import uplink_ref
from repro_torch.launch import serve as t_serve
from repro_torch.models import decode as t_decode
from repro_torch.models import transformer as t_tf
from repro_torch.netsim.channel import ge_transition_probs
from repro_torch.netsim.config import NetSimConfig
from repro_torch.netsim.faults import DefenseConfig, FaultConfig, flip_bit_op
from repro_torch.netsim.recovery import RecoveryConfig
from repro_torch.network import packets as t_pk
from repro_torch.network.trace import ClientNetworks, sample_networks
from _torch_channel_cases import (FEC_G, GE_VARIANTS, MASK_P, SEEDS,
                                  fec_case, ge_case)
import _torch_wide_cases as wide

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
@pytest.mark.parametrize("shape", [(10, 36, 255), (10, 36, 20),
                                   (3, 2, 20000), (10, 36, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_coord", [False, True])
@pytest.mark.parametrize("shift", [False, True])
def test_cuda_uplink_packet_widths_are_the_parent_expressions(
        dev, shape, dtype, per_coord, shift):
    """Packet widths off a multiple of 4 and 32, a row over several CTAs
    (F = 20,000), and rows one element past an aligned address: with
    scales that make every product exact, agg and EF bitwise the
    parent's expressions over the clients in index order (xe = x + ef,
    acc += xe * m q, den += m w, ef_out = xe (1 - m) in the stream
    dtype); ssq within rtol 1e-5 of the plain version."""
    C_, P_, F_ = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                     device=dev).to(dtype)
    ef = torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                      device=dev).to(dtype)
    if shift:
        x, ef = _shifted(x), _shifted(ef)
    m = torch.tensor(rng.random((C_, P_)) > 0.4, dtype=torch.float32,
                     device=dev)
    q = _powers_of_two(rng, (C_,), dev)
    w = _powers_of_two(rng, (C_,), dev)
    wd = w if per_coord else w.sum()
    agg, ef_out, ssq = t_uf.uplink_fused_call(x, m, q, wd, ef=ef,
                                              want_ssq=True,
                                              per_coord=per_coord)
    torch.cuda.synchronize()
    acc = torch.zeros((P_, F_), device=dev)
    den = torch.zeros((P_,), device=dev)
    for c in range(C_):
        xe = x[c].float() + ef[c].float()
        acc = acc + xe * (m[c] * q[c])[:, None]
        den = den + m[c] * w[c]
        assert torch.equal(ef_out[c], (xe * (1.0 - m[c])[:, None]).to(dtype))
    d = torch.clamp(den, min=DENOM_EPS)[:, None] if per_coord else wd
    assert torch.equal(agg, acc / d)
    r_ssq = uplink_ref(x, m, q, wd, ef=ef, want_ssq=True,
                       per_coord=per_coord)[2]
    torch.testing.assert_close(ssq.sum(-1), r_ssq, rtol=1e-5, atol=0.0)


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


CARD_ROWS = 37          # no CTA's row count divides it


@pytest.mark.cuda
@pytest.mark.parametrize("variant", GE_VARIANTS)
@pytest.mark.parametrize("P_", MASK_P)
@pytest.mark.parametrize("seed", SEEDS)
def test_cuda_netsim_mask_cases_match_plain(dev, seed, P_, variant):
    """The scan kernel bitwise its plain version at the scan's edges (P
    under, at and past a warp's 32 lanes and 4 packets a lane), R = 37
    rows, NaN uniforms, every row starting BAD, flip rates 0 and 1,
    uniforms equal to their thresholds; and again on uniforms one
    element past an aligned address (the one-packet-a-lane path)."""
    case = [torch.tensor(a, device=dev)
            for a in ge_case(CARD_ROWS, P_, seed, variant)]
    for shift in (False, True):
        args = list(case)
        if shift:
            args[0], args[1] = _shifted(args[0]), _shifted(args[1])
        before = t_nm.LAUNCHES
        m, s = t_nm.netsim_mask_call(*args)
        torch.cuda.synchronize()
        assert t_nm.LAUNCHES == before + 1
        mr, sr = ge_mask_ref(*args)
        assert torch.equal(m, mr) and torch.equal(s, sr), f"shift={shift}"


@pytest.mark.cuda
def test_cuda_netsim_mask_vmap_fold_is_one_launch(dev):
    """The sweep's scenario axis through the op: one launch over S*C rows,
    bitwise S single launches."""
    S, C_, P_ = 27, 10, 36
    case = [torch.tensor(a, device=dev) for a in ge_case(S * C_, P_, 3)]
    u_t, u_e = (a.reshape(S, C_, P_) for a in case[:2])
    rows = [a.reshape(S, C_) for a in case[2:]]
    before = t_nm.LAUNCHES
    m, s = torch.func.vmap(t_nm_ops.ge_packet_mask)(u_t, u_e, *rows)
    torch.cuda.synchronize()
    assert t_nm.LAUNCHES == before + 1
    for i in range(S):
        mi, si = t_nm.netsim_mask_call(u_t[i], u_e[i],
                                       *(r[i].contiguous() for r in rows))
        assert torch.equal(m[i], mi) and torch.equal(s[i], si)


@pytest.mark.cuda
def test_cuda_netsim_mask_binding_names_each_fault(dev):
    u = torch.rand((4, 36), device=dev)
    s0 = torch.zeros(4, dtype=torch.int32, device=dev)
    r = torch.full((4,), 0.1, device=dev)
    before = t_nm.LAUNCHES
    for args, exc, msg in [
            ((u, u, s0.cpu(), r, r, r, r), ValueError,
             "CUDA tensors only, and s0 "),
            ((u, u, s0.float(), r, r, r, r), TypeError, "s0 must be"),
            ((u, u, s0, r[:3], r, r, r), ValueError,
             "p_gb must have shape"),
            ((u, u.t().contiguous().t(), s0, r, r, r, r), ValueError,
             "u_e must"),
            ((u, u, s0, r, r, r, r.double()), TypeError, "h_b must be")]:
        with pytest.raises(exc, match=msg):
            t_nm.netsim_mask_call(*args)
    assert t_nm.LAUNCHES == before
    s1 = s0 + 1
    for shape in ((0, 36), (4, 0)):
        z = torch.rand(shape, device=dev)
        rows = shape[0]
        m, s = t_nm.netsim_mask_call(z, z, s1[:rows], r[:rows], r[:rows],
                                     r[:rows], r[:rows])
        assert m.shape == shape and torch.equal(s, s1[:rows])
    assert t_nm.LAUNCHES == before


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


def _robust_case(seed, dev, lead=(), *, finite=False, per_coord=False):
    """Robust-kernel operands on the card: uploads with a partial last
    packet (NaN and Inf planted unless ``finite``), EF, masks, scales,
    trim scales, weight > 0 validity and the denominator."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (C, P, F)).astype(np.float32)
    x[..., P - 1, D_UP - (P - 1) * F:] = 0.0
    if not finite:
        x[..., 1, 2, 3] = np.nan
        x[..., 3, 0, 0] = np.inf
    w = (rng.random(lead + (C,)) + 0.1).astype(np.float32)
    w[..., 0] = 0.0
    t = {k: torch.tensor(v, device=dev) for k, v in dict(
        x=x, ef=rng.normal(size=lead + (C, P, F)).astype(np.float32),
        m=(rng.random(lead + (C, P)) > 0.4).astype(np.float32),
        q=(rng.random(lead + (C,)) + 0.5).astype(np.float32),
        g=(rng.random(lead + (C,)) + 0.5).astype(np.float32), w=w).items()}
    t["w_pos"] = (t["w"] > 0).float()
    t["wd"] = t["w"] if per_coord else torch.clamp(t["w"].sum(-1),
                                                   min=DENOM_EPS)
    return t


def _same_bits(a, b):
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan],
                                                            b[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", DEBIAS_MODES)
@pytest.mark.parametrize("gates", [(0.0, 0.0), (1.0, 1.0)])
@pytest.mark.parametrize("use_ef", [False, True])
def test_cuda_robust_kernel_matches_plain(dev, mode, gates, use_ef):
    per_coord = mode == "per_coord_count"
    trim_k = 0 if per_coord else 2
    t = _robust_case(5, dev, per_coord=per_coord)
    scr, trg = (torch.tensor(v, device=dev) for v in gates)
    kw = dict(ef=t["ef"] if use_ef else None, g=t["g"], w_pos=t["w_pos"],
              trim_k=trim_k, per_coord=per_coord)
    before = t_ra.LAUNCHES
    agg, ef_out = t_ra.robust_agg_call(t["x"], t["m"], t["q"], t["wd"],
                                       scr, trg, **kw)
    torch.cuda.synchronize()
    assert t_ra.LAUNCHES == before + 1
    r_agg, r_ef, _ = robust_ref(t["x"], t["m"], t["q"], t["wd"],
                                screen=scr, trim_gate=trg, **kw)
    torch.testing.assert_close(agg, r_agg, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    assert bool(torch.isfinite(agg).all()) == (gates[0] == 1.0)
    if use_ef:
        assert _same_bits(ef_out, r_ef)


@pytest.mark.cuda
@pytest.mark.parametrize("use_ef", [False, True])
@pytest.mark.parametrize("trim_k", [0, 2])
def test_cuda_robust_batched_equals_single_launches(dev, use_ef, trim_k):
    t = _robust_case(9, dev, (S,))
    scr = torch.tensor([1.0, 0.0, 1.0], device=dev)
    trg = torch.tensor([1.0, 0.0, 0.0], device=dev)
    ef = t["ef"] if use_ef else None
    before = t_ra.BATCHED_LAUNCHES
    agg, ef_out = t_ra.robust_agg_batched_call(
        t["x"], t["m"], t["q"], t["wd"], scr, trg, ef=ef, g=t["g"],
        w_pos=t["w_pos"], trim_k=trim_k, per_coord=False)
    torch.cuda.synchronize()
    assert t_ra.BATCHED_LAUNCHES == before + 1
    for i in range(S):
        a, e = t_ra.robust_agg_call(
            t["x"][i], t["m"][i], t["q"][i], t["wd"][i], scr[i], trg[i],
            ef=None if ef is None else ef[i], g=t["g"][i],
            w_pos=t["w_pos"][i], trim_k=trim_k, per_coord=False)
        assert _same_bits(a, agg[i])
        if use_ef:
            assert _same_bits(e, ef_out[i])
    r_agg, _, _ = robust_ref(t["x"], t["m"], t["q"], t["wd"], ef=ef,
                             screen=scr, trim_gate=trg, g=t["g"],
                             w_pos=t["w_pos"], trim_k=trim_k,
                             per_coord=False)
    torch.testing.assert_close(agg, r_agg, rtol=1e-6, atol=1e-6,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", DEBIAS_MODES)
def test_cuda_robust_gates_off_is_the_uplink_kernel(dev, mode):
    """With every gate off the robust kernel is bitwise the uplink
    kernel on the same finite inputs: the reference's neutral lock."""
    per_coord = mode == "per_coord_count"
    t = _robust_case(13, dev, finite=True, per_coord=per_coord)
    off = torch.tensor(0.0, device=dev)
    agg, ef_out = t_ra.robust_agg_call(
        t["x"], t["m"], t["q"], t["wd"], off, off, ef=t["ef"], g=t["g"],
        w_pos=t["w_pos"], trim_k=0 if per_coord else 2,
        per_coord=per_coord)
    u_agg, u_ef, _ = t_uf.uplink_fused_call(t["x"], t["m"], t["q"], t["wd"],
                                            ef=t["ef"], per_coord=per_coord)
    assert torch.equal(agg, u_agg) and torch.equal(ef_out, u_ef)


def _robust_edge(C_, P_, F_, seed, dev, *, per_coord, gates):
    """Robust-kernel operands at a client count around the kernel's
    chunks: NaN and Inf planted in one client of one packet."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(C_, P_, F_)).astype(np.float32)
    c = C_ // 2
    x[c, 1, 3] = np.nan
    x[c, 1, F_ - 1] = np.inf
    w = (rng.random(C_) + 0.1).astype(np.float32)
    t = {k: torch.tensor(v, device=dev) for k, v in dict(
        x=x, ef=rng.normal(size=(C_, P_, F_)).astype(np.float32),
        m=(rng.random((C_, P_)) > 0.3).astype(np.float32),
        q=(rng.random(C_) + 0.5).astype(np.float32),
        g=(rng.random(C_) + 0.5).astype(np.float32), w=w).items()}
    t["m"][c, 1] = 1.0                  # the planted packet is delivered
    t["w_pos"] = (t["w"] > 0).float()
    t["wd"] = t["w"] if per_coord else torch.clamp(t["w"].sum(),
                                                   min=DENOM_EPS)
    t["scr"], t["trg"] = (torch.tensor(v, device=dev) for v in gates)
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("C_,P_,F_,trim_k", [
    (1, 4, 256, 2), (3, 4, 256, 2), (5, 4, 256, 1), (16, 36, 256, 2),
    (17, 36, 256, 2), (17, 36, 256, 0), (19, 4, 256, 3), (14, 4, 256, 6),
    (40, 4, 256, 9), (64, 4, 1024, 0), (48, 4, 1024, 2)])
@pytest.mark.parametrize("gates", [(0.0, 0.0), (1.0, 1.0)])
@pytest.mark.parametrize("use_ef", [False, True])
def test_cuda_robust_kernel_chunks_match_plain(dev, C_, P_, F_, trim_k,
                                               gates, use_ef):
    """Client counts below, at and past a chunk boundary, the tiling
    width, n <= 2k (C = 1 and 3 with k = 2, where the trimmed mean falls
    back to the masked mean) and k for each of the kernel's trim list
    lengths (1, 2, 3, 6, 9): agg within rtol 1e-6 / atol 1e-6 of the
    plain version with equal NaN positions, EF bitwise; the batched
    launch of two scenarios bitwise the single launches."""
    per_coord = trim_k == 0 and C_ == 17
    t = _robust_edge(C_, P_, F_, C_ + F_, dev, per_coord=per_coord,
                     gates=gates)
    kw = dict(ef=t["ef"] if use_ef else None, g=t["g"], w_pos=t["w_pos"],
              trim_k=trim_k, per_coord=per_coord)
    agg, ef_out = t_ra.robust_agg_call(t["x"], t["m"], t["q"], t["wd"],
                                       t["scr"], t["trg"], **kw)
    r_agg, r_ef, _ = robust_ref(t["x"], t["m"], t["q"], t["wd"],
                                screen=t["scr"], trim_gate=t["trg"], **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(agg, r_agg, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    assert bool(torch.isfinite(agg).all()) == (gates[0] == 1.0)
    if use_ef:
        assert _same_bits(ef_out, r_ef)

    # a second scenario: the clients in reverse order, the gates flipped
    def two(v):
        return torch.stack([v, v.flip(0) if v.dim() else 1.0 - v])
    kw2 = {k: two(v) if isinstance(v, torch.Tensor) else v
           for k, v in kw.items()}
    ops = [two(t[k]) for k in ("x", "m", "q")] + [
        torch.stack([t["wd"], t["wd"].flip(0) if per_coord else t["wd"]]),
        two(t["scr"]), two(t["trg"])]
    b_agg, b_ef = t_ra.robust_agg_batched_call(*ops, **kw2)
    for i in range(2):
        a, e = t_ra.robust_agg_call(
            *(o[i] for o in ops),
            **{k: v[i] if isinstance(v, torch.Tensor) else v
               for k, v in kw2.items()})
        assert _same_bits(a, b_agg[i])
        if use_ef:
            assert _same_bits(e, b_ef[i])


def _kpass_trim(y, valid, k):
    """The reference's k-pass trimmed mean in numpy float32: pass i takes
    the (value, index) successor of pass i-1's extraction, an invalid
    client reading +-TRIM_BIG, a NaN never taken, values past TRIM_BIG
    capped from the second pass on; n <= 2k falls back to the mean."""
    big = np.float32(3.0e38)
    C_, P_, F_ = y.shape
    out = np.zeros((P_, F_), np.float32)
    for p in range(P_):
        v = valid[:, p]
        n = total = np.float32(0)
        for c in range(C_):
            n += v[c]
            total += y[c, p] * v[c]
        for f in range(F_):
            sums = []
            for sign in (1, -1):
                last, acc = (-sign * np.inf, -1), np.float32(0)
                for i in range(k):
                    best = None
                    for c in range(C_):
                        val = y[c, p, f] if v[c] > 0 else sign * big
                        after = sign * val > sign * last[0] or (
                            val == last[0] and c > last[1])
                        if after and (best is None
                                      or sign * val < sign * best[0]):
                            best = (val, c)
                    bv = sign * big if best is None else best[0]
                    last = last if best is None else best
                    capped = not sign * bv < big
                    acc += sign * big if i > 0 and capped else bv
                sums.append(acc)
            two_k = np.float32(2 * k)
            out[p, f] = ((total[f] - sums[1] - sums[0])
                         / max(n - two_k, np.float32(1))) if n > two_k \
                else total[f] / max(n, np.float32(1))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("C_,k,screen", [(40, 17, 1.0), (40, 17, 0.0),
                                         (40, 24, 1.0), (14, 6, 1.0)])
def test_cuda_robust_trim_passes_match_the_k_pass_extraction(dev, C_, k,
                                                             screen):
    """trim_k past the kernel's lists (the k passes over a column) and
    C = 14, k = 6 (n - 2k about 1): bitwise the reference's k-pass
    extraction, NaN by position; the kernel's estimates y and
    validities are the screen's expressions, each one rounding."""
    P_, F_ = 3, 32
    t = _robust_edge(C_, P_, F_, C_ + k, dev, per_coord=False,
                     gates=(screen, 1.0))
    t["m"] = (torch.rand((C_, P_), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(
                             k)) > 0.05).float()
    agg, _ = t_ra.robust_agg_call(t["x"], t["m"], t["q"], t["wd"], t["scr"],
                                  t["trg"], g=t["g"], w_pos=t["w_pos"],
                                  trim_k=k, per_coord=False)
    torch.cuda.synchronize()
    x, m, g, w_pos = (t[n].cpu().numpy() for n in ("x", "m", "g", "w_pos"))
    fin = np.isfinite(x)
    if screen:
        x = np.where(fin, x, np.float32(0))
        m = (m * fin.all(-1)).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        want = _kpass_trim((x * g[:, None, None]).astype(np.float32),
                           (m * w_pos[:, None]).astype(np.float32), k)
    assert _same_bits(agg.cpu(), torch.from_numpy(want))


@pytest.mark.cuda
@pytest.mark.parametrize("use_ef", [False, True])
def test_cuda_robust_trim_column_in_device_memory(dev, monkeypatch,
                                                  use_ef):
    """The k passes over a column in device memory (where C (F + 1)
    floats outgrow shared memory) give the bits of the same passes over
    the column in shared memory: the plan is forced to the device-memory
    column at C = 40, trim_k = 17, and both launches compared."""
    t = _robust_edge(40, 3, 64, 5, dev, per_coord=False, gates=(1.0, 1.0))
    kw = dict(ef=t["ef"] if use_ef else None, g=t["g"], w_pos=t["w_pos"],
              trim_k=17, per_coord=False)
    args = (t["x"], t["m"], t["q"], t["wd"], t["scr"], t["trg"])
    in_smem, e_smem = t_ra.robust_agg_call(*args, **kw)
    base = t_ra.plan
    pl = base(1, 40, 3, 64, 17, use_ef)
    assert pl.slots == t_ra.PASSES and not pl.column
    monkeypatch.setattr(t_ra, "plan", lambda *a: base(*a)._replace(
        smem=pl.smem - 40 * 65 * 4, column=True))
    in_dev, e_dev = t_ra.robust_agg_call(*args, **kw)
    torch.cuda.synchronize()
    assert _same_bits(in_dev, in_smem)
    if use_ef:
        assert _same_bits(e_dev, e_smem)


@pytest.mark.cuda
@pytest.mark.parametrize("F_", [1, 20, 100, 255, 1024])
@pytest.mark.parametrize("trim_k", [0, 2, 17])
def test_cuda_robust_packet_widths_match_plain(dev, F_, trim_k):
    """Packet widths off a multiple of 32 and F = 1024 (the lanes past F
    idle), the trim on the lists and past them (at C = 40, where 30% of
    packets lost leave n <= 2k): agg within rtol 1e-6 /
    atol 1e-6 of the plain version with equal NaN positions, EF
    bitwise; with the gates off and finite inputs, bitwise the uplink
    kernel."""
    C_ = 40 if trim_k > 16 else 12
    t = _robust_edge(C_, 4, F_ + 4, F_, dev, per_coord=False,
                     gates=(1.0, 1.0))
    for k in ("x", "ef"):
        t[k] = t[k][..., :F_].contiguous()
    kw = dict(ef=t["ef"], g=t["g"], w_pos=t["w_pos"], trim_k=trim_k,
              per_coord=False)
    agg, ef_out = t_ra.robust_agg_call(t["x"], t["m"], t["q"], t["wd"],
                                       t["scr"], t["trg"], **kw)
    r_agg, r_ef, _ = robust_ref(t["x"], t["m"], t["q"], t["wd"],
                                screen=t["scr"], trim_gate=t["trg"], **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(agg, r_agg, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    assert bool(torch.isfinite(agg).all())
    assert _same_bits(ef_out, r_ef)
    xf = torch.nan_to_num(t["x"], nan=0.5, posinf=0.5)
    off = torch.zeros((), device=dev)
    a0, e0 = t_ra.robust_agg_call(xf, t["m"], t["q"], t["wd"], off, off,
                                  **kw)
    a1, e1, _ = t_uf.uplink_fused_call(xf, t["m"], t["q"], t["wd"],
                                       ef=t["ef"], per_coord=False)
    assert torch.equal(a0, a1) and torch.equal(e0, e1)


def _robust_operands(dev):
    t = _robust_edge(5, 3, 64, 3, dev, per_coord=False, gates=(1.0, 1.0))
    return dict(x=t["x"], m=t["m"], q=t["q"], w_or_den=t["wd"],
                screen=t["scr"], trim_gate=t["trg"], ef=t["ef"], g=t["g"],
                w_pos=t["w_pos"])


def _robust_call(ops):
    return t_ra.robust_agg_call(
        ops["x"], ops["m"], ops["q"], ops["w_or_den"], ops["screen"],
        ops["trim_gate"], ef=ops["ef"], g=ops["g"], w_pos=ops["w_pos"],
        trim_k=2, per_coord=False)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["x", "m", "q", "w_or_den", "screen",
                                  "trim_gate", "ef", "g", "w_pos"])
def test_cuda_robust_binding_names_each_fault(dev, name):
    """The one-pass check falls back to the named per-operand check: a
    CPU tensor raises the CUDA refusal, a wrong dtype TypeError, a wrong
    shape or a strided view ValueError, each naming the operand, and no
    launch is counted."""
    ops = _robust_operands(dev)
    good = ops[name]
    before = (t_ra.LAUNCHES, t_ra.BATCHED_LAUNCHES)
    faults = [(good.cpu(), ValueError, f"CUDA tensors only, and {name} "),
              (good.double(), TypeError, f"{name} must be float32")]
    if good.dim():
        # x's shape sets the others': a narrower x leaves ef the misfit
        narrow = good[..., :1]
        if name == "x":
            narrow, shape_msg = narrow.contiguous(), "ef must have shape"
        else:
            shape_msg = f"{name} must have shape"
        faults += [(narrow, ValueError, shape_msg),
                   (torch.stack([good, good], -1)[..., 0], ValueError,
                    f"{name} must be contiguous")]
    for bad, exc, msg in faults:
        with pytest.raises(exc, match=msg):
            _robust_call({**ops, name: bad})
    assert (t_ra.LAUNCHES, t_ra.BATCHED_LAUNCHES) == before
    _robust_call(ops)
    assert t_ra.LAUNCHES == before[0] + 1


@pytest.mark.cuda
def test_cuda_flip_bit_matches_cpu(dev):
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.normal(size=(C, P, F)).astype(np.float32))
    coord = torch.tensor(rng.integers(0, F, (C, P)).astype(np.int32))
    bit = torch.tensor((np.arange(C * P) % 32).reshape(C, P)
                       .astype(np.int32))
    hit = torch.tensor(rng.random((C, P)) < 0.7)
    cpu = flip_bit_op(x, coord, bit, hit)
    card = flip_bit_op(*(a.to(dev) for a in (x, coord, bit, hit)))
    assert torch.equal(card.cpu().view(torch.int32), cpu.view(torch.int32))


def _fault_grid(n_rounds):
    """docs/EXPERIMENTS.md's corruption-tolerance recipe: clean,
    faulted and undefended, faulted and defended."""
    base = FLConfig(algo="fedavg", n_rounds=n_rounds, clients_per_round=12,
                    local_steps=4, batch_size=16, eval_every=10 ** 6, seed=1,
                    tra=TRAConfig(enabled=True, loss_rate=0.3),
                    netsim=NetSimConfig(channel="gilbert_elliott",
                                        burst_len=8.0, deadline=True,
                                        deadline_s=60.0))
    faults = FaultConfig(enabled=True, corrupt_rate=0.1, corrupt_scale=0.5,
                         fail_rate=0.1)
    return [dataclasses.replace(base, faults=FaultConfig(enabled=True),
                                defense=DefenseConfig(trim_k=2)),
            dataclasses.replace(base, faults=faults,
                                defense=DefenseConfig(trim_k=2)),
            dataclasses.replace(base, faults=faults, defense=DefenseConfig(
                screen=True, clip=True, clip_norm=20.0, trim=True,
                trim_k=2))]


@pytest.mark.cuda
def test_cuda_fault_grid_round_matches_cpu(dev):
    """Two defended grid rounds are two batched robust launches and no
    uplink launch; each matches the CPU's."""
    n = 20
    data = generate_synthetic(np.random.default_rng(0), n_clients=n,
                              alpha=0.5, beta=0.5)
    nets = ClientNetworks(np.linspace(0.5, 20.0, n), np.full(n, 0.05))
    out = {}
    for d in ("cuda", "cpu"):
        before = (t_ra.BATCHED_LAUNCHES, t_uf.LAUNCHES,
                  t_uf.BATCHED_LAUNCHES)
        eng = SweepEngine.from_configs(_fault_grid(2), data, nets, device=d)
        st, logs = eng.run()
        if d == "cuda":
            torch.cuda.synchronize()
            assert (t_ra.BATCHED_LAUNCHES, t_uf.LAUNCHES,
                    t_uf.BATCHED_LAUNCHES) == \
                (before[0] + 2, before[1], before[2])
        out[d] = (logs, np.concatenate(
            [st.params[k].cpu().numpy().reshape(3, -1)
             for k in sorted(st.params)], axis=1))
    (lg, vg), (lc, vc) = out["cuda"], out["cpu"]
    np.testing.assert_array_equal(lg["ids"], lc["ids"])
    np.testing.assert_array_equal(lg["quarantine"], lc["quarantine"])
    np.testing.assert_allclose(vg, vc, rtol=1e-4, atol=1e-5)


def _fec_case(R, P_, G, seed, dev):
    rng = np.random.default_rng(seed)
    mask = (rng.random((R, P_)) > 1.0 / min(G, P_)).astype(np.float32)
    par = (rng.random((R, -(-P_ // G))) > 0.3).astype(np.float32)
    return torch.tensor(mask, device=dev), torch.tensor(par, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("R,P_,G", [(72, 36, 8), (4096, 1024, 8),
                                    (4096, 1024, 3), (7, 129, 5),
                                    (3, 5, 8)])
def test_cuda_fec_recover_matches_plain(dev, R, P_, G):
    mask, par = _fec_case(R, P_, G, R + P_ + G, dev)
    before = t_fc.LAUNCHES
    out = t_fc.fec_recover_call(mask, par, group=G)
    torch.cuda.synchronize()
    assert t_fc.LAUNCHES == before + 1
    assert torch.equal(out, fec_recover_ref(mask, par, G))
    assert bool((out >= mask).all())


@pytest.mark.cuda
def test_cuda_fec_vmap_fold_is_one_launch(dev):
    S, C_, P_, G = 6, 12, 36, 8
    mask, par = _fec_case(S * C_, P_, G, 11, dev)
    mask, par = mask.reshape(S, C_, P_), par.reshape(S, C_, -1)
    before = t_fc.LAUNCHES
    out = torch.func.vmap(
        lambda m, p: t_fec_ops.fec_recover(m, p, group=G))(mask, par)
    torch.cuda.synchronize()
    assert t_fc.LAUNCHES == before + 1
    for i in range(S):
        assert torch.equal(out[i], t_fc.fec_recover_call(mask[i], par[i],
                                                         group=G))


@pytest.mark.cuda
@pytest.mark.parametrize("G", FEC_G)
@pytest.mark.parametrize("P_", MASK_P)
@pytest.mark.parametrize("seed", SEEDS)
def test_cuda_fec_cases_match_plain(dev, seed, P_, G):
    """The ballot kernel bitwise its plain version at the count's edges (G
    from 1 to past 32 lanes, ragged last groups), R = 37 rows, NaN mask
    entries beside a loss, alone with the parity delivered and alone with
    it lost; and again on a mask one element past an aligned address."""
    mask, par = (torch.tensor(a, device=dev)
                 for a in fec_case(CARD_ROWS, P_, G, seed))
    for shift in (False, True):
        m = _shifted(mask) if shift else mask
        before = t_fc.LAUNCHES
        out = t_fc.fec_recover_call(m, par, group=G)
        torch.cuda.synchronize()
        assert t_fc.LAUNCHES == before + 1
        assert torch.equal(_bits(out), _bits(fec_recover_ref(m, par, G))), \
            f"shift={shift}"


@pytest.mark.cuda
def test_cuda_fec_binding_names_each_fault(dev):
    m = torch.ones((4, 36), device=dev)
    par = torch.ones((4, 5), device=dev)
    before = t_fc.LAUNCHES
    for args, exc, msg in [
            ((m, par.cpu()), ValueError, "CUDA tensors only, and parity "),
            ((m.cpu(), par), ValueError, "CUDA tensors only, and mask "),
            ((m.double(), par), TypeError, "mask must be"),
            ((m, par[:, :4]), ValueError, "parity must have shape"),
            ((m.t().contiguous().t(), par), ValueError,
             "mask must be contiguous")]:
        with pytest.raises(exc, match=msg):
            t_fc.fec_recover_call(*args, group=8)
    with pytest.raises(ValueError, match="group must be positive"):
        t_fc.fec_recover_call(m, par, group=0)
    assert t_fc.fec_recover_call(m[:0], par[:0], group=8).shape == (0, 36)
    assert t_fc.LAUNCHES == before


def _recovery_grid(n_rounds):
    base = FLConfig(algo="fedavg", n_rounds=n_rounds, clients_per_round=8,
                    local_steps=2, batch_size=8, eval_every=100, seed=1,
                    tra=TRAConfig(enabled=True, loss_rate=0.3),
                    netsim=NetSimConfig(channel="gilbert_elliott",
                                        down_channel="gilbert_elliott",
                                        down_loss=0.3))
    return [dataclasses.replace(
        base, tra=TRAConfig(enabled=True, loss_rate=r),
        recovery=RecoveryConfig(policy=p, traced=True))
        for p in ("one_shot", "fec", "arq") for r in (0.1, 0.3)]


@pytest.mark.cuda
def test_cuda_recovery_grid_rounds_match_cpu(dev):
    """Two recovery grid rounds are two batched uplink launches, four
    mask launches (uplink and downlink) and two FEC launches; they match
    the CPU's."""
    n = 20
    data = generate_synthetic(np.random.default_rng(0), n_clients=n,
                              alpha=0.5, beta=0.5)
    nets = ClientNetworks(np.linspace(0.5, 20.0, n), np.full(n, 0.05))
    out = {}
    for d in ("cuda", "cpu"):
        before = (t_uf.BATCHED_LAUNCHES, t_nm.LAUNCHES, t_fc.LAUNCHES)
        st, logs = SweepEngine.from_configs(_recovery_grid(2), data, nets,
                                            device=d).run()
        if d == "cuda":
            torch.cuda.synchronize()
            assert (t_uf.BATCHED_LAUNCHES, t_nm.LAUNCHES,
                    t_fc.LAUNCHES) == (before[0] + 2, before[1] + 4,
                                       before[2] + 2)
        out[d] = (logs["ids"], st.net.channel.cpu().numpy(),
                  st.net.down.cpu().numpy(), np.concatenate(
                      [st.params[k].cpu().numpy().reshape(6, -1)
                       for k in sorted(st.params)], axis=1))
    for a, b in zip(out["cuda"][:3], out["cpu"][:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(out["cuda"][3], out["cpu"][3], rtol=1e-4,
                               atol=1e-5)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("R,F_", [(36, 256), (4096, 256), (8, 128),
                                  (7, 129)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_packet_mask_matches_plain(dev, R, F_, dtype):
    rng = np.random.default_rng(R + F_)
    x = rng.normal(size=(R, F_)).astype(np.float32)
    x[0, :4] = [np.nan, np.inf, -np.inf, -0.0]
    x[1, :4] = [np.nan, np.inf, -np.inf, -2.5]
    m = (rng.random(R) > 0.3).astype(np.float32)
    m[0], m[1] = 0.0, 1.0
    x = torch.tensor(x, device=dev).to(dtype)
    m = torch.tensor(m, device=dev)
    before = t_pm.LAUNCHES
    out = t_pm.packet_mask_call(x, m)
    torch.cuda.synchronize()
    assert t_pm.LAUNCHES == before + 1 and out.dtype == dtype
    assert torch.equal(_bits(out), _bits(packet_mask_ref(x, m)))
    assert bool(torch.signbit(out[0, 3])) and float(out[0, 3]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F_", [255, 256])
def test_cuda_packet_mask_unaligned_view_matches_plain(dev, dtype, F_):
    """Rows that start one element past an aligned address (a contiguous
    view at an offset) and an odd F: the scalar path, bitwise the plain
    version; NaN * 0 stays NaN and -x * 0 is -0.0."""
    R = 36
    rng = np.random.default_rng(F_)
    flat = rng.normal(size=R * F_ + 1).astype(np.float32)
    base = torch.tensor(flat, device=dev).to(dtype)
    x = base[1:].view(R, F_)
    x[0, :4] = torch.tensor([np.nan, np.inf, -np.inf, -0.0])
    m = torch.tensor((rng.random(R) > 0.3).astype(np.float32), device=dev)
    m[0] = 0.0
    before = t_pm.LAUNCHES
    out = t_pm.packet_mask_call(x, m)
    torch.cuda.synchronize()
    assert t_pm.LAUNCHES == before + 1
    assert torch.equal(_bits(out), _bits(packet_mask_ref(x, m)))
    assert bool(torch.isnan(out[0, 0])) and bool(torch.signbit(out[0, 3]))


@pytest.mark.cuda
def test_cuda_packet_mask_binding_names_each_fault(dev):
    x = torch.ones((4, 32), device=dev)
    m = torch.ones(4, device=dev)
    before = t_pm.LAUNCHES
    for args, exc, msg in [
            ((x, m.cpu()), ValueError, "CUDA tensors only, and mask "),
            ((x.cpu(), m), ValueError, "CUDA tensors only, and x "),
            ((x.double(), m), TypeError, "x must be"),
            ((x, m.double()), TypeError, "mask must be"),
            ((x, m[:3]), ValueError, "mask must have shape"),
            ((x.t().contiguous().t(), m), ValueError,
             "x must be contiguous")]:
        with pytest.raises(exc, match=msg):
            t_pm.packet_mask_call(*args)
    assert t_pm.LAUNCHES == before
    assert t_pm.packet_mask_call(x[:0], m[:0]).shape == (0, 32)
    assert t_pm.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_packet_mask_vmap_fold_is_one_launch(dev):
    """lossy_upload vmapped over the cohort: one launch, bitwise the
    single uploads and the CPU's masks."""
    keys = prng.split(prng.PRNGKey(3, device=dev), 10)
    vec = torch.tensor(np.random.default_rng(3).normal(
        size=(10, 9098)).astype(np.float32), device=dev)
    before = t_pm.LAUNCHES
    masked, pm, kept = torch.func.vmap(
        lambda k, v: t_pk.lossy_upload(k, v, 0.3))(keys, vec)
    torch.cuda.synchronize()
    assert t_pm.LAUNCHES == before + 1
    for i in range(10):
        m1, p1, k1 = t_pk.lossy_upload(keys[i], vec[i], 0.3)
        assert torch.equal(masked[i], m1) and torch.equal(pm[i], p1)
        assert torch.equal(kept[i], k1)
    _, pm_cpu, kept_cpu = torch.func.vmap(
        lambda k, v: t_pk.lossy_upload(k, v, 0.3))(keys.cpu(), vec.cpu())
    assert torch.equal(pm.cpu(), pm_cpu)
    assert torch.equal(kept.cpu(), kept_cpu)


def _tra_case(C_, P_, F_, seed, dev, lead=()):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    m = rng.random(lead + (C_, P_)) > 0.4
    return dict(x=t(rng.normal(size=lead + (C_, P_, F_)) * m[..., None]),
                m=t(m), w=t(rng.random(lead + (C_,)) + 0.1),
                kept=t(m.mean(-1)), rate=t(np.full(lead + (C_,), 0.4)),
                suff=t(rng.random(lead + (C_,)) > 0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 36, 256), (3, 8, 128),
                                   (16, 64, 256), (5, 7, 33)])
@pytest.mark.parametrize("mode", DEBIAS_MODES)
def test_cuda_tra_agg_matches_plain(dev, shape, mode):
    c = _tra_case(*shape, sum(shape), dev)
    x, m = t_ta_ops.debias_inputs(c["x"], c["m"], mode=mode,
                                  kept_frac=c["kept"],
                                  nominal_rate=c["rate"],
                                  sufficient=c["suff"])
    x, m = x.contiguous(), m.contiguous()
    before = t_ta.LAUNCHES
    out = t_ta.tra_agg_call(x, m, c["w"])
    torch.cuda.synchronize()
    assert t_ta.LAUNCHES == before + 1
    torch.testing.assert_close(out, tra_agg_ref(x, m, c["w"]), rtol=1e-6,
                               atol=1e-6)


def _shifted(t):
    """A copy of ``t`` one element past an aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _powers_of_two(rng, shape, dev):
    """Weights whose products with 0/1 masks and with the uploads are
    exact, so that a sum's bits depend on its order alone, and a plain
    loop in index order is the kernel's expressions bit for bit."""
    return torch.tensor(2.0 ** rng.integers(-2, 3, size=shape),
                        dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 1024, 255), (16, 1024, 256),
                                   (4, 3, 2500), (5, 40, 1)])
@pytest.mark.parametrize("shift", [False, True])
def test_cuda_tra_agg_packet_widths_match_plain(dev, shape, shift):
    """An odd F at the reference's bench shape, a row past one CTA's
    tile, F = 1, and rows one element past an aligned address (the
    scalar loads): within rtol 1e-6 / atol 1e-6 of the plain version;
    and, with weights that make every product exact, bitwise the
    parent's expressions summed over the clients in index order (wm =
    m * w, num += wm * x, den += wm)."""
    c = _tra_case(*shape, sum(shape), dev)
    x, m = c["x"], c["m"]
    w = _powers_of_two(np.random.default_rng(sum(shape)), shape[:1], dev)
    if shift:
        x = _shifted(x)
    out = t_ta.tra_agg_call(x, m, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, tra_agg_ref(x, m, w), rtol=1e-6,
                               atol=1e-6)
    num = torch.zeros(shape[1:], device=dev)
    den = torch.zeros(shape[1:2], device=dev)
    for i in range(shape[0]):
        wm = m[i] * w[i]
        num = num + wm[:, None] * x[i]
        den = den + wm
    want = num / torch.clamp(den, min=DENOM_EPS)[:, None]
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", DEBIAS_MODES)
def test_cuda_tra_agg_scenario_axis_equals_single_launches(dev, mode):
    S = 4
    c = _tra_case(10, 36, 256, 17, dev, lead=(S,))

    def one(x, m, w, kept, rate, suff):
        return t_ta_ops.tra_aggregate_packed(
            x, m, w, mode=mode, kept_frac=kept, nominal_rate=rate,
            sufficient=suff)

    args = [c[k] for k in ("x", "m", "w", "kept", "rate", "suff")]
    before = t_ta.LAUNCHES
    out = torch.func.vmap(one)(*args)
    torch.cuda.synchronize()
    assert t_ta.LAUNCHES == before + 1
    for s in range(S):
        assert torch.equal(out[s], one(*(a[s] for a in args)))


def _qfed_case(shape, dev, skew=False):
    """dw (C, P, F) from a numpy seed, one float past an aligned address
    where ``skew``; losses and fq = (losses + eps)^2 as the op forms it."""
    rng = np.random.default_rng(sum(shape))
    dw = torch.tensor(rng.normal(size=shape).astype(np.float32), device=dev)
    if skew:
        buf = torch.empty(dw.numel() + 1, device=dev)
        dw = buf[1:].view(shape).copy_(dw)
    losses = torch.tensor(rng.random(shape[0]).astype(np.float32) + 0.5,
                          device=dev)
    return dw, losses, torch.pow(losses + t_qr_ops.LOSS_EPS, 2.0)


def _check_qfed(dw, losses, fq):
    """One call against the plain version: delta bitwise, ssq (C,) rtol
    1e-5 and bitwise across two calls, h within 1e-5 of the CPU's."""
    before = t_qr.LAUNCHES
    delta, ssq = t_qr.qfed_reweight_call(dw, fq)
    torch.cuda.synchronize()
    assert t_qr.LAUNCHES == before + (1 if dw.shape[0] else 0)
    d_ref, s_ref = qfed_reweight_ref(dw, fq)
    assert torch.equal(delta, d_ref)
    assert ssq.shape == (dw.shape[0],)
    torch.testing.assert_close(ssq, s_ref, rtol=1e-5, atol=0)
    d2, s2 = t_qr.qfed_reweight_call(dw, fq)
    assert torch.equal(delta, d2) and torch.equal(ssq, s2)
    _, h = t_qr_ops.qfed_reweight_packed(dw, losses, 2.0, 1.0)
    _, h_cpu = t_qr_ops.qfed_reweight_packed(dw.cpu(), losses.cpu(), 2.0,
                                             1.0)
    torch.testing.assert_close(h.cpu(), h_cpu, rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 36, 256), (16, 1024, 256),
                                   (3, 5, 33), (10, 36, 255), (4, 3, 2500),
                                   (10, 35, 255), (1, 36, 256), (10, 1, 256),
                                   (65536, 1, 1), (0, 36, 256), (10, 0, 256),
                                   (10, 36, 0)])
def test_cuda_qfed_reweight_matches_plain(dev, shape):
    _check_qfed(*_qfed_case(shape, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10, 36, 256), (16, 1024, 256)])
def test_cuda_qfed_reweight_misaligned_view_matches_plain(dev, shape):
    """dw one float past an aligned address: the float path."""
    _check_qfed(*_qfed_case(shape, dev, skew=True))


@pytest.mark.cuda
@pytest.mark.parametrize("vmapped", [False, True])
def test_cuda_qfed_reweight_is_one_device_op(dev, vmapped):
    """A call of the op, single or vmapped, is the kernel and no other
    device op (no fill, no sum), by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    dw = torch.randn((3, 10, 36, 256), device=dev)
    fq = torch.rand((3, 10), device=dev) + 0.1

    def call():
        if vmapped:
            return torch.func.vmap(t_qr_ops.qfed_reweight_op)(dw, fq)
        return t_qr_ops.qfed_reweight_op(dw[0], fq[0])

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    ops = {ev.key: ev.count for ev in prof.key_averages()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and ev.self_device_time_total > 0}
    assert len(ops) == 1 and "qfed_reweight_kernel" in next(iter(ops))
    assert 0 < sum(ops.values()) <= 5


@pytest.mark.cuda
def test_cuda_qfed_reweight_vmap_fold_is_one_launch(dev):
    rng = np.random.default_rng(8)
    dw = torch.tensor(rng.normal(size=(3, 10, 36, 256)).astype(np.float32),
                      device=dev)
    fq = torch.tensor(rng.random((3, 10)).astype(np.float32) + 0.1,
                      device=dev)
    before = t_qr.LAUNCHES
    delta, ssq = torch.func.vmap(t_qr_ops.qfed_reweight_op)(dw, fq)
    torch.cuda.synchronize()
    assert t_qr.LAUNCHES == before + 1
    for s in range(3):
        d1, s1 = t_qr_ops.qfed_reweight_op(dw[s], fq[s])
        assert torch.equal(delta[s], d1) and torch.equal(ssq[s], s1)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["fedavg", "qfedavg"])
def test_cuda_host_loop_rounds_match_cpu(dev, algo):
    """Two host-loop rounds: one tra_agg (FedAvg) or qfed_reweight
    (q-FedAvg) launch a round, cohorts and masks the CPU's."""
    rng = np.random.default_rng(7)
    data = generate_synthetic(rng, n_clients=100, alpha=1.0, beta=1.0)
    suff = sufficiency_report(sample_networks(rng, 100))
    cfg = FLConfig(algo=algo, n_rounds=2, clients_per_round=10,
                   local_steps=1, batch_size=8, seed=7,
                   tra=TRAConfig(enabled=True, loss_rate=0.1))
    counter = t_ta if algo == "fedavg" else t_qr
    before = counter.LAUNCHES
    params, recs = protocol.run_host_loop(cfg, data, suff, device=dev)
    torch.cuda.synchronize()
    assert counter.LAUNCHES == before + 2
    params_cpu, recs_cpu = protocol.run_host_loop(cfg, data, suff,
                                                  device="cpu")
    for a, b in zip(recs, recs_cpu):
        np.testing.assert_array_equal(a.ids, b.ids)
        if algo == "fedavg":
            assert torch.equal(a.pkt_mask.cpu(), b.pkt_mask)
    for k in params:
        torch.testing.assert_close(params[k].cpu(), params_cpu[k],
                                   rtol=1e-4, atol=1e-5)


# (B, KV, G, dh, T, t_blk, pos, window, is_global)
FD_CASES = [
    (1, 2, 4, 64, 256, 128, 253, None, None),
    (2, 4, 1, 128, 512, 512, 509, None, None),
    (2, 1, 8, 64, 1024, 256, 1021, None, None),
    (1, 2, 2, 32, 384, 128, 381, None, None),
    (2, 20, 1, 128, 25, 512, 24, None, None),
    (2, 20, 1, 128, 25, 512, 10, None, None),
    (2, 4, 12, 128, 300, 512, 299, None, None),
    (1, 16, 2, 128, 2048, 512, 1600, 1024, False),
    (1, 16, 2, 128, 2048, 512, 1600, 1024, True),
    (1, 2, 3, 80, 1, 512, 0, None, None),
    (1, 2, 3, 80, 383, 64, 380, None, None),
    (2, 4, 2, 128, 1000, 64, 900, 100, False),
    (2, 4, 2, 128, 1000, 64, 150, None, None),
    (1, 2, 5, 256, 700, 64, 650, None, None),
    # the tiled kernel's edges: G = 16 and G = 6; G = 12 with T not a
    # multiple of the tile and under one tile; whole tiles masked first
    # (the window) and last (past pos) in one split; dh = 80 and 256;
    # splits of 100 rows, so split boundaries fall inside tiles; G = 20,
    # head chunks of 16 + 4
    (1, 2, 16, 128, 1000, 128, 997, None, None),
    (2, 2, 6, 128, 777, 256, 770, None, None),
    (1, 4, 12, 128, 1000, 512, 999, None, None),
    (2, 4, 12, 128, 20, 512, 19, None, None),
    (1, 4, 12, 128, 2048, 2048, 1900, 128, False),
    (1, 4, 12, 128, 2048, 2048, 300, None, None),
    (1, 2, 12, 80, 500, 128, 480, None, None),
    (1, 2, 12, 256, 500, 128, 480, None, None),
    (1, 2, 12, 128, 1000, 100, 990, None, None),
    (1, 2, 20, 64, 500, 128, 490, None, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_matches_plain(dev, case, dtype):
    B, KV, G, dh, T, t_blk, pos, window, glob = case
    rng = np.random.default_rng(T + dh)
    q = torch.tensor(rng.normal(size=(B, KV, G, dh)).astype(np.float32),
                     device=dev)
    k, v = (torch.tensor(rng.normal(size=(B, T, KV, dh)).astype(
        np.float32), device=dev).to(dtype) for _ in range(2))
    bias = t_fd_ops.decode_bias(T, pos, window, glob, device=dev)
    before = t_fd.LAUNCHES
    out = t_fd.flash_decode_call(q, k, v, bias, t_blk=t_blk)
    torch.cuda.synchronize()
    assert t_fd.LAUNCHES == before + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, flash_decode_ref(q, k, v, bias),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_flash_decode_op_launches_the_kernel(dev):
    """The op launches the kernel for CUDA tensors, with the reference's
    layouts: q (B, 1, H, dh) in, (B, H, dh) f32 out."""
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.normal(size=(2, 1, 8, 64)).astype(np.float32),
                     device=dev)
    k, v = (torch.tensor(rng.normal(size=(2, 40, 2, 64)).astype(np.float32),
                         device=dev) for _ in range(2))
    before = t_fd.LAUNCHES
    out = t_fd_ops.flash_decode(q, k, v, 30, window=16, is_global=False)
    assert t_fd.LAUNCHES == before + 1 and out.shape == (2, 8, 64)
    want = t_fd_ops.flash_decode(q.cpu(), k.cpu(), v.cpu(), 30, window=16,
                                 is_global=False)
    torch.testing.assert_close(out.cpu(), want, rtol=2e-5, atol=2e-5)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _greedy(cfg, params, prompt, n_tokens, dev):
    cache = t_decode.init_cache(cfg, prompt.shape[0],
                                prompt.shape[1] + n_tokens + 1,
                                torch.float32, dev)
    logits, cache = t_serve.prefill_into_cache(cfg, params, prompt.to(dev),
                                               cache)
    toks, steps = [logits.argmax(-1).int()[:, None]], [logits]
    for i in range(n_tokens):
        logits, cache = t_decode.decode_step(cfg, params, toks[-1], cache,
                                             prompt.shape[1] + i)
        toks.append(logits.argmax(-1).int()[:, None])
        steps.append(logits)
    return torch.cat(toks, 1).cpu(), torch.stack(steps).cpu()


def _serve_card_vs_cpu(dev, cfg):
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 8)), dtype=torch.int32)
    before = t_fd.LAUNCHES
    tg, lg = _greedy(cfg, _to(params, dev), prompt, 12, dev)
    assert t_fd.LAUNCHES == before + cfg.n_layers * 20
    tc, lc = _greedy(cfg, params, prompt, 12, "cpu")
    assert torch.equal(tg, tc)
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kv", [("qwen1.5-4b", None),
                                     ("gemma3-27b", 2),
                                     ("starcoder2-15b", 2)])
def test_cuda_reduced_serve_matches_cpu(dev, name, kv):
    cfg = get_config(name).reduced()
    if kv is not None:
        cfg = dataclasses.replace(cfg, n_kv_heads=kv)
    _serve_card_vs_cpu(dev, cfg)


@pytest.mark.cuda
def test_cuda_reduced_gqa12_serve_matches_cpu(dev):
    """starcoder2-15b at reduced width with its G = 12: 24 query heads over
    n_kv_heads = 2, so the serve runs the tiled kernel's f32 path."""
    cfg = dataclasses.replace(get_config("starcoder2-15b").reduced(),
                              n_heads=24, n_kv_heads=2)
    assert cfg.n_heads // cfg.n_kv_heads == 12
    _serve_card_vs_cpu(dev, cfg)


@pytest.mark.cuda
def test_cuda_serve_launches_once_per_layer_and_step(dev):
    before = t_fd.LAUNCHES
    res = t_serve.run(["--reduced", "--tokens", "4"])
    assert res.tokens.is_cuda and res.tokens.shape == (2, 5)
    assert t_fd.LAUNCHES == before + res.cfg.n_layers * (8 + 4)


# ---------------------------------------------------------------------------
# grid axes past 65,535, SCAFFOLD's upload shape, the four algorithms
# ---------------------------------------------------------------------------
class _OnCard:
    """Stands in for a tensor on the card: the refusal reads only
    ``is_cuda``."""
    is_cuda = True


@pytest.mark.parametrize("name", ["q", "k", "v", "bias"])
def test_flash_decode_call_refuses_a_cpu_operand_first(name):
    """A CPU tensor in any operand raises the CUDA refusal, named, before
    the counter moves and before the library is built or loaded: the rest
    stand in for tensors on the card, and the CPU one is of the wrong
    dtype and shape, so no later check can raise first. Runs without a
    card."""
    ops = {k: _OnCard() for k in ("q", "k", "v", "bias")}
    ops[name] = torch.zeros(3, dtype=torch.float64)
    before = (t_fd.LAUNCHES, t_fd._lib.cache_info())
    with pytest.raises(ValueError, match=f"CUDA tensors only, and {name} "
                                         f"lies on cpu"):
        t_fd.flash_decode_call(ops["q"], ops["k"], ops["v"], ops["bias"])
    assert (t_fd.LAUNCHES, t_fd._lib.cache_info()) == before


@pytest.mark.parametrize("B,KV,n", [(1, 1, 1), (65535, 65535, 1),
                                    (65536, 1, 2), (1, 65536, 2),
                                    (131071, 65536, 6)])
def test_flash_decode_chunks_count_the_launches(B, KV, n):
    """Past 65,535 batch rows or kv heads a call launches a chunk at a
    time, and LAUNCHES counts each. Runs without a card."""
    assert t_fd.n_chunks(B, KV) == n


@pytest.mark.cuda
@pytest.mark.parametrize("per_coord", [False, True])
@pytest.mark.parametrize("use_ef", [False, True])
def test_cuda_uplink_batched_takes_65536_scenarios(dev, per_coord, use_ef):
    launches, _ = wide.uplink_wide(dev, per_coord=per_coord, use_ef=use_ef)
    assert launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("trim_k,use_ef", [(0, True), (2, False)])
def test_cuda_robust_batched_takes_65536_scenarios(dev, trim_k, use_ef):
    launches, _ = wide.robust_wide(dev, trim_k=trim_k, use_ef=use_ef)
    assert launches == 2


@pytest.mark.cuda
def test_cuda_tra_agg_batched_takes_65536_scenarios(dev):
    launches, _ = wide.tra_wide(dev)
    assert launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["B", "KV"])
@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_takes_65536_rows(dev, axis, T, dtype):
    launches, _ = wide.flash_wide(dev, axis=axis, T=T, dtype=dtype)
    assert launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", DEBIAS_MODES)
@pytest.mark.parametrize("use_ef", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_uplink_at_scaffold_upload_shape(dev, mode, use_ef, dtype):
    """SCAFFOLD uploads dw ++ dc: (10, 72, 256), the last packet 20 floats
    full, with EF rows at 2·D."""
    wide.uplink_scaffold(dev, mode=mode, use_ef=use_ef, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["pfedme", "perfedavg", "afl", "scaffold"])
def test_cuda_algorithm_rounds_match_cpu(dev, algo):
    """Two rounds of each algorithm with TRA and EF on the card and the
    CPU from one seed: cohorts equal, params and carries rtol 1e-4 / atol
    1e-5, one uplink launch a round on the card."""
    data = generate_synthetic(np.random.default_rng(0), n_clients=20,
                              alpha=0.5, beta=0.5)
    nets = sample_networks(np.random.default_rng(1), 20)
    cfg = FLConfig(algo=algo, n_rounds=2, clients_per_round=8,
                   local_steps=4, batch_size=16, pfedme_K=2,
                   error_feedback=True,
                   tra=TRAConfig(enabled=True, loss_rate=0.2))
    out = {}
    for d in ("cuda", "cpu"):
        before = t_uf.LAUNCHES
        srv = FederatedServer(cfg, data, nets, device=d)
        st, logs = srv.engine.run_block(srv._state, 0, 2)
        if d == "cuda":
            assert t_uf.LAUNCHES == before + 2
        out[d] = (logs["ids"], st)
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    for name in ("ef_mem", "lam", "c_global", "c_i"):
        np.testing.assert_allclose(getattr(out["cuda"][1], name).cpu(),
                                   getattr(out["cpu"][1], name), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("use_ef", [False, True])
def test_cuda_uplink_fedavg_norms_match_plain(dev, use_ef):
    """The gradient_norm policy's uplink: a FedAvg round's weights (no
    q-FedAvg multiplier) with the masked norms requested, through the
    engine's entry points at the quickstart's (10, 36, 256), one
    uplink_fused launch, and at the selection grid's S = 24, one
    uplink_fused_batched launch, against uplink_ref at the uplink
    tolerances."""
    Sg, Cq, Pq, Fq, d_up = 24, 10, 36, 256, 9098
    rng = np.random.default_rng(27)
    flat = rng.normal(0.0, 0.1, (Sg, Cq, d_up)).astype(np.float32)
    cnt = rng.integers(20, 200, (Sg, Cq)).astype(np.float32)
    t = {k: torch.tensor(v, device=dev) for k, v in dict(
        xp=np.pad(flat, ((0, 0), (0, 0), (0, Pq * Fq - d_up))).reshape(
            Sg, Cq, Pq, Fq),
        mask=(rng.random((Sg, Cq, Pq)) > 0.2).astype(np.float32),
        w=cnt / cnt.sum(-1, keepdims=True),
        suff=(rng.random((Sg, Cq)) > 0.3).astype(np.float32),
        lr=rng.uniform(0.1, 0.3, Sg).astype(np.float32),
        ef=rng.normal(0.0, 0.01, (Sg, Cq, d_up)).astype(np.float32)).items()}
    ef = t["ef"] if use_ef else None

    def plain(sl, lr):
        q = t_ops.debias_client_scale(t["w"][sl], mode="group_rate",
                                      sufficient=t["suff"][sl], loss_rate=lr)
        wd = torch.clamp(t["w"][sl].sum(-1), min=DENOM_EPS)
        x = t["xp"][sl]
        efp = None if ef is None else torch.nn.functional.pad(
            ef[sl], (0, Pq * Fq - d_up)).reshape(x.shape)
        return uplink_ref(x, t["mask"][sl], q, wd, ef=efp, want_ssq=True,
                          per_coord=False)

    def check(out, ref, lead):
        agg, ef_rows, ssq = out
        r_agg, r_ef, r_ssq = ref
        torch.testing.assert_close(agg, r_agg.reshape(*lead, -1)[..., :d_up],
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(ssq, r_ssq, rtol=1e-5, atol=0.0)
        if use_ef:
            assert torch.equal(ef_rows, r_ef.reshape(*lead, Cq, -1)
                               [..., :d_up])

    before = (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES)
    out = t_ops.uplink_round(
        t["xp"][0], t["mask"][0], t["w"][0], mode="group_rate", d_up=d_up,
        ef_rows=None if ef is None else ef[0], sufficient=t["suff"][0],
        loss_rate=t["lr"][0], want_ssq=True)
    torch.cuda.synchronize()
    assert (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES) == \
        (before[0] + 1, before[1])
    check(out, plain(0, t["lr"][0]), ())
    out = t_ops.uplink_round_scenarios(
        t["xp"], t["mask"], t["w"], mode="group_rate", d_up=d_up,
        ef_rows=ef, sufficient=t["suff"], loss_rate=t["lr"], want_ssq=True)
    torch.cuda.synchronize()
    assert (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES) == \
        (before[0] + 1, before[1] + 1)
    check(out, plain(slice(None), t["lr"][:, None]), (Sg,))


@pytest.mark.cuda
def test_cuda_traced_selection_grid_matches_cpu(dev):
    """Every selection policy x loss {0.1, 0.3}, traced, on the GE
    channel: a round on the card is one batched uplink launch and one
    mask launch; the first round from the same seeds and a second from
    the CPU's state (the scores then read every memory) give the CPU's
    cohorts and channel states, params rtol 1e-4 / atol 1e-5."""
    from repro_torch.core.selection import POLICIES, SelectionConfig
    data = generate_synthetic(np.random.default_rng(0), n_clients=20,
                              alpha=0.5, beta=0.5)
    nets = sample_networks(np.random.default_rng(2026), 20)
    base = FLConfig(algo="fedavg", n_rounds=2, clients_per_round=8,
                    local_steps=2, batch_size=8, eval_every=100,
                    tra=TRAConfig(enabled=True, debias="group_rate"),
                    netsim=NetSimConfig(channel="gilbert_elliott"))
    cfgs = [dataclasses.replace(
        base, sel=SelectionConfig(policy=p, traced=True, temperature=0.5),
        tra=dataclasses.replace(base.tra, loss_rate=r))
        for p in POLICIES for r in (0.1, 0.3)]
    engs = {k: SweepEngine.from_configs(cfgs, data, nets, device=d)
            for k, d in (("card", dev), ("cpu", "cpu"))}
    before = (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES, t_nm.LAUNCHES)
    card, lg = engs["card"].run_block(engs["card"].init_states(), 0, 1)
    torch.cuda.synchronize()
    assert (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES, t_nm.LAUNCHES) == \
        (before[0], before[1] + 1, before[2] + 1)
    cpu, lc = engs["cpu"].run_block(engs["cpu"].init_states(), 0, 1)
    np.testing.assert_array_equal(lg["ids"], lc["ids"])
    np.testing.assert_array_equal(card.net.channel.cpu(), cpu.net.channel)
    moved = type(cpu)(*(
        {k: v.to(dev) for k, v in f.items()} if isinstance(f, dict)
        else type(f)(*(x.to(dev) for x in f)) if isinstance(f, tuple)
        else f.to(dev) for f in cpu))
    card, lg = engs["card"].run_block(moved, 1, 1)
    cpu, lc = engs["cpu"].run_block(cpu, 1, 1)
    np.testing.assert_array_equal(lg["ids"], lc["ids"])
    for k in cpu.params:
        np.testing.assert_allclose(card.params[k].cpu(), cpu.params[k],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(card.gnorm_mem.cpu(), cpu.gnorm_mem,
                               rtol=1e-5, atol=1e-6)


def _state_to(state, dev):
    return type(state)(*(
        {k: v.to(dev) for k, v in f.items()} if isinstance(f, dict)
        else type(f)(*(x.to(dev) for x in f)) if isinstance(f, tuple)
        else f.to(dev) for f in state))


def _async_cfg(mode, loss_rate, **kw):
    """The async grid's cell (examples/async_grid_torch.py) cut to 2 local
    steps of 8 and 3 rounds."""
    from repro_torch.core.async_agg import AsyncConfig
    return FLConfig(algo="fedavg", n_rounds=3, clients_per_round=8,
                    local_steps=2, batch_size=8, eval_every=100,
                    error_feedback=True,
                    tra=TRAConfig(enabled=True, loss_rate=loss_rate),
                    netsim=NetSimConfig(channel="gilbert_elliott",
                                        burst_len=8.0, deadline=True,
                                        deadline_s=0.1),
                    srv=AsyncConfig(mode=mode, buffer_k=6, grace_s=0.2,
                                    **kw.pop("srv", {})), **kw)


def _async_inputs():
    data = generate_synthetic(np.random.default_rng(1), n_clients=20,
                              alpha=0.5, beta=0.5)
    return data, ClientNetworks(np.linspace(0.5, 20.0, 20),
                                np.full(20, 0.05))


@pytest.mark.cuda
def test_cuda_traced_mode_grid_matches_cpu(dev):
    """The sync / semi_sync / async x loss {0.1, 0.3} grid, traced: a
    round on the card is one batched uplink launch and one mask launch;
    each round from the CPU's state gives the CPU's cohorts, channel
    states, arrival bits and buffer due and tau, params rtol 1e-4 / atol
    1e-5, arrival weights rtol 1e-6."""
    from repro_torch.core.async_agg import MODES
    data, nets = _async_inputs()
    cfgs = [_async_cfg(m, r, srv=dict(traced=True)) for m in MODES
            for r in (0.1, 0.3)]
    engs = {k: SweepEngine.from_configs(cfgs, data, nets, device=d)
            for k, d in (("card", dev), ("cpu", "cpu"))}
    cpu = engs["cpu"].init_states()
    for t in range(3):
        before = (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES, t_nm.LAUNCHES)
        card, lg = engs["card"].run_block(_state_to(cpu, dev), t, 1)
        torch.cuda.synchronize()
        assert (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES, t_nm.LAUNCHES) == \
            (before[0], before[1] + 1, before[2] + 1)
        cpu, lc = engs["cpu"].run_block(cpu, t, 1)
        np.testing.assert_array_equal(lg["ids"], lc["ids"])
        np.testing.assert_array_equal(lg["arrival"] == 1.0,
                                      lc["arrival"] == 1.0)
        np.testing.assert_allclose(lg["arrival"], lc["arrival"], rtol=1e-6)
        np.testing.assert_array_equal(card.net.channel.cpu(), cpu.net.channel)
        for name in ("due", "tau"):
            np.testing.assert_array_equal(getattr(card.buf, name).cpu(),
                                          getattr(cpu.buf, name))
        for k in cpu.params:
            np.testing.assert_allclose(card.params[k].cpu(), cpu.params[k],
                                       rtol=1e-4, atol=1e-5)
    assert (cpu.buf.due < 3e9).any()


@pytest.mark.cuda
def test_cuda_async_faults_match_cpu(dev):
    """Async with NaN failures, sign flips and echo replays behind the
    screen and the clip: one robust_agg launch a round, and each round
    from the CPU's state gives its cohorts, quarantine counts and buffer
    due and tau, a finite buffer, params rtol 1e-4 / atol 1e-5."""
    data, nets = _async_inputs()
    cfg = _async_cfg("async", 0.3, seed=4,
                     faults=FaultConfig(enabled=True, fail_rate=0.2,
                                        flip_rate=0.2, echo_rate=0.2),
                     defense=DefenseConfig(screen=True, clip=True,
                                           clip_norm=2.0))
    srv = {k: FederatedServer(cfg, data, nets, device=d)
           for k, d in (("card", dev), ("cpu", "cpu"))}
    cpu = srv["cpu"]._state
    for t in range(3):
        before = t_ra.LAUNCHES
        card, lg = srv["card"].engine.run_block(_state_to(cpu, dev), t, 1)
        torch.cuda.synchronize()
        assert t_ra.LAUNCHES == before + 1
        cpu, lc = srv["cpu"].engine.run_block(cpu, t, 1)
        for name in ("ids", "quarantine"):
            np.testing.assert_array_equal(lg[name], lc[name])
        for name in ("due", "tau"):
            np.testing.assert_array_equal(getattr(card.buf, name).cpu(),
                                          getattr(cpu.buf, name))
        assert torch.isfinite(card.buf.vec).all()
        for k in cpu.params:
            np.testing.assert_allclose(card.params[k].cpu(), cpu.params[k],
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_checkpoint_roundtrip_is_bitwise(dev, tmp_path):
    """2 async rounds on the card, save, load, 2 more: bitwise the
    uninterrupted 4, live buffer entries at the boundary, the restored
    leaves on the card."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    data, nets = _async_inputs()
    srv = FederatedServer(_async_cfg("async", 0.3), data, nets, device=dev)
    mid, _ = srv.engine.run_block(srv._state, 0, 2)
    assert (mid.buf.due < 3e9).any()
    path = save_checkpoint(str(tmp_path / "ck"), mid, step=2)
    restored, step = load_checkpoint(path, mid)
    assert step == 2 and restored.buf.vec.is_cuda
    full, lf = srv.engine.run_block(mid, 2, 2)
    resumed, lr = srv.engine.run_block(restored, 2, 2)
    for a, b in zip(_state_to(full, "cpu"), _state_to(resumed, "cpu")):
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else zip(a, b) if isinstance(a, tuple) else ((a, b),)):
            assert torch.equal(x, y)
    for k in lf:
        np.testing.assert_array_equal(lr[k], lf[k])


# the telemetry keys that are counts, or means of 0/1 masks and counts:
# equal on the card and the CPU; the rest within these tolerances
TELE_EXACT = ("tele/delivered_frac", "tele/realized_loss",
              "tele/part_quartile", "tele/stale_hist", "tele/quar_frac",
              "tele/buf_fill", "tele/downlink_loss", "tele/fec_recovered",
              "tele/arq_recovered", "tele/budget_escalations",
              "tele/rec_level_mean")
TELE_RTOL = {"tele/update_norm": 1e-4, "tele/ef_norm": 1e-4,
             "tele/debias_scale_mean": 1e-6, "tele/arrival_mean": 1e-6}


def _tele_grid(case):
    """Small grids at telemetry level full, and their FEC launches a
    round: every selection policy (traced) x loss {0.1, 0.3}; the GE grid
    with EF; the recovery policies (traced) under the i.i.d. downlink."""
    from repro_torch.core.selection import POLICIES, SelectionConfig
    from repro_torch.core.telemetry import TelemetryConfig
    base = FLConfig(algo="fedavg", n_rounds=3, clients_per_round=8,
                    local_steps=2, batch_size=8, eval_every=100,
                    tra=TRAConfig(enabled=True, debias="group_rate"),
                    netsim=NetSimConfig(channel="gilbert_elliott"),
                    telemetry=TelemetryConfig(level="full"))
    rates = (0.1, 0.3)
    if case == "selection":
        return [dataclasses.replace(
            base, sel=SelectionConfig(policy=p, traced=True,
                                      temperature=0.5),
            tra=dataclasses.replace(base.tra, loss_rate=r))
            for p in POLICIES for r in rates], 0
    if case == "ef":
        return [dataclasses.replace(
            base, error_feedback=True,
            tra=dataclasses.replace(base.tra, loss_rate=r)) for r in rates], 0
    return [dataclasses.replace(
        base, tra=dataclasses.replace(base.tra, loss_rate=r),
        netsim=dataclasses.replace(base.netsim, down_channel="iid",
                                   down_loss=0.3),
        recovery=RecoveryConfig(policy=p, traced=True))
        for p in ("one_shot", "fec", "arq") for r in rates], 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["selection", "ef", "iid_downlink"])
def test_cuda_telemetry_grid_matches_cpu(dev, case):
    """A grid at level full, each round on the card from the CPU's state:
    one batched uplink and one mask launch a round (and one FEC launch
    with recovery), the same telemetry keys, the count keys and the
    carry's counts equal, the norms and means within TELE_RTOL."""
    cfgs, fec = _tele_grid(case)
    data = generate_synthetic(np.random.default_rng(0), n_clients=20,
                              alpha=0.5, beta=0.5)
    nets = sample_networks(np.random.default_rng(2026), 20)
    engs = {k: SweepEngine.from_configs(cfgs, data, nets, device=d)
            for k, d in (("card", dev), ("cpu", "cpu"))}
    cpu = engs["cpu"].init_states()
    for t in range(3):
        before = (t_uf.BATCHED_LAUNCHES, t_nm.LAUNCHES, t_fc.LAUNCHES)
        card, lg = engs["card"].run_block(_state_to(cpu, dev), t, 1)
        torch.cuda.synchronize()
        assert (t_uf.BATCHED_LAUNCHES, t_nm.LAUNCHES, t_fc.LAUNCHES) == \
            (before[0] + 1, before[1] + 1, before[2] + fec)
        cpu, lc = engs["cpu"].run_block(cpu, t, 1)
        np.testing.assert_array_equal(lg["ids"], lc["ids"])
        keys = {k for k in lc if k.startswith("tele/")}
        assert keys == {k for k in lg if k.startswith("tele/")}
        for k in keys:
            if k in TELE_EXACT:
                np.testing.assert_array_equal(lg[k], lc[k], err_msg=k)
            else:
                np.testing.assert_allclose(lg[k], lc[k], rtol=TELE_RTOL[k],
                                           err_msg=k)
        for name in ("part_count", "quar_pkts"):
            assert torch.equal(getattr(card.tele, name).cpu(),
                               getattr(cpu.tele, name))
        for name in ("arrival_mass", "stale_sum"):
            np.testing.assert_allclose(getattr(card.tele, name).cpu(),
                                       getattr(cpu.tele, name), rtol=1e-6)
        for k in cpu.params:
            np.testing.assert_allclose(card.params[k].cpu(), cpu.params[k],
                                       rtol=1e-4, atol=1e-5)
    want = {"selection": {"tele/part_quartile"},
            "ef": {"tele/ef_norm"},
            "iid_downlink": {"tele/downlink_loss", "tele/fec_recovered",
                             "tele/arq_recovered"}}[case]
    assert want <= keys


@pytest.mark.cuda
def test_cuda_event_stream_stamps_the_card(dev, tmp_path):
    """A FederatedServer run at level full on the card streams its rounds,
    its client aggregates and the program ledger, stamped with the
    card."""
    from repro_torch.core.telemetry import TelemetryConfig
    from repro_torch.utils.events import load_stream
    data, nets = _async_inputs()
    cfg = dataclasses.replace(_async_cfg("async", 0.3),
                              telemetry=TelemetryConfig(level="full"))
    path = str(tmp_path / "ev.jsonl")
    FederatedServer(cfg, data, nets, device=dev).run(events=path)
    header, rounds, programs = load_stream(path)
    env = header["env"]
    assert env["backend"] == "cuda" and env["jax"] is None
    assert env["device"] == torch.cuda.get_device_name(0)
    assert len(rounds) == cfg.n_rounds and programs
    assert all(r.buf_fill is not None and r.stale_hist is not None
               for r in rounds)
    assert sum('"client_stats"' in line for line in open(path)) == 1


@pytest.mark.cuda
def test_cuda_telemetry_off_dispatches_the_frozen_ops(dev):
    """At level off a TRA round on the card dispatches the ops of the step
    frozen before the later subsystems one for one."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from _torch_legacy_engine_v13 import LegacyState, make_legacy_round_step

    class OpLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    data, nets = _async_inputs()
    cfg = FLConfig(algo="qfedavg", n_rounds=2, clients_per_round=8,
                   local_steps=2, batch_size=8, eval_every=100,
                   tra=TRAConfig(enabled=True, loss_rate=0.1))
    srv = FederatedServer(cfg, data, nets, device=dev)
    st = srv._state
    old = LegacyState(*st[:6])
    legacy = make_legacy_round_step(cfg, srv.engine.cohort)
    for t in range(2):
        with OpLog() as new_ops:
            st, _ = srv.engine.run_single(st, t)
        with OpLog() as old_ops:
            old, _ = legacy(srv.engine.ctx, old, t)
        assert new_ops.ops == old_ops.ops
