"""The port's fused uplink step against the JAX reference.

On the CPU the port's ``uplink_round`` runs its plain version
(``uplink_ref``); it is held against the reference's jnp oracle
(``impl="ref"``) and its Pallas kernel in interpret mode
(``impl="kernel"``), on ``tests/test_uplink_fused.py``'s case: C=6,
P=16, F=32 with a partial last packet. Tolerances: agg rtol 2e-5 /
atol 1e-6 (the reference's own kernel-vs-oracle tolerance; the einsum
sums in another order), EF rows bitwise (element-wise, one rounding),
ssq rtol 1e-5. The CUDA kernel's own tests need a card and skip here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.uplink_fused import ops as j_ops
from repro_torch.core.tra import DEBIAS_MODES
from repro_torch.kernels.common import DENOM_EPS, RATE_EPS
from repro_torch.kernels.uplink_fused import ops as t_ops
from repro_torch.kernels.uplink_fused import uplink_fused as t_uf
from repro_torch.kernels.uplink_fused.ref import uplink_ref

C, P, F = 6, 16, 32
D_UP = P * F - 11                       # partial last packet
PAD = P * F - D_UP


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(7)
    flat = rng.normal(size=(C, D_UP)).astype(np.float32)
    xp = np.pad(flat, ((0, 0), (0, PAD))).reshape(C, P, F)
    ef = rng.normal(size=(C, D_UP)).astype(np.float32)
    mask = (rng.random((C, P)) > 0.4).astype(np.float32)
    w = (rng.random(C) + 0.1).astype(np.float32)
    suff = (rng.random(C) > 0.5).astype(np.float32)
    mult = (rng.random(C) + 0.5).astype(np.float32)
    pcnt = np.full((P,), F, np.float32)
    pcnt[-1] = F - PAD
    kept = (mask @ pcnt) / np.float32(D_UP)
    return dict(xp=xp, ef=ef, mask=mask, w=w, suff=suff, mult=mult,
                kept=kept.astype(np.float32), lr=np.float32(0.4))


def _jax(case, mode, *, use_ef, want_ssq, impl, stream_dtype=None):
    kw = {k: jnp.asarray(case[k]) for k in ("kept", "suff", "mult", "lr")}
    return j_ops.uplink_round(
        jnp.asarray(case["xp"]), jnp.asarray(case["mask"]),
        jnp.asarray(case["w"]), mode=mode, d_up=D_UP,
        ef_rows=jnp.asarray(case["ef"]) if use_ef else None,
        kept=kw["kept"], sufficient=kw["suff"], loss_rate=kw["lr"],
        mult=kw["mult"], want_ssq=want_ssq, impl=impl,
        stream_dtype=stream_dtype)


def _torch(case, mode, *, use_ef, want_ssq, stream_dtype=None):
    t = {k: torch.tensor(v) for k, v in case.items()}
    return t_ops.uplink_round(
        t["xp"], t["mask"], t["w"], mode=mode, d_up=D_UP,
        ef_rows=t["ef"] if use_ef else None, kept=t["kept"],
        sufficient=t["suff"], loss_rate=t["lr"], mult=t["mult"],
        want_ssq=want_ssq, stream_dtype=stream_dtype)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("mode", DEBIAS_MODES)
@pytest.mark.parametrize("use_ef", [False, True])
@pytest.mark.parametrize("want_ssq", [False, True])
def test_uplink_round_matches_reference(case, impl, mode, use_ef, want_ssq):
    before = t_uf.LAUNCHES
    a1, e1, s1 = _torch(case, mode, use_ef=use_ef, want_ssq=want_ssq)
    a0, e0, s0 = _jax(case, mode, use_ef=use_ef, want_ssq=want_ssq,
                      impl=impl)
    assert t_uf.LAUNCHES == before          # no kernel launch on the CPU
    assert a1.dtype == torch.float32 and tuple(a1.shape) == (D_UP,)
    np.testing.assert_allclose(a1.numpy(), np.asarray(a0), rtol=2e-5,
                               atol=1e-6)
    if use_ef:
        np.testing.assert_array_equal(e1.numpy(), np.asarray(e0))
    else:
        assert e1 is None
    if want_ssq:
        np.testing.assert_allclose(s1.numpy(), np.asarray(s0), rtol=1e-5)
    else:
        assert s1 is None


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_bf16_stream_contract(case, impl):
    """Uploads and EF rounded to bf16, fp32 accumulation, EF rows
    written back in bf16: the reference's contract, same values."""
    a1, e1, s1 = _torch(case, "group_rate", use_ef=True, want_ssq=True,
                        stream_dtype=torch.bfloat16)
    a0, e0, s0 = _jax(case, "group_rate", use_ef=True, want_ssq=True,
                      impl=impl, stream_dtype=jnp.bfloat16)
    assert a1.dtype == torch.float32 and e1.dtype == torch.bfloat16
    np.testing.assert_allclose(a1.numpy(), np.asarray(a0), rtol=2e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(e1.float().numpy(),
                                  np.asarray(e0, np.float32))
    np.testing.assert_allclose(s1.numpy(), np.asarray(s0), rtol=1e-5)


def test_debias_scale_and_guards(case):
    assert DENOM_EPS == 1e-12 and RATE_EPS == 1e-6
    t = {k: torch.tensor(v) for k, v in case.items()}
    for mode in DEBIAS_MODES:
        q1 = t_ops.debias_client_scale(t["w"], mode=mode, kept=t["kept"],
                                       sufficient=t["suff"],
                                       loss_rate=t["lr"], mult=t["mult"])
        q0 = j_ops.debias_client_scale(
            jnp.asarray(case["w"]), mode=mode, kept=jnp.asarray(case["kept"]),
            sufficient=jnp.asarray(case["suff"]),
            loss_rate=jnp.asarray(case["lr"]), mult=jnp.asarray(case["mult"]))
        np.testing.assert_array_equal(q1.numpy(), np.asarray(q0))
    # a fully dropped client hits the RATE_EPS guard, not DENOM_EPS
    q = t_ops.debias_client_scale(torch.ones(3), mode="per_client_rate",
                                  kept=torch.zeros(3))
    np.testing.assert_allclose(q.numpy(), 1.0 / RATE_EPS, rtol=1e-6)


def test_pack_rows_matches_reference(case):
    a = t_ops._pack_rows(torch.tensor(case["ef"]), P, F).numpy()
    b = np.asarray(j_ops._pack_rows(jnp.asarray(case["ef"]), P, F))
    np.testing.assert_array_equal(a, b)


def test_kernel_wrapper_refuses_cpu_tensors(case):
    x = torch.tensor(case["xp"])
    with pytest.raises(ValueError, match="CUDA"):
        t_uf.uplink_fused_call(x, torch.tensor(case["mask"]),
                               torch.tensor(case["w"]), torch.tensor(1.0),
                               per_coord=False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", DEBIAS_MODES)
@pytest.mark.parametrize("use_ef", [False, True])
def test_cuda_kernel_matches_plain(case, cuda_device, dtype, mode, use_ef):
    """The CUDA kernel against its plain version on the card: agg rtol
    1e-5 / atol 1e-6 (its fp32 client loop sums in another order), EF
    bitwise in the stream dtype, ssq rtol 1e-5."""
    t = {k: torch.tensor(v, device=cuda_device) for k, v in case.items()}
    q = t_ops.debias_client_scale(t["w"], mode=mode, kept=t["kept"],
                                  sufficient=t["suff"], loss_rate=t["lr"],
                                  mult=t["mult"])
    per_coord = mode == "per_coord_count"
    wd = t["w"] if per_coord else torch.clamp(t["w"].sum(), min=DENOM_EPS)
    x = t["xp"].to(dtype)
    ef = t_ops._pack_rows(t["ef"], P, F).to(dtype) if use_ef else None
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
