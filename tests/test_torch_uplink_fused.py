"""The port's fused uplink step against the JAX reference.

On the CPU the port's ``uplink_round`` runs its plain version
(``uplink_ref``); it is held against the reference's jnp oracle
(``impl="ref"``) and its Pallas kernel in interpret mode
(``impl="kernel"``), on ``tests/test_uplink_fused.py``'s case: C=6,
P=16, F=32 with a partial last packet. Tolerances: agg rtol 2e-5 /
atol 1e-6 (the reference's own kernel-vs-oracle tolerance; the einsum
sums in another order), EF rows bitwise (element-wise, one rounding),
ssq rtol 1e-5. The scenario-batched entry is held against the
reference's ``uplink_round_scenarios`` at the same tolerances and
against S single calls bitwise. The CUDA kernel's own tests are in
tests/test_torch_cuda.py.
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
from _torch_wide_cases import RecordingLib

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


S = 3


@pytest.fixture(scope="module")
def scenarios():
    """S scenarios of the case's shape, each with its own inputs."""
    rng = np.random.default_rng(11)
    flat = rng.normal(size=(S, C, D_UP)).astype(np.float32)
    xp = np.pad(flat, ((0, 0), (0, 0), (0, PAD))).reshape(S, C, P, F)
    mask = (rng.random((S, C, P)) > 0.4).astype(np.float32)
    pcnt = np.full((P,), F, np.float32)
    pcnt[-1] = F - PAD
    return dict(
        xp=xp, ef=rng.normal(size=(S, C, D_UP)).astype(np.float32),
        mask=mask, w=(rng.random((S, C)) + 0.1).astype(np.float32),
        suff=(rng.random((S, C)) > 0.5).astype(np.float32),
        mult=(rng.random((S, C)) + 0.5).astype(np.float32),
        kept=((mask @ pcnt) / np.float32(D_UP)).astype(np.float32),
        lr=np.array([0.1, 0.3, 0.5], np.float32))


def _scen_kw(sc, lib, use_ef, want_ssq, mode):
    return dict(mode=mode, d_up=D_UP,
                ef_rows=lib(sc["ef"]) if use_ef else None,
                kept=lib(sc["kept"]), sufficient=lib(sc["suff"]),
                loss_rate=lib(sc["lr"]), mult=lib(sc["mult"]),
                want_ssq=want_ssq)


@pytest.mark.parametrize("mode", DEBIAS_MODES)
@pytest.mark.parametrize("use_ef", [False, True])
@pytest.mark.parametrize("want_ssq", [False, True])
def test_uplink_round_scenarios_matches_reference(scenarios, mode, use_ef,
                                                  want_ssq):
    """The batched plain path (the op's vmap rule on the CPU) against the
    reference's batched entry, and bitwise against S single calls."""
    sc = scenarios
    before = (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES)
    a1, e1, s1 = t_ops.uplink_round_scenarios(
        torch.tensor(sc["xp"]), torch.tensor(sc["mask"]),
        torch.tensor(sc["w"]),
        **_scen_kw(sc, torch.tensor, use_ef, want_ssq, mode))
    assert (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES) == before
    a0, e0, s0 = j_ops.uplink_round_scenarios(
        jnp.asarray(sc["xp"]), jnp.asarray(sc["mask"]), jnp.asarray(sc["w"]),
        impl="ref", **_scen_kw(sc, jnp.asarray, use_ef, want_ssq, mode))
    assert tuple(a1.shape) == (S, D_UP)
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
    for i in range(S):
        one = {k: torch.tensor(v[i]) for k, v in sc.items()}
        a, e, q = t_ops.uplink_round(
            one["xp"], one["mask"], one["w"],
            **_scen_kw(one, lambda v: v, use_ef, want_ssq, mode))
        assert torch.equal(a, a1[i])
        if use_ef:
            assert torch.equal(e, e1[i])
        if want_ssq:
            assert torch.equal(q, s1[i])


def test_batched_wrapper_refuses_cpu_tensors(scenarios):
    x = torch.tensor(scenarios["xp"])
    with pytest.raises(ValueError, match="CUDA"):
        t_uf.uplink_fused_batched_call(
            x, torch.tensor(scenarios["mask"]), torch.tensor(scenarios["w"]),
            torch.ones(S), per_coord=False)


# ---------------------------------------------------------------------------
# packet widths off a multiple of 32, and the binding's contract
# ---------------------------------------------------------------------------
F_ODD = 255
D_ODD = P * F_ODD - 11


@pytest.fixture(scope="module")
def odd_case():
    """The case's clients at F = 255, a partial last packet."""
    rng = np.random.default_rng(17)
    flat = rng.normal(size=(C, D_ODD)).astype(np.float32)
    xp = np.pad(flat, ((0, 0), (0, 11))).reshape(C, P, F_ODD)
    mask = (rng.random((C, P)) > 0.4).astype(np.float32)
    pcnt = np.full((P,), F_ODD, np.float32)
    pcnt[-1] = F_ODD - 11
    return dict(xp=xp, ef=rng.normal(size=(C, D_ODD)).astype(np.float32),
                mask=mask, w=(rng.random(C) + 0.1).astype(np.float32),
                suff=(rng.random(C) > 0.5).astype(np.float32),
                mult=(rng.random(C) + 0.5).astype(np.float32),
                kept=((mask @ pcnt) / np.float32(D_ODD)).astype(np.float32),
                lr=np.float32(0.4))


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("mode", ["per_coord_count", "group_rate"])
@pytest.mark.parametrize("use_ef", [False, True])
def test_uplink_round_at_an_odd_packet_width_matches_reference(
        odd_case, impl, mode, use_ef):
    """F = 255 through the port's op against the reference's oracle and
    its interpret-mode Pallas kernel, at the module's tolerances."""
    c = odd_case
    kw = dict(mode=mode, d_up=D_ODD, want_ssq=True)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    a0, e0, s0 = j_ops.uplink_round(
        j["xp"], j["mask"], j["w"], ef_rows=j["ef"] if use_ef else None,
        kept=j["kept"], sufficient=j["suff"], loss_rate=j["lr"],
        mult=j["mult"], impl=impl, **kw)
    t = {k: torch.tensor(v) for k, v in c.items()}
    a1, e1, s1 = t_ops.uplink_round(
        t["xp"], t["mask"], t["w"], ef_rows=t["ef"] if use_ef else None,
        kept=t["kept"], sufficient=t["suff"], loss_rate=t["lr"],
        mult=t["mult"], **kw)
    np.testing.assert_allclose(a1.numpy(), np.asarray(a0), rtol=2e-5,
                               atol=1e-6)
    if use_ef:
        np.testing.assert_array_equal(e1.numpy(), np.asarray(e0))
    np.testing.assert_allclose(s1.numpy(), np.asarray(s0), rtol=1e-5)


def _uf_plan(threads, tiles, floats, C_, row):
    chunk = max(1, min(t_uf.CHUNK, C_, t_uf.SMEM_BUDGET // row))
    return t_uf.Plan(threads, tiles, floats, chunk, chunk * row)


@pytest.mark.parametrize("S,C_,P_,F_,ef,bf16,ssq,want", [
    # the paths' shapes: the quickstart round (36 rows: a thread a float),
    # the bursty grid (972 rows: 4 floats a thread) and the q-FedAvg grid
    # (with the norms only one scenario's rows count), EF tiling
    (1, 10, 36, 256, False, False, True, _uf_plan(256, 1, 1, 10, 1024)),
    (27, 10, 36, 256, False, False, False, _uf_plan(64, 1, 4, 10, 1024)),
    (9, 10, 36, 256, False, False, True, _uf_plan(256, 1, 1, 10, 1024)),
    (1, 64, 1024, 256, True, False, False, _uf_plan(64, 1, 4, 64, 2048)),
    (1, 64, 1024, 256, True, True, True, _uf_plan(64, 1, 4, 64, 1024)),
    # any width: whole warps, a row past one CTA's floats over several
    (1, 10, 36, 1, False, False, False, _uf_plan(32, 1, 1, 10, 128)),
    (1, 10, 36, 100, True, False, True, _uf_plan(128, 1, 1, 10, 1024)),
    (1, 10, 36, 255, False, True, False, _uf_plan(256, 1, 1, 10, 512)),
    (1, 10, 36, 1024, True, False, False, _uf_plan(256, 4, 1, 10, 2048)),
    (1, 10, 36, 20000, True, False, True, _uf_plan(256, 79, 1, 10, 2048)),
    (8, 10, 36, 20000, False, True, False, _uf_plan(256, 20, 4, 10, 2048)),
    (8, 10, 36, 255, True, False, False, _uf_plan(64, 1, 4, 10, 2048)),
    (1, 0, 36, 256, False, False, False, _uf_plan(256, 1, 1, 0, 1024))])
def test_launch_plan_covers_any_packet_width(S, C_, P_, F_, ef, bf16, ssq,
                                             want):
    """A thread over 4 floats from WIDE_ROWS rows on (one scenario's with
    the masked norms, so that a batched launch sums them as its single
    launches do), else one; a CTA at most MAX_THREADS; the chunk's rows
    within SMEM_BUDGET (no opt-in); the tiles cover F."""
    pl = t_uf.plan(S, C_, P_, F_, ef, bf16, ssq)
    assert pl == want
    assert pl.smem <= t_uf.SMEM_BUDGET and pl.threads % 32 == 0
    rows = P_ if ssq else S * P_
    assert pl.floats == (4 if rows >= t_uf.WIDE_ROWS else 1)
    if ssq:
        assert pl == t_uf.plan(1, C_, P_, F_, ef, bf16, ssq)
    span = pl.floats * pl.threads
    assert span * pl.tiles >= F_ > span * (pl.tiles - 1)


@pytest.mark.parametrize("S,C_,P_,F_,msg", [
    (0, 10, 36, 256, "S, P, F > 0"), (1, 10, 0, 256, "S, P, F > 0"),
    (1, 10, 36, 0, "S, P, F > 0"), (1, -1, 36, 256, "S, P, F > 0")])
def test_launch_plan_refuses_what_the_kernel_cannot_take(S, C_, P_, F_, msg):
    with pytest.raises(ValueError, match=msg):
        t_uf.plan(S, C_, P_, F_, False, False, True)


def test_launch_plan_constants_follow_the_kernel_source():
    """CHUNK and MAX_THREADS restate the kernel's kChunk and kMaxWarps,
    and the kernel's static shared memory (two buffers of 3 scalars and
    kMaxWarps ssq words a client) leaves SMEM_BUDGET within the 48 KB a
    CTA gets without an opt-in."""
    from repro_torch.kernels import _build
    src = (_build.CSRC / "uplink_fused.cu").read_text()
    assert f"constexpr int kChunk = {t_uf.CHUNK};" in src
    assert f"constexpr int kMaxWarps = {t_uf.MAX_THREADS // 32};" in src
    static = 2 * t_uf.CHUNK * (3 + t_uf.MAX_THREADS // 32) * 4
    assert t_uf.SMEM_BUDGET + static <= 48 * 1024


class _OnCard:
    """Stands in for a tensor on the card: the refusal reads only
    ``is_cuda``."""
    is_cuda = True


_OPERANDS = ("x", "m", "q", "w_or_den", "ef")


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", _OPERANDS)
def test_kernel_entries_refuse_a_cpu_operand_first(batched, name):
    """A CPU tensor in any operand raises the CUDA refusal, named, before
    a counter moves and before the library is built or loaded: the rest
    stand in for tensors on the card, and the CPU one is also of the
    wrong dtype and shape, so no later check can raise first."""
    ops = {k: _OnCard() for k in _OPERANDS}
    ops[name] = torch.zeros(3, dtype=torch.float64)
    entry = (t_uf.uplink_fused_batched_call if batched
             else t_uf.uplink_fused_call)
    before = (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES, t_uf._lib.cache_info())
    with pytest.raises(ValueError, match=f"CUDA tensors only, and {name} "
                                         f"lies on cpu"):
        entry(*(ops[k] for k in _OPERANDS[:4]), ef=ops["ef"],
              want_ssq=True, per_coord=False)
    assert (t_uf.LAUNCHES, t_uf.BATCHED_LAUNCHES,
            t_uf._lib.cache_info()) == before


def test_binding_check_names_the_operand():
    """The per-operand fallback of the one-pass check: device (naming
    CUDA), dtype, shape, contiguity, in that order."""
    card = torch.device("cuda", 0)
    t = torch.zeros((2, 3))
    f32 = torch.float32
    with pytest.raises(ValueError, match="m must be a CUDA tensor on "
                                         "cuda:0, not on cpu"):
        t_uf._check("m", t, (2, 3), f32, card)
    here = t.device
    with pytest.raises(TypeError, match="x must be torch.bfloat16"):
        t_uf._check("x", t, (2, 3), torch.bfloat16, here)
    with pytest.raises(ValueError, match=r"q must have shape \(3, 2\)"):
        t_uf._check("q", t, (3, 2), f32, here)
    with pytest.raises(ValueError, match="ef must be contiguous"):
        t_uf._check("ef", t.t(), (3, 2), f32, here)
    t_uf._check("x", t, (2, 3), f32, here)



@pytest.mark.parametrize("S,chunks", [(65535, [65535]),
                                      (65536, [65535, 1]),
                                      (131073, [65535, 65535, 3])])
@pytest.mark.parametrize("ssq", [False, True])
def test_batched_binding_launches_past_65535_scenarios_in_chunks(
        monkeypatch, S, chunks, ssq):
    """Scenarios lie on grid.y: the binding launches a chunk of at most
    MAX_SCENARIOS at a time, every operand and output offset to the
    chunk's first scenario, all chunks with the plan of the whole call,
    and counts each launch."""
    assert t_uf.MAX_SCENARIOS == 65535
    lib = RecordingLib("uplink_fused_launch")
    monkeypatch.setattr(t_uf, "_lib", lambda: lib)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    C, P, F = 2, 1, 4
    x = torch.zeros((S, C, P, F))
    ef = torch.zeros_like(x)
    m, q = torch.ones((S, C, P)), torch.ones((S, C))
    den = torch.ones(S)
    before = t_uf.BATCHED_LAUNCHES
    agg, ef_out, ssq_out = t_uf._launch((S,), x, m, q, den, ef, ssq, False)
    assert t_uf.BATCHED_LAUNCHES - before == len(chunks)
    assert [c[8] for c in lib.calls] == chunks
    pl = t_uf.plan(S, C, P, F, True, False, ssq)
    s0 = 0
    for call, n in zip(lib.calls, chunks):
        ptrs = [x, ef, m, q, den, agg, ef_out, ssq_out]
        want = [None if t is None else t.data_ptr()
                + s0 * t.stride(0) * t.element_size() for t in ptrs]
        assert list(call[:8]) == want
        assert call[15:20] == (pl.chunk, pl.threads, pl.tiles, pl.floats,
                               pl.smem)
        s0 += n
